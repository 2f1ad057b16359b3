from repro_torch.optim.adamw import (  # noqa: F401
    adamw_init, adamw_update, clip_by_global_norm)
from repro_torch.optim.schedule import cosine_schedule  # noqa: F401
from repro_torch.optim.compress import (  # noqa: F401
    compress_int8, decompress_int8, ef_compress_tree)
