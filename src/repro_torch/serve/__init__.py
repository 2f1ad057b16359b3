"""Serving: batched prefill + KV-cache decode steps, and the
continuous-batching engine over disaggregated prefill/decode KV pools
with its seeded traffic generator."""
from repro_torch.serve.step import (  # noqa: F401
    ServeOptions, init_serve_cache, make_decode_step, make_prefill_step)
