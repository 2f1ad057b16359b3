"""Serving steps: batched prefill + KV-cache decode.  The continuous-
batching engine and the traffic generator are still to port (ROADMAP.md,
Queue 1 item 7)."""
from repro_torch.serve.step import (  # noqa: F401
    ServeOptions, init_serve_cache, make_decode_step, make_prefill_step)
