"""Small configurations and runs of the cells on the CPU, for the
tests: the cells' own files, with the sizes cut to what a test holds."""
from __future__ import annotations

import argparse
import copy
import json

import torch

from perfbench import harness

SMOLLM = {"hidden_size": 64, "intermediate_size": 96,
          "num_attention_heads": 4, "num_key_value_heads": 2,
          "num_hidden_layers": 2, "vocab_size": 512}
JAMBA = {"hidden_size": 64, "intermediate_size": 96,
         "num_attention_heads": 4, "num_key_value_heads": 2,
         "num_hidden_layers": 8, "vocab_size": 512, "num_experts": 4,
         "mamba_d_state": 8, "mamba_dt_rank": 8}
TRAIN = {"batch": 4, "seq": 64, "doc_len_min": 4, "doc_len_max": 256}
PREFILL = {"len_min": 128, "len_max": 384, "grid": 4}


def small_config(name: str) -> dict:
    cfg = copy.deepcopy(harness.config(name))
    cfg.update(SMOLLM if cfg["model_type"] == "llama" else JAMBA)
    return cfg


def args(cell: str, seed: int = 2 ** 40 + 17, seconds: float = 0.5,
         trace: int = 0) -> argparse.Namespace:
    wl = harness.workload(cell)
    return argparse.Namespace(
        workload=cell, seed=seed, seconds=seconds, trace=trace,
        config_override=small_config(wl["config"]),
        params_override=TRAIN if wl["loop"] == "train" else PREFILL)


def run_cpu(cell: str, *, patch=None, **kw) -> dict:
    """One rank's run of ``cell`` on the CPU at the small size."""
    return harness.run_rank(args(cell, **kw), device=torch.device("cpu"),
                            patch=patch)


if __name__ == "__main__":
    import sys
    print(json.dumps(run_cpu(sys.argv[1])))


def _rank(rank, world, rendezvous, argv, patch, q):
    import sys
    from pathlib import Path
    root = Path(__file__).resolve().parents[2]
    sys.path[:0] = [str(root / "src"), str(root)]
    from perfbench.tests import smoke
    out = harness.run_rank(smoke.args(*argv), rank, world, rendezvous,
                           device=torch.device("cpu"), patch=patch)
    if out is not None:
        q.put(out)


def run_cpu_ranks(cell: str, world: int, *, patch=None, seed=2 ** 40 + 17,
                  seconds=0.5, trace=0) -> dict:
    """``world`` gloo ranks of ``cell`` on the CPU at the small size;
    rank 0's result."""
    import multiprocessing as mp
    q = mp.get_context("spawn").Queue()
    codes = harness.spawn_ranks(_rank, world, (cell, seed, seconds, trace),
                                patch, q, timeout=300)
    assert codes == [0] * world, codes
    return q.get(timeout=60)
