"""One rank of the examples' multi-process test
(tests/test_torch_examples.py).

Spawned by ``torch.multiprocessing.start_processes`` in ``torchrun``'s
environment (RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR/PORT): joins the
8-rank gloo group the way the examples do under ``torchrun``, runs the
quickstart's group form on each case (transport, inputs), then
``train_smollm.run`` on the CPU in the same group, and pickles what each
returned for the parent.  Loads the examples from ``examples_torch/`` by
path; imports torch and the port only.
"""
import importlib.util
import os
import pickle
from pathlib import Path

import torch
import torch.distributed as dist

EXAMPLES = Path(__file__).resolve().parents[1] / "examples_torch"


def load(name: str):
    """``examples_torch/<name>.py`` as a module, without running it."""
    spec = importlib.util.spec_from_file_location(
        f"examples_torch_{name}", EXAMPLES / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def run(rank: int, n: int, port: int, cases: dict, train: dict,
        out_dir: str) -> None:
    torch.set_num_threads(1)
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(n), LOCAL_RANK=str(rank),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    from repro_torch.launch.mesh import ensure_process_group
    device = torch.device("cpu")
    ensure_process_group(device)
    try:
        qs = load("quickstart")
        out = {"quickstart": {
            name: qs.run_group(device, transport, x=x, values=values)
            for name, (transport, x, values) in cases.items()}}
        # the launcher joins the group already up and leaves it up
        result = load("train_smollm").run(**train, device="cpu")
        out["train"] = {"losses": result.losses, "start": result.start_step}
    finally:
        dist.destroy_process_group()
    with open(f"{out_dir}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
