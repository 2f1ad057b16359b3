"""End-to-end driver: train the smollm-family model with the production
stack — explicit DP through the MPIX layer (``hierarchical`` allreduce,
4 gradient buckets), the fault-tolerant loop, checkpoints.

    PYTHONPATH=src python examples_torch/train_smollm.py --device cpu
    PYTHONPATH=src python examples_torch/train_smollm.py --full  # a card
    PYTHONPATH=src torchrun --nproc-per-node 8 \\
        examples_torch/train_smollm.py --device cpu --steps 20

The run is that of ``examples/train_smollm.py``: smollm-360m (its smoke
config unless ``--full``), 300 steps of B 8 x S 128 at lr 3e-3,
checkpoints every 100 steps, through ``repro_torch.launch.train``.
Unlike the reference, ``--steps`` and ``--full`` take effect,
``--ckpt-dir`` and ``--ckpt-every`` name the checkpoints, and
``--device`` goes to the launcher (default ``cuda``: without a card the
script exits with an error).  The default ``--ckpt-dir`` is
``repro_torch_smollm_smoke`` (``_full`` with ``--full``) under the
temporary directory (``$TMPDIR``, else ``/tmp``): the two configs never
restore each other's state.  Without ``torchrun`` the script trains
one rank (the sync runs over a group of one); under ``torchrun`` each
rank reads its rows of the batch.

Kill it mid-run and start it again: it resumes from the last committed
checkpoint and the loss curve continues exactly.  A run already past
``--steps`` does nothing.
"""
import argparse
import os
import tempfile

from repro_torch.launch import train as T

BATCH, SEQ = 8, 128


def default_ckpt_dir(full: bool) -> str:
    """The checkpoints' directory when none is named: one per config,
    under the temporary directory."""
    return os.path.join(tempfile.gettempdir(),
                        f"repro_torch_smollm_{'full' if full else 'smoke'}")


def run(steps: int = 300, full: bool = False, ckpt_dir: str | None = None,
        ckpt_every: int = 100, device: str = "cuda") -> "T.TrainRun":
    """Train through the launcher with the reference's argv; returns its
    ``TrainRun`` (the losses of the steps taken, the step it resumed
    from, the step times)."""
    if ckpt_dir is None:
        ckpt_dir = default_ckpt_dir(full)
    argv = ["--arch", "smollm-360m", "--steps", str(steps),
            "--batch", str(BATCH), "--seq", str(SEQ), "--lr", "3e-3",
            "--dp-mode", "explicit", "--dp-algorithm", "hierarchical",
            "--grad-buckets", "4", "--device", device,
            "--ckpt-dir", ckpt_dir, "--ckpt-every", str(ckpt_every)]
    if not full:
        argv.append("--smoke")
    result = T.main(argv)
    if not result.losses:          # resumed past --steps: nothing to do
        return result
    if not result.losses[-1] < result.losses[0]:
        raise RuntimeError(f"loss must decrease: {result.losses[0]:.4f} "
                           f"-> {result.losses[-1]:.4f}")
    print("train_smollm OK", flush=True)
    return result


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true",
                    help="full 360M config (slow on CPU)")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--ckpt-dir", default=None,
                    help="default: repro_torch_smollm_smoke (or _full) "
                         "under $TMPDIR")
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--device", default="cuda",
                    help="default cuda; cpu runs every kernel's plain "
                         "version")
    args = ap.parse_args(argv)
    return run(args.steps, args.full, args.ckpt_dir, args.ckpt_every,
               args.device)


if __name__ == "__main__":
    main()
