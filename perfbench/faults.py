"""Faults planted in the program underneath a run, to show that
``correct`` comes out false.  Each swaps a function of the program
through ``put`` (``setattr``, or a test's ``monkeypatch.setattr``)
before the cell's loop builds the program; ``planted(name)`` is the
``patch`` that ``harness.run_rank`` takes.  Used by the tests and by
``control.py``; the benchmark's own runs plant none."""
from __future__ import annotations

import contextlib
import functools


def state_unchanged(put=setattr) -> None:
    """A train step that returns its input state unchanged."""
    from repro_torch.train import step as mod
    make = mod.make_train_step

    def patched(*a, **kw):
        real = make(*a, **kw)

        def step(state, batch):
            _, metrics = real(state, batch)
            return state, metrics
        return step
    put(mod, "make_train_step", patched)


def half_batch(put=setattr) -> None:
    """A train step that leaves out the second half of its rows and
    takes the mean over the rest."""
    from repro_torch.train import step as mod
    make = mod.make_train_step

    def patched(*a, **kw):
        real = make(*a, **kw)

        def step(state, batch):
            n = batch["tokens"].shape[0] // 2
            return real(state, {k: v[:n] for k, v in batch.items()})
        return step
    put(mod, "make_train_step", patched)


def no_exchange(put=setattr) -> None:
    """The gradient sync between cards left out: each rank divides its
    own gradient sums by the group's count."""
    from repro_torch.train import sync

    def local(grads, group, *, denom=None, **kw):
        return {k: (g.float() / denom).to(g.dtype) for k, g in grads.items()}
    put(sync, "dp_allreduce", local)


def altered_token(put=setattr) -> None:
    """A prefill whose greedy token at the last position comes out as
    another id: the best logit swapped with that of the id half the
    vocabulary away."""
    from repro_torch.serve import step as mod
    make = mod.make_prefill_step

    def patched(*a, **kw):
        real = make(*a, **kw)

        def prefill(params, tokens, **kwa):
            logits = real(params, tokens, **kwa)
            row = logits[0, -1]
            best = int(row.argmax())
            other = (best + row.numel() // 2) % row.numel()
            row[best], row[other] = row[other].clone(), row[best].clone()
            return logits
        return prefill
    put(mod, "make_prefill_step", patched)


FAULTS = {"state_unchanged": state_unchanged, "half_batch": half_batch,
          "no_exchange": no_exchange, "altered_token": altered_token}


_PLANTED: list = []


def _put(obj, name, value) -> None:
    _PLANTED.append((obj, name, getattr(obj, name)))
    setattr(obj, name, value)


def _apply(name: str, ctx) -> None:
    FAULTS[name](_put)


@contextlib.contextmanager
def undone():
    """Every fault planted inside the block is taken out again at its
    end (several runs in one process)."""
    try:
        yield
    finally:
        while _PLANTED:
            obj, name, value = _PLANTED.pop()
            setattr(obj, name, value)


def planted(name: str):
    """The ``patch`` that plants fault ``name`` in a run (picklable, so
    that each spawned rank plants it in its own process)."""
    return functools.partial(_apply, name)
