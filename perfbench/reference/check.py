"""The numbers ``correct`` compares, worked out from the program's
readings and the reference's.  Plain arithmetic on tensors and floats:
nothing here runs a model."""
from __future__ import annotations

import statistics

import torch


def _finite(x: float) -> float:
    """A gap that is not a number counts as infinitely wide."""
    return x if x == x else float("inf")


def judge(ref_logits, tokens) -> dict:
    """At every position: the gap of ``tokens`` (``token_gaps``), and at
    the last (the served first token) its rank among the reference's
    logits, 0 for the best."""
    last = ref_logits[-1].float()
    rank = int((last > last[int(tokens[-1])]).sum())
    return {"gaps": token_gaps(ref_logits, tokens).cpu(), "rank": rank}


def prefill_numbers(judged: list) -> dict:
    """From each checked request's judgement (``judge``):
    ``token_gap`` the widest gap anywhere, ``token_gap_mean`` the mean
    over every position, ``first_token_gap`` the widest at a served
    first token, ``first_token_rank`` the largest reference rank of a
    served first token, ``token_mismatch`` the share of positions whose
    token is not the reference's best."""
    flat = torch.cat([j["gaps"].flatten() for j in judged])
    return {"token_gap": float(flat.max()),
            "token_gap_mean": float(flat.mean()),
            "first_token_gap": max(float(j["gaps"][-1]) for j in judged),
            "first_token_rank": float(max(j["rank"] for j in judged)),
            "token_mismatch": float((flat > 0).float().mean())}


def token_gaps(ref_logits, tokens):
    """For each position, how far the reference's logit of ``tokens``
    (the program's choice) lies below the reference's best, in units of
    the reference logits' standard deviation at that position."""
    ref = ref_logits.float()
    best = ref.max(-1).values
    got = torch.gather(ref, -1, tokens.long()[:, None])[:, 0]
    return (best - got) / ref.std(-1).clamp(min=1e-30)


def leaf_gaps(prog: dict, ref: dict, leaves=None) -> dict:
    """For each leaf, the gap |prog - ref| between the two sides' norms
    of it, measured against the reference's norm of that leaf or of the
    median leaf, whichever is larger."""
    leaves = list(ref) if leaves is None else list(leaves)
    med = statistics.median(ref[k] for k in leaves)
    return {k: _finite(abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30))
            for k in leaves}


def _per_median(norms: dict) -> dict:
    med = statistics.median(norms.values())
    return {k: v / max(med, 1e-30) for k, v in norms.items()}


def moving_leaves(raw_grad_norms: dict) -> list[str]:
    """The leaves whose change is compared: every leaf whose reference
    gradient is at least a thousandth of the median leaf's (a gradient
    nought to rounding moves its leaf under Adam by round-off alone)."""
    med = statistics.median(raw_grad_norms.values())
    return [k for k, v in raw_grad_norms.items() if v >= 1e-3 * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``loss_gap``: the largest relative gap of a step's loss, and
    ``loss1_gap`` the first step's; ``grad_norm_gap``: the relative gap
    of the first step's global gradient norm before the clip;
    ``grad_gap``: the worst leaf's gap of
    the first step's gradient norm as the optimizer takes it, and
    ``grad_gap_median`` the median leaf's; ``change_gap`` /
    ``change_gap_median``: the same of the norm of the weights' change
    over the steps (leaves the reference does not move left out)."""
    if len(prog["losses"]) != len(ref["losses"]):
        raise ValueError("the two sides ran different numbers of steps")
    norm_gap = _finite(abs(prog["grad_norm"] - ref["grad_norm"])
                       / ref["grad_norm"])
    losses = [_finite(abs(a - b) / abs(b))
              for a, b in zip(prog["losses"], ref["losses"])]
    grads = leaf_gaps(prog["grad_norms"], ref["grad_norms"])
    shape = leaf_gaps(_per_median(prog["grad_norms"]),
                      _per_median(ref["grad_norms"]))
    moving = moving_leaves(ref["raw_grad_norms"])
    changes = leaf_gaps(prog["change_norms"], ref["change_norms"], moving)
    worst = lambda g: max(g, key=g.get)  # noqa: E731
    return {"loss_gap": max(losses), "loss1_gap": losses[0],
            "grad_norm_gap": norm_gap,
            "grad_gap": max(grads.values()),
            "grad_gap_median": statistics.median(grads.values()),
            "grad_shape_gap": statistics.median(shape.values()),
            "change_gap": max(changes.values()),
            "change_gap_median": statistics.median(changes.values()),
            "_grad_leaf": worst(grads), "_change_leaf": worst(changes)}
