"""AdamW with f32 moments over bf16 (or f32) parameters, on dicts of
tensors (parameter name -> tensor).

Written as the reference writes it, which ``torch.optim.AdamW`` is not:
the moments stay f32 whatever the parameter's dtype, the bias
corrections divide the moments (``(mu / c1) / (sqrt(nu / c2) + eps)``),
and the weight decay is added to the step before the learning rate
multiplies it.  Every update is out of place: the caller's state is
left as it was.
"""
from __future__ import annotations

import torch


def adamw_init(params: dict) -> dict:
    zeros = {k: torch.zeros(p.shape, dtype=torch.float32, device=p.device)
             for k, p in params.items()}
    dev = next(iter(params.values())).device if params else None
    return {"mu": zeros,
            "nu": {k: torch.zeros_like(z) for k, z in zeros.items()},
            "count": torch.zeros((), dtype=torch.int32, device=dev)}


def clip_by_global_norm(grads: dict, max_norm: float):
    """-> (grads * min(1, max_norm / (gnorm + 1e-9)), gnorm), gnorm the
    sqrt of the leaves' f32 sums of squares; each leaf scaled in f32 and
    rounded back to its dtype once."""
    gnorm = torch.sqrt(sum(torch.sum(torch.square(g.float()))
                           for g in grads.values()))
    scale = torch.clamp(max_norm / (gnorm + 1e-9), max=1.0)
    return ({k: (g.float() * scale).to(g.dtype) for k, g in grads.items()},
            gnorm)


def adamw_update(params: dict, grads: dict, state: dict, *, lr, b1=0.9,
                 b2=0.95, eps=1e-8, weight_decay=0.1):
    """-> (new params, new state).  ``lr`` is a float or an f32 scalar
    tensor."""
    cnt = state["count"] + 1
    c1 = 1.0 - torch.pow(b1, cnt.float())
    c2 = 1.0 - torch.pow(b2, cnt.float())
    new_p, new_mu, new_nu = {}, {}, {}
    for k, p in params.items():
        g32 = grads[k].float()
        mu = b1 * state["mu"][k] + (1 - b1) * g32
        nu = b2 * state["nu"][k] + (1 - b2) * torch.square(g32)
        step = (mu / c1) / (torch.sqrt(nu / c2) + eps)
        step = step + weight_decay * p.float()
        new_p[k] = (p.float() - lr * step).to(p.dtype)
        new_mu[k], new_nu[k] = mu, nu
    return new_p, {"mu": new_mu, "nu": new_nu, "count": cnt}
