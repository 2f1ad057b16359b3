"""LM assembly: embed -> blocks -> final norm -> logits.

The reference scans the homogeneous middle of the stack over parameters
stacked on an ``n_periods`` axis; the port keeps one module per layer
(``layers.{i}``, in ``cfg.blocks()`` order) and loops over them.  The
roundings follow the reference: the gemma embed scale ``sqrt(d_model)``
is rounded to the activation dtype before the multiply, every norm casts
back to its input dtype, and the final softcap runs on the logits in
their own dtype (bf16 with bf16 weights).
"""
from __future__ import annotations

import torch
from torch import nn

from repro_torch.models import blocks
from repro_torch.models.common import dense_init_, rmsnorm, softcap
from repro_torch.models.config import ModelConfig


def _check_supported(cfg: ModelConfig) -> None:
    if cfg.encoder is not None:
        raise NotImplementedError(
            "the encoder stack is not yet ported (whisper; ROADMAP.md "
            "Queue 1 item 10)")
    if cfg.vision_prefix:
        raise NotImplementedError(
            "the vision prefix is not yet ported (qwen2-vl; ROADMAP.md "
            "Queue 1 item 10)")


class Model(nn.Module):
    """Parameters ``embed`` [V, d], ``final_norm`` [d], ``lm_head`` [d, V]
    (untied heads only) and ``layers.{i}.*`` (see ``blocks.Block``); the
    module functions below run it.  Without a ``generator`` the weights
    are left uninitialised (use the ``meta`` device to build a
    skeleton)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        _check_supported(cfg)
        kw = dict(device=device, dtype=torch.bfloat16)
        self.embed = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model,
                                              **kw))
        fill = torch.zeros if cfg.gemma_norm else torch.ones
        self.final_norm = nn.Parameter(fill(cfg.d_model, **kw))
        if not cfg.tie_embeddings:
            self.lm_head = nn.Parameter(torch.empty(cfg.d_model,
                                                    cfg.vocab_size, **kw))
        self.layers = nn.ModuleList(
            blocks.Block(spec, cfg, device=device, generator=generator)
            for spec in cfg.blocks())
        if generator is not None:
            dense_init_(self.embed, generator, scale=1.0)
            if not cfg.tie_embeddings:
                dense_init_(self.lm_head, generator)


def init_params(cfg: ModelConfig, *, generator: torch.Generator,
                device=None) -> Model:
    """The port's own init with the reference's distributions: weights
    normal * fan_in^-1/2 in bf16, the embedding normal * 1, norms at
    their neutral value (0 for gemma's (1 + w), else 1).  Draws come
    from ``generator``, on ``device``."""
    return Model(cfg, device=device, generator=generator)


def from_state(cfg: ModelConfig, state: dict, *, device=None) -> Model:
    """A model holding the tensors of ``state`` (names as in
    ``Model.state_dict()``, dtypes kept), e.g. from
    ``repro_torch.convert.params_from_jax``."""
    m = Model(cfg, device="meta")
    want = set(m.state_dict())
    if set(state) != want:
        raise ValueError(f"state does not fit {cfg.name}: missing "
                         f"{sorted(want - set(state))[:5]}, unexpected "
                         f"{sorted(set(state) - want)[:5]}")
    m.load_state_dict({k: t.to(device) if device is not None else t
                       for k, t in state.items()}, assign=True)
    return m


def embed_tokens(p: Model, cfg: ModelConfig, tokens):
    x = p.embed[tokens]
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    return x


def _logits(p: Model, cfg: ModelConfig, x):
    x = rmsnorm(x, p.final_norm, cfg.norm_eps, gemma_style=cfg.gemma_norm)
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    logits = x @ head
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def forward(p: Model, cfg: ModelConfig, tokens, *, positions=None,
            use_kernel=False):
    """tokens [B, S] -> logits [B, S, V]."""
    B, S = tokens.shape
    x = embed_tokens(p, cfg, tokens)
    if positions is None:
        positions = torch.arange(S, dtype=torch.int32,
                                 device=tokens.device)[None, :]
    for layer, spec in zip(p.layers, cfg.blocks()):
        x = blocks.forward(layer, spec, cfg, x, positions=positions,
                           use_kernel=use_kernel)
    return _logits(p, cfg, x)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None, dtype=torch.bfloat16) -> dict:
    """One cache per layer: k/v [batch, max_len, K, D] in ``dtype`` (bf16
    as in the reference) for attention layers; for rwkv layers the
    recurrent state (``s`` f32, the token-shift carries in ``dtype``;
    see ``rwkv.init_state``)."""
    _check_supported(cfg)
    return {"layers": [blocks.init_cache(spec, cfg, batch, max_len,
                                         device=device, dtype=dtype)
                       for spec in cfg.blocks()]}


def decode_step(p: Model, cfg: ModelConfig, cache: dict, tokens):
    """tokens [B, 1] -> (logits [B, 1, V], cache'); the caches are
    updated in place."""
    x = embed_tokens(p, cfg, tokens)
    layers = []
    for layer, spec, lc in zip(p.layers, cfg.blocks(), cache["layers"]):
        x, lc = blocks.decode(layer, spec, cfg, x, lc)
        layers.append(lc)
    return _logits(p, cfg, x), {"layers": layers}


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig) -> int:
    """Parameters of the port's model (embedding once if tied), counted
    on the ``meta`` device: nothing is allocated."""
    return sum(t.numel() for t in Model(cfg, device="meta").parameters())
