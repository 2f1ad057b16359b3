"""LM assembly: embed -> blocks -> final norm -> logits; for an
encoder-decoder (whisper) an encoder stack over precomputed frames whose
output every cross-attention block reads; for a VLM backbone (qwen2-vl)
precomputed patch embeddings in the leading rows and M-RoPE positions.

The reference scans the homogeneous middle of the stack over parameters
stacked on an ``n_periods`` axis; the port keeps one module per layer
(``layers.{i}``, in ``cfg.blocks()`` order) and loops over them.  The
roundings follow the reference: the gemma embed scale ``sqrt(d_model)``
is rounded to the activation dtype before the multiply, every norm casts
back to its input dtype, and the final softcap runs on the logits in
their own dtype (bf16 with bf16 weights).

``split`` (``train.shard.SeqSplit``, passed down by the caller, never
read from a global) runs the sequence split over the model axis: each
model rank embeds and runs its contiguous S/n rows (a VLM's vision
prefix is placed first, then cut; M-RoPE positions are computed for the
whole sequence, then cut) and returns their logits.  A stack whose
length does not divide the model axis (whisper's 1500-frame encoder)
runs whole on every model rank.
"""
from __future__ import annotations

import dataclasses

import torch
from torch import nn
from torch.utils.checkpoint import checkpoint

from repro_torch.models import blocks
from repro_torch.models.common import (dense_init_, linear, lookup, rmsnorm,
                                       softcap)
from repro_torch.models.config import BlockSpec, ModelConfig

_ENCODER_SPEC = BlockSpec(mixer="attn", ff="mlp")


def encoder_config(cfg: ModelConfig) -> ModelConfig:
    """The encoder stack's own config (the reference's ``enc_cfg``): the
    encoder's widths and heads, non-causal attention with rope."""
    enc = cfg.encoder
    enc_attn = dataclasses.replace(
        cfg.attn, causal=False, n_heads=enc.n_heads, n_kv_heads=enc.n_heads,
        head_dim=enc.d_model // enc.n_heads)
    return dataclasses.replace(cfg, d_model=enc.d_model, d_ff=enc.d_ff,
                               attn=enc_attn)


class Encoder(nn.Module):
    """``layers.{i}`` (attention + MLP blocks) and ``final_norm``."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
        ecfg = encoder_config(cfg)
        self.layers = nn.ModuleList(
            blocks.Block(_ENCODER_SPEC, ecfg, device=device,
                         generator=generator)
            for _ in range(cfg.encoder.n_layers))
        self.final_norm = nn.Parameter(torch.ones(
            cfg.encoder.d_model, dtype=torch.bfloat16, device=device))


class Model(nn.Module):
    """Parameters ``embed`` [V, d], ``final_norm`` [d], ``lm_head`` [d, V]
    (untied heads only), ``layers.{i}.*`` (see ``blocks.Block``) and, for
    an encoder-decoder, ``encoder.*``; the module functions below run it.
    Without a ``generator`` the weights are left uninitialised (use the
    ``meta`` device to build a skeleton)."""

    def __init__(self, cfg: ModelConfig, *, device=None,
                 generator: torch.Generator | None = None):
        super().__init__()
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
        if cfg.encoder is not None:
            self.encoder = Encoder(cfg, device=device, generator=generator)
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


def held(layer):
    """A layer as the block functions read it: a sharded layer
    (``train.shard.ShardedLayer``) is gathered here, where the layer
    runs (inside its period's remat region); a ``Block`` is itself."""
    gather = getattr(layer, "gather", None)
    return layer if gather is None else gather()


def positions_for(cfg: ModelConfig, S: int, device=None):
    """The default prefill positions: [1, S], or [3, 1, S] (the three
    M-RoPE streams alike) for M-RoPE."""
    pos = torch.arange(S, dtype=torch.int32, device=device)[None, :]
    if cfg.attn is not None and cfg.attn.mrope_sections is not None:
        return pos[None].expand(3, 1, S)
    return pos


def _split_for(split, S: int):
    """``split`` bound to a sequence of S (the mask positions of its
    keys), or None where S does not divide the model axis."""
    if split is None or not split.applies(S):
        return None
    return split


def encode(p: Model, cfg: ModelConfig, frames, split=None):
    """Whisper's encoder on precomputed frames [B, n_frames, d_enc]
    (the conv front end is stubbed, as in the reference): non-causal
    attention + MLP blocks, then ``encoder.final_norm``.  Under a
    ``split`` that the frames divide each model rank runs its frames and
    the output is gathered; else the stack runs whole."""
    ecfg = encoder_config(cfg)
    S = frames.shape[1]
    pos = torch.arange(S, dtype=torch.int32, device=frames.device)[None, :]
    split = _split_for(split, S)
    x = frames
    if split is not None:
        split = dataclasses.replace(split, key_pos=pos)
        x, pos = split.cut(frames), split.cut(pos, -1)
    for layer in p.encoder.layers:
        x = blocks.forward(held(layer), _ENCODER_SPEC, ecfg, x,
                           positions=pos, split=split)
    x = rmsnorm(x, p.encoder.final_norm, cfg.norm_eps)
    return x if split is None else split.gather(x)


def embed_tokens(p: Model, cfg: ModelConfig, tokens, vision_embeds=None):
    """Token embeddings; for a VLM the leading ``vision_embeds.shape[1]``
    rows are replaced by the precomputed patch embeddings."""
    x = lookup(p.embed, tokens)
    if cfg.gemma_norm:
        x = x * torch.tensor(cfg.d_model ** 0.5, dtype=x.dtype)
    if cfg.vision_prefix and vision_embeds is not None:
        n_vis = vision_embeds.shape[1]
        x = torch.cat([vision_embeds.to(x.dtype), x[:, n_vis:]], dim=1)
    return x


def _logits(p: Model, cfg: ModelConfig, x):
    x = rmsnorm(x, p.final_norm, cfg.norm_eps, gemma_style=cfg.gemma_norm)
    head = p.embed.T if cfg.tie_embeddings else p.lm_head
    logits = linear(x, head)
    if cfg.final_softcap:
        logits = softcap(logits, cfg.final_softcap)
    return logits


def forward(p: Model, cfg: ModelConfig, tokens, *, positions=None,
            vision_embeds=None, encoder_frames=None, use_kernel=False,
            moe_dispatch=None, remat=False, split=None):
    """tokens [B, S] -> logits [B, S, V]; ``p`` is a ``Model`` or a view
    over sharded storage (``train.shard.sharded_model``).  An
    encoder-decoder takes
    ``encoder_frames`` [B, n_frames, d_enc]; a VLM may take
    ``vision_embeds`` [B, n_vis, d].  ``moe_dispatch(p_moe, cfg_moe, x)``
    replaces the MoE layers' dense dispatch.  ``remat`` recomputes the
    periodic layers' activations in the backward pass, one period at a
    time, as the reference checkpoints its scan body with nothing
    saveable: each period's forward runs again (kernels included) when
    its gradient is needed; the prefix and suffix layers are not
    checkpointed.  ``split``: the sequence split over the model axis
    (module docstring): the logits are this rank's rows, [B, S/n, V];
    a remat region's recompute reuses its collectives' results over the
    model axis (``split.remat_contexts``)."""
    B, S = tokens.shape
    if positions is None:
        positions = positions_for(cfg, S, tokens.device)
    cross_src = None
    if cfg.encoder is not None:
        if encoder_frames is None:
            raise ValueError(f"{cfg.name} is an encoder-decoder: pass "
                             f"encoder_frames")
        cross_src = encode(p, cfg, encoder_frames, split)
    split = _split_for(split, S)
    if split is None:
        x = embed_tokens(p, cfg, tokens, vision_embeds)
    else:
        mrope = cfg.attn is not None and cfg.attn.mrope_sections is not None
        split = dataclasses.replace(
            split, key_pos=positions[0] if mrope else positions)
        if cfg.vision_prefix and vision_embeds is not None:
            x = split.cut(embed_tokens(p, cfg, tokens, vision_embeds))
        else:
            x = embed_tokens(p, cfg, split.cut(tokens))
        positions = split.cut(positions, -1)
    kw = dict(positions=positions, cross_src=cross_src,
              use_kernel=use_kernel, moe_dispatch=moe_dispatch, split=split)
    layers = list(zip(p.layers, cfg.blocks()))

    def run(x, span):
        for layer, spec in span:
            x = blocks.forward(held(layer), spec, cfg, x, **kw)
        return x

    n_pre, n_per = len(cfg.prefix), len(cfg.period)
    mid = n_pre + n_per * cfg.n_periods
    if remat and torch.is_grad_enabled() and cfg.n_periods:
        keep = {} if split is None else {"context_fn": split.remat_contexts}
        x = run(x, layers[:n_pre])
        for i in range(n_pre, mid, n_per):
            x = checkpoint(run, x, layers[i:i + n_per], use_reentrant=False,
                           **keep)
        x = run(x, layers[mid:])
    else:
        x = run(x, layers)
    return _logits(p, cfg, x)


def lm_loss(p: Model, cfg: ModelConfig, tokens, labels, *,
            reduction="mean", **kw):
    """Next-token cross-entropy; labels < 0 are masked.  The logits go
    to f32 before the log-sum-exp.

    reduction="mean": the scalar mean over live tokens.
    reduction="sum_count": (sum, live count), what data-parallel shards
    exchange so that the global mean is exact under uneven masking.
    ``kw`` goes to ``forward``; under a sequence split (``split``) the
    loss is over this model rank's rows."""
    split = _split_for(kw.get("split"), tokens.shape[1])
    if split is not None:
        labels = split.cut(labels)
    logits = forward(p, cfg, tokens, **kw).float()
    mask = labels >= 0
    lbl = torch.where(mask, labels, 0).long()
    logz = torch.logsumexp(logits, dim=-1)
    gold = torch.gather(logits, -1, lbl[..., None])[..., 0]
    nll = (logz - gold) * mask
    if reduction == "sum_count":
        return nll.sum(), mask.sum()
    return nll.sum() / torch.clamp(mask.sum(), min=1)


# ---------------------------------------------------------------------------
# decode
# ---------------------------------------------------------------------------


def init_cache(cfg: ModelConfig, batch: int, max_len: int, *,
               device=None, dtype=torch.bfloat16) -> dict:
    """One cache per layer: k/v [batch, max_len, K, D] in ``dtype`` (bf16
    as in the reference) for attention layers, the latents for MLA
    layers; for rwkv layers the recurrent state (``s`` f32, the
    token-shift carries in ``dtype``; see ``rwkv.init_state``)."""
    return {"layers": [blocks.init_cache(spec, cfg, batch, max_len,
                                         device=device, dtype=dtype)
                       for spec in cfg.blocks()]}


def decode_step(p: Model, cfg: ModelConfig, cache: dict, tokens, *,
                cross_src=None, seqs=None, moe_dispatch=None):
    """tokens [B, 1] -> (logits [B, 1, V], cache'); the caches are
    updated in place.  ``cross_src`` is the encoder output for an
    encoder-decoder (``encode``).  ``seqs``: per layer, None or the
    ``SeqShard`` of a cache whose sequence is cut over ranks;
    ``moe_dispatch`` replaces the MoE layers' capacity dispatch."""
    x = embed_tokens(p, cfg, tokens)
    layers = []
    seqs = seqs or [None] * cfg.n_layers
    for layer, spec, lc, seq in zip(p.layers, cfg.blocks(), cache["layers"],
                                    seqs):
        x, lc = blocks.decode(held(layer), spec, cfg, x, lc,
                              cross_src=cross_src, seq=seq,
                              moe_dispatch=moe_dispatch)
        layers.append(lc)
    return _logits(p, cfg, x), {"layers": layers}


# ---------------------------------------------------------------------------
# parameter counting
# ---------------------------------------------------------------------------


def count_params(cfg: ModelConfig, active_only: bool = False) -> int:
    """Parameters of the port's model (embedding once if tied), counted
    on the ``meta`` device: nothing is allocated.  ``active_only``
    discounts the routed experts to the activated fraction ``top_k /
    n_experts``, as the reference does: one ``int()`` over the summed
    expert stacks of every MoE layer."""
    m = Model(cfg, device="meta")
    total = sum(t.numel() for t in m.parameters())
    if active_only and cfg.moe is not None:
        moe_total = sum(getattr(layer.moe, k).numel()
                        for layer, spec in zip(m.layers, cfg.blocks())
                        if spec.ff == "moe"
                        for k in ("w_gate", "w_up", "w_down")
                        if hasattr(layer.moe, k))
        frac = 1.0 - cfg.moe.top_k / cfg.moe.n_experts
        total -= int(moe_total * frac)
    return total
