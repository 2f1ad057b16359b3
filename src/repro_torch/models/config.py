"""Model configuration: one dataclass family covers every assigned arch.

A copy of the reference package's dataclasses, so a configuration reads
the same in both packages.  A model is a stack of *blocks* described by
``BlockSpec``s, written ``prefix + period * n_periods + suffix``; the
port runs it as one module per layer in that order (the reference
scans the stacked periods).
"""
from __future__ import annotations

import dataclasses
from typing import Literal


@dataclasses.dataclass(frozen=True)
class AttnConfig:
    n_heads: int
    n_kv_heads: int
    head_dim: int
    rope_theta: float = 10000.0
    window: int | None = None          # sliding-window size (None = full)
    softcap: float | None = None       # attention logit soft-capping
    qk_norm: bool = False              # rmsnorm on q/k heads (qwen3)
    mrope_sections: tuple[int, ...] | None = None   # qwen2-vl M-RoPE
    causal: bool = True                # False for encoder self-attention
    cross: bool = False                # cross-attention (whisper decoder)
    use_rope: bool = True              # jamba attention is position-free


@dataclasses.dataclass(frozen=True)
class MLAConfig:
    """DeepSeek multi-head latent attention."""
    q_lora_rank: int
    kv_lora_rank: int
    qk_nope_head_dim: int
    qk_rope_head_dim: int
    v_head_dim: int
    n_heads: int
    rope_theta: float = 10000.0

    @property
    def qk_head_dim(self) -> int:
        return self.qk_nope_head_dim + self.qk_rope_head_dim


@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_expert: int                       # per-expert ffn hidden dim
    n_shared: int = 0                   # shared (always-on) experts
    router: Literal["softmax", "sigmoid"] = "softmax"
    route_scale: float = 1.0
    norm_topk: bool = True              # renormalize top-k weights
    # experts [lo, hi) held by this device (expert parallelism: the layer
    # routes over all n_experts and adds only its own experts' part);
    # None holds all of them.  Not a field of the reference, whose
    # single-device layer holds every expert.
    held: tuple[int, int] | None = None

    def held_range(self) -> tuple[int, int]:
        lo, hi = self.held if self.held is not None else (0, self.n_experts)
        if not 0 <= lo < hi <= self.n_experts:
            raise ValueError(f"held experts [{lo}, {hi}) outside "
                             f"[0, {self.n_experts})")
        return lo, hi


@dataclasses.dataclass(frozen=True)
class RWKVConfig:
    head_dim: int = 64                  # wkv head size (finch)
    decay_lora: int = 64
    mix_lora: int = 32


@dataclasses.dataclass(frozen=True)
class MambaConfig:
    d_state: int = 16
    d_conv: int = 4
    expand: int = 2
    dt_rank: int | None = None          # default ceil(d_model / 16)


@dataclasses.dataclass(frozen=True)
class BlockSpec:
    """One residual block: a mixer + a feed-forward."""
    mixer: Literal["attn", "mla", "rwkv", "mamba", "none"]
    ff: Literal["mlp", "moe", "cmix", "none"]
    # gemma2-style per-block attention window override (None = cfg default)
    window: int | None = None
    # whisper decoder: additional cross-attention sublayer after the mixer
    cross: bool = False


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    d_model: int
    vocab_size: int
    d_ff: int
    # stack structure
    prefix: tuple[BlockSpec, ...]
    period: tuple[BlockSpec, ...]
    n_periods: int
    suffix: tuple[BlockSpec, ...] = ()
    # sub-configs (present when the stack uses the mixer/ff)
    attn: AttnConfig | None = None
    mla: MLAConfig | None = None
    moe: MoEConfig | None = None
    rwkv: RWKVConfig | None = None
    mamba: MambaConfig | None = None
    # misc
    mlp_act: Literal["silu", "gelu"] = "silu"
    gated_mlp: bool = True                   # whisper uses plain fc-act-fc
    norm_eps: float = 1e-6
    tie_embeddings: bool = True
    final_softcap: float | None = None       # gemma2 final-logit softcap
    gemma_norm: bool = False                 # (1 + scale) rmsnorm + embed scaling
    post_block_norm: bool = False            # gemma2 post-attn/ffn norms
    # encoder (whisper): an encoder stack consuming precomputed frames
    encoder: "EncoderConfig | None" = None
    # vlm: number of leading positions fed by precomputed patch embeds
    vision_prefix: int = 0

    @property
    def n_layers(self) -> int:
        return (len(self.prefix) + len(self.period) * self.n_periods
                + len(self.suffix))

    def blocks(self) -> list[BlockSpec]:
        return (list(self.prefix) + list(self.period) * self.n_periods
                + list(self.suffix))

    def param_count(self) -> int:
        """Parameter count of the port's own model, built on the ``meta``
        device (embedding counted once if tied)."""
        from repro_torch.models.model import count_params
        return count_params(self)

    def active_param_count(self) -> int:
        """Parameters a token activates: the routed experts discounted
        to ``top_k / n_experts`` (``count_params(active_only=True)``)."""
        from repro_torch.models.model import count_params
        return count_params(self, active_only=True)


@dataclasses.dataclass(frozen=True)
class EncoderConfig:
    n_layers: int
    d_model: int
    n_heads: int
    d_ff: int
    n_frames: int = 1500          # whisper: fixed post-conv frame count
