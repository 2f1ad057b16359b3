"""jamba-1.5-large-398b [hybrid]: 72L d_model=8192 64H (GQA kv=8)
d_ff=24576, MoE 16e top-2 — mamba+attn 1:7 interleave (attn at offset 4
of every 8), MoE every other layer; attention carries no positional
embedding (mamba supplies order).  [arXiv:2403.19887]"""
import dataclasses

from repro_torch.models.config import (AttnConfig, BlockSpec, MambaConfig,
                                       ModelConfig, MoEConfig)


def _period(window=None):
    # layers 0..7: attn at 4, MoE on odd layers (offsets from the paper)
    return tuple(
        BlockSpec(mixer=("attn" if i == 4 else "mamba"),
                  ff=("moe" if i % 2 == 1 else "mlp"))
        for i in range(8))


def config() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b",
        d_model=8192, vocab_size=65536, d_ff=24576,
        prefix=(), period=_period(), n_periods=9,
        attn=AttnConfig(n_heads=64, n_kv_heads=8, head_dim=128,
                        use_rope=False),
        mamba=MambaConfig(d_state=16, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=16, top_k=2, d_expert=24576,
                      router="softmax", norm_topk=True),
        mlp_act="silu", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="jamba-1.5-large-398b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(), period=_period(), n_periods=1,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                        use_rope=False),
        mamba=MambaConfig(d_state=8, d_conv=4, expand=2),
        moe=MoEConfig(n_experts=4, top_k=2, d_expert=48,
                      router="softmax", norm_topk=True),
        mlp_act="silu", tie_embeddings=False,
    )


def one_card() -> ModelConfig:
    """The cut that one 80 GB card holds: 25,910,996,704 parameters,
    51.8 GB in bf16 (the whole model has 398,555,145,696).

    source: ``config()`` above, arXiv:2403.19887 (Jamba-1.5-Large).
    reduced: ``n_periods`` 9 -> 1 (layers 0-7, one whole period: every
    kind of layer in its published ratio); experts held 16 -> 8
    (``moe.held = (0, 8)``).  Every width is the published one, and the
    router routes over all 16 experts, top-2.
    deployment: each MoE layer divided over 2 ranks of an expert-parallel
    group, 8 experts each (expert e on rank e // 8, the reference's
    layout in ``repro/train/moe_dispatch.py``); this card is rank 0 and
    runs without the alltoall, adding only its experts' part.  The other
    8 periods would lie on further pipeline stages."""
    cfg = config()
    return dataclasses.replace(
        cfg, name="jamba-1.5-large-398b-one-card", n_periods=1,
        moe=dataclasses.replace(cfg.moe, held=(0, 8)))
