"""gemma2-2b [dense]: 26L d_model=2304 8H (GQA kv=4) d_ff=9216
vocab=256000 — local+global alternating (window 4096), logit softcaps,
sandwich norms, GeGLU, head_dim 256.  [arXiv:2408.00118]"""
from repro_torch.models.config import AttnConfig, BlockSpec, ModelConfig

WINDOW = 4096


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b",
        d_model=2304, vocab_size=256000, d_ff=9216,
        prefix=(),
        period=(BlockSpec("attn", "mlp", window=WINDOW),   # local
                BlockSpec("attn", "mlp", window=None)),    # global
        n_periods=13,
        attn=AttnConfig(n_heads=8, n_kv_heads=4, head_dim=256,
                        rope_theta=10000.0, softcap=50.0),
        mlp_act="gelu", gemma_norm=True, post_block_norm=True,
        tie_embeddings=True, final_softcap=30.0,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma2-2b-smoke",
        d_model=64, vocab_size=277, d_ff=128,
        prefix=(),
        period=(BlockSpec("attn", "mlp", window=8),
                BlockSpec("attn", "mlp", window=None)),
        n_periods=2,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                        rope_theta=10000.0, softcap=50.0),
        mlp_act="gelu", gemma_norm=True, post_block_norm=True,
        tie_embeddings=True, final_softcap=30.0,
    )
