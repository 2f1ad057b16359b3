"""gemma-2b [dense]: 18L d_model=2048 8H (MQA kv=1) d_ff=16384
vocab=256000 — GeGLU, head_dim=256.  [arXiv:2403.08295]"""
from repro_torch.models.config import AttnConfig, BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b",
        d_model=2048, vocab_size=256000, d_ff=16384,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=18,
        attn=AttnConfig(n_heads=8, n_kv_heads=1, head_dim=256,
                        rope_theta=10000.0),
        mlp_act="gelu", gemma_norm=True, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="gemma-2b-smoke",
        d_model=64, vocab_size=277, d_ff=192,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=3,
        attn=AttnConfig(n_heads=4, n_kv_heads=1, head_dim=16,
                        rope_theta=10000.0),
        mlp_act="gelu", gemma_norm=True, tie_embeddings=True,
    )
