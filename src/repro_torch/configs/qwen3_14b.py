"""qwen3-14b [dense]: 40L d_model=5120 40H (GQA kv=8) d_ff=17408
vocab=151936 — qk_norm, head_dim 128, untied.  [hf:Qwen/Qwen3-14B]"""
from repro_torch.models.config import AttnConfig, BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b",
        d_model=5120, vocab_size=151936, d_ff=17408,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=40,
        attn=AttnConfig(n_heads=40, n_kv_heads=8, head_dim=128,
                        rope_theta=1_000_000.0, qk_norm=True),
        mlp_act="silu", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen3-14b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=3,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                        rope_theta=1_000_000.0, qk_norm=True),
        mlp_act="silu", tie_embeddings=False,
    )
