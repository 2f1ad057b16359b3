"""smollm-360m [dense]: 32L d_model=960 15H (GQA kv=5) d_ff=2560
vocab=49152 — llama-arch small.  [hf:HuggingFaceTB/SmolLM-360M]"""
from repro_torch.models.config import AttnConfig, BlockSpec, ModelConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m",
        d_model=960, vocab_size=49152, d_ff=2560,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=32,
        attn=AttnConfig(n_heads=15, n_kv_heads=5, head_dim=64,
                        rope_theta=10000.0),
        mlp_act="silu", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="smollm-360m-smoke",
        d_model=60, vocab_size=277, d_ff=160,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=3,
        attn=AttnConfig(n_heads=3, n_kv_heads=1, head_dim=20,
                        rope_theta=10000.0),
        mlp_act="silu", tie_embeddings=True,
    )
