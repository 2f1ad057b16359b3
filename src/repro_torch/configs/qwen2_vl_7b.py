"""qwen2-vl-7b [vlm]: 28L d_model=3584 28H (GQA kv=4) d_ff=18944
vocab=152064 — M-RoPE (sections 16/24/24), dynamic-resolution patch
frontend stubbed (input_specs supplies precomputed patch embeddings for
the leading vision positions).  [arXiv:2409.12191]"""
from repro_torch.models.config import AttnConfig, BlockSpec, ModelConfig

VISION_PREFIX = 256            # stubbed patch positions per sequence


def config() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b",
        d_model=3584, vocab_size=152064, d_ff=18944,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=28,
        attn=AttnConfig(n_heads=28, n_kv_heads=4, head_dim=128,
                        rope_theta=1_000_000.0,
                        mrope_sections=(16, 24, 24)),
        mlp_act="silu", tie_embeddings=False,
        vision_prefix=VISION_PREFIX,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="qwen2-vl-7b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=3,
        attn=AttnConfig(n_heads=4, n_kv_heads=2, head_dim=16,
                        rope_theta=1_000_000.0,
                        mrope_sections=(2, 3, 3)),
        mlp_act="silu", tie_embeddings=False,
        vision_prefix=8,
    )
