"""whisper-small [audio]: enc-dec 12L+12L d_model=768 12H d_ff=3072
vocab=51865 — conv frontend stubbed (input_specs supplies 1500
precomputed frame embeddings); plain (non-gated) GELU MLP.
[arXiv:2212.04356]"""
from repro_torch.models.config import (AttnConfig, BlockSpec, EncoderConfig,
                                       ModelConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="whisper-small",
        d_model=768, vocab_size=51865, d_ff=3072,
        prefix=(),
        period=(BlockSpec("attn", "mlp", cross=True),), n_periods=12,
        attn=AttnConfig(n_heads=12, n_kv_heads=12, head_dim=64,
                        rope_theta=10000.0),
        encoder=EncoderConfig(n_layers=12, d_model=768, n_heads=12,
                              d_ff=3072, n_frames=1500),
        mlp_act="gelu", gated_mlp=False, tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="whisper-small-smoke",
        d_model=64, vocab_size=277, d_ff=128,
        prefix=(),
        period=(BlockSpec("attn", "mlp", cross=True),), n_periods=2,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                        rope_theta=10000.0),
        encoder=EncoderConfig(n_layers=2, d_model=64, n_heads=4,
                              d_ff=128, n_frames=30),
        mlp_act="gelu", gated_mlp=False, tie_embeddings=True,
    )
