"""rwkv6-3b [ssm]: 32L d_model=2560 (attn-free) d_ff=8960 vocab=65536 —
Finch, data-dependent decay, head_dim 64.  [arXiv:2404.05892]"""
from repro_torch.models.config import BlockSpec, ModelConfig, RWKVConfig


def config() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b",
        d_model=2560, vocab_size=65536, d_ff=8960,
        prefix=(), period=(BlockSpec("rwkv", "cmix"),), n_periods=32,
        rwkv=RWKVConfig(head_dim=64, decay_lora=64, mix_lora=32),
        tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="rwkv6-3b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(), period=(BlockSpec("rwkv", "cmix"),), n_periods=3,
        rwkv=RWKVConfig(head_dim=16, decay_lora=8, mix_lora=8),
        tie_embeddings=False,
    )
