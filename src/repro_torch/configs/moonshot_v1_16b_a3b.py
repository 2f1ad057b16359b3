"""moonshot-v1-16b-a3b [moe]: 48L d_model=2048 16H (kv=16) d_ff=1408
(expert dim), MoE 64e top-6 + 2 shared, sigmoid router, first layer
dense (d_ff 11264), vocab=163840 — kimi/moonlight family.
[hf:moonshotai/Moonlight-16B-A3B]"""
from repro_torch.models.config import (AttnConfig, BlockSpec, ModelConfig,
                                       MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b",
        d_model=2048, vocab_size=163840, d_ff=11264,
        prefix=(BlockSpec("attn", "mlp"),),
        period=(BlockSpec("attn", "moe"),), n_periods=47,
        attn=AttnConfig(n_heads=16, n_kv_heads=16, head_dim=128,
                        rope_theta=50000.0),
        moe=MoEConfig(n_experts=64, top_k=6, d_expert=1408, n_shared=2,
                      router="sigmoid", route_scale=2.446, norm_topk=True),
        mlp_act="silu", tie_embeddings=True,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="moonshot-v1-16b-a3b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(BlockSpec("attn", "mlp"),),
        period=(BlockSpec("attn", "moe"),), n_periods=2,
        attn=AttnConfig(n_heads=4, n_kv_heads=4, head_dim=16,
                        rope_theta=50000.0),
        moe=MoEConfig(n_experts=8, top_k=3, d_expert=48, n_shared=2,
                      router="sigmoid", route_scale=2.446, norm_topk=True),
        mlp_act="silu", tie_embeddings=True,
    )
