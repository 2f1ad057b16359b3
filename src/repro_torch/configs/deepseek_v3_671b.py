"""deepseek-v3-671b [moe]: 61L d_model=7168 128H d_ff(dense)=18432,
MoE 256e top-8 + 1 shared (d_expert=2048), MLA (q_lora 1536, kv_lora 512,
nope 128 + rope 64, v 128), sigmoid router scale 2.5, vocab=129280,
first 3 layers dense.  MTP head omitted, as in the reference package.
[arXiv:2412.19437]"""
import dataclasses

from repro_torch.models.config import (BlockSpec, MLAConfig, ModelConfig,
                                       MoEConfig)


def config() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b",
        d_model=7168, vocab_size=129280, d_ff=18432,
        prefix=(BlockSpec("mla", "mlp"),) * 3,
        period=(BlockSpec("mla", "moe"),), n_periods=58,
        mla=MLAConfig(q_lora_rank=1536, kv_lora_rank=512,
                      qk_nope_head_dim=128, qk_rope_head_dim=64,
                      v_head_dim=128, n_heads=128, rope_theta=10000.0),
        moe=MoEConfig(n_experts=256, top_k=8, d_expert=2048, n_shared=1,
                      router="sigmoid", route_scale=2.5, norm_topk=True),
        mlp_act="silu", tie_embeddings=False,
    )


def smoke() -> ModelConfig:
    return ModelConfig(
        name="deepseek-v3-671b-smoke",
        d_model=64, vocab_size=277, d_ff=160,
        prefix=(BlockSpec("mla", "mlp"),),
        period=(BlockSpec("mla", "moe"),), n_periods=2,
        mla=MLAConfig(q_lora_rank=24, kv_lora_rank=16,
                      qk_nope_head_dim=16, qk_rope_head_dim=8,
                      v_head_dim=16, n_heads=4, rope_theta=10000.0),
        moe=MoEConfig(n_experts=8, top_k=2, d_expert=48, n_shared=1,
                      router="sigmoid", route_scale=2.5, norm_topk=True),
        mlp_act="silu", tie_embeddings=False,
    )


def one_card() -> ModelConfig:
    """The cut that one 80 GB card holds: 4,189,134,080 parameters,
    8.38 GB in bf16 (the whole model has 671,026,419,200).

    source: ``config()`` above, arXiv:2412.19437 (DeepSeek-V3).
    reduced: ``n_periods`` 58 -> 1 (layers 0-3: the three dense MLA+MLP
    layers and one MLA+MoE layer, every kind of layer in the model);
    experts held 256 -> 8 (``moe.held = (0, 8)``).  Every width is the
    published one, and the router routes over all 256 experts, top-8;
    the shared expert and the router stay whole.
    deployment: rank 0 of the paper's EP32 prefill unit (arXiv:2412.19437
    section 3.4.1: 256 / 32 = 8 routed experts a GPU), expert e on rank
    e // 8 (the reference's layout in ``repro/train/moe_dispatch.py``);
    this card runs without the alltoall, adding only its experts' part.
    The other 57 periods would lie on further pipeline stages."""
    cfg = config()
    return dataclasses.replace(
        cfg, name="deepseek-v3-671b-one-card", n_periods=1,
        moe=dataclasses.replace(cfg.moe, held=(0, 8)))
