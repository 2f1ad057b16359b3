"""The system under test as the benchmark builds it: the port's own
configuration dataclasses filled from a configuration file, and the
check that the weights the benchmark drew fit the port's model."""
from __future__ import annotations

from perfbench import layout


def port_config(cfg: dict):
    """The port's ``ModelConfig`` of a configuration file (llama or
    jamba), every width as the file gives it."""
    from repro_torch.models.config import (AttnConfig, BlockSpec,
                                           MambaConfig, ModelConfig,
                                           MoEConfig)
    z = layout.dims(cfg)
    kinds = layout.layer_kinds(cfg)
    if cfg["model_type"] == "llama":
        attn = AttnConfig(n_heads=z["H"], n_kv_heads=z["K"], head_dim=z["D"],
                          rope_theta=z["rope_theta"])
        return ModelConfig(
            name=cfg["name"], d_model=z["d"], vocab_size=z["V"], d_ff=z["f"],
            prefix=(), period=(BlockSpec("attn", "mlp"),), n_periods=z["L"],
            attn=attn, mlp_act="silu", tie_embeddings=z["tied"],
            norm_eps=z["eps"])
    period = cfg["attn_layer_period"]
    while period % cfg["expert_layer_period"]:
        period += cfg["attn_layer_period"]
    if z["L"] % period:
        raise ValueError(f"{z['L']} layers are not whole periods of {period}")
    blocks = tuple(BlockSpec(m, f) for m, f in kinds[:period])
    return ModelConfig(
        name=cfg["name"], d_model=z["d"], vocab_size=z["V"], d_ff=z["f"],
        prefix=(), period=blocks, n_periods=z["L"] // period,
        attn=AttnConfig(n_heads=z["H"], n_kv_heads=z["K"], head_dim=z["D"],
                        use_rope=False),
        mamba=MambaConfig(d_state=z["S"], d_conv=z["conv"],
                          expand=cfg["mamba_expand"], dt_rank=z["R"]),
        moe=MoEConfig(n_experts=z["E"], top_k=z["top_k"], d_expert=z["f"],
                      router="softmax", norm_topk=False),
        mlp_act="silu", tie_embeddings=z["tied"], norm_eps=z["eps"])


def check_layout(mcfg, params: dict) -> None:
    """Raise unless ``params`` holds exactly the port model's weights,
    each in its shape and dtype."""
    from repro_torch.models.model import Model
    want = Model(mcfg, device="meta").state_dict()
    if set(want) != set(params):
        raise ValueError(
            f"weights do not fit {mcfg.name}: missing "
            f"{sorted(set(want) - set(params))[:5]}, unexpected "
            f"{sorted(set(params) - set(want))[:5]}")
    for k, t in want.items():
        if tuple(t.shape) != tuple(params[k].shape) or \
                t.dtype != params[k].dtype:
            raise ValueError(f"{k}: the port holds {tuple(t.shape)} "
                             f"{t.dtype}, drawn {tuple(params[k].shape)} "
                             f"{params[k].dtype}")
