"""The benchmark's own reading of a configuration file: which kind of
layer sits where, and the weights a model of that configuration holds
(names, shapes, dtypes and how the benchmark draws them).

The weight names are those of the port's ``Model.state_dict()``, the
interface through which the benchmark hands the same weights to the
program and to the plain reference.  Nothing here imports torch or the
program: the harness checks the names and shapes against the program's
model at set-up.
"""
from __future__ import annotations

import dataclasses
import math


@dataclasses.dataclass(frozen=True)
class Leaf:
    name: str
    shape: tuple
    dtype: str            # "bfloat16" | "float32"
    init: str             # "normal" | "norm" | "dt_bias" | "a_log" | "ones"
    std: float = 1.0


def dims(cfg: dict) -> dict:
    """The sizes every reader needs, from the source's own keys."""
    d = cfg["hidden_size"]
    H = cfg["num_attention_heads"]
    out = {"d": d, "V": cfg["vocab_size"], "L": cfg["num_hidden_layers"],
           "H": H, "K": cfg["num_key_value_heads"], "D": d // H,
           "f": cfg["intermediate_size"], "eps": cfg["rms_norm_eps"],
           "tied": bool(cfg["tie_word_embeddings"])}
    if cfg["model_type"] == "jamba":
        out.update(E=cfg["num_experts"], top_k=cfg["num_experts_per_tok"],
                   Di=cfg["mamba_expand"] * d, S=cfg["mamba_d_state"],
                   conv=cfg["mamba_d_conv"], R=cfg["mamba_dt_rank"])
    else:
        out["rope_theta"] = cfg["rope_theta"]
    return out


def layer_kinds(cfg: dict) -> list[tuple[str, str]]:
    """(mixer, feed-forward) of each layer: ("attn", "mlp") for a llama
    model; for jamba, attention where ``i % attn_layer_period ==
    attn_layer_offset`` (else mamba) and MoE where ``i %
    expert_layer_period == expert_layer_offset`` (else a dense MLP)."""
    L = cfg["num_hidden_layers"]
    if cfg["model_type"] == "llama":
        return [("attn", "mlp")] * L
    if cfg["model_type"] != "jamba":
        raise ValueError(f"model_type {cfg['model_type']!r} not known")
    return [("attn" if i % cfg["attn_layer_period"]
             == cfg["attn_layer_offset"] else "mamba",
             "moe" if i % cfg["expert_layer_period"]
             == cfg["expert_layer_offset"] else "mlp") for i in range(L)]


def _dense(name, n_in, n_out):
    return Leaf(name, (n_in, n_out), "bfloat16", "normal", n_in ** -0.5)


def _norm(name, n):
    return Leaf(name, (n,), "bfloat16", "norm")


def groups(cfg: dict) -> list[tuple[str, list[Leaf]]]:
    """The weights in groups that are drawn together: ``top`` (embedding,
    final norm, untied head) and one per layer.  Every projection is
    normal with std fan_in^-1/2 (expert stacks by their own fan-in), the
    embedding normal with std 0.02 (the published initializer_range),
    norms 1 + 0.05 normal, so activations stay near unit scale through
    the depth; mamba's ``A_log`` is log(1..S)
    and ``D`` ones, as the published init has them, and ``dt_bias`` the
    inverse softplus of a step in [1e-3, 1e-1]."""
    z = dims(cfg)
    d, V = z["d"], z["V"]
    top = [Leaf("embed", (V, d), "bfloat16", "normal", 0.02),
           _norm("final_norm", d)]
    if not z["tied"]:
        top.append(_dense("lm_head", d, V))
    out = [("top", top)]
    H, K, D, f = z["H"], z["K"], z["D"], z["f"]
    for i, (mixer, ff) in enumerate(layer_kinds(cfg)):
        p = f"layers.{i}."
        leaves = [_norm(p + "norm_mixer", d)]
        if mixer == "attn":
            leaves += [_dense(p + "attn.wq", d, H * D),
                       _dense(p + "attn.wk", d, K * D),
                       _dense(p + "attn.wv", d, K * D),
                       _dense(p + "attn.wo", H * D, d)]
        else:
            Di, S, R, C = z["Di"], z["S"], z["R"], z["conv"]
            m = p + "mamba."
            leaves += [_dense(m + "w_in", d, 2 * Di),
                       Leaf(m + "conv_w", (C, Di), "bfloat16", "normal",
                            C ** -0.5),
                       Leaf(m + "conv_b", (Di,), "bfloat16", "normal", 0.1),
                       _dense(m + "w_x", Di, R + 2 * S),
                       _dense(m + "w_dt", R, Di),
                       Leaf(m + "dt_bias", (Di,), "float32", "dt_bias"),
                       Leaf(m + "A_log", (Di, S), "float32", "a_log"),
                       Leaf(m + "D", (Di,), "float32", "ones"),
                       _norm(m + "dt_norm", R), _norm(m + "b_norm", S),
                       _norm(m + "c_norm", S),
                       _dense(m + "w_out", Di, d)]
        leaves.append(_norm(p + "norm_ff", d))
        if ff == "mlp":
            leaves += [_dense(p + "mlp.w_gate", d, f),
                       _dense(p + "mlp.w_up", d, f),
                       _dense(p + "mlp.w_down", f, d)]
        else:
            E = z["E"]
            leaves += [Leaf(p + "moe.router", (d, E), "float32", "normal",
                            d ** -0.5),
                       Leaf(p + "moe.w_gate", (E, d, f), "bfloat16",
                            "normal", d ** -0.5),
                       Leaf(p + "moe.w_up", (E, d, f), "bfloat16", "normal",
                            d ** -0.5),
                       Leaf(p + "moe.w_down", (E, f, d), "bfloat16",
                            "normal", f ** -0.5)]
        out.append((f"layers.{i}", leaves))
    return out


def param_count(cfg: dict) -> int:
    return sum(math.prod(leaf.shape) for _, g in groups(cfg) for leaf in g)
