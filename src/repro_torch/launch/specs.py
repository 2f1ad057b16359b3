"""Stand-ins for every model input on the ``meta`` device: the
dry-run's zero-allocation inputs, with the reference's shapes and
dtypes."""
from __future__ import annotations

import torch

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.models import model as M

META = torch.device("meta")


def _t(shape, dtype) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device=META)


def input_specs(arch: str, shape_name: str, cfg=None):
    """Returns (kind, dict of meta tensors) for the (arch x shape) cell
    (``cfg``: a cut of the arch's config to size them for).

    train:   {"tokens", "labels"[, "encoder_frames"][, "vision_embeds"]}
    prefill: the same without labels
    decode:  {"cache": the cache tree (``models.model.init_cache``),
              "tokens": [B, 1][, "cross_src": the encoder output]}
    """
    cfg = cfg or get_config(arch)
    sp = SHAPES[shape_name]
    B, S = sp.global_batch, sp.seq_len

    def extras():
        kw = {}
        if cfg.encoder is not None:
            kw["encoder_frames"] = _t(
                (B, cfg.encoder.n_frames, cfg.encoder.d_model),
                torch.bfloat16)
        if cfg.vision_prefix:
            kw["vision_embeds"] = _t((B, cfg.vision_prefix, cfg.d_model),
                                     torch.bfloat16)
        return kw

    if sp.kind == "train":
        return "train", dict(tokens=_t((B, S), torch.int32),
                             labels=_t((B, S), torch.int32), **extras())
    if sp.kind == "prefill":
        return "prefill", dict(tokens=_t((B, S), torch.int32), **extras())
    assert sp.kind == "decode"
    out = {"cache": M.init_cache(cfg, B, S, device=META),
           "tokens": _t((B, 1), torch.int32)}
    if cfg.encoder is not None:
        out["cross_src"] = _t((B, cfg.encoder.n_frames,
                               cfg.encoder.d_model), torch.bfloat16)
    return "decode", out


def state_shapes(cfg, opts):
    """The train state (``train.step.init_train_state``) on the ``meta``
    device: nothing is allocated and nothing is drawn."""
    from repro_torch.train.step import init_train_state
    g = torch.Generator()
    g.manual_seed(0)
    return init_train_state(g, cfg, opts, device=META)
