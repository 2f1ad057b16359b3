"""The configuration files against their sources: jamba2-mini against
its catalog row, key for key (the row as copied beside the configuration
in ``configs/sources/``, and the catalog itself where
``MODEL_CONFIGS_CATALOG`` names its ``architectures.jsonl``),
smollm-360m against the port's own preset of the published model."""
import json
import os
from pathlib import Path

import pytest

from perfbench import harness, layout

SOURCES = harness.BENCH / "configs" / "sources"
WIDTH_ENDS = ("_size", "_dim", "_rank", "expand", "_state", "_per_tok",
              "_width")


def _rows():
    """The copied row, and the catalog's own where it is given."""
    rows = [json.loads((SOURCES / "jamba2-mini.json").read_text())]
    catalog = os.environ.get("MODEL_CONFIGS_CATALOG")
    if catalog and Path(catalog).is_file():
        for line in Path(catalog).read_text().splitlines():
            if json.loads(line)["name"] == "AI21-Jamba2-Mini":
                rows.append(json.loads(line))
        assert len(rows) == 2 and rows[0] == rows[1]
    return rows


@pytest.mark.parametrize("row", _rows(), ids=("copy", "catalog")[:len(_rows())])
def test_jamba2_mini_holds_the_catalog_row(row):
    cfg = harness.config("jamba2-mini")
    entry = next(c for c in harness.manifest()["configs"]
                 if c["name"] == "jamba2-mini")
    assert entry["source"] == row["source_url"]
    reduced = set(cfg["reduced"])
    assert reduced == {"num_hidden_layers", "layers"}
    source = {k: v for k, v in row.items() if k != "config"}
    source.update(row["config"])
    for k, v in source.items():
        assert k in cfg, k
        if k in reduced:
            assert cfg[k] != v
        else:
            assert cfg[k] == v, k
    assert cfg["config"] == row["config"]          # the group, whole
    for k in reduced:
        assert not k.endswith(WIDTH_ENDS)


def test_jamba2_mini_cut_is_whole_periods():
    cfg = harness.config("jamba2-mini")
    kinds = layout.layer_kinds(cfg)
    assert len(kinds) == 16
    assert sum(m == "attn" for m, _ in kinds) == 2
    assert sum(f == "moe" for _, f in kinds) == 8
    assert layout.param_count(cfg) == 26_053_599_168


def test_smollm_matches_the_ports_preset_of_the_published_model():
    from repro_torch import configs
    from perfbench import program
    mine = program.port_config(harness.config("smollm-360m"))
    preset = configs.get_config("smollm-360m")
    assert mine.norm_eps == 1e-5 and preset.norm_eps == 1e-6
    import dataclasses
    assert dataclasses.replace(mine, norm_eps=preset.norm_eps) == preset
    assert layout.param_count(harness.config("smollm-360m")) \
        == preset.param_count() == 361_821_120


def test_jamba2_mini_builds_the_ports_model():
    from repro_torch.models.model import count_params
    from perfbench import program
    cfg = harness.config("jamba2-mini")
    mcfg = program.port_config(cfg)
    assert mcfg.n_layers == 16 and mcfg.moe.n_experts == 16
    assert mcfg.moe.held is None and not mcfg.moe.norm_topk
    assert mcfg.mamba.dt_rank == 256 and mcfg.attn.head_dim == 128
    assert count_params(mcfg) == layout.param_count(cfg)
