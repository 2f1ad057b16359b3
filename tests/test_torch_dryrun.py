"""The port's dry-run (``repro_torch.launch.dryrun``): each cell's
per-device step on ``meta``, with nothing allocated.

- the reference dry-run's own cells (tests/device_scripts/
  check_dryrun_cell.py: smollm-360m train_4k, rwkv6-3b long_500k) and
  moonshot-v1-16b-a3b train_4k under ``mpix_ep``, on the 16x16 and the
  2x16x16 mesh: every key of the reference's result.  smollm and
  moonshot run here cut to 2 layers (whole, they take 28-44 s a mesh on
  this host); ``chip_smoke.py`` phase (S2) runs them whole;
- the parameter bytes a device holds equal ``train.sharding``'s share,
  exactly;
- the FLOPs equal an analytic count of the products the step runs on
  the device's rows: the sequence split over ``model`` gives each
  device T = B S / n_model of its data rank's B S tokens, so 2 x (matrix
  parameters a token goes through) x T a pass, the plain attention's
  score and value products of its S / n_model query rows against all S
  keys (4 B H S_q S_k D, q rows padded to whole chunks where the core
  chunks), the head 2 T d V, and the passes: forward, the remat
  recompute of every periodic layer, backward twice the forward.  The recompute stops once every saved
  tensor is rebuilt (``torch.utils.checkpoint``'s early stop), so a
  periodic layer's last product (the MLP's, or the shared experts',
  ``w_down``) is not re-run.  Dense: within 2%.  MoE under
  ``mpix_ep``: the routed experts counted at their capacity slots, E C
  rows with C = int(T_slice k / E x 1.25) (the capacity excess: about
  1.25x the k T_slice rows a token-exact count gives), the router and
  the shared experts on the device's token slice (its T rows); within
  2%;
- the CLI writes the JSON with those keys and SKIPs the cells
  ``runnable()`` rules out.

The recorder's collective bytes against a live step's on gloo ranks are
held in tests/test_torch_sharded_step.py (it has the ranks).
"""
import dataclasses
import json

import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_config
from repro_torch.configs.shapes import SHAPES
from repro_torch.launch import dryrun
from repro_torch.models import attention
from repro_torch.models import model as M
from repro_torch.train import sharding

KEYS = {"arch", "shape", "mesh", "kind", "compile_s", "flops_per_device",
        "hbm_bytes_per_device", "collectives", "mem", "n_devices"}
MEM_KEYS = {"argument_bytes", "output_bytes", "temp_bytes", "peak_bytes"}
COLL_KEYS = {"all-gather", "all-reduce", "reduce-scatter", "all-to-all",
             "collective-permute", "count", "total"}


def _cut(arch):
    cfg = get_config(arch)
    if arch == "rwkv6-3b":
        return cfg
    n_per = 2 - len(cfg.prefix)
    return dataclasses.replace(cfg, n_periods=n_per)


CELLS = {("smollm-360m", "train_4k"): {"moe_mode": "mpix_ep"},
         ("rwkv6-3b", "long_500k"): {"moe_mode": "mpix_ep"},
         ("moonshot-v1-16b-a3b", "train_4k"): {"moe_mode": "mpix_ep"}}


@pytest.fixture(scope="module")
def results():
    out = {}
    for (arch, shape), ov in CELLS.items():
        for mp in (False, True):
            out[(arch, shape, mp)] = dryrun.analyse(
                arch, shape, multi_pod=mp, train_overrides=ov,
                cfg=_cut(arch), verbose=False)
    return out


CASES = [(a, s, mp) for (a, s) in CELLS for mp in (False, True)]


@pytest.mark.parametrize("arch,shape,mp", CASES)
def test_cell_has_reference_keys(results, arch, shape, mp):
    r = results[(arch, shape, mp)]
    assert set(r) >= KEYS
    assert set(r["mem"]) >= MEM_KEYS
    assert set(r["collectives"]) == COLL_KEYS
    assert r["n_devices"] == (512 if mp else 256)
    assert r["mesh"] == ("2x16x16" if mp else "16x16")
    assert r["kind"] == SHAPES[shape].kind
    assert r["flops_per_device"] > 0 and r["hbm_bytes_per_device"] > 0
    m = r["mem"]
    assert m["peak_bytes"] == m["argument_bytes"] + m["temp_bytes"]
    assert m["temp_bytes"] > 0 and r["collectives"]["count"] > 0


@pytest.mark.parametrize("arch,shape,mp", CASES)
def test_param_bytes_are_the_spec_share(results, arch, shape, mp):
    cfg = _cut(arch)
    mesh = dryrun.layout_for(mp)
    sd = M.Model(cfg, device="meta").state_dict()
    specs = sharding.param_specs(sd, cfg, mesh)
    want = sum(sharding.shard_bytes(t.shape, t.element_size(), specs[k],
                                    mesh) for k, t in sd.items())
    m = results[(arch, shape, mp)]["mem"]
    assert m["param_bytes"] == want
    if SHAPES[shape].kind == "train":          # mu, nu f32; count, step
        want_opt = sum(sharding.shard_bytes(t.shape, 4, specs[k], mesh)
                       for k, t in sd.items()) * 2 + 8
        assert m["opt_bytes"] == want_opt
    # the largest gathered parameter fits under the temp peak (a
    # decode gathers a parameter cut over ``model`` over the data axes
    # only: its model block)
    def gathered(k, t):
        n = 1
        if SHAPES[shape].kind == "decode" and "model" in sharding.spec_axes(
                specs[k]):
            n = mesh.shape["model"]
        return t.numel() * t.element_size() // n
    assert m["temp_bytes"] > max(gathered(k, t) for k, t in sd.items())


def _mat(params: dict, prefix: str, skip=()) -> int:
    return sum(t.numel() for k, t in params.items()
               if k.startswith(prefix) and t.ndim >= 2
               and not any(s in k for s in skip))


def analytic_train_flops(cfg, mesh, opts_capacity=1.25) -> float:
    """The products of one remat train step on one device (see the
    module docstring for the terms)."""
    sp = SHAPES["train_4k"]
    n_data = mesh.axis_size(sharding.data_axes(mesh))
    Mn = mesh.shape["model"]
    B, S = sp.global_batch // n_data, sp.seq_len
    Sq = S // Mn                            # the device's query rows
    T = B * Sq
    sd = M.Model(cfg, device="meta").state_dict()
    n_pre = len(cfg.prefix)
    mid = n_pre + len(cfg.period) * cfg.n_periods
    total = 2 * T * cfg.d_model * cfg.vocab_size * 3          # the head
    for i, spec in enumerate(cfg.blocks()):
        pre = f"layers.{i}."
        f = 2 * T * _mat(sd, pre, skip=(".moe.",))
        if spec.mixer == "attn":
            a = cfg.attn
            c = attention._chunk_rows(B, a.n_heads, S)
            rows = (Sq if Sq <= attention.CHUNK_THRESHOLD and
                    B * a.n_heads * Sq * S <= attention.CHUNK_SCORES
                    else -(-Sq // c) * c)
            f += 4 * B * a.n_heads * rows * S * a.head_dim
        if spec.ff == "moe":
            moe = cfg.moe
            C = max(1, int(T * moe.top_k / moe.n_experts * opts_capacity))
            d, fe = cfg.d_model, moe.d_expert
            f += 2 * T * d * moe.n_experts                       # router
            f += 2 * 3 * d * fe * moe.n_experts * C              # experts
            f += 2 * T * _mat(sd, pre + "moe.shared.")           # shared
        total += f * (4 if n_pre <= i < mid else 3)
        if n_pre <= i < mid:           # the recompute stops before the
            last = next(k for k in (pre + "mlp.w_down",      # last product
                                    pre + "moe.shared.w_down") if k in sd)
            total -= 2 * T * sd[last].numel()
    return float(total)


@pytest.mark.parametrize("arch,mp", [("smollm-360m", False),
                                     ("smollm-360m", True),
                                     ("moonshot-v1-16b-a3b", False),
                                     ("moonshot-v1-16b-a3b", True)])
def test_flops_equal_analytic_count(results, arch, mp):
    got = results[(arch, "train_4k", mp)]["flops_per_device"]
    want = analytic_train_flops(_cut(arch), dryrun.layout_for(mp))
    assert got == pytest.approx(want, rel=0.02)


def test_cli_writes_json_and_skips(tmp_path, capsys):
    out = tmp_path / "out.json"
    dryrun.main(["--cells", "rwkv6-3b:long_500k,smollm-360m:long_500k",
                 "--mesh", "both", "--json", str(out)])
    got = json.loads(out.read_text())
    assert got["failures"] == []
    rows = got["results"]
    assert {r["mesh"] for r in rows if not r.get("skip")} == {
        "16x16", "2x16x16"}
    assert any(r.get("skip") and r["arch"] == "smollm-360m" for r in rows)
    for r in rows:
        if not r.get("skip"):
            assert set(r) >= KEYS
    assert "SKIP" in capsys.readouterr().out


def test_decode_records_no_cache_gather():
    """rwkv6-3b's long-context decode gathers its weights and its
    model-cut states, and moves no cache otherwise; the explicit-DP train
    step's collectives are mpix calls priced by their schedule."""
    r = dryrun.analyse("rwkv6-3b", "long_500k", multi_pod=False,
                       verbose=False)
    assert r["collectives"]["all-gather"] > 0
    assert r["collectives"]["all-to-all"] == 0
    cfg = dataclasses.replace(get_config("smollm-360m"), n_periods=1)
    mesh = dryrun.layout_for(False)
    ins = {k: torch.empty((256, 64), dtype=torch.int32, device="meta")
           for k in ("tokens", "labels")}
    res = dryrun.analyse_cell(cfg, "train", ins, mesh, train_overrides=dict(
        dp_mode="explicit", dp_algorithm="ring_rs_ag"))
    kinds = {e[0] for e in mesh.log}
    assert "mpix-all-reduce" in kinds
    grads = sum(t.numel() for t in M.Model(cfg, device="meta").parameters())
    # ring reduce-scatter + allgather: 2 (n-1)/n of the f32 gradient
    ring = [e for e in mesh.log if e[0] == "mpix-all-reduce"]
    n = mesh.axis_size("data")
    assert ring[0][3] == pytest.approx(2 * (n - 1) / n * grads * 4,
                                       rel=1e-3)
    assert res["collectives"]["all-reduce"] >= ring[0][3]
