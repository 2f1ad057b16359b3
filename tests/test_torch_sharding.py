"""The port's sharding specs, input specs and parameter counts held to
the reference's, all exact:

- every ``Model.state_dict()`` name's spec (``repro_torch.train.sharding``)
  equals the reference's ``PartitionSpec`` for its path
  (``repro.train.sharding.param_specs`` on ``jax.eval_shape`` params),
  mapped through ``convert.param_names_from_jax``, for all ten archs on
  a 16x16 and a 2x16x16 stand-in mesh (an object with ``shape`` and
  ``axis_names``: no device mesh is built).  Specs are compared dim by
  dim after normalising ``P()`` and short specs to one entry a dim and
  single names to 1-tuples; a periodic layer drops the stacked axis;
- ``cache_specs`` with ``long_context`` on and off, on ``jax.eval_shape``
  caches at a batch and length that divide and a length that does not,
  mapped through ``convert.cache_names_from_jax``;
- ``launch.specs.input_specs`` shapes and dtypes for every runnable cell;
- ``count_params`` and ``active_param_count`` for all ten archs.
"""
import types

import jax
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro import configs as jconfigs
from repro.configs.shapes import SHAPES, runnable
from repro.launch import specs as jspecs
from repro.models import model as JM
from repro.train import sharding as jsharding

from repro_torch import configs
from repro_torch.convert import (at_path, cache_names_from_jax,
                                 param_names_from_jax)
from repro_torch.launch import specs
from repro_torch.models import model as M
from repro_torch.train import sharding

MESHES = {
    "16x16": types.SimpleNamespace(shape={"data": 16, "model": 16},
                                   axis_names=("data", "model")),
    "2x16x16": types.SimpleNamespace(
        shape={"pod": 2, "data": 16, "model": 16},
        axis_names=("pod", "data", "model")),
}
ARCHS = list(configs.ARCHS)


def _norm(spec, nd):
    """One tuple of axes a dim."""
    ent = list(spec) + [None] * (nd - len(spec))
    return tuple(sharding.entry_axes(e) for e in ent)


@pytest.fixture(scope="module")
def ref_params():
    return {}


def _shapes(arch, cache):
    if arch not in cache:
        cfg = jconfigs.get_config(arch)
        cache[arch] = jax.eval_shape(
            lambda: JM.init_params(jax.random.key(0), cfg))
    return cache[arch]


@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_equal_reference(arch, ref_params):
    shapes = _shapes(arch, ref_params)
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    sd = M.Model(cfg, device="meta").state_dict()
    names = param_names_from_jax(shapes)
    assert set(names) == set(sd)
    for mk, mesh in MESHES.items():
        jspec = jsharding.param_specs(shapes, jcfg, mesh)
        mine = sharding.param_specs(sd, cfg, mesh)
        cut = 0
        for name, (path, index) in names.items():
            leaf = at_path(shapes, path)
            want = _norm(at_path(jspec, path), len(leaf.shape))
            if index is not None:
                assert want[0] == (), (name, want)
                want = want[1:]
            got = _norm(mine[name], sd[name].ndim)
            assert got == want, (arch, mk, name, got, want)
            assert tuple(sd[name].shape) == tuple(
                leaf.shape[1:] if index is not None else leaf.shape)
            cut += any(got)
        assert cut, (arch, mk)


def test_rwkv_stacked_small_vector_is_cut():
    """rwkv6-3b's channel-mix ``mu`` [2, 2560] is 5,120 elements a layer,
    under the size cut alone; the stacked [32, 2, 2560] is not."""
    cfg = configs.get_config("rwkv6-3b")
    sd = M.Model(cfg, device="meta").state_dict()
    for mk, mesh in MESHES.items():
        assert sharding.param_spec("layers.0.cmix.mu", sd[
            "layers.0.cmix.mu"].shape, cfg, mesh) == (None, "model")
        assert sharding.param_spec("layers.5.rwkv.mu", sd[
            "layers.5.rwkv.mu"].shape, cfg, mesh) == (None, "model")
    assert tuple(sd["layers.0.cmix.mu"].shape) == (2, 2560)


def test_whisper_odd_vocab_replicates():
    cfg = configs.get_config("whisper-small")
    spec = sharding.param_spec("embed", (cfg.vocab_size, cfg.d_model), cfg,
                               MESHES["16x16"])
    assert spec == (None, ("data",))


@pytest.mark.parametrize("long_context", [False, True])
@pytest.mark.parametrize("arch", ["gemma2-2b", "deepseek-v3-671b",
                                  "rwkv6-3b", "jamba-1.5-large-398b",
                                  "whisper-small"])
def test_cache_specs_equal_reference(arch, long_context):
    cfg = configs.get_config(arch)
    jcfg = jconfigs.get_config(arch)
    for B, S in ((32, 512), (32, 520)):       # 520: no 256- or 512-cut
        jcache = jax.eval_shape(lambda: JM.init_cache(jcfg, B, S))
        cache = M.init_cache(cfg, B, S, device="meta")
        flat = sharding.flat_names(cache)
        names = cache_names_from_jax(jcache)
        assert set(names) == set(flat)
        for mk, mesh in MESHES.items():
            jspec = jsharding.cache_specs(jcache, jcfg, mesh,
                                          long_context=long_context)
            mine = sharding.flat_names(sharding.cache_specs(
                cache, cfg, mesh, long_context=long_context))
            for name, (path, index) in names.items():
                leaf = at_path(jcache, path)
                t = flat[name]
                if not hasattr(t, "shape"):          # the host ``len``
                    assert mine[name] is None
                    continue
                want = _norm(at_path(jspec, path), len(leaf.shape))
                if index is not None:
                    assert want[0] == ()
                    want = want[1:]
                assert _norm(mine[name], t.ndim) == want, (
                    arch, mk, B, S, name, mine[name], want)
                assert tuple(t.shape) == tuple(
                    leaf.shape[1:] if index is not None else leaf.shape)
                assert str(t.dtype).removeprefix("torch.") == str(
                    leaf.dtype)


def test_batch_specs():
    for mesh in MESHES.values():
        want = _norm(jsharding.batch_specs(mesh), 2)
        assert _norm(sharding.batch_specs(mesh), 2) == want
        assert sharding.data_axes(mesh) == jsharding.data_axes(mesh)


CELLS = [(a, s) for a in ARCHS for s in SHAPES if runnable(a, s)]


def test_runnable_cells_count():
    assert len(CELLS) == 32


def _dt(x):
    return str(x.dtype).removeprefix("torch.")


@pytest.mark.parametrize("arch,shape", CELLS)
def test_input_specs_equal_reference(arch, shape):
    jkind, jins = jspecs.input_specs(arch, shape)
    kind, ins = specs.input_specs(arch, shape)
    assert kind == jkind
    assert set(ins) == set(jins)
    for k, v in ins.items():
        if k == "cache":
            names = cache_names_from_jax(v_ref := jins["cache"])
            flat = sharding.flat_names(v)
            assert set(names) == set(flat)
            for name, (path, index) in names.items():
                leaf, t = at_path(v_ref, path), flat[name]
                if not hasattr(t, "shape"):
                    continue
                want = leaf.shape[1:] if index is not None else leaf.shape
                assert tuple(t.shape) == tuple(want), name
                assert t.device.type == "meta"
                assert _dt(t) == str(leaf.dtype), name
            continue
        assert v.device.type == "meta"
        assert tuple(v.shape) == tuple(jins[k].shape), k
        assert _dt(v) == str(jins[k].dtype), k


def test_state_shapes_on_meta():
    from repro_torch.train.step import TrainOptions
    cfg = configs.get_config("smollm-360m")
    st = specs.state_shapes(cfg, TrainOptions(compress_dcn=True))
    sd = M.Model(cfg, device="meta").state_dict()
    assert set(st["params"]) == set(sd)
    for tree in (st["params"], st["opt"]["mu"], st["opt"]["nu"],
                 st["ef_residual"]):
        for k, v in tree.items():
            assert v.device.type == "meta" and v.shape == sd[k].shape
    assert st["opt"]["mu"]["embed"].dtype == torch.float32
    assert st["params"]["embed"].dtype == torch.bfloat16


# the reference's counts (``count_params(cfg, active_only=...)``)
ACTIVE = {"deepseek-v3-671b": 37_552_297_472,
          "moonshot-v1-16b-a3b": 4_469_101_504,
          "jamba-1.5-large-398b": 94_149_338_592}


@pytest.mark.parametrize("arch", ARCHS)
def test_param_counts_equal_reference(arch, ref_params):
    cfg = configs.get_config(arch)
    shapes = _shapes(arch, ref_params)
    total = sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))
    assert M.count_params(cfg) == total == cfg.param_count()
    active = JM.count_params(jconfigs.get_config(arch), active_only=True)
    assert cfg.active_param_count() == active
    assert M.count_params(cfg, active_only=True) == active
    if arch in ACTIVE:
        assert active == ACTIVE[arch]
    if cfg.moe is None:
        assert active == total
