"""The port's optimizer pieces (``repro_torch.optim``) against the JAX
package's, on seeded float32 and bfloat16 trees with negative zeros.

Tolerances:

- ``compress_int8`` / ``decompress_int8`` / ``ef_compress_tree``:
  bitwise (elementwise ops in the same order; round half to even on
  both sides), the residuals included;
- ``adamw_update``: the moments bitwise; the bias corrections take
  ``b ** count`` through each library's ``pow``, which may differ by an
  ulp, so the updated parameters are held to 2 ulps of the step (float32:
  ``rtol 1e-6``; bfloat16: bitwise or one bf16 ulp where a float32
  value rounds on a tie boundary, at most 1 element in 1000);
- ``clip_by_global_norm``: the norm sums leaves in another order,
  ``rtol 1e-6``, and the clipped leaves ``rtol 2e-6`` (f32) or one bf16
  ulp;
- ``cosine_schedule``: ``cos`` differs by at most an ulp between the
  libraries: ``rtol 3e-7``; the warmup branch bitwise.
"""
import ml_dtypes
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro import optim as joptim
from repro.optim import compress as jcompress
from repro.optim import schedule as jschedule

from repro_torch import optim
from repro_torch.convert import tensor_from_numpy

SHAPES = {"a": (7, 33), "b": (300,), "c": (2, 3, 5), "d": (1,)}


def _tree(seed, dtype, scale=1.0):
    rng = np.random.default_rng(seed)
    out = {}
    for k, s in SHAPES.items():
        a = (rng.standard_normal(s) * scale).astype(np.float32)
        a.reshape(-1)[::5] = -0.0
        a.reshape(-1)[1::11] = 0.0
        out[k] = a.astype(ml_dtypes.bfloat16) if dtype == "bfloat16" else a
    return out


def _port(tree):
    return {k: tensor_from_numpy(v) for k, v in tree.items()}


def _bits(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        if x.dtype == torch.bfloat16:
            return x.view(torch.int16).numpy()
        return x.numpy().view(np.int32) if x.dtype == torch.float32 \
            else x.numpy()
    a = np.asarray(x)
    if a.dtype == ml_dtypes.bfloat16:
        return a.view(np.int16)
    return a.view(np.int32) if a.dtype == np.float32 else a


def _f32(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.mark.parametrize("kw", [
    dict(warmup_steps=0, total_steps=10),
    dict(warmup_steps=1, total_steps=10),
    dict(warmup_steps=4, total_steps=20),
    dict(warmup_steps=5, total_steps=5),
])
def test_cosine_schedule(kw):
    for step in (0, 1, 2, 3, 4, 5, 7, 10, 19, 20, 25, 1000):
        want = np.float32(jschedule.cosine_schedule(
            jnp.int32(step), peak_lr=3e-3, **kw))
        got = optim.cosine_schedule(torch.tensor(step, dtype=torch.int32),
                                    peak_lr=3e-3, **kw)
        assert got.dtype == torch.float32 and got.shape == ()
        if step < kw["warmup_steps"]:
            assert _bits(got) == want.view(np.int32), (step, kw)
        else:
            np.testing.assert_allclose(float(got), want, rtol=3e-7,
                                       err_msg=f"{step} {kw}")
    # an int step as well as a tensor
    assert float(optim.cosine_schedule(3, peak_lr=1.0, warmup_steps=4,
                                       total_steps=8)) == 0.75


def test_adamw_init():
    p = _port(_tree(0, "bfloat16"))
    st = optim.adamw_init(p)
    assert int(st["count"]) == 0 and st["count"].dtype == torch.int32
    for k, v in p.items():
        assert st["mu"][k].dtype == torch.float32
        assert st["mu"][k].shape == v.shape
        assert not st["mu"][k].any() and not st["nu"][k].any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_adamw_update(dtype):
    jp = _tree(1, dtype)
    js = joptim.adamw_init(jp)
    tp = _port(jp)
    ts = optim.adamw_init(tp)
    for it in range(3):                     # the moments carry over
        jg = _tree(2 + it, dtype, scale=0.1)
        lr = np.float32(1e-3 * (it + 1))
        jp, js = joptim.adamw_update(jp, jg, js, lr=jnp.float32(lr),
                                     weight_decay=0.1)
        tp, ts = optim.adamw_update(tp, _port(jg), ts, lr=torch.tensor(lr),
                                    weight_decay=0.1)
        assert int(ts["count"]) == int(js["count"]) == it + 1
        for k in SHAPES:
            for part in ("mu", "nu"):
                assert (_bits(ts[part][k]) == _bits(js[part][k])).all(), \
                    (part, k, it)
            assert tp[k].dtype == tensor_from_numpy(np.asarray(jp[k])).dtype
            a, b = _f32(tp[k]), _f32(jp[k])
            if dtype == "float32":
                np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-9)
            else:
                off = np.abs(a - b) > 0
                assert (np.abs(a - b) <= np.abs(b) * 2.0 ** -7).all(), k
                assert off.mean() <= 1e-3, (k, off.sum())


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("max_norm", [1e9, 1.0, 0.01])
def test_clip_by_global_norm(dtype, max_norm):
    jg = _tree(3, dtype)
    want, wn = joptim.clip_by_global_norm(jg, max_norm)
    got, gn = optim.clip_by_global_norm(_port(jg), max_norm)
    np.testing.assert_allclose(float(gn), float(wn), rtol=1e-6)
    for k in SHAPES:
        assert got[k].dtype == tensor_from_numpy(jg[k]).dtype
        a, b = _f32(got[k]), _f32(want[k])
        if max_norm >= 1e9:
            assert (_bits(got[k]) == _bits(want[k])).all()
        elif dtype == "float32":
            np.testing.assert_allclose(a, b, rtol=2e-6, atol=1e-30)
        else:
            assert (np.abs(a - b) <= np.abs(b) * 2.0 ** -7 + 1e-30).all()


@pytest.mark.parametrize("n", [1, 255, 256, 257, 1000])
def test_compress_roundtrip_bitwise(n):
    rng = np.random.default_rng(n)
    x = rng.standard_normal(n).astype(np.float32) * 3
    x[::7] = -0.0
    # exact halves: round half to even on both sides
    x[1::13] = np.float32(127.0 * 2.5 / 127.0)
    jq, js = jcompress.compress_int8(jnp.asarray(x))
    tq, ts = optim.compress_int8(torch.from_numpy(x.copy()))
    assert tq.dtype == torch.int8 and ts.dtype == torch.float32
    assert (tq.numpy() == np.asarray(jq)).all()
    assert (_bits(ts) == _bits(js)).all()
    jd = jcompress.decompress_int8(jq, js, x.shape, jnp.float32)
    td = optim.decompress_int8(tq, ts, x.shape, torch.float32)
    assert (_bits(td) == _bits(jd)).all()


def test_round_half_to_even():
    x = torch.tensor([0.5, 1.5, 2.5, -0.5, -2.5, 127.0, 126.5])
    q, s = optim.compress_int8(x)
    back = (x / s[0]).numpy()
    assert (q[0, :7].numpy() == np.asarray(jnp.round(back))).all()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ef_compress_tree_bitwise(dtype):
    jg = _tree(4, dtype)
    jc, jr = jcompress.ef_compress_tree(jg, None)
    tc, tr = optim.ef_compress_tree(_port(jg), None)
    jg2 = _tree(5, dtype)
    jc2, jr2 = jcompress.ef_compress_tree(jg2, jr)
    tc2, tr2 = optim.ef_compress_tree(_port(jg2), tr)
    for (c_j, r_j, c_t, r_t) in ((jc, jr, tc, tr), (jc2, jr2, tc2, tr2)):
        for k in SHAPES:
            assert (c_t[k][0].numpy() == np.asarray(c_j[k][0])).all()
            assert (_bits(c_t[k][1]) == _bits(c_j[k][1])).all()
            assert r_t[k].dtype == torch.float32
            assert (_bits(r_t[k]) == _bits(r_j[k])).all(), k
