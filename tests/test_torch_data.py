"""The port's step-addressable data stream (``repro_torch.data``, numpy
threefry) against the JAX package's ``DataPipeline``.

Tolerances:

- the keys, the uniforms and the BOS positions: bitwise (the port's
  numpy threefry is the reference's partitionable threefry);
- tokens: equal except where ``exp(u * log(V - 2))`` lands within 2
  float32 ulps of an integer.  XLA's float32 ``exp`` is its own
  polynomial; the port computes ``exp`` in float64 and rounds it, so
  near an integer the two floors can part by one.  Every differing
  token is asserted to be such a case, and labels follow their tokens.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.data import DataPipeline as JPipe, PipelineConfig as JCfg

from repro_torch.data import DataPipeline, PipelineConfig
from repro_torch.data import _threefry as tf

SEEDS = (0, 3, 2 ** 31 - 1)
STEPS = (0, 1, 123)


def _ref_draws(cfg, step, rows):
    """The reference's (u, b, exp) of rows [lo, hi), as its ``_row``
    computes them."""
    key = jax.random.fold_in(jax.random.key(cfg.seed), step)
    keys = jax.random.split(key, cfg.global_batch)[rows[0]: rows[1]]
    us, bs = [], []
    for k in keys:
        k1, k2 = jax.random.split(k)
        us.append(np.asarray(jax.random.uniform(k1, (cfg.seq_len,),
                                                jnp.float32)))
        bs.append(np.asarray(jax.random.uniform(k2, (cfg.seq_len,),
                                                jnp.float32)))
    u, b = np.stack(us), np.stack(bs)
    e = np.asarray(jnp.exp(jnp.asarray(u) * np.log(cfg.vocab_size - 2)))
    return u, b, e


def _near_integer(e, ulps=2):
    return np.abs(e - np.round(e)) <= ulps * np.spacing(e)


@pytest.mark.parametrize("seed", SEEDS)
def test_keys_bitwise(seed):
    k = jax.random.key(seed)
    assert tuple(int(v) for v in jax.random.key_data(k)) == tf.key(seed)
    for step in STEPS:
        kf = jax.random.fold_in(k, step)
        mine = tf.fold_in(tf.key(seed), step)
        assert tuple(int(v) for v in jax.random.key_data(kf)) == mine
        ks = np.asarray(jax.random.key_data(jax.random.split(kf, 7)))
        assert (ks == tf.split(mine, 7)).all()
        bits = np.asarray(jax.random.bits(kf, (33,), jnp.uint32))
        assert (bits == tf.random_bits(mine, 33)).all()


@pytest.mark.parametrize("vocab", [277, 49152])
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("shards", [1, 2, 4])
def test_batches_against_reference(vocab, seed, shards):
    cfg = PipelineConfig(vocab_size=vocab, seq_len=96, global_batch=4,
                         seed=seed, mean_doc_len=16)
    jcfg = JCfg(vocab_size=vocab, seq_len=96, global_batch=4, seed=seed,
                mean_doc_len=16)
    rows = cfg.global_batch // shards
    for step in STEPS:
        whole = DataPipeline(cfg).batch(step)
        for sh in range(shards):
            pipe = DataPipeline(cfg, shards, sh)
            got = pipe.batch(step)
            want = JPipe(jcfg, shards, sh).batch(step)
            u, b = pipe.uniforms(step)
            ru, rb, re = _ref_draws(jcfg, step, (sh * rows, (sh + 1) * rows))
            assert (u.view(np.uint32) == ru.view(np.uint32)).all()
            assert (b.view(np.uint32) == rb.view(np.uint32)).all()
            bos = rb < np.float32(1.0 / cfg.mean_doc_len)
            tok, wt = got["tokens"].numpy(), np.asarray(want["tokens"])
            assert got["tokens"].dtype == torch.int32
            assert ((tok == cfg.bos_id) | ~bos).all()
            assert ((wt == cfg.bos_id) == (tok == cfg.bos_id)).all()
            diff = tok != wt
            assert (_near_integer(re[diff])).all(), re[diff]
            assert (np.abs(tok - wt) <= 1).all()
            lab, wl = got["labels"].numpy(), np.asarray(want["labels"])
            ldiff = lab != wl
            assert (ldiff[:, :-1] == diff[:, 1:]).all()
            assert (lab[:, -1] == -100).all()
            # a shard is its rows of the one-shard batch
            sl = slice(sh * rows, (sh + 1) * rows)
            assert (whole["tokens"][sl] == got["tokens"]).all()


def test_reshard_keeps_the_global_stream():
    cfg = PipelineConfig(vocab_size=49152, seq_len=64, global_batch=8)
    p4 = DataPipeline(cfg, 4, 1)
    p2 = p4.reshard(2, 0)
    assert (p2.num_shards, p2.shard, p2.rows) == (2, 0, 4)
    a = p2.batch(5)["tokens"][2:4]
    assert (a == p4.batch(5)["tokens"]).all()
    j = JPipe(JCfg(vocab_size=49152, seq_len=64, global_batch=8), 4, 1)
    assert (j.reshard(2, 0).batch(5)["tokens"].shape == (4, 64))


def test_boundary_tokens_are_rare():
    """At the launcher's width (V = 49152, 8 rows of 2048) the floors
    part on few tokens, all of them boundary cases."""
    cfg = PipelineConfig(vocab_size=49152, seq_len=2048, global_batch=8)
    jcfg = JCfg(vocab_size=49152, seq_len=2048, global_batch=8)
    got = DataPipeline(cfg).batch(0)["tokens"].numpy()
    want = np.asarray(JPipe(jcfg).batch(0)["tokens"])
    _, _, re = _ref_draws(jcfg, 0, (0, 8))
    diff = got != want
    assert diff.sum() <= 8, diff.sum()
    assert _near_integer(re[diff]).all()
