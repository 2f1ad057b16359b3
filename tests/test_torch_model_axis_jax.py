"""The sequence-split forward against the JAX package's ``forward``.

Four gloo ranks ((1, 4) over ``("data", "model")``, one spawn,
``tests/torch_model_axis_worker.run_forwards``) each run their S/4 rows
of each arch's smoke model (gemma2-2b, deepseek-v3-671b, rwkv6-3b,
jamba-1.5-large-398b, whisper-small, qwen2-vl-7b) with the sequence
split, on the JAX package's seeded weights in f32 converted by
``convert.params_from_jax``; this process puts the rows together over
the model ranks and holds them against the JAX ``forward`` of the same
tokens (whisper's frames, qwen2-vl's vision prefix) at
tests/torch_arch_helpers.py's f32 tolerance, ``atol = rtol = 1e-4``.
The ranks start first and wait for the weights while this process
draws them.
"""
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro import configs as jconfigs
from repro.models import model as JM

from repro_torch.convert import params_from_jax

sys.path.insert(0, os.path.dirname(__file__))
import torch_model_axis_worker as worker  # noqa: E402

JAX_F32 = dict(atol=1e-4, rtol=1e-4)


def _jax_inputs(arch):
    """(JAX params in f32, tokens, extra inputs) from numpy seeds."""
    jcfg = jconfigs.get_smoke(arch)
    jp = jax.tree.map(lambda x: x.astype(jnp.float32),
                      JM.init_params(jax.random.key(0), jcfg))
    rng = np.random.default_rng(3)
    toks = rng.integers(0, jcfg.vocab_size, (worker.FWD_B, worker.S)
                        ).astype(np.int32)
    kw = {}
    if jcfg.encoder is not None:
        kw["encoder_frames"] = rng.normal(size=(
            worker.FWD_B, jcfg.encoder.n_frames, jcfg.encoder.d_model)
        ).astype(np.float32)
    if jcfg.vision_prefix:
        kw["vision_embeds"] = rng.normal(size=(
            worker.FWD_B, jcfg.vision_prefix, jcfg.d_model)).astype(
            np.float32)
    return jcfg, jp, toks, kw


@pytest.fixture(scope="module")
def results(tmp_path):
    path = str(tmp_path / "arch_params.pt")
    ctx = torch.multiprocessing.start_processes(
        worker.run_forwards, args=(4, f"file://{tmp_path}/rendezvous",
                                   str(tmp_path), path),
        nprocs=4, join=False, start_method="spawn")
    data, jax_in = {}, {}
    for arch in worker.ARCHS:
        jcfg, jp, toks, kw = _jax_inputs(arch)
        jax_in[arch] = (jcfg, jp, toks, kw)
        data[arch] = {"params": params_from_jax(jax.tree.map(np.asarray,
                                                             jp)),
                      "tokens": torch.from_numpy(toks),
                      "kw": {k: torch.from_numpy(v) for k, v in kw.items()}}
    torch.save(data, path)
    open(path + ".done", "w").close()
    want = {arch: np.asarray(JM.forward(
        jp, jcfg, jnp.asarray(toks),
        **{k: jnp.asarray(v) for k, v in kw.items()}), np.float32)
        for arch, (jcfg, jp, toks, kw) in jax_in.items()}
    while not ctx.join():
        pass
    outs = [torch.load(tmp_path / f"rank{r}.pt", weights_only=False)
            for r in range(4)]
    return outs, want


@pytest.fixture(scope="module")
def tmp_path(tmp_path_factory):
    return tmp_path_factory.mktemp("model_axis_jax")


@pytest.mark.parametrize("arch", worker.ARCHS)
def test_split_forward_equals_jax(results, arch):
    outs, want = results
    assert sorted(o["coords"]["model"] for o in outs) == [0, 1, 2, 3]
    rows = [o["logits"][arch] for o in sorted(
        outs, key=lambda o: o["coords"]["model"])]
    got = torch.cat(rows, dim=1).float().numpy()
    assert got.shape == want[arch].shape
    np.testing.assert_allclose(got, want[arch], **JAX_F32, err_msg=arch)
