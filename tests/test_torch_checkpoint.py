"""The port's checkpoints (repro_torch.checkpoint): trees of tensors in
torch's own format, held against the reference's store.

The nine corruption cases of the reference's
``tests/test_checkpoint_corruption.py`` on the port: every damaged file
in a committed step makes ``restore_checkpoint`` raise the typed
``CheckpointCorruptError``, and ``FaultTolerantLoop.resume_or_init``
falls back to the newest intact step (or a fresh init).  ``torch.load``
does not check a stored entry's CRC, so the port checks each shard's
sha256 from the manifest: a flipped payload byte is always caught (the
reference only catches it where the zip CRC does).  A manifest lists
the same leaves, shapes, dtypes and shard owners as the reference's for
the same tree, and the gemma2-2b smoke parameters round-trip bit for
bit against the reference's own round trip (bf16 by raw bits).
"""
import json
import warnings
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax

from repro import configs as jconfigs
from repro.checkpoint import restore_checkpoint as jrestore
from repro.checkpoint import save_checkpoint as jsave
from repro.models import model as JM

from repro_torch.checkpoint import (AsyncCheckpointer,
                                    CheckpointCorruptError, committed_steps,
                                    latest_step, restore_checkpoint,
                                    save_checkpoint)
from repro_torch.convert import params_from_jax
from repro_torch.runtime.fault import FaultTolerantLoop


def _tree(scale=1.0):
    return {"w": torch.arange(24, dtype=torch.float32).reshape(4, 6) * scale,
            "b": torch.full((4,), scale, dtype=torch.float32),
            "step": torch.tensor(0, dtype=torch.int32)}


def _shard(tmp_path, step=5, k=0):
    return tmp_path / f"step_{step:08d}" / f"shard_{k}.pt"


def _truncate(path: Path, keep_frac=0.5):
    raw = path.read_bytes()
    path.write_bytes(raw[: max(1, int(len(raw) * keep_frac))])


def _bitflip(path: Path, offset=7):
    raw = bytearray(path.read_bytes())
    raw[offset % len(raw)] ^= 0xFF
    path.write_bytes(bytes(raw))


def test_truncated_shard_raises_typed_error(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    _truncate(_shard(tmp_path))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _tree(), step=5)


def test_bitflipped_manifest_raises_typed_error(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    _bitflip(tmp_path / "step_00000005" / "manifest.json")
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _tree(), step=5)


def test_garbage_shard_raises_typed_error(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    _shard(tmp_path).write_bytes(b"not a zip")
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _tree(), step=5)


def test_missing_leaf_and_shape_mismatch_are_typed(tmp_path):
    save_checkpoint(tmp_path, 5, _tree())
    d = tmp_path / "step_00000005"
    man = json.loads((d / "manifest.json").read_text())
    (d / "manifest.json").write_text(
        json.dumps(dict(man, leaves=man["leaves"][1:])))
    with pytest.raises(CheckpointCorruptError, match="missing leaf"):
        restore_checkpoint(tmp_path, _tree(), step=5)
    man_shape = json.loads(json.dumps(man))
    man_shape["leaves"][0]["shape"] = [1, 1]
    (d / "manifest.json").write_text(json.dumps(man_shape))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _tree(), step=5)
    # a tree_like the run does not match is typed too
    (d / "manifest.json").write_text(json.dumps(man))
    wrong = dict(_tree(), w=torch.zeros(6, 4))
    with pytest.raises(CheckpointCorruptError, match="shape"):
        restore_checkpoint(tmp_path, wrong, step=5)


def test_committed_steps_newest_first(tmp_path):
    for s in (3, 12, 7):
        save_checkpoint(tmp_path, s, _tree())
    (tmp_path / "step_00000099").mkdir()
    assert committed_steps(tmp_path) == [12, 7, 3]
    assert latest_step(tmp_path) == 12
    assert committed_steps(tmp_path / "missing") == []


def test_resume_falls_back_to_newest_intact(tmp_path):
    for s, scale in ((10, 1.0), (20, 2.0), (30, 3.0)):
        save_checkpoint(tmp_path, s, _tree(scale), meta={"next_step": s})
    _truncate(_shard(tmp_path, 30))
    loop = FaultTolerantLoop(tmp_path)
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        state, step = loop.resume_or_init(_tree(0.0))
    assert step == 20
    assert torch.equal(state["w"], _tree(2.0)["w"])
    assert any(issubclass(w.category, RuntimeWarning) for w in caught)


def test_resume_all_corrupt_falls_back_to_init(tmp_path):
    for s in (10, 20):
        save_checkpoint(tmp_path, s, _tree(), meta={"next_step": s})
    _bitflip(tmp_path / "step_00000010" / "manifest.json")
    _truncate(_shard(tmp_path, 20))
    loop = FaultTolerantLoop(tmp_path)
    init = _tree(0.0)
    with warnings.catch_warnings(record=True):
        warnings.simplefilter("always")
        state, step = loop.resume_or_init(init)
    assert step == 0
    assert torch.equal(state["w"], init["w"])


def test_resume_intact_path_unchanged(tmp_path):
    for s in (10, 20):
        save_checkpoint(tmp_path, s, _tree(s * 1.0), meta={"next_step": s})
    loop = FaultTolerantLoop(tmp_path)
    state, step = loop.resume_or_init(_tree(0.0))
    assert step == 20
    assert torch.equal(state["w"], _tree(20.0)["w"])


@pytest.mark.parametrize("where", ["payload", "middle", "tail"])
def test_bitflipped_shard_payload_is_always_detected(tmp_path, where):
    """Flipped bytes anywhere in a shard: torch.load would decode the
    payload's as other values, so the manifest's sha256 catches them."""
    save_checkpoint(tmp_path, 5, _tree())
    p = _shard(tmp_path)
    raw = bytearray(p.read_bytes())
    if where == "payload":                 # inside the stored floats
        at = raw.find(np.arange(24, dtype=np.float32)[8:12].tobytes())
        assert at > 0
        span = range(at, at + 4)
    elif where == "middle":
        span = range(len(raw) // 2, len(raw) // 2 + 40)
    else:
        span = range(len(raw) - 8, len(raw))
    for off in span:
        raw[off] ^= 0xFF
    p.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorruptError):
        restore_checkpoint(tmp_path, _tree(), step=5)


# ---------------------------------------------------------------------------
# the manifest and the data, against the reference's store
# ---------------------------------------------------------------------------


def test_manifest_lists_the_reference_leaves(tmp_path):
    rng = np.random.default_rng(0)
    arrays = {"blocks": [{"w": rng.standard_normal((3, 5)).astype(
        np.float32), "b": rng.standard_normal(5).astype(np.float32)}
        for _ in range(3)],
        "embed": rng.standard_normal((7, 2)).astype(np.float32),
        "pair": (np.arange(4, dtype=np.int32), np.float32(2.5)),
        "none": None}
    tree = {"blocks": [{k: torch.from_numpy(v) for k, v in b.items()}
                       for b in arrays["blocks"]],
            "embed": torch.from_numpy(arrays["embed"]),
            "pair": (torch.from_numpy(arrays["pair"][0]),
                     torch.tensor(2.5)), "none": None}
    save_checkpoint(tmp_path / "t", 3, tree, num_shards=3,
                    meta={"next_step": 3})
    jsave(tmp_path / "j", 3, arrays, num_shards=3, meta={"next_step": 3})
    got = json.loads((tmp_path / "t/step_00000003/manifest.json").read_text())
    want = json.loads((tmp_path / "j/step_00000003/manifest.json").read_text())
    assert set(got["shard_sha256"]) == {"shard_0.pt", "shard_1.pt",
                                        "shard_2.pt"}
    del got["shard_sha256"]
    assert got == want
    back, meta = restore_checkpoint(tmp_path / "t", tree)
    assert meta == {"next_step": 3} and back["none"] is None
    assert isinstance(back["pair"], tuple)
    for (a, b) in zip(jax.tree_util.tree_leaves(arrays),
                      jax.tree_util.tree_leaves(
                          jax.tree.map(np.asarray, back))):
        assert np.asarray(a).tobytes() == b.tobytes()


def test_gemma2_smoke_params_round_trip_bitwise(tmp_path):
    """The port's gemma2-2b smoke parameters (bf16) through a sharded
    save and restore: bit for bit the tensors saved, and the same bits
    as the reference's checkpoint of the same weights, restored."""
    jp = jax.tree.map(np.asarray, JM.init_params(
        jax.random.key(0), jconfigs.get_smoke("gemma2-2b")))
    state = params_from_jax(jp)
    assert any(t.dtype == torch.bfloat16 for t in state.values())
    ck = AsyncCheckpointer(tmp_path / "t", num_shards=2)
    ck.save(1, state, meta={"next_step": 1})
    ck.wait()
    like = {k: torch.empty_like(t) for k, t in state.items()}
    back, _ = restore_checkpoint(tmp_path / "t", like, device="cpu")
    jsave(tmp_path / "j", 1, jp, num_shards=2)
    jback, _ = jrestore(tmp_path / "j", jp)
    ref = params_from_jax(jback)
    assert list(back) == list(state)
    for k, t in state.items():
        got = back[k]
        assert got.dtype == t.dtype and got.shape == t.shape, k
        if t.dtype == torch.bfloat16:
            assert torch.equal(got.view(torch.int16), t.view(torch.int16))
            assert torch.equal(got.view(torch.int16),
                               ref[k].view(torch.int16)), k
        else:
            assert got.numpy().tobytes() == ref[k].numpy().tobytes(), k
    # one leaf against the reference's raw numpy bits directly
    emb = back["embed"].view(torch.int16).numpy().view(np.uint16)
    assert np.array_equal(emb, np.asarray(jback["embed"]).view(np.uint16))
