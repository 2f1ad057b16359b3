"""Sharded, atomic, async checkpointing of trees of tensors.

Layout: <dir>/step_<N>/
    manifest.json          tree structure + leaf shapes/dtypes + meta,
                           and each shard file's sha256
    shard_<k>.pt           leaf tensors owned by host k (``torch.save``;
                           leaves are assigned round-robin by size)
    _COMMITTED             written last -> atomicity marker

A tree is nested ``dict`` / ``list`` / ``tuple`` with tensor leaves
(numpy arrays and scalars are stored as tensors).  Leaf paths use the
``keystr`` form (``"['blocks'][0]['w']"``), dict keys in sorted order,
so a manifest lists the same leaves, shapes, dtypes and shard owners as
the reference package's for the same tree.  bf16 is stored natively.

Fault-tolerance properties exercised by tests:
  * atomic: a crash mid-save leaves no _COMMITTED marker; restore picks
    the newest committed step and ignores partial directories.
  * async: ``AsyncCheckpointer`` copies to host memory synchronously
    and writes on a background thread — the train loop blocks only for
    the copy, not the I/O.
  * integrity: ``torch.load`` does not check the CRC of a stored entry,
    so a flipped payload byte would decode as other values; restore
    checks each shard's sha256 against the manifest before loading it
    and raises ``CheckpointCorruptError`` on any mismatch.
  * elastic: restore takes the *tree*, not the placement — leaves come
    back on the device the caller names (by default each where its
    ``tree_like`` leaf lives).
"""
from __future__ import annotations

import hashlib
import io
import json
import os
import shutil
import threading
from pathlib import Path

import numpy as np
import torch

_MARKER = "_COMMITTED"


class CheckpointCorruptError(RuntimeError):
    """A committed checkpoint could not be restored intact: truncated or
    bit-flipped shard file, unparseable manifest, missing leaf, shape or
    byte-count mismatch.  Typed so recovery code
    (``FaultTolerantLoop.resume_or_init``) can fall back to the newest
    *intact* checkpoint instead of crashing — while genuine programming
    errors (a tree_like that doesn't match the run) still surface with
    the full underlying cause chained."""


# ---------------------------------------------------------------------------
# the tree flattener (dict / list / tuple; keystr paths)
# ---------------------------------------------------------------------------


def _flatten(tree, prefix: str = ""):
    """[(keystr path, leaf)] in the reference's flatten order: dict keys
    sorted, sequences in order, ``None`` an empty subtree."""
    if tree is None:
        return []
    if isinstance(tree, dict):
        out = []
        for k in sorted(tree):
            out += _flatten(tree[k], f"{prefix}[{k!r}]")
        return out
    if isinstance(tree, (list, tuple)):
        out = []
        for i, v in enumerate(tree):
            out += _flatten(v, f"{prefix}[{i}]")
        return out
    return [(prefix, tree)]


def _unflatten(like, by_path: dict, prefix: str = ""):
    """``like``'s structure with each leaf replaced by ``by_path[its
    keystr path]`` (the caller's dict order kept)."""
    if like is None:
        return None
    if isinstance(like, dict):
        return {k: _unflatten(v, by_path, f"{prefix}[{k!r}]")
                for k, v in like.items()}
    if isinstance(like, (list, tuple)):
        vals = [_unflatten(v, by_path, f"{prefix}[{i}]")
                for i, v in enumerate(like)]
        if isinstance(like, list):
            return vals
        return type(like)(*vals) if hasattr(like, "_fields") else tuple(vals)
    return by_path[prefix]


def _as_tensor(v) -> torch.Tensor:
    if isinstance(v, torch.Tensor):
        return v
    return torch.as_tensor(np.asarray(v))


def _dtype_name(t: torch.Tensor) -> str:
    """numpy's name for the dtype (``float32``, ``bfloat16``, ``int32``)."""
    return str(t.dtype).removeprefix("torch.")


def _host(tree, *, copy: bool = False) -> list:
    """[(path, host tensor)]: leaves copied to host memory (host leaves
    too when ``copy``), one ``torch.cuda.synchronize`` when any leaf
    lives on a card."""
    leaves = [(p, _as_tensor(v)) for p, v in _flatten(tree)]
    host = [(p, t.detach().to("cpu", non_blocking=True, copy=copy))
            for p, t in leaves]
    if any(t.device.type == "cuda" for _, t in leaves):
        torch.cuda.synchronize()
    return host


def _digest(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


# ---------------------------------------------------------------------------
# save / restore
# ---------------------------------------------------------------------------


def _save_host(ckpt_dir, step: int, leaves, *, num_shards: int,
               meta: dict | None):
    ckpt_dir = Path(ckpt_dir)
    final = ckpt_dir / f"step_{step:08d}"
    tmp = ckpt_dir / f".tmp_step_{step:08d}"
    if tmp.exists():
        shutil.rmtree(tmp)
    tmp.mkdir(parents=True)
    nbytes = [t.numel() * t.element_size() for _, t in leaves]
    # round-robin-by-size shard assignment
    order = sorted(range(len(leaves)), key=lambda i: -nbytes[i])
    owner = {}
    loads = [0] * num_shards
    for i in order:
        k = loads.index(min(loads))
        owner[i] = k
        loads[k] += nbytes[i]
    digests = {}
    for k in range(num_shards):
        blob = io.BytesIO()
        torch.save({f"leaf_{i}": t.contiguous()
                    for i, (_, t) in enumerate(leaves) if owner[i] == k},
                   blob)
        data = blob.getvalue()
        (tmp / f"shard_{k}.pt").write_bytes(data)
        digests[f"shard_{k}.pt"] = _digest(data)
    manifest = {
        "step": step,
        "meta": meta or {},
        "leaves": [{"path": p, "shape": list(t.shape),
                    "dtype": _dtype_name(t), "shard": owner[i]}
                   for i, (p, t) in enumerate(leaves)],
        "num_shards": num_shards,
        "shard_sha256": digests,
    }
    (tmp / "manifest.json").write_text(json.dumps(manifest))
    (tmp / _MARKER).write_text("ok")
    if final.exists():
        shutil.rmtree(final)
    os.replace(tmp, final)
    return final


def save_checkpoint(ckpt_dir, step: int, tree, *, num_shards: int = 1,
                    meta: dict | None = None):
    """Synchronous sharded atomic save (host 0 API; in multi-host each
    host writes its own shard file — simulated here by writing all)."""
    return _save_host(ckpt_dir, step, _host(tree), num_shards=num_shards,
                      meta=meta)


def committed_steps(ckpt_dir) -> list[int]:
    """Committed step numbers, newest first (the fallback walk order
    for ``FaultTolerantLoop.resume_or_init``)."""
    ckpt_dir = Path(ckpt_dir)
    if not ckpt_dir.exists():
        return []
    steps = []
    for d in ckpt_dir.iterdir():
        if d.name.startswith("step_") and (d / _MARKER).exists():
            steps.append(int(d.name.split("_")[1]))
    return sorted(steps, reverse=True)


def latest_step(ckpt_dir) -> int | None:
    steps = committed_steps(ckpt_dir)
    return steps[0] if steps else None


def _load_shard(d: Path, name: str, want: str) -> dict:
    data = (d / name).read_bytes()
    if _digest(data) != want:
        raise CheckpointCorruptError(
            f"shard {name} in {d}: sha256 does not match the manifest")
    out = torch.load(io.BytesIO(data), map_location="cpu",
                     weights_only=True)
    if not isinstance(out, dict):
        raise CheckpointCorruptError(f"shard {name} in {d} holds "
                                     f"{type(out).__name__}, not a dict")
    return out


def restore_checkpoint(ckpt_dir, tree_like, step: int | None = None, *,
                       device=None):
    """Returns (tree of tensors shaped like ``tree_like``, meta).

    Each leaf is placed on ``device`` when given, else where the
    matching ``tree_like`` leaf lives (the host for non-tensor leaves).
    Raises ``CheckpointCorruptError`` when the committed step's files
    are damaged (truncated or altered shard, flipped manifest bytes,
    missing or misshapen leaf)."""
    ckpt_dir = Path(ckpt_dir)
    if step is None:
        step = latest_step(ckpt_dir)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {ckpt_dir}")
    d = ckpt_dir / f"step_{step:08d}"
    try:
        manifest = json.loads((d / "manifest.json").read_text())
        num_shards = int(manifest["num_shards"])
        digests = dict(manifest["shard_sha256"])
        leaves_meta = {m["path"]: (i, m) for i, m in
                       enumerate(manifest["leaves"])}
    except (OSError, ValueError, KeyError, TypeError) as e:
        raise CheckpointCorruptError(
            f"unreadable manifest in {d}: {e!r}") from e
    shards = {}
    try:
        for k in range(num_shards):
            name = f"shard_{k}.pt"
            if name not in digests:
                raise CheckpointCorruptError(
                    f"manifest in {d} has no digest for {name}")
            shards.update(_load_shard(d, name, digests[name]))
    except CheckpointCorruptError:
        raise
    except Exception as e:  # zipfile/torch.load raise a zoo of types
        raise CheckpointCorruptError(  # on truncation and bad records
            f"unreadable shard in {d}: {e!r}") from e
    out = {}
    for path, like in _flatten(tree_like):
        if path not in leaves_meta:
            raise CheckpointCorruptError(
                f"checkpoint {d} missing leaf {path}")
        i, m = leaves_meta[path]
        t = shards.get(f"leaf_{i}")
        if not isinstance(t, torch.Tensor):
            raise CheckpointCorruptError(
                f"checkpoint {d} shard files missing array for {path}")
        try:
            shape = tuple(int(s) for s in m["shape"])
            dtype_ok = _dtype_name(t) == str(m["dtype"])
        except (ValueError, TypeError, KeyError) as e:
            raise CheckpointCorruptError(
                f"checkpoint {d} leaf {path} undecodable: {e!r}") from e
        if not dtype_ok or tuple(t.shape) != shape:
            raise CheckpointCorruptError(
                f"checkpoint {d} leaf {path}: stored {_dtype_name(t)} "
                f"{tuple(t.shape)}, manifest {m['dtype']} {shape}")
        want = tuple(getattr(like, "shape", t.shape))
        if tuple(t.shape) != want:
            raise CheckpointCorruptError(
                f"checkpoint {d} leaf {path} shape {tuple(t.shape)} != "
                f"{want}")
        dev = device if device is not None else (
            like.device if isinstance(like, torch.Tensor) else "cpu")
        out[path] = t.to(dev)
    return _unflatten(tree_like, out), manifest["meta"]


class AsyncCheckpointer:
    """Overlaps checkpoint I/O with training (one in flight at a time)."""

    def __init__(self, ckpt_dir, num_shards: int = 1):
        self.ckpt_dir = Path(ckpt_dir)
        self.num_shards = num_shards
        self._thread: threading.Thread | None = None
        self.last_error: Exception | None = None

    def save(self, step: int, tree, meta=None):
        self.wait()
        # blocking part: device -> host (host leaves copied too, so the
        # loop may update them in place while the write runs)
        leaves = _host(tree, copy=True)

        def _write():
            try:
                _save_host(self.ckpt_dir, step, leaves,
                           num_shards=self.num_shards, meta=meta)
            except Exception as e:   # surfaced on next wait()
                self.last_error = e

        self._thread = threading.Thread(target=_write, daemon=True)
        self._thread.start()

    def wait(self):
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self.last_error is not None:
            e, self.last_error = self.last_error, None
            raise e
