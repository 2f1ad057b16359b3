"""Deterministic, step-addressable, shardable synthetic data pipeline.

Fault-tolerance contract: ``batch(step)`` is a pure function of (seed,
step, shard): any step is replayable after a restart, any shard is
recomputable on a replacement host, and straggler mitigation can hand
a slow host's shard to a fast one without coordination (see
``runtime/straggler.py``).  No state beyond the integer step needs
checkpointing.

The generator is the reference's counter-mode threefry stream
(``data/_threefry.py``, numpy on the host) producing a Zipf-ish token
distribution (so losses move like text, not uniform noise), with
documents separated by BOS and the label masked across the boundary.
The uniforms and the BOS positions are the reference's bit for bit.
A token is ``floor(exp(u * log(V - 2))) + 1`` with ``exp`` computed in
float64 and rounded to float32: XLA's float32 ``exp`` is its own
polynomial, so a token can differ from the reference's where
``exp`` lands within a float32 ulp or two of an integer.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.data import _threefry as tf


@dataclasses.dataclass(frozen=True)
class PipelineConfig:
    vocab_size: int
    seq_len: int
    global_batch: int
    seed: int = 0
    mean_doc_len: int = 512
    bos_id: int = 1


class DataPipeline:
    """Sharded view: this process materializes rows
    [shard * rows_per_shard, (shard+1) * rows_per_shard)."""

    def __init__(self, cfg: PipelineConfig, num_shards: int = 1,
                 shard: int = 0):
        if num_shards < 1 or cfg.global_batch % num_shards:
            raise ValueError(f"a global batch of {cfg.global_batch} rows "
                             f"does not split into {num_shards} shards")
        self.cfg = cfg
        self.num_shards = num_shards
        self.shard = shard
        self.rows = cfg.global_batch // num_shards

    def uniforms(self, step: int) -> tuple[np.ndarray, np.ndarray]:
        """(u, b): this shard's two float32 uniform draws [rows, S], the
        token draw and the document-boundary draw."""
        cfg = self.cfg
        row0 = self.shard * self.rows
        k = tf.fold_in(tf.key(cfg.seed), step)
        keys = tf.split(k, cfg.global_batch)[row0: row0 + self.rows]
        u = np.empty((self.rows, cfg.seq_len), np.float32)
        b = np.empty_like(u)
        for i, (k0, k1) in enumerate(keys):
            sub = tf.split((int(k0), int(k1)), 2)
            u[i] = tf.uniform((int(sub[0, 0]), int(sub[0, 1])), cfg.seq_len)
            b[i] = tf.uniform((int(sub[1, 0]), int(sub[1, 1])), cfg.seq_len)
        return u, b

    def batch(self, step: int, device=None) -> dict:
        """-> dict(tokens [rows, S] int32, labels [rows, S] int32), on
        ``device`` (default the host)."""
        cfg = self.cfg
        u, b = self.uniforms(step)
        c = np.float32(np.log(cfg.vocab_size - 2))
        e = np.exp((u * c).astype(np.float64)).astype(np.float32)
        toks = e.astype(np.int32) + 1
        # doc boundaries: geometric with mean mean_doc_len
        toks = np.where(b < np.float32(1.0 / cfg.mean_doc_len), cfg.bos_id,
                        toks)
        toks = np.clip(toks, 0, cfg.vocab_size - 1).astype(np.int32)
        labels = np.concatenate(
            [toks[:, 1:], np.full((self.rows, 1), -100, np.int32)], 1)
        # mask the label at document boundaries (next token is a new BOS)
        labels = np.where(labels == cfg.bos_id, -100, labels).astype(
            np.int32)
        return {"tokens": torch.from_numpy(toks).to(device),
                "labels": torch.from_numpy(labels).to(device)}

    # -- elasticity ------------------------------------------------------
    def reshard(self, num_shards: int, shard: int) -> "DataPipeline":
        """Same global stream under a different shard decomposition:
        restoring a checkpoint onto a different mesh keeps data exact."""
        return DataPipeline(self.cfg, num_shards, shard)
