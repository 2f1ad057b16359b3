"""The flash-attention kernel's tile classes against a brute-force mask.

``tile_classes`` (``kernels/attention/kernel.py``, mirrored line for line
by ``kv_range`` in ``csrc/flash_attention.cu``) tells the Hopper body,
for each q tile, which kv tiles it visits and which of those are
interior (no mask at all).  Held here, on the CPU, against the live
mask of the reference (causal ``u <= t``, window ``u > t - window``,
keys below Sk): every skipped (q tile, kv tile) pair holds only masked
scores, a pair is interior exactly when it holds only live scores and
no key past Sk, and a q tile with a row that has no live key visits
every kv tile (such a row weighs every key equally, as the reference
does).
"""
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from repro_torch.kernels.attention.kernel import (WGMMA_BQ, tile_classes,
                                                  wgmma_bk)


def _live(Sq, Sk, causal, window):
    t = np.arange(Sq)[:, None]
    u = np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), dtype=bool)
    if causal:
        live &= u <= t
    if window is not None:
        live &= u > t - window
    return live


def _check(Sq, Sk, bq, bk, causal, window):
    live = _live(Sq, Sk, causal, window)
    nk = -(-Sk // bk)
    classes = tile_classes(Sq, Sk, bq, bk, causal, window)
    assert len(classes) == -(-Sq // bq)
    for qt, (j_lo, j_hi, i_lo, i_hi) in enumerate(classes):
        rows = live[qt * bq:(qt + 1) * bq]
        where = f"Sq={Sq} Sk={Sk} bq={bq} bk={bk} causal={causal} " \
                f"window={window} q tile {qt}"
        assert 0 <= j_lo < j_hi <= nk, where
        assert j_lo <= i_lo <= i_hi <= j_hi, where
        if not rows.any(axis=1).all():          # a row with no live key
            assert (j_lo, j_hi) == (0, nk), where
        for j in range(nk):
            block = rows[:, j * bk:(j + 1) * bk]
            whole = (j + 1) * bk <= Sk
            if not j_lo <= j < j_hi:
                assert not block.any(), f"{where}: skipped tile {j} is live"
            assert (i_lo <= j < i_hi) == (whole and bool(block.all())), \
                f"{where}: kv tile {j} interior is {i_lo <= j < i_hi}"


CASES = [
    # (Sq, Sk, causal, window)
    (1024, 1024, True, None),
    (1024, 1024, True, 64),
    (1024, 1024, False, None),
    (1024, 1024, False, 100),
    (200, 40, True, 8),            # rows with no live key
    (200, 40, False, 8),
    (160, 160, True, 1),           # window 1: the diagonal only
    (300, 200, True, 1),
    (300, 300, True, 2),           # a window edge one key before a tile
    (400, 400, False, 66),
    (128, 400, False, 127),        # the last row's window starts at key 1
    (160, 160, True, 500),         # window >= Sk
    (97, 300, False, 300),
    (300, 97, True, None),         # Sq > Sk, ragged
    (97, 300, True, None),         # Sq < Sk
    (8192, 8192, True, 4096),      # gemma2-2b's local layer
]


@pytest.mark.parametrize("bk", [64, 80, 128])
@pytest.mark.parametrize("Sq,Sk,causal,window", CASES)
def test_tile_classes_match_the_mask(Sq, Sk, causal, window, bk):
    _check(Sq, Sk, WGMMA_BQ, bk, causal, window)


@settings(max_examples=300, deadline=None)
@given(Sq=st.integers(1, 600), Sk=st.integers(1, 600),
       bq=st.sampled_from([64, 128]), bk=st.sampled_from([64, 80, 128]),
       causal=st.booleans(),
       window=st.one_of(st.none(), st.integers(1, 700)))
def test_tile_classes_match_the_mask_swept(Sq, Sk, bq, bk, causal, window):
    _check(Sq, Sk, bq, bk, causal, window)


@pytest.mark.parametrize("D,bk", [(64, 128), (128, 128), (136, 64),
                                  (256, 64)])
def test_kv_tile_width_by_head_dim(D, bk):
    assert wgmma_bk(D) == bk
