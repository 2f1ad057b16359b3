"""The traffic generators: the same seed gives the same inputs, other
seeds other inputs but the same work."""
import numpy as np

from perfbench import harness
from perfbench.traffic import packed_docs, prompts

SEED = 2 ** 33 + 12345
TRAIN = harness.workload("smollm-360m.train")["params"]
PREFILL = harness.workload("jamba2-mini.prefill")["params"]


def _steps(seed, n=3, **kw):
    s = packed_docs.Stream(TRAIN, seed, 49152, **kw)
    return [s.next() for _ in range(n)]


def test_packed_docs_deterministic_in_seed():
    a, b = _steps(SEED), _steps(SEED)
    for x, y in zip(a, b):
        assert np.array_equal(x["tokens"], y["tokens"])
    c = _steps(SEED + 1)
    assert not np.array_equal(a[0]["tokens"], c[0]["tokens"])


def test_packed_docs_rows_all_differ_and_shift():
    rows = np.concatenate([b["tokens"] for b in _steps(SEED)])
    assert rows.shape == (3 * TRAIN["batch"], TRAIN["seq"])
    assert len({r.tobytes() for r in rows}) == rows.shape[0]
    b = _steps(SEED, 1)[0]
    assert np.array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])
    assert b["tokens"].min() >= 0 and b["tokens"].max() < 49152


def test_packed_docs_ranks_take_disjoint_rows_of_one_stream():
    whole = packed_docs.Stream(dict(TRAIN, batch=4 * TRAIN["batch"]), SEED,
                               49152).next()["tokens"]
    for r in range(4):
        mine = _steps(SEED, 1, rank=r, world=4)[0]["tokens"]
        B = TRAIN["batch"]
        assert np.array_equal(mine, whole[r * B:(r + 1) * B])


def test_packed_docs_documents_are_heavy_tailed():
    s = packed_docs.Stream(TRAIN, SEED, 49152)
    lens = [s._doc().size for _ in range(4000)]
    assert min(lens) >= TRAIN["doc_len_min"] + 1
    assert np.percentile(lens, 99) > 20 * np.median(lens)


def test_prompts_same_work_for_every_seed():
    grid = prompts.length_grid(PREFILL)
    assert len(grid) == PREFILL["grid"]
    assert all(n % PREFILL["round_to"] == 0 for n in grid)
    assert PREFILL["len_min"] <= min(grid) and max(grid) <= PREFILL["len_max"]
    for seed in (SEED, SEED + 1, 7):
        s = prompts.Stream(PREFILL, seed, 65536)
        got = sorted(s.next().size for _ in range(len(grid)))
        assert got == sorted(grid)


def test_prompts_deterministic_in_seed():
    a = prompts.Stream(PREFILL, SEED, 65536)
    b = prompts.Stream(PREFILL, SEED, 65536)
    c = prompts.Stream(PREFILL, SEED + 1, 65536)
    xa, xb, xc = a.next(), b.next(), c.next()
    assert np.array_equal(xa, xb)
    assert xa.size != xc.size or not np.array_equal(xa, xc)
