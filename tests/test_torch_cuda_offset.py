"""The flash kernel's query offset on the card (``q_start``): output row t
of a block of rows sits at position ``q_start + t`` of the keys.

Marked ``cuda``: skips without an NVIDIA GPU (the kernels are built by
nvcc on first use).  Imports torch and the port only, so it runs on the
machine with the card:

    PYTHONPATH=src python -m pytest -m cuda tests/test_torch_cuda_offset.py

- a sequence cut into 4 blocks of rows, each run with its offset: within
  the reference's kernel tolerance (3e-5 f32, 2e-2 bf16) of
  ``flash_attention_plain`` with the same offset, and bitwise the same
  rows of the whole call where the offset is a multiple of the body's
  q tile (128 rows on the wgmma body, 64 on the CUDA-core body: the
  same tiles walk the same kv tiles in the same order); bf16 blocks on
  the wgmma body (head dims 64 / 128 / 256, GQA, causal, window,
  softcap), f32 on the CUDA-core body;
- offsets off the tile (a block of 96 rows at 160) and the gather
  prologue with an offset, against the plain version.
"""
import pytest

torch = pytest.importorskip("torch")

from repro_torch import cuda
from repro_torch.kernels.attention import ops as attn_ops
from repro_torch.kernels.attention.kernel import flash_attention_plain

pytestmark = pytest.mark.cuda

TOL = {torch.float32: 3e-5, torch.bfloat16: 2e-2}


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the CUDA kernels run only there)")
    return torch.device("cuda")


def _qkv(dev, dtype, B, S, H, K, D, seed):
    g = torch.Generator(device=dev)
    g.manual_seed(seed)
    return (torch.randn((B, S, H, D), generator=g, device=dev, dtype=dtype),
            torch.randn((B, S, K, D), generator=g, device=dev, dtype=dtype),
            torch.randn((B, S, K, D), generator=g, device=dev, dtype=dtype))


@pytest.mark.parametrize("dtype,D,H,K,window,cap", [
    (torch.bfloat16, 64, 4, 2, None, None),
    (torch.bfloat16, 128, 4, 4, 300, 50.0),
    (torch.bfloat16, 256, 8, 4, None, 50.0),
    (torch.bfloat16, 64, 6, 1, 700, None),
    (torch.float32, 64, 4, 2, None, 30.0),
    (torch.float32, 32, 2, 1, 100, None),
])
def test_offset_blocks_match_plain_and_whole(dev, dtype, D, H, K, window,
                                             cap):
    B, S, n = 2, 1024, 4
    q, k, v = _qkv(dev, dtype, B, S, H, K, D, D + H)
    whole = attn_ops.flash_attention(q, k, v, True, window, cap)
    blk = S // n
    want_body = "wgmma" if dtype == torch.bfloat16 else "cuda_cores"
    for r in range(n):
        before = dict(cuda.FLASH_BODIES)
        got = attn_ops.flash_attention(q[:, r * blk:(r + 1) * blk], k, v,
                                       True, window, cap, q_start=r * blk)
        torch.cuda.synchronize()
        assert cuda.FLASH_BODIES[want_body] == before[want_body] + 1
        want = flash_attention_plain(q[:, r * blk:(r + 1) * blk], k, v,
                                     causal=True, window=window,
                                     softcap=cap, q_start=r * blk)
        torch.testing.assert_close(got.float(), want.float(),
                                   atol=TOL[dtype], rtol=TOL[dtype])
        assert torch.equal(got, whole[:, r * blk:(r + 1) * blk]), r


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_offset_off_the_tile(dev, dtype):
    q, k, v = _qkv(dev, dtype, 1, 512, 4, 2, 64, 3)
    qb = q[:, 160:256]
    got = attn_ops.flash_attention(qb, k, v, True, 200, 50.0, None, 96, 128,
                                   q_start=160)
    want = flash_attention_plain(qb, k, v, causal=True, window=200,
                                 softcap=50.0, q_start=160)
    torch.testing.assert_close(got.float(), want.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])


def test_offset_gather(dev):
    q, k, v = _qkv(dev, torch.bfloat16, 2, 1024, 4, 2, 64, 5)
    qb = q[:, 512:768]
    g = torch.Generator(device=dev)
    g.manual_seed(9)
    rows = torch.stack([torch.randperm(256, generator=g, device=dev)
                        for _ in range(2)]).to(torch.int32)
    rows[:, ::8] = -1
    got = attn_ops.flash_attention(qb, k, v, True, None, None, q_rows=rows,
                                   q_start=512)
    want = flash_attention_plain(qb, k, v, causal=True, q_rows=rows,
                                 q_start=512)
    torch.testing.assert_close(got.float(), want.float(), atol=2e-2,
                               rtol=2e-2)
    assert bool((got[rows < 0] == 0).all())
