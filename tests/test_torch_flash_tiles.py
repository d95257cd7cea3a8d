"""The flash kernel's tile classes, dtype routing and alignment predicate,
on the CPU.

``flash_attention.tile_class`` is the rule that the CUDA kernel mirrors to
skip a (q tile, kv tile) pair, run it without a mask, or mask it element by
element. Each case here checks it by brute force against the mask itself:
a SKIP tile has no (q, k) pair that attends, a FULL tile has every pair
attend (keys past Sk count as not attending), and a PARTIAL tile has some
pairs that attend and some that do not. q rows past Sq are not part of a
tile (the kernel does not write them)."""
import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

# (Sq, Sk, causal, window, chunk): the card sweep's masks, the tensor-core
# cases' edges (window 300, chunk 100, ragged S), and their mixes
MASKS = [
    (256, 256, True, 0, 0),
    (512, 512, False, 0, 0),
    (1024, 1024, True, 256, 0),
    (1024, 1024, True, 0, 256),
    (1024, 1024, True, 300, 0),
    (512, 512, True, 0, 100),
    (200, 200, False, 0, 100),
    (333, 333, True, 0, 0),
    (300, 300, True, 128, 0),
    (1000, 1000, True, 0, 0),
    (100, 100, False, 0, 0),
    (2048, 2048, True, 2048, 0),
    (512, 512, True, 100, 64),
    (700, 700, True, 130, 200),
    (400, 400, False, 50, 0),
    (400, 400, False, 60, 96),
    (257, 300, True, 0, 0),
    (300, 257, False, 33, 70),
    (129, 129, True, 0, 0),      # the backward's card cases: one row past a 128 tile,
    (191, 191, True, 0, 0),      # 63 rows past one,
    (512, 512, True, 130, 0),    # a window of 130,
    (300, 300, True, 0, 100),    # a chunk of 100
]
# (block_q, block_k): the kernels' tiles (f32 64 x 64; bf16 forward 128 x
# 128 at d_head <= 128, 128 x 64 at 256, each consumer warpgroup's 64 rows;
# bf16 backward 64 x 128 a dK / dV step, 128 x 64 a dQ step, 64 x 64 a
# warpgroup's share of either) and odd sizes that do not divide the masks'
# edges
TILES = [(64, 64), (128, 128), (128, 64), (64, 128), (64, 32), (48, 80)]


def _mask(Sq, Sk, causal, window, chunk):
    q = np.arange(Sq)[:, None]
    k = np.arange(Sk)[None, :]
    m = np.ones((Sq, Sk), bool)
    if causal:
        m &= q >= k
    if window:
        m &= (q - k) < window
    if chunk:
        m &= (q // chunk) == (k // chunk)
    return m


@pytest.mark.parametrize("tile", TILES)
@pytest.mark.parametrize("mask", MASKS)
def test_tile_class_matches_brute_force(mask, tile):
    Sq, Sk, causal, window, chunk = mask
    bq, bk = tile
    m = _mask(Sq, Sk, causal, window, chunk)
    seen = set()
    for q0 in range(0, Sq, bq):
        for k0 in range(0, Sk + bk, bk):  # one tile wholly past Sk too
            # the tile's pairs: real q rows, every key of the tile (past Sk: no)
            pairs = np.zeros((min(q0 + bq, Sq) - q0, bk), bool)
            if k0 < Sk:
                part = m[q0:q0 + bq, k0:k0 + bk]
                pairs[:, :part.shape[1]] = part
            cls = fa.tile_class(q0, bq, k0, bk, Sq, Sk,
                                causal=causal, window=window, chunk=chunk)
            want = fa.SKIP if not pairs.any() else fa.FULL if pairs.all() else fa.PARTIAL
            assert cls == want, (q0, k0, cls, want)
            seen.add(cls)
    assert fa.PARTIAL in seen or fa.FULL in seen


def test_tile_class_counts_at_the_main_path():
    """Causal at S 2048 with 128 x 128 tiles: only the 16 diagonal tiles are
    partial, the 120 below them full, the 120 above skipped; the window of
    2048 (recurrentgemma-9b) changes nothing at that length."""
    for window in (0, 2048):
        counts = {fa.SKIP: 0, fa.FULL: 0, fa.PARTIAL: 0}
        for q0 in range(0, 2048, 128):
            for k0 in range(0, 2048, 128):
                counts[fa.tile_class(q0, 128, k0, 128, 2048, 2048,
                                     causal=True, window=window, chunk=0)] += 1
        assert counts == {fa.SKIP: 120, fa.FULL: 120, fa.PARTIAL: 16}


def test_designs_route_by_dtype():
    assert fa.DESIGNS == {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core f32"}
    assert set(fa.DESIGNS) == set(fa.DTYPES)


@pytest.mark.parametrize("make,aligned", [
    (lambda: torch.zeros((2, 8, 4, 64), dtype=torch.bfloat16), True),
    (lambda: torch.zeros((2, 8, 12, 64), dtype=torch.bfloat16)[:, :, 4:6], True),
    (lambda: torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16)[..., 8:], True),
    (lambda: torch.zeros((1, 8, 2, 65), dtype=torch.bfloat16)[..., 1:], False),
    (lambda: torch.zeros((1, 8, 2, 72), dtype=torch.bfloat16)[..., 4:68], False),
    (lambda: torch.zeros((1, 8, 3, 20), dtype=torch.bfloat16)[..., :16], False),
    (lambda: torch.zeros((1, 8, 2, 68), dtype=torch.float32)[..., 4:], True),
    (lambda: torch.zeros((1, 8, 2, 66), dtype=torch.float32)[..., 2:], False),
])
def test_alignment_predicate(make, aligned):
    t = make()
    assert fa.aligned_for_tma(t) is aligned


def test_cpu_path_takes_misaligned_views():
    """The alignment check guards the tensor-core kernel only: on the CPU a
    misaligned bf16 view goes to the plain version like any other."""
    rng = np.random.default_rng(0)
    big = torch.from_numpy(rng.standard_normal((1, 16, 3, 65), np.float32)).bfloat16()
    q = big[:, :, :2, 1:]
    kv = big[:, :, 2:, 1:]
    assert not fa.aligned_for_tma(q)
    before = fa.launches
    got = fa.flash_attention(q, kv, kv)
    assert fa.launches == before
    want = fa.flash_attention(q.contiguous(), kv.contiguous(), kv.contiguous())
    assert torch.equal(got, want)
