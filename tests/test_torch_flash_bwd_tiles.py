"""The bf16 flash backward's persistent grid, on the CPU.

``flash_attention.bwd_items`` and ``persistent_rounds`` mirror the order in
which the dK / dV and dQ kernels' persistent grids take their items. Each
case checks that the blocks together take every (tile, head, batch) item
exactly once and that, under a causal mask, the items come heaviest first:
an item's work is the number of (head, 64-row step) pairs that
``tile_class`` does not skip, which the kernel walks."""
import pytest
import torch

from repro_torch.kernels import flash_attention as fa

R, ITEM = fa.BWD_ROWS, fa.BWD_ITEM

# (B, S, H, KV, causal, window, chunk): rsc-llm training, the card cases'
# ragged S and mask edges, MQA, and a mask without causality
SHAPES = [
    (2, 2048, 32, 8, True, 0, 0),
    (1, 333, 4, 2, False, 0, 0),
    (1, 300, 4, 2, True, 100, 0),
    (1, 129, 4, 2, True, 0, 0),
    (1, 191, 4, 2, True, 0, 0),
    (1, 512, 8, 1, True, 130, 0),
    (2, 100, 4, 2, True, 0, 0),
    (1, 96, 2, 1, True, 0, 50),
    (1, 1024, 2, 2, True, 0, 256),
]
# the card's SM count and grids smaller and larger than a shape's items
BLOCKS = [132, 7, 1]


def _work(kind, item, shape):
    """(head, 64-row step) pairs of an item that tile_class does not skip."""
    B, S, H, KV, causal, window, chunk = shape
    start = item[0]
    kw = dict(causal=causal, window=window, chunk=chunk)
    if kind == "dkdv":
        steps = sum(fa.tile_class(q0, R, start, ITEM, S, S, **kw) != fa.SKIP
                    for q0 in range(0, S, R))
        return steps * (H // KV)
    return sum(fa.tile_class(start, ITEM, k0, R, S, S, **kw) != fa.SKIP
               for k0 in range(0, S, R))


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("kind", ["dkdv", "dq"])
@pytest.mark.parametrize("shape", SHAPES)
def test_persistent_grid_takes_every_item_once(shape, kind, n_blocks):
    B, S, H, KV, causal = shape[:5]
    items = fa.bwd_items(kind, B, S, S, H, KV, causal=causal)
    heads = KV if kind == "dkdv" else H
    want = {(t, h, b) for t in range(0, S, ITEM) for h in range(heads) for b in range(B)}
    assert len(items) == len(want) and set(items) == want
    grid = min(len(items), n_blocks)  # as the launch: min(items, SMs)
    taken = [i for mine in fa.persistent_rounds(len(items), grid) for i in mine]
    assert sorted(taken) == list(range(len(items)))


@pytest.mark.parametrize("kind", ["dkdv", "dq"])
@pytest.mark.parametrize("shape", [s for s in SHAPES if s[4] and not s[5] and not s[6]])
def test_causal_items_come_heaviest_first(shape, kind):
    """Under a plain causal mask (ragged S included) the order is by work;
    a window or chunk makes the items' work nearly even, and the kernels
    keep the same order there."""
    B, S, H, KV, causal = shape[:5]
    work = [_work(kind, it, shape) for it in fa.bwd_items(kind, B, S, S, H, KV, causal=causal)]
    assert work == sorted(work, reverse=True)


def test_training_shape_items_and_rounds():
    """rsc-llm training (B 2, S 2048, 8 kv heads, G 4) on 132 SMs: 256 dK / dV
    items, key tile j doing 4 (32 - 2 j) steps; the two rounds pair a block's
    heavy item with a light one, so every block does 128 to 136 steps (the
    mean is 131.9)."""
    shape = (2, 2048, 32, 8, True, 0, 0)
    items = fa.bwd_items("dkdv", 2, 2048, 2048, 32, 8, causal=True)
    assert len(items) == 256
    work = [_work("dkdv", it, shape) for it in items]
    assert work[0] == 128 and work[-1] == 8 and sum(work) == 17408
    per_block = [sum(work[i] for i in mine) for mine in fa.persistent_rounds(256, 132)]
    assert max(per_block) == 136 and min(per_block) == 128
    dq = fa.bwd_items("dq", 2, 2048, 2048, 32, 8, causal=True)
    assert len(dq) == 1024 and dq[0] == (1920, 0, 0) and dq[-1] == (0, 31, 1)


def test_bwd_items_rejects_an_unknown_kind():
    with pytest.raises(ValueError, match="kind"):
        fa.bwd_items("dv", 1, 64, 64, 2, 1, causal=True)


def test_backward_designs_route_by_dtype():
    assert fa.BWD_DESIGNS == {torch.bfloat16: "wgmma+tma", torch.float32: "cuda-core f32"}
    assert set(fa.BWD_DESIGNS) == set(fa.DTYPES)
    assert fa.HEAD_DIMS == (16, 32, 64, 128, 256)  # the backward takes each


# (B, S, H, KV, causal, window, chunk) at D 256: recurrentgemma-9b training
# (MQA, window 2048 = S), a window shorter than S, a ragged S, GQA, and a
# shape whose items need no head split
SHAPES_256 = [
    (2, 2048, 16, 1, True, 2048, 0),
    (1, 4096, 16, 1, True, 2048, 0),
    (1, 300, 4, 1, True, 128, 0),
    (1, 333, 4, 2, False, 0, 0),
    (4, 2048, 2, 2, True, 0, 0),
]


def _work_256(item, shape):
    """(head, 64-row step) pairs of a D 256 dK / dV item."""
    B, S, H, KV, causal, window, chunk = shape
    kw = dict(causal=causal, window=window, chunk=chunk)
    split = fa.bwd_split(256, B, S, H, KV)
    steps = sum(fa.tile_class(q0, R, item[0], R, S, S, **kw) != fa.SKIP for q0 in range(0, S, R))
    return steps * (H // KV // split)


@pytest.mark.parametrize("n_blocks", BLOCKS)
@pytest.mark.parametrize("shape", SHAPES_256)
def test_d256_items_cover_every_key_half_and_head_group_once(shape, n_blocks):
    """At D 256 a dK / dV item is 64 keys, one half of D and one group of
    the kv head's query heads; a dQ item 64 q rows.  The persistent grid
    takes each once."""
    B, S, H, KV, causal = shape[:5]
    split = fa.bwd_split(256, B, S, H, KV)
    assert (H // KV) % split == 0
    items = fa.bwd_items("dkdv", B, S, S, H, KV, causal=causal, D=256)
    want = {(t, h, b, part, g) for t in range(0, S, R) for h in range(KV) for b in range(B)
            for part in range(2) for g in range(split)}
    assert len(items) == len(want) and set(items) == want
    dq = fa.bwd_items("dq", B, S, S, H, KV, causal=causal, D=256)
    assert set(dq) == {(t, h, b) for t in range(0, S, R) for h in range(H) for b in range(B)}
    for n in (len(items), len(dq)):
        taken = [i for mine in fa.persistent_rounds(n, min(n, n_blocks)) for i in mine]
        assert sorted(taken) == list(range(n))


def test_d256_training_shape_splits_heads_and_balances_the_blocks():
    """recurrentgemma-9b training (B 2, S 2048, 16 / 1 heads, window 2048) on
    132 SMs: 64-key tiles and two halves of D give 128 items, too few for
    the card and as uneven as a causal mask (key tile j sees 32 - j q
    tiles); four head groups make 512 items of 4 (32 - j) steps, and the
    rounds give every block 256 steps."""
    shape = SHAPES_256[0]
    assert fa.bwd_split(256, 2, 2048, 16, 1) == 4 and fa.bwd_split(128, 2, 2048, 16, 1) == 1
    items = fa.bwd_items("dkdv", 2, 2048, 2048, 16, 1, causal=True, D=256)
    work = [_work_256(it, shape) for it in items]
    assert len(items) == 512 and work[0] == 128 and work[-1] == 4 and sum(work) == 33792
    assert work == sorted(work, reverse=True)
    per_block = [sum(work[i] for i in mine) for mine in fa.persistent_rounds(512, 132)]
    assert max(per_block) == min(per_block) == 256
    assert fa.bwd_split(256, 4, 2048, 2, 2) == 1  # 1024 items without a split
