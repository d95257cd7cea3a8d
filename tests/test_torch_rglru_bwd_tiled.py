"""The tiled RG-LRU backward (``csrc/rglru_bwd_tiled.cu``) on the CPU: its
order in plain PyTorch (``rglru.rglru_bwd_tiled``: tiles padded with zeros,
a checkpoint of h every 8 steps, h rebuilt per chunk from its checkpoint,
the carry chain, the epilogue) and its grid (``rglru.bwd_grid``).

The mirror must give ``ref.rglru_bwd_ref``'s bits (``torch.equal``): every
operation is one f32 rounding in the same order, which is what lets the
kernel equal the plain version on the card.  It is also held to ``jax.vjp``
of ``repro.kernels.ref.rglru_ref`` within ``tests/test_torch_rglru_bwd.py``'s
tolerance against the sequential oracle (1e-5 max(1, |want|), dlog_a's
scale taking |x ds/dlog_a| too).  Inputs come from numpy with a seed; log_a
is set to exactly 0, -1e-7 and -30 on every other step, or left random."""
import pathlib
import re

import numpy as np
import pytest
import torch

from repro_torch.kernels import ref
from repro_torch.kernels import rglru as kg
from tests.test_torch_rglru_bwd import NAMES, _close, _dl_scale, _want

CSRC = pathlib.Path(kg.__file__).resolve().parent / "csrc" / "rglru_bwd_tiled.cu"

# ragged S (not a multiple of the 24-step tile, or of the 8-step chunk) and
# ragged W (not a multiple of the 32-channel strip)
SHAPES = [(1, 1, 8), (2, 33, 16), (1, 64, 32), (2, 77, 40), (1, 130, 33), (3, 200, 70)]
LOG_A = ["random", 0.0, -1e-7, -30.0]


def _inputs(B, S, W, log_a, x_dtype, la_dtype, seed=0):
    """x, log_a, h0, dO and dh from numpy: x, dO, h0, dh ~ N(0, 1), log_a =
    -softplus(N(0, 1)) with every other step at ``log_a`` unless random."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x = n(B, S, W).to(x_dtype)
    la = -torch.nn.functional.softplus(n(B, S, W))
    if log_a != "random":
        la[:, ::2] = log_a
    return x, la.to(la_dtype), n(B, W), n(B, S, W).to(x_dtype), n(B, W)


@pytest.mark.parametrize("types", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("log_a", LOG_A)
@pytest.mark.parametrize("state", [False, True])
@pytest.mark.parametrize("shape", SHAPES)
def test_mirror_equals_the_plain_backward_to_the_bit(shape, state, log_a, types):
    x, la, h0, do, dh = _inputs(*shape, log_a, *types)
    h0, dh = (h0, dh) if state else (None, None)
    got = kg.rglru_bwd_tiled(x, la, h0, do, dh)
    want = ref.rglru_bwd_ref(x, la, h0, do, dh)
    assert [g.dtype for g in got] == [types[0], types[1], torch.float32]
    for name, g, w in zip(NAMES, got, want):
        assert torch.equal(g, w), name


@pytest.mark.parametrize("mode", ["ref", "zero", "near0", "underflow"])
@pytest.mark.parametrize("with_h0", [False, True])
@pytest.mark.parametrize("shape", [(2, 33, 16), (1, 128, 64), (2, 70, 40)])
def test_mirror_matches_jax_vjp(shape, with_h0, mode):
    """Against jax.vjp of the JAX package's sequential oracle, with
    cotangents on the output and on the final state."""
    from tests.test_torch_rglru_bwd import _inputs as jax_inputs

    x, la, h0, do, dh = (torch.from_numpy(a) for a in jax_inputs(*shape, mode))
    got = kg.rglru_bwd_tiled(x, la, h0 if with_h0 else None, do, dh)
    scales = (0.0, _dl_scale(shape, mode), 0.0)
    for name, g, w, sc in zip(NAMES, got, _want(shape, mode, with_h0, "sequential")[2:],
                              scales):
        _close(g, w, name, 1e-5, sc)


@pytest.mark.parametrize("shape", SHAPES + [(2, 2048, 300), (1, 4097, 65)])
def test_grid_covers_every_element_once(shape):
    """Each (b, t, w) of dx and dlog_a has exactly one owner thread among
    the kernel's blocks, groups, tiles, warps and lanes."""
    grid = kg.bwd_grid(*shape)
    assert grid.blocks == (-(-shape[2] // kg.STRIP), shape[0])
    assert grid.n_tiles * grid.tile >= shape[1] > (grid.n_tiles - 1) * grid.tile
    owners = grid.owners()
    assert owners.shape == shape
    assert (owners == 1).all()


def test_grid_at_the_training_shape_has_at_least_sixteen_warps_an_sm():
    """recurrentgemma-9b training (B 2, S 2048, W 4096): at least 2112
    warps, 16 an SM on average over the H100's 132 SMs, each element once."""
    grid = kg.bwd_grid(2, 2048, 4096)
    assert grid.blocks == (128, 2) and grid.warps_per_block == 16
    assert grid.warps == 4096 >= 16 * 132
    assert (grid.owners() == 1).all()


def test_constants_match_the_kernel_source():
    """The wrapper's mirror of the kernel's strip, groups, warps a group and
    chunk is the kernel's own."""
    src = CSRC.read_text()
    consts = {name: int(v) for name, v in re.findall(r"constexpr int (\w+) = (\d+);", src)}
    assert (consts["NW"], consts["NG"], consts["GW"], consts["C"]) == (
        kg.STRIP, kg.GROUPS, kg.GROUP_WARPS, kg.TILED_CHUNK)
    assert kg.TILE == kg.GROUP_WARPS * kg.TILED_CHUNK


def test_designs_route_by_dtype_and_the_override_is_checked():
    """Both dtypes go to the tiled design; ``kernel=`` takes either design
    (on the CPU both return the plain version and count no launch);
    ``phases`` other than both passes needs the tiled design."""
    assert kg.BWD_DESIGNS == {torch.bfloat16: kg.BWD_TILED, torch.float32: kg.BWD_TILED}
    assert set(kg.BWD_ENTRY) == {kg.BWD_TILED, kg.BWD_CHANNEL}
    x, la, h0, do, dh = _inputs(2, 20, 8, "random", torch.float32, torch.float32)
    want = ref.rglru_bwd_ref(x, la, h0, do, dh)
    before = dict(kg.bwd_kernel_launches), kg.bwd_launches
    for kernel in kg.BWD_ENTRY:
        got = kg.rglru_bwd(x, la, h0, do, dh, kernel=kernel)
        assert all(torch.equal(g, w) for g, w in zip(got, want))
    assert (dict(kg.bwd_kernel_launches), kg.bwd_launches) == before
    with pytest.raises(ValueError, match="unknown backward kernel"):
        kg.rglru_bwd(x, la, h0, do, dh, kernel="sequential")
    with pytest.raises(ValueError, match="phases"):
        kg.rglru_bwd(x, la, h0, do, dh, kernel=kg.BWD_CHANNEL, phases=kg.FORWARD)
    with pytest.raises(ValueError, match="phases"):
        kg.rglru_bwd(x, la, h0, do, dh, phases=8)
