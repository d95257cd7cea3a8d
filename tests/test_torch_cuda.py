"""repro_torch on the card: the CUDA kernels against their plain versions,
and the serve path through them.  Every test needs a CUDA card and skips
without one; this file imports no jax, so it runs on a machine that has
only PyTorch:

    PYTHONPATH=src python -m pytest tests/test_torch_cuda.py

Tolerances: flash attention f32 1e-5 (the card sums in another order and
uses expf), bf16 2e-2 (the reference's bf16 tolerance); WKV-6 the
reference's own, f32 5e-5, bf16 5e-2; RG-LRU f32 1e-5 (the reference's
between its kernel and its oracle) and one bf16 ulp for a bf16 output;
the flash backward f32 5e-5 (the reference's VJP tolerance), bf16 2e-2 plus
one bf16 ulp of the plain value; the WKV-6 backward f32 5e-5 times the
output's largest magnitude, bf16 one bf16 ulp more.  The training tests run
the trainer in a subprocess: cuBLAS reads CUBLAS_WORKSPACE_CONFIG when CUDA
initialises."""
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ref
from repro_torch.kernels import rglru as kg
from repro_torch.kernels import wkv6 as k6
from repro_torch.models import params as pmod
from repro_torch.models import transformer
from repro_torch.models.steps import make_decode_step, make_prefill_step
from repro_torch.models.transformer import Transformer
from repro_torch.runtime.fault_injection import FaultInjector, InjectedFault
from repro_torch.runtime.serve_loop import ServeConfig, Server

TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2}
WKV_TOL = {torch.float32: 5e-5, torch.bfloat16: 5e-2}

CASES = [
    # (B, S, H, KV, D, causal, window, chunk, softcap)
    (2, 256, 4, 2, 64, True, 0, 0, 0.0),
    (1, 512, 4, 4, 64, False, 0, 0, 0.0),
    (1, 512, 8, 1, 64, True, 0, 0, 0.0),      # MQA
    (1, 1024, 4, 2, 64, True, 256, 0, 0.0),   # sliding window
    (1, 1024, 2, 2, 64, True, 0, 256, 0.0),   # chunked
    (2, 256, 4, 4, 128, True, 0, 0, 0.0),     # d_head 128
    (1, 256, 8, 2, 128, True, 0, 0, 0.0),     # GQA 4:1
    (1, 256, 2, 2, 64, True, 0, 0, 30.0),     # softcap
    (1, 333, 4, 2, 128, True, 0, 0, 0.0),     # ragged S
    (2, 40, 4, 2, 16, False, 0, 0, 0.0),      # smoke width, one partial tile
    (1, 96, 2, 1, 32, True, 0, 0, 0.0),
    (2, 256, 4, 1, 256, True, 0, 0, 0.0),     # d_head 256, MQA (recurrentgemma-9b)
    (1, 1024, 4, 1, 256, True, 256, 0, 0.0),  # d_head 256, MQA, sliding window
    (1, 300, 2, 1, 256, True, 128, 0, 0.0),   # d_head 256, ragged S
]

# bf16 only: the tensor-core kernel's tile classes at the main path's shapes
# and at mask edges that do not fall on a tile boundary
BF16_CASES = [
    (1, 2048, 32, 8, 128, True, 0, 0, 0.0),     # rsc-llm prefill, B 1
    (1, 2048, 16, 1, 256, True, 2048, 0, 0.0),  # recurrentgemma-9b prefill, B 1
    (1, 1024, 4, 1, 256, True, 300, 0, 0.0),    # window not a multiple of the tile
    (1, 512, 4, 2, 128, True, 0, 100, 0.0),     # chunk of 100
    (1, 512, 4, 2, 128, True, 0, 0, 30.0),      # softcap at d_head 128
    (1, 333, 4, 1, 256, True, 0, 0, 0.0),       # ragged S at d_head 256
    (1, 200, 2, 2, 64, False, 0, 100, 0.0),     # chunk without causal
]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _qkv(case, dtype, device):
    B, S, H, KV, D = case[:5]
    rng = np.random.default_rng(0)
    return tuple(torch.from_numpy(rng.standard_normal(s, np.float32)).to(device, dtype)
                 for s in ((B, S, H, D), (B, S, KV, D), (B, S, KV, D)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", CASES)
def test_kernel_matches_plain(cuda, case, dtype):
    causal, window, chunk, softcap = case[5:]
    q, k, v = _qkv(case, dtype, cuda)
    kw = dict(causal=causal, window=window, chunk=chunk, softcap=softcap)
    before = fa.launches
    got = fa.flash_attention(q, k, v, **kw)
    assert fa.launches == before + 1
    want = ref.attention_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == q.shape
    np.testing.assert_allclose(got.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=TOL[dtype])


@pytest.mark.parametrize("case", BF16_CASES)
def test_tensor_core_kernel_matches_plain(cuda, case):
    test_kernel_matches_plain(cuda, case, torch.bfloat16)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_kernel_reads_strided_inputs(cuda, dtype):
    """q/k/v are read through their strides: a (B, S, H, D) view of a
    larger buffer (last dim contiguous; 16-byte aligned, as the bf16
    kernel's TMA needs) gives the same result as a copy."""
    big = torch.randn((2, 128, 12, 64), device=cuda).to(dtype)
    q, k, v = big[:, :, :4], big[:, :, 4:6], big[:, :, 6:8]
    got = fa.flash_attention(q, k, v)
    want = fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got, want)


def test_wrapper_rejects_misaligned_bf16_view(cuda):
    """A bf16 view whose start or strides are not 16-byte multiples raises;
    the same view in f32 (CUDA-core kernel) is taken."""
    z = torch.zeros((1, 8, 2, 65), device=cuda, dtype=torch.bfloat16)[..., 1:]
    ok = torch.zeros((1, 8, 2, 64), device=cuda, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(z, ok, ok)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention(ok, ok, z)
    zf = torch.zeros((1, 8, 2, 65), device=cuda)[..., 1:]
    out = fa.flash_attention(zf, zf, zf)
    torch.cuda.synchronize()
    assert torch.equal(out, torch.zeros_like(out))


def test_wrapper_rejects_on_card(cuda):
    q = torch.zeros((1, 8, 2, 64), device=cuda)
    with pytest.raises(ValueError, match="contiguous"):
        fa.flash_attention(q, q.transpose(1, 3).contiguous().transpose(1, 3), q)
    with pytest.raises(ValueError, match="head dim 48"):
        z = torch.zeros((1, 8, 2, 48), device=cuda)
        fa.flash_attention(z, z, z)


def _wkv_inputs(B, S, H, D, dtype, device, state=False):
    """The reference test's distribution (tests/test_kernels.py)."""
    rng = np.random.default_rng(0)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    r, k, v = (n(B, S, H, D) * 0.5 for _ in range(3))
    w = torch.sigmoid(n(B, S, H, D)) * 0.5 + 0.45
    out = [t.to(device, dtype) for t in (r, k, v, w, n(H, D) * 0.3)]
    if state:
        out.append((n(B, H, D, D) * 0.5).to(device))
    return out


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("shape,state", [
    ((1, 128, 2, 16), False), ((2, 256, 4, 32), False), ((1, 64, 8, 64), False),
    ((2, 100, 4, 64), False),   # ragged S (not a multiple of the chunk)
    ((2, 77, 4, 32), True),     # with an initial state
    ((4, 1, 8, 64), True),      # one decode step
    ((3, 5, 2, 16), True),
])
def test_wkv6_kernel_matches_plain(cuda, shape, state, dtype):
    args = _wkv_inputs(*shape, dtype, cuda, state=state)
    want, s_want = ref.wkv6_ref(*args)  # before the kernel updates the state in place
    before = k6.launches
    out, s = k6.wkv6(*args)
    assert k6.launches == before + 1
    torch.cuda.synchronize()
    assert out.dtype == dtype and out.shape == shape and s.dtype == torch.float32
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(),
                               atol=WKV_TOL[dtype])
    np.testing.assert_allclose(s.cpu().numpy(), s_want.cpu().numpy(), atol=WKV_TOL[dtype])


# the WKV-6 backward against its plain version (f64 inside): f32 5e-5 (the
# reference's WKV-6 tolerance) times the output's largest magnitude, since
# the gradients sum over every later step; bf16 outputs one bf16 ulp more
WKV_BWD_TOL = 5e-5


@pytest.mark.parametrize("decays", [None, 1e-3, 0.999])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D", k6.HEAD_DIMS)
def test_wkv6_backward_kernel_matches_plain_and_repeats_bit_for_bit(cuda, D, dtype, decays):
    """At a ragged S with a state, a final-state cotangent, and decays of the
    reference test, near 0 and near 1."""
    r, k, v, w, u, st = _wkv_inputs(2, 77, 4, D, dtype, cuda, state=True)
    if decays is not None:
        w = torch.full_like(w, decays)
    rng = np.random.default_rng(1)
    do = torch.from_numpy(rng.standard_normal((2, 77, 4, D)).astype(np.float32)).to(cuda, dtype)
    ds = torch.from_numpy(rng.standard_normal((2, 4, D, D)).astype(np.float32)).to(cuda)
    args = (r, k, v, w, u, st, do, ds)
    want = ref.wkv6_bwd_ref(*args)
    before = k6.bwd_launches
    got = k6.wkv6_bwd(*args)
    again = k6.wkv6_bwd(*args)
    torch.cuda.synchronize()
    assert k6.bwd_launches == before + 2
    assert [g.dtype for g in got] == [dtype] * 4 + [torch.float32] * 2
    for n, (g, wn, g2) in enumerate(zip(got, want, again)):
        assert torch.equal(g, g2)
        g, wn = g.float().cpu(), wn.float().cpu()
        lim = WKV_BWD_TOL * max(1.0, float(wn.abs().max()))
        if dtype == torch.bfloat16 and n < 4:
            lim = lim + 2.0 ** -7 * wn.abs()
        assert bool(((g - wn).abs() <= lim).all()), n


def test_rwkv_training_on_card_goes_through_the_kernels(cuda):
    """Smoke rwkv6-7b's loss and gradients on the card in f32 (the
    sequential WKV-6 forward twice per layer, the forward and its remat
    recompute, and the backward once) match the CPU's plain path to 1e-5
    (loss) and 1e-4 (gradients); bf16 takes the chunked forward."""
    cfg = smoke_config(get_arch("rwkv6-7b"))
    params = pmod.materialize(transformer.model_defs(cfg), seed=1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 65)))
    out = []
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        k6.bwd_launches = 0
        k6.kernel_launches = dict.fromkeys(k6.kernel_launches, 0)
        loss, _ = transformer.loss_fn(leaves, cfg, {"tokens": tokens.to(dev)},
                                      dtype=torch.float32)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append([loss.detach().cpu()] + [g.cpu() for g in grads])
    assert (k6.kernel_launches[k6.SEQUENTIAL], k6.bwd_launches) == (2 * cfg.n_layers,
                                                                    cfg.n_layers)
    assert abs(float(out[0][0] - out[1][0])) <= 1e-5
    for a, b in zip(out[0][1:], out[1][1:]):
        assert torch.isfinite(b).all()
        np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)
    leaves = {k: v.to(cuda).requires_grad_() for k, v in params.items()}
    k6.kernel_launches = dict.fromkeys(k6.kernel_launches, 0)
    loss, _ = transformer.loss_fn(leaves, cfg, {"tokens": tokens.to(cuda)})
    grads = torch.autograd.grad(loss, list(leaves.values()))
    assert k6.kernel_launches[k6.CHUNKED] == 2 * cfg.n_layers
    assert all(torch.isfinite(g).all() for g in grads)


def test_wkv6_updates_the_state_in_place(cuda):
    args = _wkv_inputs(2, 1, 4, 64, torch.bfloat16, cuda, state=True)
    want, s_want = ref.wkv6_ref(*args)
    st = args[-1]
    out, s = k6.wkv6(*args)
    torch.cuda.synchronize()
    assert s is st
    np.testing.assert_allclose(out.float().cpu().numpy(), want.float().cpu().numpy(), atol=5e-2)
    np.testing.assert_allclose(st.cpu().numpy(), s_want.cpu().numpy(), atol=5e-2)


def test_wkv6_reads_strided_inputs(cuda):
    """r, k, v, w as (B, S, H, D) views of one larger buffer (last dim
    contiguous) give the same result as copies."""
    big = torch.randn((2, 40, 16, 32), device=cuda) * 0.5
    r, k, v = big[:, :, :4], big[:, :, 4:8], big[:, :, 8:12]
    w = torch.sigmoid(big[:, :, 12:16]) * 0.5 + 0.45
    u = torch.randn((4, 32), device=cuda) * 0.3
    got = k6.wkv6(r, k, v, w, u)
    want = k6.wkv6(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(), u)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def _decays(w, decays, seed=0):
    """w set to exact decays: all 0, all 1, all 1e-30 (products underflow),
    or runs of 7 steps of ordinary w, 0, 1, and an element-wise mix."""
    if decays in ("zero", "one", "tiny"):
        return torch.full_like(w, {"zero": 0.0, "one": 1.0, "tiny": 1e-30}[decays])
    rng = np.random.default_rng(seed)
    pick = torch.from_numpy(rng.integers(0, 4, tuple(w.shape))).to(w.device)
    wf = w.float()
    mix = torch.where(pick == 0, 0.0, torch.where(pick == 1, 1.0, torch.where(
        pick == 2, 1e-30, wf)))
    run = (torch.arange(w.shape[1], device=w.device) // 7 % 4).view(1, -1, 1, 1)
    return torch.where(run == 1, 0.0, torch.where(run == 2, 1.0, torch.where(
        run == 3, mix, wf))).to(w.dtype)


def _check_wkv6(got, want, dtype, rel=0.0):
    """Out within tol + rel |want| (above 8 one bf16 ulp of the output is
    more than 5e-2, and the two sides sum in different orders), state
    within tol."""
    out, s = got
    d = (out.float() - want[0].float()).abs()
    assert bool(torch.isfinite(out).all())
    assert bool((d <= WKV_TOL[dtype] + rel * want[0].float().abs()).all()), d.max().item()
    assert (s - want[1]).abs().max().item() <= WKV_TOL[dtype]


@pytest.mark.parametrize("kernel", [k6.CHUNKED, k6.SEQUENTIAL])
@pytest.mark.parametrize("decays", ["zero", "one", "tiny", "runs"])
@pytest.mark.parametrize("shape,state", [((2, 77, 4, 64), True), ((1, 333, 8, 64), False),
                                         ((3, 5, 2, 16), True), ((2, 40, 4, 32), True)])
def test_wkv6_bf16_extreme_decays_match_plain(cuda, shape, state, decays, kernel):
    """w = 0, 1 and 1e-30 and runs of them at S that are no multiple of the
    chunked kernel's 16 steps: no NaN, and the plain version's result."""
    args = _wkv_inputs(*shape, torch.bfloat16, cuda, state=state)
    args[3] = _decays(args[3], decays)
    want = ref.wkv6_ref(*args)
    got = k6.wkv6(*args, kernel=kernel)
    torch.cuda.synchronize()
    _check_wkv6(got, want, torch.bfloat16, rel=2.0 ** -7)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("S", [1, 16, 100])
def test_wkv6_routes_by_dtype_on_card(cuda, dtype, S):
    """bf16 launches the chunked kernel and f32 the sequential one, at the
    decode step and in prefill alike; each launch is counted once."""
    args = _wkv_inputs(2, S, 4, 64, dtype, cuda, state=True)
    want = ref.wkv6_ref(*args)
    before = dict(k6.kernel_launches)
    got = k6.wkv6(*args)
    torch.cuda.synchronize()
    taken = k6.design(dtype)
    assert k6.kernel_launches[taken] == before[taken] + 1
    assert sum(k6.kernel_launches.values()) == sum(before.values()) + 1
    _check_wkv6(got, want, dtype)


@pytest.mark.parametrize("kernel", [k6.CHUNKED, k6.SEQUENTIAL])
@pytest.mark.parametrize("shape,state", [((4, 1, 64, 64), True), ((1, 2048, 4, 64), False)])
def test_wkv6_both_kernels_match_plain_at_the_main_path_shapes(cuda, shape, state, kernel):
    """The decode step (B 4, H 64) and a prefill of 2048 steps (4 heads),
    bf16, through either kernel."""
    args = _wkv_inputs(*shape, torch.bfloat16, cuda, state=state)
    want = ref.wkv6_ref(*args)
    got = k6.wkv6(*args, kernel=kernel)
    torch.cuda.synchronize()
    _check_wkv6(got, want, torch.bfloat16, rel=2.0 ** -7)


def test_wkv6_chunked_reads_aligned_strided_bf16_views(cuda):
    """bf16 r, k, v, w as views of one buffer (16-byte strides) give the same
    result as copies."""
    big = torch.randn((2, 40, 16, 32), device=cuda) * 0.5
    big16 = big.bfloat16()
    r, k, v = big16[:, :, :4], big16[:, :, 4:8], big16[:, :, 8:12]
    w = (torch.sigmoid(big[:, :, 12:16]) * 0.5 + 0.45).bfloat16()
    u = torch.randn((4, 32), device=cuda) * 0.3
    got = k6.wkv6(r, k, v, w, u)
    want = k6.wkv6(r.contiguous(), k.contiguous(), v.contiguous(), w.contiguous(), u)
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


def test_wkv6_chunked_rejects_misaligned_bf16_view_and_f32(cuda):
    big = torch.zeros((1, 8, 2, 20), device=cuda, dtype=torch.bfloat16)
    r = big[..., 2:18]  # starts 4 bytes in
    u = torch.zeros((2, 16), device=cuda)
    before = k6.launches
    with pytest.raises(ValueError, match="16-byte"):
        k6.wkv6(r, r, r, r, u)
    z = torch.zeros((1, 8, 2, 16), device=cuda)
    with pytest.raises(ValueError, match="bf16"):
        k6.wkv6(z, z, z, z, u, kernel=k6.CHUNKED)
    assert k6.launches == before


def _rglru_inputs(B, S, W, x_dtype, la_dtype, device, state=False, seed=0):
    """The reference test's distribution: x ~ N(0, 1), log_a =
    -softplus(N(0, 1)), h0 ~ N(0, 1) (f32)."""
    rng = np.random.default_rng(seed)
    n = lambda *s: torch.from_numpy(rng.standard_normal(s).astype(np.float32))  # noqa: E731
    x = n(B, S, W).to(device, x_dtype)
    la = (-torch.nn.functional.softplus(n(B, S, W))).to(device, la_dtype)
    return x, la, (n(B, W).to(device) if state else None)


def _check_rglru(got, want, x_dtype):
    (out, h), (w_out, w_h) = got, want
    assert out.dtype == x_dtype and h.dtype == torch.float32
    w = w_out.float().cpu().numpy()
    d = np.abs(out.float().cpu().numpy() - w)
    if x_dtype == torch.float32:
        assert d.max() <= 1e-5
    else:  # one bf16 ulp of the output
        assert (d <= 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), 1e-30))) - 7)).all()
    np.testing.assert_allclose(h.cpu().numpy(), w_h.cpu().numpy(), atol=1e-5)


@pytest.mark.parametrize("types", [(torch.float32, torch.float32),
                                   (torch.bfloat16, torch.float32),
                                   (torch.bfloat16, torch.bfloat16)])
@pytest.mark.parametrize("shape,state", [
    ((1, 128, 64), False), ((2, 256, 128), False), ((1, 64, 512), False),
    ((1, 128, 64), True), ((2, 256, 128), True), ((1, 64, 512), True),
    ((4, 1, 4096), True),    # one recurrentgemma-9b decode step
    ((2, 77, 4000), True),   # ragged S and a ragged last block of W
    ((3, 33, 100), False),
])
def test_rglru_kernel_matches_plain(cuda, shape, state, types):
    x, la, h0 = _rglru_inputs(*shape, *types, cuda, state=state)
    want = ref.rglru_ref(x, la, h0)  # before the kernel updates h0 in place
    before = kg.launches
    got = kg.rglru(x, la, h0)
    assert kg.launches == before + 1
    torch.cuda.synchronize()
    assert got[0].shape == shape
    _check_rglru(got, want, types[0])


def test_rglru_updates_the_state_in_place(cuda):
    x, la, h0 = _rglru_inputs(4, 1, 4096, torch.bfloat16, torch.float32, cuda, state=True)
    want = ref.rglru_ref(x, la, h0)
    got = kg.rglru(x, la, h0)
    torch.cuda.synchronize()
    assert got[1] is h0
    _check_rglru(got, want, torch.bfloat16)


def test_rglru_reads_strided_inputs(cuda):
    """x and log_a as (B, S, W) views of larger buffers (last dim
    contiguous) give the same result as copies."""
    big = torch.randn((2, 50, 3, 96), device=cuda)
    x = big[:, :, 0]
    la = -torch.nn.functional.softplus(big[:, :, 1:3]).reshape(2, 50, 192)[:, :, 10:106]
    got = kg.rglru(x, la)
    want = kg.rglru(x.contiguous(), la.contiguous())
    torch.cuda.synchronize()
    assert torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])


@pytest.mark.parametrize("arch", ["rsc-llm", "qwen3-0.6b", "rwkv6-7b", "recurrentgemma-9b"])
def test_smoke_model_on_card_matches_cpu(cuda, arch):
    cfg = smoke_config(get_arch(arch))
    cpu = Transformer(cfg, device="cpu", dtype=torch.float32, seed=2)
    gpu = Transformer(cfg, device=cuda, dtype=torch.float32)
    gpu.load_state_dict(cpu.state_dict(), strict=True)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 70)))
    outs = []
    for model, dev in ((cpu, "cpu"), (gpu, cuda)):
        prefill, decode = make_prefill_step(model), make_decode_step(model)
        logits, cache = prefill({"tokens": tokens.to(dev)})
        seq = [logits.cpu()]
        for _ in range(3):
            logits, cache = decode(cache, logits[:, -1].argmax(-1)[:, None])
            seq.append(logits.cpu())
        outs.append(torch.stack(seq))
    np.testing.assert_allclose(outs[1].numpy(), outs[0].numpy(), atol=1e-4)


def test_server_on_card_launches_the_kernel_per_layer_per_prefill(cuda):
    cfg = smoke_config(get_arch("rsc-llm"))
    scfg = ServeConfig(batch=2, prompt_len=64, max_new_tokens=6)
    fa.launches = 0
    clean = Server(cfg, scfg).run()
    assert fa.launches == cfg.n_layers
    fa.launches = 0
    faulted = Server(cfg, scfg, FaultInjector(schedule={3: InjectedFault("pcie_errors")})).run()
    assert fa.launches == 2 * cfg.n_layers and faulted.retries == 1
    np.testing.assert_array_equal(clean.outputs, faulted.outputs)


def test_server_on_card_launches_wkv6_per_layer_per_step(cuda):
    """rwkv6-7b: one launch per layer for the prefill and for every decode
    step; a crash before decode step 3 adds a prefill and 3 steps."""
    cfg = smoke_config(get_arch("rwkv6-7b"))
    scfg = ServeConfig(batch=2, prompt_len=40, max_new_tokens=6)
    k6.launches = fa.launches = 0
    clean = Server(cfg, scfg).run()
    assert k6.launches == cfg.n_layers * (1 + 6) and fa.launches == 0
    k6.launches = 0
    faulted = Server(cfg, scfg, FaultInjector(schedule={3: InjectedFault("pcie_errors")})).run()
    assert k6.launches == cfg.n_layers * ((1 + 3) + (1 + 6)) and faulted.retries == 1
    np.testing.assert_array_equal(clean.outputs, faulted.outputs)


def test_server_on_card_launches_rglru_per_layer_per_step(cuda):
    """recurrentgemma-9b: the RG-LRU kernel once per rglru layer for the
    prefill and for every decode step, flash once per local layer per
    prefill (decode attention stays plain); a crash before decode step 3
    adds a prefill and 3 steps."""
    cfg = smoke_config(get_arch("recurrentgemma-9b"))
    kinds = cfg.layer_kinds()
    n_rg, n_local = kinds.count("rglru"), kinds.count("local")
    assert (n_rg, n_local) == (6, 2)
    scfg = ServeConfig(batch=2, prompt_len=80, max_new_tokens=6)
    kg.launches = fa.launches = k6.launches = 0
    clean = Server(cfg, scfg).run()
    assert kg.launches == n_rg * (1 + 6) and fa.launches == n_local and k6.launches == 0
    kg.launches = fa.launches = 0
    faulted = Server(cfg, scfg, FaultInjector(schedule={3: InjectedFault("pcie_errors")})).run()
    assert kg.launches == n_rg * ((1 + 3) + (1 + 6)) and fa.launches == 2 * n_local
    assert faulted.retries == 1
    np.testing.assert_array_equal(clean.outputs, faulted.outputs)


# -- the flash backward and the LSE forward ------------------------------------
BWD_TOL = {torch.float32: 5e-5, torch.bfloat16: 2e-2}
BWD_CASES = [
    (2, 256, 4, 2, 64, True, 0, 0, 0.0),
    (1, 1024, 4, 2, 64, True, 256, 0, 0.0),   # sliding window
    (1, 1024, 2, 2, 64, True, 0, 256, 0.0),   # chunked
    (1, 512, 8, 1, 64, True, 0, 0, 0.0),      # MQA
    (1, 256, 2, 2, 64, True, 0, 0, 30.0),     # softcap
    (1, 333, 4, 2, 128, False, 0, 0, 0.0),    # ragged S, no mask
    (1, 300, 4, 2, 128, True, 100, 0, 0.0),   # window not a multiple of the tile
    (2, 40, 4, 2, 16, True, 0, 0, 0.0),       # smoke width, one partial tile
    (1, 96, 2, 1, 32, True, 0, 50, 0.0),      # chunk of 50
    (1, 2048, 32, 8, 128, True, 0, 0, 0.0),   # rsc-llm training, B 1
    # the bf16 design's tile edges: 128-key / 128-row items, 64-row steps
    (1, 200, 4, 2, 16, True, 0, 0, 0.0),      # D 16 over two items
    (1, 300, 4, 4, 32, True, 0, 100, 0.0),    # D 32, chunk of 100
    (1, 129, 4, 2, 128, True, 0, 0, 0.0),     # one row past a 128 tile
    (2, 191, 4, 2, 128, True, 0, 0, 0.0),     # 63 rows past one
    (1, 512, 4, 2, 128, True, 130, 0, 0.0),   # window of 130
    (1, 512, 4, 2, 128, True, 0, 100, 0.0),   # chunk of 100 at D 128
]
ROOT = pathlib.Path(__file__).resolve().parents[1]


def _assert_bwd_close(got, want, dtype):
    g, w = got.float().cpu(), want.float().cpu()
    lim = BWD_TOL[dtype] + (2.0 ** -7 * w.abs() if dtype == torch.bfloat16 else 0.0)
    assert got.dtype == want.dtype and got.shape == want.shape
    assert bool(((g - w).abs() <= lim).all()), float((g - w).abs().max())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_lse_forward_matches_plain(cuda, case, dtype):
    kw = dict(causal=case[5], window=case[6], chunk=case[7], softcap=case[8])
    q, k, v = _qkv(case, dtype, cuda)
    before = (fa.launches, fa.lse_launches)
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    assert (fa.launches, fa.lse_launches) == (before[0], before[1] + 1)
    o_r, lse_r = ref.attention_lse_ref(q, k, v, **kw)
    torch.cuda.synchronize()
    _assert_bwd_close(o, o_r, dtype)
    assert lse.shape == (case[0], case[2], case[1]) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.cpu().numpy(), lse_r.cpu().numpy(), atol=1e-5)
    assert torch.equal(o, fa.flash_attention(q, k, v, **kw))  # the serve output, unchanged


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("case", BWD_CASES)
def test_backward_kernel_matches_plain_and_repeats_bit_for_bit(cuda, case, dtype):
    kw = dict(causal=case[5], window=case[6], chunk=case[7], softcap=case[8])
    q, k, v = _qkv(case, dtype, cuda)
    do = torch.flip(q, dims=(1,)).contiguous()
    o, lse = fa.flash_attention_lse(q, k, v, **kw)
    before = fa.bwd_launches
    got = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    again = fa.flash_attention_bwd(q, k, v, o, lse, do, **kw)
    assert fa.bwd_launches == before + 2
    want = ref.flash_bwd_ref(q, k, v, o, lse, do, **kw)
    torch.cuda.synchronize()
    for a, b in zip(got, want):
        _assert_bwd_close(a, b, dtype)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("D", fa.BWD_HEAD_DIMS)
def test_bf16_backward_runs_the_wgmma_design_at_every_head_dim(cuda, D):
    """The kernels a bf16 backward launches, by name (torch.profiler): the
    delta pass and the wgmma design's dK / dV and dQ kernels at this D."""
    from torch.profiler import ProfilerActivity, profile

    assert fa.BWD_DESIGNS[torch.bfloat16] == "wgmma+tma"
    case = (1, 200, 4, 2, D, True, 0, 0, 0.0)
    q, k, v = _qkv(case, torch.bfloat16, cuda)
    o, lse = fa.flash_attention_lse(q, k, v)
    fa.flash_attention_bwd(q, k, v, o, lse, q)  # built and warm
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fa.flash_attention_bwd(q, k, v, o, lse, q)
        torch.cuda.synchronize()
    names = " ".join(e.key for e in prof.key_averages())
    assert f"wg::dkdv_kernel<{D}>" in names and f"wg::dq_kernel<{D}>" in names, names
    assert "delta_kernel" in names and "cc::" not in names, names


def test_backward_kernel_refuses_head_dim_256_and_a_misaligned_bf16_tensor(cuda):
    q = torch.zeros((1, 64, 2, 256), device=cuda, dtype=torch.bfloat16)
    k = torch.zeros((1, 64, 1, 256), device=cuda, dtype=torch.bfloat16)
    o, lse = fa.flash_attention_lse(q, k, k)
    with pytest.raises(NotImplementedError, match="head dims"):
        fa.flash_attention_bwd(q, k, k, o, lse, q)
    q, k = q[..., :64].contiguous(), k[..., :64].contiguous()
    o, lse = fa.flash_attention_lse(q, k, k)
    do = torch.zeros(q.numel() + 1, device=cuda, dtype=torch.bfloat16)[1:].view(q.shape)
    with pytest.raises(ValueError, match="16-byte"):
        fa.flash_attention_bwd(q, k, k, o, lse, do)


def test_serving_launches_only_the_forward_without_lse(cuda):
    """Under inference mode the serve path takes the forward that writes no
    LSE, once per layer per prefill, and never the backward."""
    cfg = smoke_config(get_arch("rsc-llm"))
    fa.launches = fa.lse_launches = fa.bwd_launches = 0
    Server(cfg, ServeConfig(batch=2, prompt_len=64, max_new_tokens=4)).run()
    assert (fa.launches, fa.lse_launches, fa.bwd_launches) == (cfg.n_layers, 0, 0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_training_loss_on_card_goes_through_the_kernels(cuda, dtype):
    """Smoke rsc-llm's loss and gradients on the card: the LSE forward twice
    per layer (the forward and its remat recompute) and the backward once;
    f32 matches the CPU's plain path to 1e-5 (loss) and 1e-4 (grads)."""
    cfg = smoke_config(get_arch("rsc-llm"))
    params = pmod.materialize(transformer.model_defs(cfg), seed=1)
    tokens = torch.from_numpy(np.random.default_rng(2).integers(3, cfg.vocab_size, (2, 65)))
    out = []
    for dev in ("cpu", cuda):
        leaves = {k: v.to(dev).requires_grad_() for k, v in params.items()}
        fa.lse_launches = fa.bwd_launches = 0
        loss, _ = transformer.loss_fn(leaves, cfg, {"tokens": tokens.to(dev)}, dtype=dtype)
        grads = torch.autograd.grad(loss, list(leaves.values()))
        out.append([loss.detach().cpu()] + [g.cpu() for g in grads])
    assert (fa.lse_launches, fa.bwd_launches) == (2 * cfg.n_layers, cfg.n_layers)
    assert all(torch.isfinite(t).all() for t in out[1])
    if dtype == torch.float32:
        assert abs(float(out[0][0] - out[1][0])) <= 1e-5
        for a, b in zip(out[0][1:], out[1][1:]):
            np.testing.assert_allclose(b.numpy(), a.numpy(), atol=1e-4)


def _run_py(code, **env):
    base = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                          timeout=600, env=dict(base, PYTHONPATH=str(ROOT / "src"), **env))


def test_trainer_on_card_requires_the_cublas_setting(cuda):
    code = ("from repro_torch.configs.base import get_arch, smoke_config\n"
            "from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig\n"
            "FaultTolerantTrainer(smoke_config(get_arch('rsc-llm')), TrainerConfig())\n")
    r = _run_py(code)
    assert r.returncode != 0 and "CUBLAS_WORKSPACE_CONFIG" in r.stderr


FAULTED_VS_CLEAN = """
import sys
import numpy as np, torch
from repro_torch.checkpoint.manager import CheckpointManager, _flatten
from repro_torch.configs.base import get_arch, smoke_config
from repro_torch.models import params as pmod, transformer
from repro_torch.optim import adamw
from repro_torch.runtime.fault_injection import FaultInjector, InjectedFault
from repro_torch.runtime.train_loop import FaultTolerantTrainer, TrainerConfig
cfg = smoke_config(get_arch(sys.argv[2] if len(sys.argv) > 2 else "rsc-llm"))
p0 = {p: torch.empty(d.shape, device="meta") for p, d in pmod.flatten(transformer.model_defs(cfg))}
leaves = []
for label, sched in (("clean", {}), ("fault", {10: InjectedFault("gpu_memory_errors")})):
    tc = TrainerConfig(total_steps=16, global_batch=4, seq_len=64, ckpt_every_steps=4,
                       ckpt_async=False, seed=7, ckpt_dir=sys.argv[1] + "/" + label)
    rep = FaultTolerantTrainer(cfg, tc, FaultInjector(schedule=sched), device="cuda").run()
    assert rep.final_step == 16
    _, tree, _ = CheckpointManager(tc.ckpt_dir).restore((p0, adamw.init(p0)))
    leaves.append(_flatten(tree))
assert all(np.array_equal(leaves[0][k].numpy(), leaves[1][k].numpy()) for k in leaves[0])
print("identical", len(leaves[0]))
"""


def test_faulted_training_on_card_ends_bit_identical_to_clean(cuda, tmp_path):
    """tests/test_runtime.py's bit-exact resume on the card: smoke rsc-llm in
    bf16 through the kernels, a clean run and one that crashes before step
    11, final checkpoints equal leaf by leaf."""
    base = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    r = subprocess.run([sys.executable, "-c", FAULTED_VS_CLEAN, str(tmp_path)],
                       capture_output=True, text=True, timeout=600,
                       env=dict(base, PYTHONPATH=str(ROOT / "src"),
                                CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert "identical 37" in r.stdout


def test_faulted_rwkv_training_on_card_ends_bit_identical_to_clean(cuda, tmp_path):
    """The same on smoke rwkv6-7b: the WKV-6 forward and backward kernels
    are deterministic, so a run that crashes and restores ends on the clean
    run's bits."""
    base = {k: v for k, v in os.environ.items() if k != "CUBLAS_WORKSPACE_CONFIG"}
    r = subprocess.run([sys.executable, "-c", FAULTED_VS_CLEAN, str(tmp_path), "rwkv6-7b"],
                       capture_output=True, text=True, timeout=600,
                       env=dict(base, PYTHONPATH=str(ROOT / "src"),
                                CUBLAS_WORKSPACE_CONFIG=":4096:8"))
    assert r.returncode == 0, r.stderr[-3000:]
    assert r.stdout.startswith("identical ")
