// RG-LRU backward (RecurrentGemma) for Hopper (sm_90a), plain C interface
// for ctypes.
//
// Replaces the VJP of the RG-LRU recurrence that the JAX package trains
// through: jax.grad of repro/kernels/ref.py::rglru_ref, which is also the
// VJP of the associative scan of repro/kernels/ops.py::rglru (the Pallas
// kernel of repro/kernels/rglru_scan.py has no backward). With
//   a_t = exp(l_t), e_t = exp(2 l_t), s_t = sqrt(max(1 - e_t, 1e-12)),
//   h_t = a_t h_{t-1} + s_t x_t
// and g_t the cotangent of h_t (g_{S-1} = dO_{S-1} + dh, g_t = dO_t +
// a_{t+1} g_{t+1}), it writes
//   dx_t = g_t s_t
//   dl_t = (g_t h_{t-1}) a_t + 2 (-((g_t x_t) (0.5 / s_t) share_t) e_t)
//   dh0  = a_0 g_0
// where share_t is jax.grad's rule for the clamp's maximum: 1 where 1 - e_t
// wins, 0.5 at a tie, 0 where 1e-12 wins. The arithmetic is f32 in the
// order of ref.py::rglru_bwd_ref, each product and sum rounded on its own
// (__fmul_rn / __fadd_rn, so nvcc does not contract them), and h is rebuilt
// by the forward kernel's own arithmetic, so it is the h the forward wrote.
// h is never rebuilt by dividing by a_t: log_a reaches -8 softplus(lam)
// and a_t underflows to 0.
//
// What bounds it on an H100. At recurrentgemma-9b training (B 2, S 2048,
// W 4096, x and dO bf16, log_a f32) the function reads x, log_a and dO
// and writes dx and dlog_a: 14 bytes an element, 235 MB, 0.070 ms at
// 3.35 TB/s, far above the ~30 f32 operations an element at 67 TFLOP/s, so
// it is bound by bytes. This design reads x and log_a twice (once in each
// walk) and writes and reads a checkpoint of h every C steps: 20.5 bytes an
// element, 344 MB, 0.103 ms at the same rate.
//
// Design: one thread owns one (b, w) channel, adjacent threads adjacent w,
// so every load and store of a warp is coalesced, as in rglru.cu.
//  1. A forward walk rebuilds h from h0 and writes h before every chunk of
//     C steps to the scratch (B, ceil(S / C), W) f32.
//  2. A reverse walk, chunk by chunk from the last: the chunk's h is rebuilt
//     from its checkpoint into registers, then its steps are walked
//     backwards, carrying a_{t} g_{t} to the step before.
// Each walk loads the next chunk's inputs into registers while it computes
// the current one, as rglru.cu does. Blocks of 64 threads spread the 8 K
// channels of the training shape over 128 SMs. No atomics: every output
// element has one owner thread, so two runs give the same bits.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 64;  // threads (channels) a block
constexpr int C = 16;   // steps a chunk; the wrapper's CHUNK

struct Params {
  const void* x;     // (B, S, W) contiguous
  const void* la;    // (B, S, W) contiguous
  const float* h0;   // (B, W) f32, or null (zeros)
  const void* dout;  // (B, S, W), x's dtype
  const float* dh;   // (B, W) f32, or null (zeros)
  void* dx;          // (B, S, W), x's dtype
  void* dla;         // (B, S, W), log_a's dtype
  float* dh0;        // (B, W) f32
  float* ck;         // (B, ceil(S / C), W) f32 scratch
  int B, S, W;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename TX, typename TA>
__global__ void __launch_bounds__(NT) rglru_bwd_kernel(const Params p) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const int S = p.S, W = p.W, n_ck = (S + C - 1) / C;
  const int64_t base = (int64_t)b * S * W + w;  // element (b, 0, w)
  const TX* x = static_cast<const TX*>(p.x) + base;
  const TA* la = static_cast<const TA*>(p.la) + base;
  const TX* dout = static_cast<const TX*>(p.dout) + base;
  TX* dx = static_cast<TX*>(p.dx) + base;
  TA* dla = static_cast<TA*>(p.dla) + base;
  float* ck = p.ck + (int64_t)b * n_ck * W + w;
  const int64_t hi = (int64_t)b * W + w;

  TX xn[C];  // the next chunk's loads, in flight while this one is computed
  TA ln[C];
  TX dn[C];
  auto load = [&](int c, bool with_do) {
#pragma unroll
    for (int i = 0; i < C; ++i) {
      const int t = c * C + i;
      const bool in = t < S;
      xn[i] = in ? x[(int64_t)t * W] : from_f32<TX>(0.f);
      ln[i] = in ? la[(int64_t)t * W] : from_f32<TA>(0.f);
      if (with_do) dn[i] = in ? dout[(int64_t)t * W] : from_f32<TX>(0.f);
    }
  };

  // 1. the forward walk: h before every chunk into the scratch
  float h = p.h0 != nullptr ? p.h0[hi] : 0.f;
  load(0, false);
  for (int c = 0; c < n_ck; ++c) {
    ck[(int64_t)c * W] = h;
    float l[C], bt[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      l[i] = to_f32(ln[i]);
      bt[i] = to_f32(xn[i]);
    }
    if (c + 1 < n_ck) load(c + 1, false);
    float e[C];
#pragma unroll
    for (int i = 0; i < C; ++i) e[i] = fmaxf(1.f - expf(2.f * l[i]), 1e-12f);
#pragma unroll
    for (int i = 0; i < C; ++i) bt[i] = __fmul_rn(sqrtf(e[i]), bt[i]);
    // steps past S (l = 0, x = 0) come last and leave nothing that is read
#pragma unroll
    for (int i = 0; i < C; ++i) h = __fadd_rn(__fmul_rn(expf(l[i]), h), bt[i]);
  }

  // 2. the reverse walk; carry = a_{t+1} g_{t+1}, dh at the last step
  float carry = p.dh != nullptr ? p.dh[hi] : 0.f;
  load(n_ck - 1, true);
  for (int c = n_ck - 1; c >= 0; --c) {
    float xf[C], l[C], dof[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      xf[i] = to_f32(xn[i]);
      l[i] = to_f32(ln[i]);
      dof[i] = to_f32(dn[i]);
    }
    const float h_in = ck[(int64_t)c * W];
    if (c > 0) load(c - 1, true);
    float a[C], e[C], s[C], share[C], hp[C];
#pragma unroll
    for (int i = 0; i < C; ++i) {
      a[i] = expf(l[i]);
      e[i] = expf(2.f * l[i]);
      const float u = 1.f - e[i];
      const float m = fmaxf(u, 1e-12f);
      share[i] = u == m ? (m == 1e-12f ? 0.5f : 1.f) : 0.f;
      s[i] = sqrtf(m);
    }
    float hh = h_in;  // h_{t-1} of each step, rebuilt as the forward walk did
#pragma unroll
    for (int i = 0; i < C; ++i) {
      hp[i] = hh;
      hh = __fadd_rn(__fmul_rn(a[i], hh), __fmul_rn(s[i], xf[i]));
    }
    const int t0 = c * C;
#pragma unroll
    for (int i = C - 1; i >= 0; --i) {
      if (t0 + i < S) {  // the ragged last chunk; uniform elsewhere
        const float g = __fadd_rn(carry, dof[i]);
        const float ds = -__fmul_rn(__fmul_rn(__fmul_rn(g, xf[i]), __fdiv_rn(0.5f, s[i])),
                                    share[i]);
        const float dl = __fadd_rn(__fmul_rn(__fmul_rn(g, hp[i]), a[i]),
                                   __fmul_rn(2.f, __fmul_rn(ds, e[i])));
        dx[(int64_t)(t0 + i) * W] = from_f32<TX>(__fmul_rn(g, s[i]));
        dla[(int64_t)(t0 + i) * W] = from_f32<TA>(dl);
        carry = __fmul_rn(g, a[i]);
      }
    }
  }
  p.dh0[hi] = carry;
}

template <typename TX, typename TA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.W + NT - 1) / NT, p.B);
  rglru_bwd_kernel<TX, TA><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, la_dtype: 0 = float32, 1 = bfloat16; log_a is f32 or x's dtype.
// x, log_a, dout, dx, dla contiguous (B, S, W); dout and dx in x's dtype,
// dla in log_a's; h0 and dh (either may be null) and dh0 f32 contiguous
// (B, W); ck f32 scratch of B * ceil(S / 16) * W floats. Returns a
// cudaError_t (0 = success).
extern "C" int rglru_bwd(const void* x, const void* la, const float* h0, const void* dout,
                         const float* dh, void* dx, void* dla, float* dh0, float* ck,
                         int x_dtype, int la_dtype, int B, int S, int W, void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || dh0 == nullptr || ck == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p{x, la, h0, dout, dh, dx, dla, dh0, ck, B, S, W};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && la_dtype == 0) return (int)launch<float, float>(p, s);
  if (x_dtype == 1 && la_dtype == 0) return (int)launch<__nv_bfloat16, float>(p, s);
  if (x_dtype == 1 && la_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
