// RG-LRU linear recurrence (RecurrentGemma) for Hopper (sm_90a), plain C
// interface for ctypes.
//
// Replaces repro/kernels/rglru_scan.py::_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.rglru). It computes what that kernel computes,
// elementwise over the width W and sequentially over t:
//
//   a_t = exp(la_t),  b_t = sqrt(max(1 - exp(2 la_t), 1e-12)) * x_t
//   h_t = a_t * h_{t-1} + b_t
//
// starting from h0 (zero when the pointer is null), writing every h_t in
// x's dtype and the final h as f32. The arithmetic is f32 in the
// reference's order: expf, sqrtf and fmaxf as written above, and the
// products and sums rounded one by one (__fmul_rn / __fadd_rn, so nvcc does
// not contract them into FMAs), with no fast math. 1 - a*a would round
// otherwise where a is close to 1, and the main path's a reaches 0.999.
//
// What bounds it on an H100. At recurrentgemma-9b prefill (B 4, S 2048,
// W 4096) one layer reads x (bf16) and log_a (f32) and writes h (bf16):
// 33.5M elements x 8 bytes ~= 268 MB, ~0.080 ms at 3.35 TB/s. The ~7 f32
// operations and 3 special-function evaluations an element would take
// well under that, so it is bound by bytes. A decode step (S = 1) reads
// and writes 16 K channels and is bound by its launch.
//
// Design. One thread owns one (b, w) channel and keeps h in a register for
// the whole sequence; the Pallas kernel's sequential time-chunk grid axis
// becomes a loop over t inside the thread. Adjacent threads own adjacent w,
// so every load and store of a warp is coalesced. With only B*W = 16 K
// threads at full width (128 blocks of 128, at most one per SM, one warp
// per scheduler) latency has to be hidden inside each thread:
//  - nothing in a step's loads depends on h, so the next CH steps of x and
//    log_a are loaded into registers while the current CH are computed;
//  - nor do the coefficients: for a chunk, 1 - exp(2 la) and then
//    sqrt(.) * x are computed for all CH steps in passes before the h
//    chain, so their CH independent chains overlap. Computed step by step,
//    behind a per-step guard, every step was its own basic block and one
//    step's latency followed the last: 0.27 ms a layer against 0.16 ms
//    (NVIDIA H100 80GB HBM3, 700 W; PERF.md).
// Full chunks run without a guard; the ragged last chunk and a ragged last
// block are masked, so any S >= 1 and any W work. Inputs are read through
// their strides (last dim contiguous).
//
// In place. h_out may equal h0: each element has one owner thread, which
// reads it before the loop and writes it after. The wrapper passes a given
// state as both, so prefill writes straight into the layer's slice of the
// stacked cache and decode updates that slice in place.
//
// What the simple design leaves on the table: the parallelism is the
// number of channels, so the card holds ~4 warps per SM and the kernel
// runs at ~2x its bytes bound. A chunked scan over time (each chunk's
// local scan, then a carry pass) would give it more warps.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 128;  // threads (channels) per block
constexpr int CH = 16;   // timesteps loaded ahead

struct Params {
  const void* x;      // (B, S, W), last dim contiguous
  const void* la;     // (B, S, W), last dim contiguous
  const float* h0;    // (B, W) f32 contiguous, or null
  void* o;            // (B, S, W) contiguous, x's dtype
  float* h_out;       // (B, W) f32 contiguous; may equal h0
  int B, S, W;
  int64_t x_sb, x_ss;
  int64_t la_sb, la_ss;
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
__global__ void __launch_bounds__(NT) rglru_fwd_kernel(const Params p) {
  const int w = blockIdx.x * NT + threadIdx.x;
  const int b = blockIdx.y;
  if (w >= p.W) return;
  const int S = p.S;
  const TX* x = static_cast<const TX*>(p.x) + b * p.x_sb + w;
  const TA* la = static_cast<const TA*>(p.la) + b * p.la_sb + w;
  TX* o = static_cast<TX*>(p.o) + (int64_t)b * S * p.W + w;
  const int64_t hi = (int64_t)b * p.W + w;

  float h = p.h0 != nullptr ? p.h0[hi] : 0.f;

  TX xn[CH];  // the next chunk's loads, in flight while this one is computed
  TA ln[CH];
  auto load = [&](int t0) {
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      const bool in = t0 + t < S;
      xn[t] = in ? x[(int64_t)(t0 + t) * p.x_ss] : from_f32<TX>(0.f);
      ln[t] = in ? la[(int64_t)(t0 + t) * p.la_ss] : from_f32<TA>(0.f);
    }
  };

  load(0);
  for (int t0 = 0; t0 < S; t0 += CH) {
    float l[CH], bt[CH];
#pragma unroll
    for (int t = 0; t < CH; ++t) {
      l[t] = to_f32(ln[t]);
      bt[t] = to_f32(xn[t]);
    }
    if (t0 + CH < S) load(t0 + CH);
    // The coefficients do not depend on h: each pass below is CH
    // independent chains, so their latencies overlap instead of adding up
    // step by step (sqrtf's slow-path branch ends a basic block per step).
    float e[CH];
#pragma unroll
    for (int t = 0; t < CH; ++t) e[t] = fmaxf(1.f - expf(2.f * l[t]), 1e-12f);
#pragma unroll
    for (int t = 0; t < CH; ++t) bt[t] = __fmul_rn(sqrtf(e[t]), bt[t]);
    if (t0 + CH <= S) {  // a full chunk: no per-step guard, one basic block
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        h = __fadd_rn(__fmul_rn(expf(l[t]), h), bt[t]);
        o[(int64_t)(t0 + t) * p.W] = from_f32<TX>(h);
      }
    } else {
#pragma unroll
      for (int t = 0; t < CH; ++t) {
        if (t0 + t < S) {
          h = __fadd_rn(__fmul_rn(expf(l[t]), h), bt[t]);
          o[(int64_t)(t0 + t) * p.W] = from_f32<TX>(h);
        }
      }
    }
  }
  p.h_out[hi] = h;
}

template <typename TX, typename TA>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.W + NT - 1) / NT, p.B);
  rglru_fwd_kernel<TX, TA><<<grid, NT, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// x_dtype, la_dtype: 0 = float32, 1 = bfloat16; log_a is f32 or x's dtype.
// h0 (may be null) and h_out are f32 contiguous (B, W); o is contiguous
// (B, S, W) in x's dtype. Returns a cudaError_t (0 = success).
extern "C" int rglru_fwd(const void* x, const void* la, const float* h0, void* o,
                         float* h_out, int x_dtype, int la_dtype, int B, int S, int W,
                         int64_t x_sb, int64_t x_ss, int64_t la_sb, int64_t la_ss,
                         void* stream) {
  if (B <= 0 || S <= 0 || W <= 0 || B > 65535 || h_out == nullptr)
    return (int)cudaErrorInvalidValue;
  const Params p{x, la, h0, o, h_out, B, S, W, x_sb, x_ss, la_sb, la_ss};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0 && la_dtype == 0) return (int)launch<float, float>(p, s);
  if (x_dtype == 1 && la_dtype == 0) return (int)launch<__nv_bfloat16, float>(p, s);
  if (x_dtype == 1 && la_dtype == 1) return (int)launch<__nv_bfloat16, __nv_bfloat16>(p, s);
  return (int)cudaErrorInvalidValue;
}
