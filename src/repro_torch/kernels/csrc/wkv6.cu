// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), sequential on CUDA
// cores, plain C interface for ctypes.
//
// Replaces repro/kernels/rwkv6_scan.py::_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.wkv6) for f32 inputs. Routing (the wrapper,
// kernels/wkv6.py::design): f32 takes this kernel, whose products stay true
// f32 for the 5e-5 checks; bf16 takes the chunked tensor-core kernel in
// wkv6_chunked.cu, at every S (prefill and the decode step). This entry
// still takes bf16 too, so the two kernels can be compared on the card
// (chip_smoke.py times both at rwkv6-7b's shapes).
//
// It computes what ops.wkv6 computes, per (b, h), sequentially over t, with
// a D x D f32 state S[key i][value j]:
//
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// starting from state_in (zero when the pointer is null), writing the final
// state as f32 and the output in the input dtype. Unlike the Pallas kernel,
// which raises when it is given a state, this one takes one, so prefill and
// every decode step (S = 1) run through it.
//
// What bounds it on an H100. At rwkv6-7b prefill (B 4, S 2048, H 64, D 64,
// bf16) the function needs 5*B*S*H*D^2 ~= 1.07e10 operations (out_j =
// sum_i r_i S_ij + (sum_i r_i u_i k_i) v_j and S_ij <- w_i S_ij + k_i v_j;
// ~0.011 ms at the bf16 tensor-core peak) and must move five (B,S,H,D) bf16
// tensors plus the state, ~344 MB (~0.10 ms at 3.35 TB/s): it is bound by
// bytes. A decode step (S = 1) is bound by the 2 x 4.2 MB of state it reads
// and writes. This kernel does 4 f32 instructions per (t, i, j) on CUDA
// cores (the u term is not folded into a per-step scalar), so at prefill it
// is far from that bound (PERF.md).
//
// Design. One block per (b, h), 4*D threads. Column j of the state is
// split over KS = 4 adjacent lanes; lane q holds rows i = q, q+4, ... (D/4
// floats in registers), sums its share of out_t[j], and two shuffles add the
// four shares. The Pallas kernel's sequential chunk axis becomes a loop over
// t inside the block. r, k, w (and u) are staged in shared memory as one
// float4 per (t, i), so a lane reads all four with one load that it shares
// with the 7 other lanes of its row in the warp (interleaved rows keep the 4
// addresses in distinct banks); v is staged beside them. Timesteps are
// staged CH at a time, each thread bringing one element of one of r, k, v,
// w: while the block computes one chunk from one buffer, the next chunk's
// loads are in flight in registers and are stored to the other buffer
// afterwards, so one __syncthreads() per chunk is enough and no step waits
// on device memory. Inputs are read through their strides (last dim
// contiguous); a ragged last chunk is masked, so any S works. All
// arithmetic is f32 fmaf.
//
// Why 4 lanes a column. With one thread a column (D threads a block), the
// 256 blocks of rwkv6-7b prefill put one warp on each warp scheduler, which
// then waits out every shared-memory and FMA latency: 2.71 ms a layer
// (NVIDIA H100 80GB HBM3, 700 W; PERF.md). Four lanes a column give each scheduler four warps to switch
// between, for two shuffles and two adds a step per lane.
//
// In place. state_out may equal state_in: each thread reads its own
// elements of its block's state before the time loop and writes the same
// elements after it, and no two threads share one. The wrapper passes a
// given state as both, so prefill and decode update the layer's cache slice
// in place (the reference returns a new state).
//
// What the simple design leaves on the table: the arithmetic is on CUDA
// cores and each step's shared-memory loads are served a quarter-warp at a
// time; at rwkv6-7b prefill it is ~13x its bytes bound, which is why bf16
// went to the chunked design (PERF.md has both kernels' times).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CH = 16;  // timesteps staged per chunk
constexpr int KS = 4;   // threads per state column (the key dim is split KS ways)

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const float* u;         // (H, D) f32, contiguous
  const float* state_in;  // (B, H, D, D) f32, contiguous, or null
  void* o;                // (B, S, H, D) contiguous
  float* state_out;       // (B, H, D, D) f32, contiguous; may equal state_in
  int B, S, H;
  int64_t r_sb, r_ss, r_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
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

template <typename T, int D>
__global__ void __launch_bounds__(KS * D) wkv6_fwd_kernel(const Params p) {
  constexpr int M = D / KS;  // state rows per thread
  __shared__ float4 s_rkwu[2][CH][D];  // (r, k, w, u) of key index i at step t
  __shared__ float s_v[2][CH][D];      // v of value index j at step t

  const int tid = threadIdx.x;
  const int h = blockIdx.x % p.H;
  const int b = blockIdx.x / p.H;
  const int S = p.S;

  // Loading role: thread tid brings element e of one of r, k, v, w (role
  // 0..3) for every step of a chunk, so a warp's loads are contiguous.
  const int role = tid / D, e = tid % D;
  const T* src;
  int64_t src_ss;
  float* dst;  // buffer 0, step 0; the step stride is dst_ts floats
  int dst_ts;
  if (role == 0) {
    src = static_cast<const T*>(p.r) + b * p.r_sb + h * p.r_sh;
    src_ss = p.r_ss;
    dst = &s_rkwu[0][0][e].x;
  } else if (role == 1) {
    src = static_cast<const T*>(p.k) + b * p.k_sb + h * p.k_sh;
    src_ss = p.k_ss;
    dst = &s_rkwu[0][0][e].y;
  } else if (role == 2) {
    src = static_cast<const T*>(p.v) + b * p.v_sb + h * p.v_sh;
    src_ss = p.v_ss;
    dst = &s_v[0][0][e];
  } else {
    src = static_cast<const T*>(p.w) + b * p.w_sb + h * p.w_sh;
    src_ss = p.w_ss;
    dst = &s_rkwu[0][0][e].z;
  }
  src += e;
  dst_ts = role == 2 ? D : 4 * D;
  const int dst_bs = CH * dst_ts;  // buffer stride
  if (role == 0) {  // u is the same at every step: written once, never restaged
    const float ue = p.u[h * D + e];
#pragma unroll
    for (int t = 0; t < 2 * CH; ++t) s_rkwu[t / CH][t % CH][e].w = ue;
  }

  // Compute role: thread tid owns rows i = q + KS*m (m < M) of column j of
  // the state; interleaved rows keep the KS float4 reads of a warp in
  // distinct banks.
  const int j = tid / KS, q = tid % KS;
  const int64_t o_ss = (int64_t)p.H * D;
  T* o = static_cast<T*>(p.o) + (int64_t)b * S * o_ss + (int64_t)h * D + j;
  const int64_t st_off = ((int64_t)b * p.H + h) * D * D + (int64_t)q * D + j;

  float s[M];
  if (p.state_in != nullptr) {
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = p.state_in[st_off + (int64_t)m * KS * D];
  } else {
#pragma unroll
    for (int m = 0; m < M; ++m) s[m] = 0.f;
  }

  T pf[CH];  // one chunk's loads, held as the input type until staged
  const T zero = from_f32<T>(0.f);
  auto load = [&](int t0) {
#pragma unroll
    for (int t = 0; t < CH; ++t) pf[t] = t0 + t < S ? src[(t0 + t) * src_ss] : zero;
  };
  auto stage = [&](int buf) {
#pragma unroll
    for (int t = 0; t < CH; ++t) dst[buf * dst_bs + t * dst_ts] = to_f32(pf[t]);
  };

  const int n_chunks = (S + CH - 1) / CH;
  load(0);
  stage(0);
  __syncthreads();
  for (int c = 0; c < n_chunks; ++c) {
    const int buf = c & 1;
    const int t0 = c * CH;
    const bool more = c + 1 < n_chunks;
    if (more) load(t0 + CH);  // in flight while this chunk is computed
    const int nt = min(CH, S - t0);
#pragma unroll 1
    for (int t = 0; t < nt; ++t) {
      const float vj = s_v[buf][t][j];
      const float4* x = &s_rkwu[buf][t][q];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 y = x[m * KS];  // (r_i, k_i, w_i, u_i), i = q + KS*m
        const float kv = y.y * vj;
        acc[m & 1] = fmaf(y.x, fmaf(y.w, kv, s[m]), acc[m & 1]);
        s[m] = fmaf(y.z, s[m], kv);
      }
      // sum over the KS threads of column j (adjacent lanes)
      float part = acc[0] + acc[1];
#pragma unroll
      for (int off = 1; off < KS; off <<= 1) part += __shfl_xor_sync(0xffffffffu, part, off);
      if (q == 0) o[(int64_t)(t0 + t) * o_ss] = from_f32<T>(part);
    }
    if (more) stage(buf ^ 1);  // the other buffer's readers finished before the last sync
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < M; ++m) p.state_out[st_off + (int64_t)m * KS * D] = s[m];
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  wkv6_fwd_kernel<T, D><<<p.B * p.H, KS * D, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w and the output). u and both
// states are f32 and contiguous; the output is contiguous (B, S, H, D).
// Returns a cudaError_t (0 = success).
extern "C" int wkv6_fwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* state_in, void* o, float* state_out,
                        int dtype, int B, int S, int H, int D,
                        int64_t r_sb, int64_t r_ss, int64_t r_sh,
                        int64_t k_sb, int64_t k_ss, int64_t k_sh,
                        int64_t v_sb, int64_t v_ss, int64_t v_sh,
                        int64_t w_sb, int64_t w_ss, int64_t w_sh,
                        void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || state_out == nullptr) return (int)cudaErrorInvalidValue;
  const Params p{r, k, v, w, u, state_in, o, state_out, B, S, H,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 16) return (int)launch<float, 16>(p, s);
    if (D == 32) return (int)launch<float, 32>(p, s);
    if (D == 64) return (int)launch<float, 64>(p, s);
  } else if (dtype == 1) {
    if (D == 16) return (int)launch<__nv_bfloat16, 16>(p, s);
    if (D == 32) return (int)launch<__nv_bfloat16, 32>(p, s);
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}
