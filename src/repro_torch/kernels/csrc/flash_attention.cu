// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.flash_attention). It computes the same function:
// online softmax with running (m, l, acc) in f32, causal / sliding-window /
// chunk masks with where-masking at -1e30, fully masked KV tiles skipped,
// GQA as kv_head = h / (H / KV) with no K/V replication, optional tanh
// softcap, l clamped at 1e-20 so a row with no valid key yields 0, output in
// the input dtype.
//
// What bounds it on an H100. At rsc-llm prefill (B 4, S 2048, H 32, KV 8,
// D 128, causal) one layer does 4*B*H*S^2*D/2 ~= 1.37e11 FLOPs and must move
// (2H + 2KV)*B*S*D*2 bytes ~= 168 MB: ~0.14 ms at the 989 TFLOP/s bf16
// tensor-core peak against ~0.05 ms at 3.35 TB/s. So it is compute-bound.
//
// Design. One thread block per (b, h, 64-row q tile); a loop inside the
// block over 64-row KV tiles takes the place of the Pallas kernel's
// sequential kv grid axis. Q, K and V tiles are staged in shared memory as
// f32 (K and Q rows padded by one float so column reads hit distinct banks),
// and 256 threads each own a 4x4 patch of the score tile and 4 rows x D/16
// columns of the output. All arithmetic is CUDA-core f32 FMA: f32 inputs get
// true f32 products (no TF32, no bf16 staging). q/k/v are read in their
// (B, S, H, D) layout through the strides passed in; the last dim must be
// contiguous. A ragged last tile is masked, so any S works. D is a template
// argument: 16 and 32 (the smoke configs), 64, 128 and 256 (recurrentgemma-9b;
// its 213,760 bytes of staging fit under the 232,448-byte opt-in limit, one
// block per SM, as at 128).
//
// What the simple design leaves on the table: no tensor cores (wgmma or
// mma.sync), no TMA / cp.async pipelining of the next tile, and element-wise
// loads. Its time against the bound is recorded in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 256;   // threads: 16 x 16
constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int B, Sq, Sk, H, KV;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal, window, chunk;
  float softcap, scale;
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

// Reductions over the 16 lanes that share one row (lanes ty*16 .. ty*16+15).
__device__ __forceinline__ float row_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float row_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(NT) flash_fwd_kernel(const Params p) {
  constexpr int QS = D + 1;   // padded row stride of the Q and K tiles
  constexpr int PS = BK + 1;  // padded row stride of the P tile
  constexpr int DC = D / 16;  // output columns per thread

  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * QS;
  float* sV = sK + BK * QS;
  float* sP = sV + BK * D;

  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  const int q_start = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);

  const T* q = static_cast<const T*>(p.q) + b * p.q_sb + h * p.q_sh;
  const T* k = static_cast<const T*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const T* v = static_cast<const T*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  T* o = static_cast<T*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q_start + r;
    sQ[r * QS + c] = qi < p.Sq ? to_f32(q[qi * p.q_ss + c]) : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int q_last = q_start + BQ - 1;
  const int n_kv = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    // tile-level reachability: can any (q, k) pair in this tile attend?
    bool run = true;
    if (p.causal) run = run && (q_last >= k_start);
    if (p.window > 0) run = run && (q_start < k_start + BK + p.window);
    if (p.chunk > 0) {
      run = run && (q_last / p.chunk >= k_start / p.chunk);
      run = run && (q_start / p.chunk <= (k_start + BK - 1) / p.chunk);
    }
    if (!run) continue;  // uniform over the block

    __syncthreads();  // the previous tile's readers of sK / sV / sP are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k_start + r;
      const bool in = kj < p.Sk;
      sK[r * QS + c] = in ? to_f32(k[kj * p.k_ss + c]) : 0.f;
      sV[r * D + c] = in ? to_f32(v[kj * p.v_ss + c]) : 0.f;
    }
    __syncthreads();

    // S = Q K^T for rows ty*4 + i, columns tx + 16*j
    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
    for (int d = 0; d < D; ++d) {
      float a[4], bk[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) a[i] = sQ[(ty * 4 + i) * QS + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) bk[j] = sK[(tx + 16 * j) * QS + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(a[i], bk[j], s[i][j]);
    }

    // mask, online softmax, P to shared memory
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_start + ty * 4 + i;
      bool ok[4];
      float rmax = NEG_INF;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kj = k_start + tx + 16 * j;
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        bool keep = kj < p.Sk;
        if (p.causal) keep = keep && (qi >= kj);
        if (p.window > 0) keep = keep && (qi - kj < p.window);
        if (p.chunk > 0) keep = keep && (qi / p.chunk == kj / p.chunk);
        ok[j] = keep;
        s[i][j] = keep ? x : NEG_INF;
        rmax = fmaxf(rmax, s[i][j]);
      }
      rmax = row_max(rmax);
      const float m_new = fmaxf(m[i], rmax);
      float rsum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // masked entries are 0 even when the whole row is masked (m_new = -1e30)
        const float pj = ok[j] ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * PS + tx + 16 * j] = pj;
        rsum += pj;
      }
      rsum = row_sum(rsum);
      const float corr = expf(m[i] - m_new);
      l[i] = l[i] * corr + rsum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[i][c] *= corr;
    }
    __syncthreads();

    // acc += P V
#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vv = sV[kk * D + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][c] = fmaf(pv[i], vv, acc[i][c]);
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_start + ty * 4 + i;
    if (qi >= p.Sq) continue;
    const float lsafe = fmaxf(l[i], 1e-20f);
#pragma unroll
    for (int c = 0; c < DC; ++c) o[qi * p.o_ss + tx + 16 * c] = from_f32<T>(acc[i][c] / lsafe);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<T, D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                   int causal, int window, int chunk, float softcap, float scale,
                                   void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, B, Sq, Sk, H, KV,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 causal, window, chunk, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {
    if (D == 16) return (int)launch<float, 16>(p, s);
    if (D == 32) return (int)launch<float, 32>(p, s);
    if (D == 64) return (int)launch<float, 64>(p, s);
    if (D == 128) return (int)launch<float, 128>(p, s);
    if (D == 256) return (int)launch<float, 256>(p, s);
  } else if (dtype == 1) {
    if (D == 16) return (int)launch<__nv_bfloat16, 16>(p, s);
    if (D == 32) return (int)launch<__nv_bfloat16, 32>(p, s);
    if (D == 64) return (int)launch<__nv_bfloat16, 64>(p, s);
    if (D == 128) return (int)launch<__nv_bfloat16, 128>(p, s);
    if (D == 256) return (int)launch<__nv_bfloat16, 256>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
