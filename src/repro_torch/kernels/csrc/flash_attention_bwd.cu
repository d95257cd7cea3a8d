// Flash-attention backward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces the VJP of repro/kernels/ops.py::_flash (_flash_bwd_impl), the
// backward that the JAX package pairs with the Pallas forward kernel of
// repro/kernels/flash_attention.py (which defines none of its own). It
// computes the same function from (q, k, v, o, lse, dO), accumulating in
// f32:
//   delta = rowsum(dO * O)
//   P     = exp(s - lse) where the mask keeps (q, k), else 0
//           (s = q.k * scale, then softcap * tanh(s / softcap) when set)
//   dV    = P^T dO,  dP = dO V^T,  dS = P (dP - delta) [(1 - tanh^2)] * scale
//   dQ    = dS K,    dK = dS^T Q
// with causal / sliding-window / chunk masks, GQA / MQA (dK and dV summed
// over the G query heads of a kv head), and dq, dk, dv written in the input
// dtype.
//
// Three kernels, no atomics, so two runs give the same bits (the trainer's
// bit-exact resume depends on it):
//   delta  one warp per (b, s, h) row, a fixed shuffle-tree sum.
//   dkdv   one block per (b, kv head, key tile). K and V stay in shared
//          memory; the block loops over the G heads of its group and over
//          the q tiles that the mask does not skip (tile_class, as the
//          forward), recomputes S and dP, and keeps dK and dV in registers
//          until the end.
//   dq     one block per (b, head, q tile). Q and dO stay in shared memory;
//          the block loops over the key tiles, recomputes S, dP and dS, and
//          keeps dQ in registers.
//
// What bounds it on an H100: the function needs 5 products of 2 B H S^2 D
// (halved under a causal mask); at rsc-llm training (B 2, S 2048, H 32,
// KV 8, D 128) that is 1.72e11 FLOP, 0.174 ms at the 989 TFLOP/s bf16
// tensor-core peak, against ~0.1 ms for its bytes: operations bound. Both
// designs do 7 products (S and dP twice). Their times are in PERF.md.
//
// bf16 -- mma.sync m16n8k16 on the tensor cores (namespace tc). 4 warps a
//   block; in dkdv a warp owns 16 keys of a 64-key tile and steps over q in
//   32-row tiles, in dq a warp owns 16 q rows of a 64-row tile and steps over
//   keys in 32-key tiles. Tiles are staged in shared memory by cp.async in
//   rows padded to D + 8 (conflict-free ldmatrix). S^T and dP^T (dkdv) or S
//   and dP (dq) come out in mma accumulators; P and dS are rounded to bf16
//   and fed back from registers as the A operand of the next products (the
//   accumulator layout of two n8 tiles is the A layout of one k16 step), with
//   Q, dO or K as B through ldmatrix(.trans). Each step waits for its own
//   tiles: a double-buffered cp.async ring was tried and was slower (PERF.md).
//   Left on the table: wgmma, more rows a block, fewer registers (the
//   dK / dV accumulators hold two blocks an SM).
//
// f32 -- CUDA-core FMA (namespace cc), true f32 products for the 5e-5
//   checks (tensor cores take f32 only as TF32). 256 threads as 16 x 16; a thread owns
//   a 4 x 4 patch of each 64 x 64 score tile and 4 rows x D / 16 columns of
//   its output; tiles staged in shared memory as f32 (rows padded by one
//   float): 149 KB at D 128. D 256 would need 280 KB in either design's
//   layout, so both take D <= 128.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"

namespace {

struct BwdParams {
  const void* q;     // (B, Sq, H, D), contiguous
  const void* k;     // (B, Sk, KV, D)
  const void* v;
  const void* o;     // (B, Sq, H, D)
  const void* dout;  // (B, Sq, H, D)
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sq), written by the first kernel
  void* dq;          // like q
  void* dk;          // like k
  void* dv;          // like v
  int B, Sq, Sk, H, KV;
  int causal, window, chunk;
  float softcap, scale;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d]: one warp a row
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams p, int D) {
  const int row = (blockIdx.x * 256 + threadIdx.x) >> 5;  // b * Sq * H + s * H + h
  const int lane = threadIdx.x & 31;
  if (row >= p.B * p.Sq * p.H) return;  // uniform over the warp
  const T* o = static_cast<const T*>(p.o) + (int64_t)row * D;
  const T* d = static_cast<const T*>(p.dout) + (int64_t)row * D;
  float acc = 0.f;
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f(d[c]), to_f(o[c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    const int h = row % p.H, s = (row / p.H) % p.Sq, b = row / (p.H * p.Sq);
    p.delta[((int64_t)b * p.H + h) * p.Sq + s] = acc;
  }
}

template <typename T>
cudaError_t launch_delta(const BwdParams& p, int D, cudaStream_t stream) {
  const int64_t rows = (int64_t)p.B * p.Sq * p.H;
  delta_kernel<T><<<(unsigned)((rows * 32 + 255) / 256), 256, 0, stream>>>(p, D);
  return cudaGetLastError();
}

// The mask and the scaled, softcapped score of one (q, k) pair, in the
// reference's order: returns P and turns dp into dS.
__device__ __forceinline__ float prob_and_grad(float qk, float& dp, float lse, float del,
                                               bool keep, const BwdParams& p) {
  float x = qk * p.scale, dsc = 1.f;
  if (p.softcap > 0.f) {
    const float t = tanhf(x / p.softcap);
    x = t * p.softcap;
    dsc = 1.f - t * t;
  }
  const float pij = keep ? expf(x - lse) : 0.f;
  dp = pij * (dp - del) * dsc * p.scale;
  return pij;
}

namespace cc {

constexpr int BQ = 64;   // q rows a tile
constexpr int BK = 64;   // keys a tile
constexpr int NT = 256;  // threads: 16 x 16
constexpr int PS = BK + 1;  // padded row stride of the score tile

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (size_t)(4 * 64 * (D + 1) + BQ * PS + 2 * BQ);
}

// rows start .. start + 63 of a (rows, D) slab whose rows are row_stride
// elements apart, into dst (row stride D + 1); rows past limit are 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int start, int limit) {
  for (int idx = threadIdx.x; idx < 64 * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = start + r;
    dst[r * (D + 1) + c] = gr < limit ? src[(int64_t)gr * row_stride + c] : 0.f;
  }
}

// s[i][j] = sum_d a[ty*4+i][d] * b[tx+16j][d] over two staged tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[4][4], const float* a, const float* b,
                                         int ty, int tx) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(ty * 4 + i) * LD + d];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// From q.k (s) and dO.v (dp) of a tile: s becomes P and dp becomes dS.
// sL / sDel hold the tile's lse and delta by q row.
__device__ __forceinline__ void probs_and_grads(float (&s)[4][4], float (&dp)[4][4],
                                                const float* sL, const float* sDel, int q_start,
                                                int k_start, int ty, int tx, const BwdParams& p) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = ty * 4 + i, qi = q_start + r;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const bool keep = qi < p.Sq && attends(qi, k_start + tx + 16 * j, p);
      s[i][j] = prob_and_grad(s[i][j], dp[i][j], sL[r], sDel[r], keep, p);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const BwdParams p) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + BK * LD;
  float* sQ = sV + BK * LD;
  float* sdO = sQ + BQ * LD;
  float* sP = sdO + BQ * LD;  // P, then dS
  float* sL = sP + BQ * PS;
  float* sDel = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_start = blockIdx.x * BK, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;

  load_tile<D>(sK, static_cast<const float*>(p.k) + ((int64_t)b * p.Sk * p.KV + kvh) * D, kv_rs,
                  k_start, p.Sk);
  load_tile<D>(sV, static_cast<const float*>(p.v) + ((int64_t)b * p.Sk * p.KV + kvh) * D, kv_rs,
                  k_start, p.Sk);

  float dk[4][DC], dv[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (p.Sq + BQ - 1) / BQ;
  for (int g = 0; g < G; ++g) {
    const int h = kvh * G + g;
    const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
    const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_start = qt * BQ;
      if (tile_class(q_start, BQ, k_start, BK, p.Sq, p.Sk, p.causal, p.window, p.chunk) == SKIP)
        continue;  // uniform over the block
      __syncthreads();  // the last tile's readers of sQ / sdO / sP are done
      load_tile<D>(sQ, static_cast<const float*>(p.q) + head, q_rs, q_start, p.Sq);
      load_tile<D>(sdO, static_cast<const float*>(p.dout) + head, q_rs, q_start, p.Sq);
      for (int r = tid; r < BQ; r += NT) {
        const int qi = q_start + r;
        sL[r] = qi < p.Sq ? lse[qi] : 0.f;
        sDel[r] = qi < p.Sq ? delta[qi] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];  // rows: q, columns: keys
      tile_dot<D>(s, sQ, sK, ty, tx);
      tile_dot<D>(dp, sdO, sV, ty, tx);
      probs_and_grads(s, dp, sL, sDel, q_start, k_start, ty, tx, p);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * PS + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dV[key][d] += sum_q P[q][key] dO[q][d]; this thread: keys ty*4+i, d tx+16c
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) pv[i] = sP[qq * PS + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float x = sdO[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dv[i][c] = fmaf(pv[i], x, dv[i][c]);
        }
      }
      __syncthreads();  // P is read no more
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sP[(ty * 4 + i) * PS + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK[key][d] += sum_q dS[q][key] Q[q][d]
      for (int qq = 0; qq < BQ; ++qq) {
        float ds[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) ds[i] = sP[qq * PS + ty * 4 + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float x = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < 4; ++i) dk[i][c] = fmaf(ds[i], x, dk[i][c]);
        }
      }
    }
  }

  float* dk_out = static_cast<float*>(p.dk) + ((int64_t)b * p.Sk * p.KV + kvh) * D;
  float* dv_out = static_cast<float*>(p.dv) + ((int64_t)b * p.Sk * p.KV + kvh) * D;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kj = k_start + ty * 4 + i;
    if (kj >= p.Sk) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      dk_out[kj * kv_rs + tx + 16 * c] = dk[i][c];
      dv_out[kj * kv_rs + tx + 16 * c] = dv[i][c];
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(const BwdParams p) {
  constexpr int LD = D + 1, DC = D / 16;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + BQ * LD;
  float* sK = sdO + BQ * LD;
  float* sV = sK + BK * LD;
  float* sS = sV + BK * LD;  // dS
  float* sL = sS + BQ * PS;
  float* sDel = sL + BQ;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_start = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;
  const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
  const int64_t kv_head = ((int64_t)b * p.Sk * p.KV + kvh) * D;

  load_tile<D>(sQ, static_cast<const float*>(p.q) + head, q_rs, q_start, p.Sq);
  load_tile<D>(sdO, static_cast<const float*>(p.dout) + head, q_rs, q_start, p.Sq);
  const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
  const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
  for (int r = tid; r < BQ; r += NT) {
    const int qi = q_start + r;
    sL[r] = qi < p.Sq ? lse[qi] : 0.f;
    sDel[r] = qi < p.Sq ? delta[qi] : 0.f;
  }

  float dq[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  const int n_kt = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * BK;
    if (tile_class(q_start, BQ, k_start, BK, p.Sq, p.Sk, p.causal, p.window, p.chunk) == SKIP)
      continue;  // uniform over the block
    __syncthreads();  // the last tile's readers of sK / sV / sS are done
    load_tile<D>(sK, static_cast<const float*>(p.k) + kv_head, kv_rs, k_start, p.Sk);
    load_tile<D>(sV, static_cast<const float*>(p.v) + kv_head, kv_rs, k_start, p.Sk);
    __syncthreads();

    float s[4][4], dp[4][4];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    probs_and_grads(s, dp, sL, sDel, q_start, k_start, ty, tx, p);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) sS[(ty * 4 + i) * PS + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[q][d] += sum_key dS[q][key] K[key][d]; this thread: q rows ty*4+i, d tx+16c
    for (int kk = 0; kk < BK; ++kk) {
      float ds[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) ds[i] = sS[(ty * 4 + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < 4; ++i) dq[i][c] = fmaf(ds[i], x, dq[i][c]);
      }
    }
  }

  float* dq_out = static_cast<float*>(p.dq) + head;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qi = q_start + ty * 4 + i;
    if (qi >= p.Sq) continue;
#pragma unroll
    for (int c = 0; c < DC; ++c) dq_out[qi * q_rs + tx + 16 * c] = dq[i][c];
  }
}

template <int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<float>(p, D, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  if ((err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  dkdv_kernel<D><<<dim3((p.Sk + BK - 1) / BK, p.KV, p.B), NT, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((p.Sq + BQ - 1) / BQ, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cc

namespace tc {

using bf16 = __nv_bfloat16;
constexpr int NT = 128;  // 4 warps
constexpr int KB = 64;   // keys a dkdv block, 16 a warp
constexpr int QS = 32;   // q rows a dkdv step
constexpr int QB = 64;   // q rows a dq block, 16 a warp
constexpr int KS = 32;   // keys a dq step

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}
// 16 bytes global -> shared; zero-filled when !valid
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" ::: "memory");
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
__device__ __forceinline__ void ldsm_x4_t(uint32_t (&d)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(d[0]), "=r"(d[1]), "=r"(d[2]), "=r"(d[3])
               : "r"(addr));
}
// d += a b, m16n8k16, bf16 operands, f32 accumulator
__device__ __forceinline__ void mma(float (&d)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}
// The A operand (16 x 16, k = 16 ks ..) from the accumulators of n8 tiles
// 2 ks and 2 ks + 1: their layout is the A layout, rounded to bf16.
__device__ __forceinline__ void acc_to_a(uint32_t (&a)[4], const float (&c)[4][4], int ks) {
  a[0] = pack(c[2 * ks][0], c[2 * ks][1]);
  a[1] = pack(c[2 * ks][2], c[2 * ks][3]);
  a[2] = pack(c[2 * ks + 1][0], c[2 * ks + 1][1]);
  a[3] = pack(c[2 * ks + 1][2], c[2 * ks + 1][3]);
}

// rows start .. start + rows - 1 of a (., D) bf16 slab whose rows are rs
// elements apart, into shared memory at a pitch of D + 8; rows past limit 0
template <int D>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src, int64_t rs, int start,
                                          int rows, int limit) {
  constexpr int VPR = D / 8;  // 16-byte vectors a row
  for (int i = threadIdx.x; i < rows * VPR; i += NT) {
    const int r = i / VPR, c = (i % VPR) * 8, gr = start + r;
    const bool ok = gr < limit;
    cp_async16(smem_u32(dst + r * (D + 8) + c), src + (ok ? (int64_t)gr * rs + c : 0), ok);
  }
}

// acc[n8 tile][4] += A (16 rows of a, from row a_row) times the rows b_row ..
// b_row + 31 of b, transposed: the 16 x 32 block of a b^T, both K-major
// (rows of D contiguous) in shared memory at a pitch of D + 8
template <int D>
__device__ __forceinline__ void rows_dot(float (&acc)[4][4], const bf16* a, int a_row,
                                         const bf16* b, int b_row, int lane) {
  constexpr int P = D + 8;
  const int lr = lane & 7, lq = lane >> 3;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t af[4];
    ldsm_x4(af, smem_u32(a + (a_row + lr + (lq & 1) * 8) * P + kk * 16 + (lq >> 1) * 8));
#pragma unroll
    for (int np = 0; np < 2; ++np) {
      uint32_t bf[4];  // b0, b1 of n8 tile 2 np, then of 2 np + 1
      ldsm_x4(bf, smem_u32(b + (b_row + np * 16 + lr + (lq >> 1) * 8) * P + kk * 16 +
                           (lq & 1) * 8));
      mma(acc[2 * np], af, bf[0], bf[1]);
      mma(acc[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// out[n8 tile of D][4] += A (16 x 32, from the accumulators c) times the 32
// rows b_row .. of b (row-major, D contiguous): B read transposed
template <int D>
__device__ __forceinline__ void acc_times_rows(float (&out)[D / 8][4], const float (&c)[4][4],
                                               const bf16* b, int b_row, int lane) {
  constexpr int P = D + 8;
  const int lr = lane & 7, lq = lane >> 3;
#pragma unroll
  for (int ks = 0; ks < 2; ++ks) {
    uint32_t af[4];
    acc_to_a(af, c, ks);
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t bf[4];
      ldsm_x4_t(bf, smem_u32(b + (b_row + ks * 16 + lr + (lq & 1) * 8) * P + np * 16 +
                             (lq >> 1) * 8));
      mma(out[2 * np], af, bf[0], bf[1]);
      mma(out[2 * np + 1], af, bf[2], bf[3]);
    }
  }
}

// accumulator element e of n8 tile nt: row g + 8 (e >> 1), column 8 nt + 2 t + (e & 1)
template <int D>
__device__ __forceinline__ void store_rows(bf16* out, int64_t rs, const float (&acc)[D / 8][4],
                                           int row0, int limit, int lane) {
  const int g = lane >> 2, t = lane & 3;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row0 + g + 8 * half;
    if (r >= limit) continue;
#pragma unroll
    for (int nt = 0; nt < D / 8; ++nt)
      *reinterpret_cast<__nv_bfloat162*>(out + r * rs + nt * 8 + 2 * t) =
          __floats2bfloat162_rn(acc[nt][2 * half], acc[nt][2 * half + 1]);
  }
}

template <int D>
constexpr size_t smem_bytes() {  // either kernel: two 64-row and two 32-row tiles
  return sizeof(bf16) * (size_t)(2 * 64 + 2 * 32) * (D + 8) + 2 * 32 * sizeof(float);
}

// dK, dV of 64 keys; warp w owns keys 16 w .. 16 w + 15 of the tile
template <int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const BwdParams p) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);  // [KB][P]
  bf16* sV = sK + KB * P;                        // [KB][P]
  bf16* sQ = sV + KB * P;                        // [QS][P]
  bf16* sdO = sQ + QS * P;                       // [QS][P]
  float* sL = reinterpret_cast<float*>(sdO + QS * P);  // [QS]
  float* sDel = sL + QS;

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  const int k_start = blockIdx.x * KB, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;
  const int64_t kv_head = ((int64_t)b * p.Sk * p.KV + kvh) * D;
  load_rows<D>(sK, static_cast<const bf16*>(p.k) + kv_head, kv_rs, k_start, KB, p.Sk);
  load_rows<D>(sV, static_cast<const bf16*>(p.v) + kv_head, kv_rs, k_start, KB, p.Sk);
  cp_async_wait_all();  // read after the first step's __syncthreads

  float dk[D / 8][4] = {}, dv[D / 8][4] = {};
  const int key0 = k_start + warp * 16;  // this thread's keys: key0 + g, key0 + g + 8
  const int n_qt = (p.Sq + QS - 1) / QS;
  for (int gi = 0; gi < G; ++gi) {
    const int h = kvh * G + gi;
    const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
    const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_start = qt * QS;
      const int cls = tile_class(q_start, QS, k_start, KB, p.Sq, p.Sk, p.causal, p.window,
                                 p.chunk);
      if (cls == SKIP) continue;  // uniform over the block
      __syncthreads();  // the last step's readers of sQ / sdO / sL / sDel are done
      load_rows<D>(sQ, static_cast<const bf16*>(p.q) + head, q_rs, q_start, QS, p.Sq);
      load_rows<D>(sdO, static_cast<const bf16*>(p.dout) + head, q_rs, q_start, QS, p.Sq);
      if (threadIdx.x < QS) {
        const int qi = q_start + threadIdx.x;
        sL[threadIdx.x] = qi < p.Sq ? lse[qi] : 0.f;
        sDel[threadIdx.x] = qi < p.Sq ? delta[qi] : 0.f;
      }
      cp_async_wait_all();
      __syncthreads();

      // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 q rows
      float s[4][4] = {}, dp[4][4] = {};
      rows_dot<D>(s, sK, warp * 16, sQ, 0, lane);
      rows_dot<D>(dp, sV, warp * 16, sdO, 0, lane);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int kj = key0 + g + 8 * (e >> 1), ql = nt * 8 + 2 * t + (e & 1);
          const int qi = q_start + ql;
          const bool keep = qi < p.Sq && (cls == FULL || attends(qi, kj, p));
          s[nt][e] = prob_and_grad(s[nt][e], dp[nt][e], sL[ql], sDel[ql], keep, p);
        }
      // dV += P^T dO and dK += dS^T Q over the 32 q rows
      acc_times_rows<D>(dv, s, sdO, 0, lane);
      acc_times_rows<D>(dk, dp, sQ, 0, lane);
    }
  }
  store_rows<D>(static_cast<bf16*>(p.dk) + kv_head, kv_rs, dk, key0, p.Sk, lane);
  store_rows<D>(static_cast<bf16*>(p.dv) + kv_head, kv_rs, dv, key0, p.Sk, lane);
}

// dQ of 64 q rows of one head; warp w owns rows 16 w .. 16 w + 15
template <int D>
__global__ void __launch_bounds__(NT) dq_kernel(const BwdParams p) {
  constexpr int P = D + 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);  // [QB][P]
  bf16* sdO = sQ + QB * P;                       // [QB][P]
  bf16* sK = sdO + QB * P;                       // [KS][P]
  bf16* sV = sK + KS * P;                        // [KS][P]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  // under a causal mask the last q tiles do the most work: they go first
  const int qt = p.causal ? gridDim.x - 1 - blockIdx.x : blockIdx.x;
  const int q_start = qt * QB, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;
  const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
  const int64_t kv_head = ((int64_t)b * p.Sk * p.KV + kvh) * D;
  load_rows<D>(sQ, static_cast<const bf16*>(p.q) + head, q_rs, q_start, QB, p.Sq);
  load_rows<D>(sdO, static_cast<const bf16*>(p.dout) + head, q_rs, q_start, QB, p.Sq);
  cp_async_wait_all();  // read after the first step's __syncthreads

  const int row0 = q_start + warp * 16;  // this thread's rows: row0 + g, row0 + g + 8
  float lse[2], del[2];
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int qi = row0 + g + 8 * half;
    const int64_t at = ((int64_t)b * p.H + h) * p.Sq + qi;
    lse[half] = qi < p.Sq ? p.lse[at] : 0.f;
    del[half] = qi < p.Sq ? p.delta[at] : 0.f;
  }

  float dq[D / 8][4] = {};
  const int n_kt = (p.Sk + KS - 1) / KS;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * KS;
    const int cls = tile_class(q_start, QB, k_start, KS, p.Sq, p.Sk, p.causal, p.window,
                               p.chunk);
    if (cls == SKIP) continue;  // uniform over the block
    __syncthreads();  // the last step's readers of sK / sV are done
    load_rows<D>(sK, static_cast<const bf16*>(p.k) + kv_head, kv_rs, k_start, KS, p.Sk);
    load_rows<D>(sV, static_cast<const bf16*>(p.v) + kv_head, kv_rs, k_start, KS, p.Sk);
    cp_async_wait_all();
    __syncthreads();

    // S = Q K^T and dP = dO V^T: this warp's 16 q rows x 32 keys
    float s[4][4] = {}, dp[4][4] = {};
    rows_dot<D>(s, sQ, warp * 16, sK, 0, lane);
    rows_dot<D>(dp, sdO, warp * 16, sV, 0, lane);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int half = e >> 1, qi = row0 + g + 8 * half;
        const int kj = k_start + nt * 8 + 2 * t + (e & 1);
        const bool keep = qi < p.Sq && (cls == FULL || attends(qi, kj, p));
        prob_and_grad(s[nt][e], dp[nt][e], lse[half], del[half], keep, p);
      }
    // dQ += dS K over the 32 keys
    acc_times_rows<D>(dq, dp, sK, 0, lane);
  }
  store_rows<D>(static_cast<bf16*>(p.dq) + head, q_rs, dq, row0, p.Sq, lane);
}

template <int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  cudaError_t err = launch_delta<bf16>(p, D, stream);
  if (err != cudaSuccess) return err;
  constexpr size_t smem = smem_bytes<D>();
  if ((err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  dkdv_kernel<D><<<dim3((p.Sk + KB - 1) / KB, p.KV, p.B), NT, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((p.Sq + QB - 1) / QB, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace tc

// the design follows the dtype: bf16 on the tensor cores, f32 on CUDA cores
cudaError_t launch_d(const BwdParams& p, int dtype, int D, cudaStream_t s) {
  if (dtype == 1) {
    if (D == 16) return tc::launch<16>(p, s);
    if (D == 32) return tc::launch<32>(p, s);
    if (D == 64) return tc::launch<64>(p, s);
    if (D == 128) return tc::launch<128>(p, s);
  } else if (dtype == 0) {
    if (D == 16) return cc::launch<16>(p, s);
    if (D == 32) return cc::launch<32>(p, s);
    if (D == 64) return cc::launch<64>(p, s);
    if (D == 128) return cc::launch<128>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every pointer 16-byte aligned); every
// tensor contiguous; delta is f32 scratch of (B, H, Sq). Returns a
// cudaError_t (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, int dtype, int B, int Sq, int Sk, int H,
                                   int KV, int D, int causal, int window, int chunk,
                                   float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0) return (int)cudaErrorInvalidValue;
  const BwdParams p{q, k, v, o, dout, lse, delta, dq, dk, dv, B, Sq, Sk, H, KV,
                    causal, window, chunk, softcap, scale};
  return (int)launch_d(p, dtype, D, static_cast<cudaStream_t>(stream));
}
