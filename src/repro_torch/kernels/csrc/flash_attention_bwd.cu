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
//   delta  a fixed shuffle-tree sum a (b, s, h) row: one warp (f32), or D / 8
//          lanes that load 16 bytes each (bf16).
//   dkdv   one block owns each (b, kv head, key tile). K and V stay in shared
//          memory; the block loops over the G heads of its group and over
//          the q tiles that the mask does not skip (tile_class, as the
//          forward), recomputes S and dP, and keeps dK and dV in registers
//          until the end.
//   dq     one block owns each (b, head, q tile). Q and dO stay in shared memory;
//          the block loops over the key tiles, recomputes S, dP and dS, and
//          keeps dQ in registers.
//
// What bounds it on an H100: the function needs 5 products of 2 B H S^2 D
// (halved under a causal mask); at rsc-llm training (B 2, S 2048, H 32,
// KV 8, D 128) that is 1.72e11 FLOP, 0.174 ms at the 989 TFLOP/s bf16
// tensor-core peak, against ~0.1 ms for its bytes: operations bound; the
// same at recurrentgemma-9b training (B 2, S 2048, H 16, KV 1, D 256).
// Both designs do 7 products (S and dP twice), so 0.243 ms is this
// design's floor; at D 256 the bf16 design does 9 (S and dP once more for
// the second half of D). Their times are in PERF.md.
//
// bf16 -- wgmma on the tensor cores, tiles fed by TMA (namespace wg). The
//   dkdv and dq kernels are persistent grids of one block per SM with the
//   heaviest causal items first, as the forward's; a block is three
//   warpgroups: one thread of the third fills a ring of mbarrier-guarded
//   stages by TMA and gives its registers to the two consumer warpgroups
//   (setmaxnreg 40 / 232), which own 64 rows each. At D 256 (Cfg) a block
//   has one consumer warpgroup and a 2-stage ring, items are 64 rows, and
//   a dK / dV item takes half of D: S^T and dP^T still contract over all of
//   D, while dK and dV keep 2 x 64 f32 a thread, as at D 128 (all of D
//   would take 2 x 128, more than the registers). Under MQA 64-key items
//   are few (128 at recurrentgemma-9b training) and as uneven as the causal
//   mask, so an item also takes only a group of the kv head's query heads
//   (the wrapper's bwd_split, 4 groups there: 512 items, 256 steps on every
//   SM); the groups' f32 partial sums go to a scratch and split_sum_kernel
//   adds them in a fixed order.
//   dkdv: an item is (b, kv head, 128-key tile); K and V stay in shared
//     memory, Q, dO and the rows' delta and lse log2(e) stream through the
//     ring, 64 q rows a stage. S^T = K Q^T and dP^T = V dO^T are wgmma
//     m64n64k16 with both operands in swizzled shared memory; P^T and dS^T
//     are made in registers (lse and delta indexed by the accumulator's
//     column, since q rows are its N dimension), rounded to bf16 and fed
//     back as the register A operand of dV += P^T dO and dK += dS^T Q
//     (m64nDk16), dO and Q read N-major through the descriptor's transpose
//     bit: one swizzled Q tile is the K-major B of S^T and the N-major B of
//     dK.
//   dq: an item is (b, head, 128-row q tile); Q and dO stay, K and V
//     stream, 64 keys a stage: S = Q K^T and dP = dO V^T (shared memory
//     operands), dQ += dS K (dS from registers, K read N-major).
//   A warpgroup whose 64 rows the mask skips for a stage still waits for it
//   and releases it, so every role passes every barrier phase. TMA
//   zero-fills rows past S; the mask drops them and no store goes past S.
//   The element-wise pass keeps the softcap's branch outside its unrolled
//   loops and masks through per-row (dq) or per-key (dkdv) intervals, as the
//   forward does: with tanhf and attends() inside the loop both kernels ran
//   about 3x slower (PERF.md). Shared memory at D 128: 64 KB resident + 3
//   stages x 32.5 KB; at D 256: 64 KB + 2 x 64.5 KB. Left on the table
//   (PERF.md): the S^T / dP^T products
//   read both operands from shared memory at n = 64, the SM's whole 128 B a
//   cycle; overlapping a warpgroup's element-wise work with its own products
//   (split waits) spilled and was slower, turn-taking between the
//   warpgroups gained 1%, float2 statistic loads spilled, and dQ with Q and
//   dO as register A operands gained 3% with a spill.

// f32 -- CUDA-core FMA (namespace cc), true f32 products for the 5e-5
//   checks (tensor cores take f32 only as TF32). 256 threads as 16 x 16; a
//   thread owns a 4 x 4 patch of each 64 x 64 score tile and 4 rows x D / 16
//   columns of its output; tiles staged in shared memory as f32 (rows padded
//   by one float): 149 KB at D 128. At D 256 64-row tiles would need 280 KB,
//   so the tiles are 32 x 32 (2 x 2 patches, 136 KB).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

struct BwdParams {
  const void* q;     // (B, Sq, H, D), contiguous
  const void* k;     // (B, Sk, KV, D)
  const void* v;
  const void* o;     // (B, Sq, H, D)
  const void* dout;  // (B, Sq, H, D)
  const float* lse;  // (B, H, Sq)
  float* delta;      // (B, H, Sp), written by the first kernel
  float* lse2;       // (B, H, Sp), lse log2(e), written by the first kernel for bf16, or null
  void* dq;          // like q
  void* dk;          // like k
  void* dv;          // like v
  float* part;       // bf16 with n_split > 1: [dk, dv][n_split][B, Sk, KV, D] f32 partial sums
  int n_split;       // head groups a bf16 dK / dV item sums over: 1, or a divisor of H / KV
  int B, Sq, Sk, H, KV;
  int Sp;  // the row pitch of delta and lse2: Sq (f32), Sq rounded up to 4 (bf16, for TMA)
  int causal, window, chunk;
  int q_off;  // q row i sits at position q_off + i
  float softcap, scale;
};

constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

// delta[b, h, s] = sum_d dO[b, s, h, d] * O[b, s, h, d], rows Sp apart;
// with lse2, lse * log2(e) at the same place. f32: one warp a row; bf16:
// 16 bytes a lane, D / 8 lanes a row. A fixed shuffle tree sums a row.
template <typename T>
__global__ void __launch_bounds__(256) delta_kernel(const BwdParams p, int D) {
  const int lanes = sizeof(T) == 4 ? 32 : D / 8;  // a row's
  const int64_t thread = (int64_t)blockIdx.x * 256 + threadIdx.x;
  const int64_t row = thread / lanes;  // b * Sq * H + s * H + h
  const int lane = (int)(thread % lanes);
  const bool in = row < (int64_t)p.B * p.Sq * p.H;
  float acc = 0.f;
  if (in) {
    const T* o = static_cast<const T*>(p.o) + row * D;
    const T* d = static_cast<const T*>(p.dout) + row * D;
    if constexpr (sizeof(T) == 4) {
      for (int c = lane; c < D; c += 32) acc = fmaf(to_f(d[c]), to_f(o[c]), acc);
    } else {
      const uint4 ov = *reinterpret_cast<const uint4*>(o + lane * 8);
      const uint4 dv = *reinterpret_cast<const uint4*>(d + lane * 8);
      const __nv_bfloat162* o2 = reinterpret_cast<const __nv_bfloat162*>(&ov);
      const __nv_bfloat162* d2 = reinterpret_cast<const __nv_bfloat162*>(&dv);
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float2 of = __bfloat1622float2(o2[j]), df = __bfloat1622float2(d2[j]);
        acc = fmaf(df.x, of.x, acc);
        acc = fmaf(df.y, of.y, acc);
      }
    }
  }
  for (int off = lanes / 2; off > 0; off >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (in && lane == 0) {
    const int h = (int)(row % p.H), s = (int)(row / p.H % p.Sq), b = (int)(row / ((int64_t)p.H * p.Sq));
    const int64_t at = ((int64_t)b * p.H + h) * p.Sp + s;
    p.delta[at] = acc;
    if (p.lse2 != nullptr) p.lse2[at] = p.lse[((int64_t)b * p.H + h) * p.Sq + s] * LOG2E;
  }
}

template <typename T>
cudaError_t launch_delta(const BwdParams& p, int D, cudaStream_t stream) {
  const int64_t threads = (int64_t)p.B * p.Sq * p.H * (sizeof(T) == 4 ? 32 : D / 8);
  delta_kernel<T><<<(unsigned)((threads + 255) / 256), 256, 0, stream>>>(p, D);
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

constexpr int NT = 256;  // threads: 16 x 16

// Score tiles of T q rows by T keys: 64 up to D 128, 32 at D 256, where
// 64-row tiles would need 280 KB of shared memory. A thread owns a P x P
// patch of a score tile.
template <int D>
struct Tile {
  static constexpr int T = D > 128 ? 32 : 64;
  static constexpr int P = T / 16;
  static constexpr int PS = T + 1;  // padded row stride of the score tile
};

// K, V, Q and dO tiles (rows padded by one float), the score tile, and a
// tile's lse and delta: 149 KB at D 128, 136 KB at D 256
template <int D>
constexpr size_t smem_bytes() {
  constexpr int T = Tile<D>::T;
  return sizeof(float) * (size_t)(4 * T * (D + 1) + T * Tile<D>::PS + 2 * T);
}

// rows start .. start + T - 1 of a (rows, D) slab whose rows are row_stride
// elements apart, into dst (row stride D + 1); rows past limit are 0
template <int D>
__device__ __forceinline__ void load_tile(float* dst, const float* src, int64_t row_stride,
                                          int start, int limit) {
  for (int idx = threadIdx.x; idx < Tile<D>::T * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int gr = start + r;
    dst[r * (D + 1) + c] = gr < limit ? src[(int64_t)gr * row_stride + c] : 0.f;
  }
}

// s[i][j] = sum_d a[ty*P+i][d] * b[tx+16j][d] over two staged tiles
template <int D>
__device__ __forceinline__ void tile_dot(float (&s)[Tile<D>::P][Tile<D>::P], const float* a,
                                         const float* b, int ty, int tx) {
  constexpr int LD = D + 1, P = Tile<D>::P;
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int j = 0; j < P; ++j) s[i][j] = 0.f;
#pragma unroll 8
  for (int d = 0; d < D; ++d) {
    float av[P], bv[P];
#pragma unroll
    for (int i = 0; i < P; ++i) av[i] = a[(ty * P + i) * LD + d];
#pragma unroll
    for (int j = 0; j < P; ++j) bv[j] = b[(tx + 16 * j) * LD + d];
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
  }
}

// From q.k (s) and dO.v (dp) of a tile: s becomes P and dp becomes dS.
// sL / sDel hold the tile's lse and delta by q row.
template <int P>
__device__ __forceinline__ void probs_and_grads(float (&s)[P][P], float (&dp)[P][P],
                                                const float* sL, const float* sDel, int q_start,
                                                int k_start, int ty, int tx, const BwdParams& p) {
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int r = ty * P + i, qi = q_start + r;
#pragma unroll
    for (int j = 0; j < P; ++j) {
      const bool keep = qi < p.Sq && attends(qi, k_start + tx + 16 * j, p);
      s[i][j] = prob_and_grad(s[i][j], dp[i][j], sL[r], sDel[r], keep, p);
    }
  }
}

template <int D>
__global__ void __launch_bounds__(NT) dkdv_kernel(const BwdParams p) {
  constexpr int LD = D + 1, DC = D / 16, T = Tile<D>::T, P = Tile<D>::P, PS = Tile<D>::PS;
  extern __shared__ float smem[];
  float* sK = smem;
  float* sV = sK + T * LD;
  float* sQ = sV + T * LD;
  float* sdO = sQ + T * LD;
  float* sP = sdO + T * LD;  // P, then dS
  float* sL = sP + T * PS;
  float* sDel = sL + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int k_start = blockIdx.x * T, kvh = blockIdx.y, b = blockIdx.z;
  const int G = p.H / p.KV;
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;

  load_tile<D>(sK, static_cast<const float*>(p.k) + ((int64_t)b * p.Sk * p.KV + kvh) * D, kv_rs,
                  k_start, p.Sk);
  load_tile<D>(sV, static_cast<const float*>(p.v) + ((int64_t)b * p.Sk * p.KV + kvh) * D, kv_rs,
                  k_start, p.Sk);

  // dK and dV are summed in three levels: a tile's T q rows (acc), a head's
  // tiles (hk, hv), the group's heads (dk, dv), so that f32 rounding grows
  // with the levels' lengths, not with their product (under MQA at D 256 a
  // key sums 16 heads x 2048 rows)
  float dk[P][DC], dv[P][DC], hk[P][DC], hv[P][DC], acc[P][DC];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dk[i][c] = dv[i][c] = 0.f;

  const int n_qt = (p.Sq + T - 1) / T;
  for (int g = 0; g < G; ++g) {
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) hk[i][c] = hv[i][c] = 0.f;
    const int h = kvh * G + g;
    const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
    const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
    const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
    for (int qt = 0; qt < n_qt; ++qt) {
      const int q_start = qt * T;
      if (tile_class(q_start, T, k_start, T, p.Sq, p.Sk,
                     p.causal, p.window, p.chunk, p.q_off) == SKIP)
        continue;  // uniform over the block
      __syncthreads();  // the last tile's readers of sQ / sdO / sP are done
      load_tile<D>(sQ, static_cast<const float*>(p.q) + head, q_rs, q_start, p.Sq);
      load_tile<D>(sdO, static_cast<const float*>(p.dout) + head, q_rs, q_start, p.Sq);
      for (int r = tid; r < T; r += NT) {
        const int qi = q_start + r;
        sL[r] = qi < p.Sq ? lse[qi] : 0.f;
        sDel[r] = qi < p.Sq ? delta[qi] : 0.f;
      }
      __syncthreads();

      float s[P][P], dp[P][P];  // rows: q, columns: keys
      tile_dot<D>(s, sQ, sK, ty, tx);
      tile_dot<D>(dp, sdO, sV, ty, tx);
      probs_and_grads<P>(s, dp, sL, sDel, q_start, k_start, ty, tx, p);
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) sP[(ty * P + i) * PS + tx + 16 * j] = s[i][j];
      __syncthreads();
      // dV[key][d] += sum_q P[q][key] dO[q][d]; this thread: keys ty*P+i, d tx+16c
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
      for (int qq = 0; qq < T; ++qq) {
        float pv[P];
#pragma unroll
        for (int i = 0; i < P; ++i) pv[i] = sP[qq * PS + ty * P + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float x = sdO[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < P; ++i) acc[i][c] = fmaf(pv[i], x, acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) hv[i][c] += acc[i][c];
      __syncthreads();  // P is read no more
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int j = 0; j < P; ++j) sP[(ty * P + i) * PS + tx + 16 * j] = dp[i][j];
      __syncthreads();
      // dK[key][d] += sum_q dS[q][key] Q[q][d]
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
      for (int qq = 0; qq < T; ++qq) {
        float ds[P];
#pragma unroll
        for (int i = 0; i < P; ++i) ds[i] = sP[qq * PS + ty * P + i];
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float x = sQ[qq * LD + tx + 16 * c];
#pragma unroll
          for (int i = 0; i < P; ++i) acc[i][c] = fmaf(ds[i], x, acc[i][c]);
        }
      }
#pragma unroll
      for (int i = 0; i < P; ++i)
#pragma unroll
        for (int c = 0; c < DC; ++c) hk[i][c] += acc[i][c];
    }
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        dk[i][c] += hk[i][c];
        dv[i][c] += hv[i][c];
      }
  }

  float* dk_out = static_cast<float*>(p.dk) + ((int64_t)b * p.Sk * p.KV + kvh) * D;
  float* dv_out = static_cast<float*>(p.dv) + ((int64_t)b * p.Sk * p.KV + kvh) * D;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int kj = k_start + ty * P + i;
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
  constexpr int LD = D + 1, DC = D / 16, T = Tile<D>::T, P = Tile<D>::P, PS = Tile<D>::PS;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sdO = sQ + T * LD;
  float* sK = sdO + T * LD;
  float* sV = sK + T * LD;
  float* sS = sV + T * LD;  // dS
  float* sL = sS + T * PS;
  float* sDel = sL + T;

  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int q_start = blockIdx.x * T, h = blockIdx.y, b = blockIdx.z;
  const int kvh = h / (p.H / p.KV);
  const int64_t kv_rs = (int64_t)p.KV * D, q_rs = (int64_t)p.H * D;
  const int64_t head = ((int64_t)b * p.Sq * p.H + h) * D;
  const int64_t kv_head = ((int64_t)b * p.Sk * p.KV + kvh) * D;

  load_tile<D>(sQ, static_cast<const float*>(p.q) + head, q_rs, q_start, p.Sq);
  load_tile<D>(sdO, static_cast<const float*>(p.dout) + head, q_rs, q_start, p.Sq);
  const float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
  const float* delta = p.delta + ((int64_t)b * p.H + h) * p.Sq;
  for (int r = tid; r < T; r += NT) {
    const int qi = q_start + r;
    sL[r] = qi < p.Sq ? lse[qi] : 0.f;
    sDel[r] = qi < p.Sq ? delta[qi] : 0.f;
  }

  float dq[P][DC];
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int c = 0; c < DC; ++c) dq[i][c] = 0.f;

  const int n_kt = (p.Sk + T - 1) / T;
  for (int kt = 0; kt < n_kt; ++kt) {
    const int k_start = kt * T;
    if (tile_class(q_start, T, k_start, T, p.Sq, p.Sk,
                   p.causal, p.window, p.chunk, p.q_off) == SKIP)
      continue;  // uniform over the block
    __syncthreads();  // the last tile's readers of sK / sV / sS are done
    load_tile<D>(sK, static_cast<const float*>(p.k) + kv_head, kv_rs, k_start, p.Sk);
    load_tile<D>(sV, static_cast<const float*>(p.v) + kv_head, kv_rs, k_start, p.Sk);
    __syncthreads();

    float s[P][P], dp[P][P];
    tile_dot<D>(s, sQ, sK, ty, tx);
    tile_dot<D>(dp, sdO, sV, ty, tx);
    probs_and_grads<P>(s, dp, sL, sDel, q_start, k_start, ty, tx, p);
#pragma unroll
    for (int i = 0; i < P; ++i)
#pragma unroll
      for (int j = 0; j < P; ++j) sS[(ty * P + i) * PS + tx + 16 * j] = dp[i][j];
    __syncthreads();
    // dQ[q][d] += sum_key dS[q][key] K[key][d]; this thread: q rows ty*P+i, d tx+16c
    for (int kk = 0; kk < T; ++kk) {
      float ds[P];
#pragma unroll
      for (int i = 0; i < P; ++i) ds[i] = sS[(ty * P + i) * PS + kk];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float x = sK[kk * LD + tx + 16 * c];
#pragma unroll
        for (int i = 0; i < P; ++i) dq[i][c] = fmaf(ds[i], x, dq[i][c]);
      }
    }
  }

  float* dq_out = static_cast<float*>(p.dq) + head;
#pragma unroll
  for (int i = 0; i < P; ++i) {
    const int qi = q_start + ty * P + i;
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
  constexpr int T = Tile<D>::T;
  if ((err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  if ((err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  dkdv_kernel<D><<<dim3((p.Sk + T - 1) / T, p.KV, p.B), NT, smem, stream>>>(p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  dq_kernel<D><<<dim3((p.Sq + T - 1) / T, p.H, p.B), NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: wgmma with TMA rings and warp specialisation (see the note at the
// top). Tiles are swizzled as hopper.cuh describes: W columns a row, D / W
// such column blocks a tile, 64 rows a tile.
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int R = 64;  // rows a consumer warpgroup owns; rows a streamed tile

// Up to D 128 a block has two consumer warpgroups and a 3-stage ring, and a
// dK / dV item takes all of D. At D 256 a 64-row tile is 32 KB, so a block
// has one consumer warpgroup and a 2-stage ring, and a dK / dV item takes
// half of D: S^T and dP^T still contract over all of D, but dK and dV keep
// 2 x 64 f32 a thread, as at D 128.
template <int D>
struct Cfg {
  static constexpr int W = Swizzle<D>::W, NB = D / W, ROW = W * 2;
  static constexpr int TILE = R * D * 2;  // bytes of a 64-row bf16 tile
  static constexpr int STAT = 2 * R * 4;  // a dK / dV stage's delta and lse log2(e) rows
  static constexpr int NC = D <= 128 ? 2 : 1;      // consumer warpgroups
  static constexpr int NT = 128 * (NC + 1);        // and one producer warpgroup
  static constexpr int STAGES = D <= 128 ? 3 : 2;  // ring depth
  static constexpr int DO = D <= 128 ? D : D / 2;  // dK / dV columns an item
  static constexpr int PARTS = D / DO;
  // two resident tiles for each consumer warpgroup, two streamed tiles (and
  // in dK / dV their rows' statistics) a stage; 1 KB alignment and the
  // barriers on top. D 128: 64 KB + 3 x 32.5 KB; D 256: 64 KB + 2 x 64.5 KB
  static constexpr size_t SMEM = 2 * NC * TILE + STAGES * (2 * TILE + STAT) + 1024 + 128;
};

// Round r of a persistent grid hands items r * gridDim.x onwards to the
// blocks, in reverse order on odd rounds, so that a block that took a
// heavy item in one round takes a light one in the next.
__device__ __forceinline__ int round_item(int r) {
  return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
}

// s (the scores) becomes P and dp (dO . v) becomes dS, element by element,
// stat(i, lse2, del) giving element i's lse log2(e) and delta; the softcap
// is uniform, so one loop runs. The mask comes after, in a loop of its own.
template <class Stat>
__device__ __forceinline__ void probs_grads(float (&s)[R / 2], float (&dp)[R / 2], const Stat& stat,
                                            const BwdParams& p) {
  if (p.softcap > 0.f) {
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      float l, d;
      stat(i, l, d);
      const float th = tanhf(s[i] * p.scale / p.softcap);
      s[i] = ex2(th * p.softcap * LOG2E - l);
      dp[i] = s[i] * (dp[i] - d) * (1.f - th * th) * p.scale;
    }
  } else {
    const float sl2 = p.scale * LOG2E;
#pragma unroll
    for (int i = 0; i < R / 2; ++i) {
      float l, d;
      stat(i, l, d);
      s[i] = ex2(fmaf(s[i], sl2, -l));
      dp[i] = s[i] * (dp[i] - d) * p.scale;
    }
  }
}

// the keys lo .. hi that q row qi (at position q_off + qi) attends (lo > hi: none)
__device__ __forceinline__ void key_range(int qi, const BwdParams& p, int& lo, int& hi) {
  const int qp = qi + p.q_off;
  lo = 0;
  hi = p.Sk - 1;
  if (p.causal) hi = min(hi, qp);
  if (p.window > 0) lo = max(lo, qp - p.window + 1);
  if (p.chunk > 0) {
    const int first = qp / p.chunk * p.chunk;
    lo = max(lo, first);
    hi = min(hi, first + p.chunk - 1);
  }
}

// the q rows lo .. hi that attend key kj (lo > hi: none), as row indices:
// row i sits at position q_off + i
__device__ __forceinline__ void q_range(int kj, const BwdParams& p, int& lo, int& hi) {
  lo = p.causal ? kj - p.q_off : 0;
  hi = kj < p.Sk ? p.Sq - 1 : -1;
  if (p.window > 0) hi = min(hi, kj + p.window - 1 - p.q_off);
  if (p.chunk > 0) {
    const int first = kj / p.chunk * p.chunk - p.q_off;
    lo = max(lo, first);
    hi = min(hi, first + p.chunk - 1);
  }
}

__device__ __forceinline__ void store2(bf16* at, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(at) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(float* at, float a, float b) {
  *reinterpret_cast<float2*>(at) = make_float2(a, b);
}

// a (64 x N) accumulator's rows e < 2 ? r0 : r1, columns 8 n + 2 t + (e & 1),
// stored (as bf16, or f32 partial sums) to rows of out (rs elements apart)
// that are < limit
template <int N, typename T>
__device__ __forceinline__ void store_rows(T* out, int64_t rs, const float (&acc)[N / 2],
                                           int r0, int r1, int limit, int t) {
#pragma unroll
  for (int n = 0; n < N / 8; ++n) {
    if (r0 < limit) store2(out + r0 * rs + 8 * n + 2 * t, acc[4 * n], acc[4 * n + 1]);
    if (r1 < limit) store2(out + r1 * rs + 8 * n + 2 * t, acc[4 * n + 2], acc[4 * n + 3]);
  }
}

// dK and dV of NC x 64 keys of one kv head, columns part DO .. part DO +
// DO - 1, summed over the item's heads of the group (all G, or G / n_split
// with f32 partial sums per head group); consumer warpgroup wg owns keys
// 64 wg .. 64 wg + 63. K and V stay in shared memory; Q, dO and their rows'
// delta and lse stream through the ring, 64 q rows a stage, over the item's
// heads and the q tiles that tile_class does not skip.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
    dkdv_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
                __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
                __grid_constant__ const CUtensorMap tstat, const BwdParams p) {
  using C = Cfg<D>;
  constexpr int W = C::W, NB = C::NB, ROW = C::ROW, TILE = C::TILE, STAT = C::STAT;
  constexpr int NC = C::NC, STAGES = C::STAGES, DO = C::DO, PARTS = C::PARTS;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sK = (raw + 1023) & ~1023u;    // [NC warpgroups][NB][64][W]
  const uint32_t sV = sK + NC * TILE;           // [NC warpgroups][NB][64][W]
  const uint32_t sQ = sV + NC * TILE;           // [STAGES][NB][64][W]
  const uint32_t sdO = sQ + STAGES * TILE;      // [STAGES][NB][64][W]
  const uint32_t sStat = sdO + STAGES * TILE;   // [STAGES][delta, lse log2(e)][64] f32
  const uint32_t bars = sStat + STAGES * STAT;  // kv full / empty, then per stage full, empty
  const uint32_t kv_full = bars, kv_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int G = p.H / p.KV, Gs = G / p.n_split;  // heads of the group, of an item
  const int n_qt = (p.Sq + R - 1) / R;
  const int n_steps = Gs * n_qt;  // (head of the item, q tile) pairs, head-major
  const int per_tile = p.KV * p.B * PARTS * p.n_split;  // items a key tile
  const int n_items = (p.Sk + NC * R - 1) / (NC * R) * per_tile;
  // items are (key tile, kv head, batch, part of D, head group); under a
  // causal mask the first key tiles see the most q rows, so they come first
  auto item = [&](int i, int& k_start, int& kvh, int& b, int& part, int& hg) {
    k_start = i / per_tile * NC * R;
    const int r = i % per_tile;
    kvh = r % p.KV;
    b = r / p.KV % p.B;
    part = r / (p.KV * p.B) % PARTS;
    hg = r / (p.KV * p.B * PARTS);
  };
  // an item's steps in order, skipping the q tiles that none of its keys
  // attends; the producer and every consumer walk the same sequence
  auto next_step = [&](int k_start, int j) {
    for (++j; j < n_steps; ++j)
      if (tile_class(j % n_qt * R, R, k_start, NC * R, p.Sq, p.Sk, p.causal, p.window,
                     p.chunk, p.q_off) != SKIP)
        break;
    return j;
  };

  if (tid == 0) {
    mbar_init(kv_full, 1);
    mbar_init(kv_empty, 128 * NC);  // every consumer thread is done with an item's K and V
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);  // every consumer thread releases a stage
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    // producer: one thread keeps the ring full, running into the next item
    // while the consumers finish the last
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * NC && lane == 0) {
      int stage = 0, phase = 0, kv_phase = 0;
      for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
        int k_start, kvh, b, part, hg;
        item(it, k_start, kvh, b, part, hg);
        // K and V wait until the consumers are done with the last item's;
        // the item's first q tile goes ahead of them
        auto load_kv = [&]() {
          mbar_wait(kv_empty, kv_phase ^ 1);
          kv_phase ^= 1;
          mbar_expect_tx(kv_full, 2 * NC * TILE);
          for (int w = 0; w < NC; ++w)
            for (int c = 0; c < NB; ++c) {
              tma_load(sK + w * TILE + c * R * ROW, &tk, kv_full, c * W, k_start + R * w, kvh, b);
              tma_load(sV + w * TILE + c * R * ROW, &tv, kv_full, c * W, k_start + R * w, kvh, b);
            }
        };
        bool kv_loaded = false;
        for (int j = next_step(k_start, -1); j < n_steps; j = next_step(k_start, j)) {
          const int h = kvh * G + hg * Gs + j / n_qt, q_start = j % n_qt * R;
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * TILE + STAT);
          for (int c = 0; c < NB; ++c) {
            tma_load(sQ + stage * TILE + c * R * ROW, &tq, full(stage), c * W, q_start, h, b);
            tma_load(sdO + stage * TILE + c * R * ROW, &tdo, full(stage), c * W, q_start, h, b);
          }
          const int row = b * p.H + h;  // of delta; lse log2(e) is B H rows further
          tma_load_2d(sStat + stage * STAT, &tstat, full(stage), q_start, row);
          tma_load_2d(sStat + stage * STAT + R * 4, &tstat, full(stage), q_start,
                      p.B * p.H + row);
          if (!kv_loaded) load_kv();
          kv_loaded = true;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (!kv_loaded) load_kv();
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const float* stat = reinterpret_cast<const float*>(smem_raw + (sStat - raw));
    const uint32_t k_tile = sK + wg * TILE, v_tile = sV + wg * TILE;
    // s, dp: S^T and dP^T, then P^T and dS^T; element 4 n + e is key e < 2 ?
    // kj0 : kj1, q row 8 n + 2 t + (e & 1) of the step's tile. dk, dv:
    // the same keys, column part DO + 8 n + 2 t + (e & 1)
    float dk[DO / 2], dv[DO / 2], s[R / 2], dp[R / 2];
    uint32_t pa[R / 16][4], da[R / 16][4];  // P^T and dS^T as A operands, bf16 pairs
    int stage = 0, phase = 0, kv_phase = 0;  // the ring runs on across items
    for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
      int k_start, kvh, b, part, hg;
      item(it, k_start, kvh, b, part, hg);
      const int key0 = k_start + R * wg;  // this warpgroup's first key
      const int kj0 = key0 + 16 * (warp & 3) + g, kj1 = kj0 + 8;
      int lo0, hi0, lo1, hi1;  // the q rows that attend keys kj0 and kj1: an interval for every mask
      q_range(kj0, p, lo0, hi0);
      q_range(kj1, p, lo1, hi1);
#pragma unroll
      for (int i = 0; i < DO / 2; ++i) dk[i] = dv[i] = 0.f;
      mbar_wait(kv_full, kv_phase);
      kv_phase ^= 1;
      for (int j = next_step(k_start, -1); j < n_steps; j = next_step(k_start, j)) {
        const int q_start = j % n_qt * R;
        const int cls = tile_class(q_start, R, key0, R, p.Sq, p.Sk,
                                   p.causal, p.window, p.chunk, p.q_off);
        mbar_wait(full(stage), phase);
        if (cls != SKIP) {  // uniform over the warpgroup; a skipped stage is still released
          const uint32_t q_tile = sQ + stage * TILE, do_tile = sdO + stage * TILE;
          // S^T = K Q^T and dP^T = V dO^T: K-major A and B, k16 steps of 32
          // bytes inside a swizzled row
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t c = kk * 16 / W, off = (kk * 16 % W) * 2;
            Wgmma<R>::ss(s, desc<D>(k_tile + c * R * ROW + off, 16, 8 * ROW),
                         desc<D>(q_tile + c * R * ROW + off, 16, 8 * ROW), kk > 0 ? 1 : 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t c = kk * 16 / W, off = (kk * 16 % W) * 2;
            Wgmma<R>::ss(dp, desc<D>(v_tile + c * R * ROW + off, 16, 8 * ROW),
                         desc<D>(do_tile + c * R * ROW + off, 16, 8 * ROW), kk > 0 ? 1 : 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(s);
          fence_operands(dp);
          // P^T and dS^T in place: lse and delta belong to the columns
          const float* del = stat + stage * (STAT / 4);
          const float* lse2 = del + R;
          probs_grads(s, dp, [&](int i, float& l, float& d) {
            const int col = (i >> 2) * 8 + 2 * t + (i & 1);
            l = lse2[col];
            d = del[col];
          }, p);
          if (cls != FULL || q_start + R > p.Sq) {  // tile_class ignores rows past Sq
#pragma unroll
            for (int i = 0; i < R / 2; ++i) {
              const int qi = q_start + (i >> 2) * 8 + 2 * t + (i & 1);
              const bool keep = (i & 2) ? (qi >= lo1 && qi <= hi1) : (qi >= lo0 && qi <= hi0);
              s[i] = keep ? s[i] : 0.f;
              dp[i] = keep ? dp[i] : 0.f;
            }
          }
          acc_to_a<R>(pa, s);
          acc_to_a<R>(da, dp);
          // dV += P^T dO and dK += dS^T Q over the item's DO columns: dO
          // and Q are N-major (D contiguous), so B is read transposed; 16 q
          // rows a step are two 8-row groups (SBO), the D blocks are LBO
          // apart, and the item's columns start DO / W blocks in
          const uint32_t cols = part * (DO / W) * R * ROW;
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < R / 16; ++kk)
            Wgmma<DO>::rs(dv, pa[kk], desc<D>(do_tile + cols + kk * 16 * ROW, R * ROW, 8 * ROW));
#pragma unroll
          for (int kk = 0; kk < R / 16; ++kk)
            Wgmma<DO>::rs(dk, da[kk], desc<D>(q_tile + cols + kk * 16 * ROW, R * ROW, 8 * ROW));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dv);
          fence_operands(dk);
        }
        mbar_arrive(empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(kv_empty);  // K and V are read no more: the next item's may load
      const int64_t rs = (int64_t)p.KV * D;
      const int64_t head = ((int64_t)b * p.Sk * p.KV + kvh) * D + part * DO;
      if (p.n_split == 1) {
        store_rows<DO>(static_cast<bf16*>(p.dk) + head, rs, dk, kj0, kj1, p.Sk, t);
        store_rows<DO>(static_cast<bf16*>(p.dv) + head, rs, dv, kj0, kj1, p.Sk, t);
      } else {  // the head group's partial sums; split_sum_kernel adds them up
        const int64_t n = (int64_t)p.B * p.Sk * p.KV * D;
        store_rows<DO>(p.part + hg * n + head, rs, dk, kj0, kj1, p.Sk, t);
        store_rows<DO>(p.part + (p.n_split + hg) * n + head, rs, dv, kj0, kj1, p.Sk, t);
      }
    }
  }
}

// dQ of NC x 64 q rows of one head; consumer warpgroup wg owns rows 64 wg
// .. 64 wg + 63. Q and dO stay in shared memory; K and V stream through the
// ring, 64 keys a stage, over the key tiles that tile_class does not skip.
template <int D>
__global__ void __launch_bounds__(Cfg<D>::NT, 1)
    dq_kernel(__grid_constant__ const CUtensorMap tq, __grid_constant__ const CUtensorMap tdo,
              __grid_constant__ const CUtensorMap tk, __grid_constant__ const CUtensorMap tv,
              const BwdParams p) {
  using C = Cfg<D>;
  constexpr int W = C::W, NB = C::NB, ROW = C::ROW, TILE = C::TILE;
  constexpr int NC = C::NC, STAGES = C::STAGES;

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = (smem_u32(smem_raw) + 1023) & ~1023u;  // [NC warpgroups][NB][64][W]
  const uint32_t sdO = sQ + NC * TILE;                        // [NC warpgroups][NB][64][W]
  const uint32_t sK = sdO + NC * TILE;                        // [STAGES][NB][64][W]
  const uint32_t sV = sK + STAGES * TILE;                     // [STAGES][NB][64][W]
  const uint32_t bars = sV + STAGES * TILE;  // q full / empty, then per stage full, empty
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto full = [&](int s) { return bars + 8 * (2 + s); };
  auto empty = [&](int s) { return bars + 8 * (2 + STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (p.Sq + NC * R - 1) / (NC * R);
  const int n_items = n_qt * p.H * p.B;
  const int n_kt = (p.Sk + R - 1) / R;
  // items are (q tile, head, batch); under a causal mask the last q tiles do
  // the most work, so they come first, and heads that share a kv head are
  // neighbours
  auto item = [&](int i, int& q_start, int& h, int& b) {
    const int qt = i / (p.H * p.B);
    q_start = (p.causal ? n_qt - 1 - qt : qt) * NC * R;
    h = i % p.H;
    b = (i / p.H) % p.B;
  };
  auto next_tile = [&](int q_start, int kt) {
    for (++kt; kt < n_kt; ++kt)
      if (tile_class(q_start, NC * R, kt * R, R, p.Sq, p.Sk,
                     p.causal, p.window, p.chunk, p.q_off) != SKIP)
        break;
    return kt;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 128 * NC);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full(s), 1);
      mbar_init(empty(s), 128 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 4 * NC) {
    if constexpr (NC == 2) asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 4 * NC && lane == 0) {
      int stage = 0, phase = 0, q_phase = 0;
      for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
        int q_start, h, b;
        item(it, q_start, h, b);
        const int kvh = h / (p.H / p.KV);
        // Q and dO wait until the consumers are done with the last item's;
        // the item's first K and V tiles go ahead of them
        auto load_q = [&]() {
          mbar_wait(q_empty, q_phase ^ 1);
          q_phase ^= 1;
          mbar_expect_tx(q_full, 2 * NC * TILE);
          for (int w = 0; w < NC; ++w)
            for (int c = 0; c < NB; ++c) {
              tma_load(sQ + w * TILE + c * R * ROW, &tq, q_full, c * W, q_start + R * w, h, b);
              tma_load(sdO + w * TILE + c * R * ROW, &tdo, q_full, c * W, q_start + R * w, h, b);
            }
        };
        bool q_loaded = false;
        for (int kt = next_tile(q_start, -1); kt < n_kt; kt = next_tile(q_start, kt)) {
          mbar_wait(empty(stage), phase ^ 1);
          mbar_expect_tx(full(stage), 2 * TILE);
          for (int c = 0; c < NB; ++c) {
            tma_load(sK + stage * TILE + c * R * ROW, &tk, full(stage), c * W, kt * R, kvh, b);
            tma_load(sV + stage * TILE + c * R * ROW, &tv, full(stage), c * W, kt * R, kvh, b);
          }
          if (!q_loaded) load_q();
          q_loaded = true;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        if (!q_loaded) load_q();
      }
    }
  } else {
    if constexpr (NC == 2) asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = sQ + wg * TILE, do_tile = sdO + wg * TILE;
    // s, dp: S and dP, then dS in dp; element 4 n + e is row e < 2 ? qi0 :
    // qi1, key 8 n + 2 t + (e & 1) of the stage's tile. dq: the same rows,
    // column 8 n + 2 t + (e & 1)
    float dq[D / 2], s[R / 2], dp[R / 2];
    uint32_t da[R / 16][4];  // dS as the A operand, bf16 pairs
    int stage = 0, phase = 0, q_phase = 0;
    for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
      int q_start, h, b;
      item(it, q_start, h, b);
      const int row0 = q_start + R * wg;  // this warpgroup's first row
      const int qi0 = row0 + 16 * (warp & 3) + g, qi1 = qi0 + 8;
      // the rows' lse log2(e) and delta (0 past Sq: finite, never stored)
      const int64_t at = ((int64_t)b * p.H + h) * p.Sp;
      const float l0 = qi0 < p.Sq ? p.lse2[at + qi0] : 0.f, l1 = qi1 < p.Sq ? p.lse2[at + qi1] : 0.f;
      const float d0 = qi0 < p.Sq ? p.delta[at + qi0] : 0.f, d1 = qi1 < p.Sq ? p.delta[at + qi1] : 0.f;
      int lo0, hi0, lo1, hi1;  // the keys that rows qi0 and qi1 attend: an interval for every mask
      key_range(qi0, p, lo0, hi0);
      key_range(qi1, p, lo1, hi1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) dq[i] = 0.f;
      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      for (int kt = next_tile(q_start, -1); kt < n_kt; kt = next_tile(q_start, kt)) {
        const int k_start = kt * R;
        const int cls = tile_class(row0, R, k_start, R, p.Sq, p.Sk,
                                   p.causal, p.window, p.chunk, p.q_off);
        mbar_wait(full(stage), phase);
        if (cls != SKIP) {  // uniform over the warpgroup; a skipped stage is still released
          const uint32_t k_tile = sK + stage * TILE, v_tile = sV + stage * TILE;
          // S = Q K^T and dP = dO V^T: K-major A and B
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t c = kk * 16 / W, off = (kk * 16 % W) * 2;
            Wgmma<R>::ss(s, desc<D>(q_tile + c * R * ROW + off, 16, 8 * ROW),
                         desc<D>(k_tile + c * R * ROW + off, 16, 8 * ROW), kk > 0 ? 1 : 0);
          }
#pragma unroll
          for (int kk = 0; kk < D / 16; ++kk) {
            const uint32_t c = kk * 16 / W, off = (kk * 16 % W) * 2;
            Wgmma<R>::ss(dp, desc<D>(do_tile + c * R * ROW + off, 16, 8 * ROW),
                         desc<D>(v_tile + c * R * ROW + off, 16, 8 * ROW), kk > 0 ? 1 : 0);
          }
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(s);
          fence_operands(dp);
          probs_grads(s, dp, [&](int i, float& l, float& d) {
            l = (i & 2) ? l1 : l0;
            d = (i & 2) ? d1 : d0;
          }, p);
          if (cls != FULL) {
#pragma unroll
            for (int i = 0; i < R / 2; ++i) {
              const int kj = k_start + (i >> 2) * 8 + 2 * t + (i & 1);
              const bool keep = (i & 2) ? (kj >= lo1 && kj <= hi1) : (kj >= lo0 && kj <= hi0);
              dp[i] = keep ? dp[i] : 0.f;
            }
          }
          acc_to_a<R>(da, dp);
          // dQ += dS K: K is N-major (D contiguous), read transposed
          wgmma_fence();
#pragma unroll
          for (int kk = 0; kk < R / 16; ++kk)
            Wgmma<D>::rs(dq, da[kk], desc<D>(k_tile + kk * 16 * ROW, R * ROW, 8 * ROW));
          wgmma_commit();
          wgmma_wait<0>();
          fence_operands(dq);
        }
        mbar_arrive(empty(stage));
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
      }
      mbar_arrive(q_empty);  // Q and dO are read no more: the next item's may load
      const int64_t rs = (int64_t)p.H * D;
      store_rows<D>(static_cast<bf16*>(p.dq) + ((int64_t)b * p.Sq * p.H + h) * D, rs, dq, qi0,
                    qi1, p.Sq, t);
    }
  }
}

// delta and lse log2(e) as one (2 B H, Sq) f32 map at a row pitch of Sp,
// read in boxes of 64 of a row; reads past Sq give 0
bool make_stat_map(CUtensorMap* map, float* base, int Sq, int Sp, int rows) {
  const EncodeTiledFn encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)Sq, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)Sp * 4};
  const cuuint32_t box[2] = {(cuuint32_t)R, 1};
  const cuuint32_t elem[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, base, dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// dk and dv from the head groups' f32 partial sums [2][n_split][n], added in
// the groups' order and rounded to bf16
__global__ void __launch_bounds__(256) split_sum_kernel(const float* part, bf16* dk, bf16* dv,
                                                        int64_t n, int n_split) {
  const int64_t i = (int64_t)blockIdx.x * 256 + threadIdx.x;
  if (i >= n) return;
  const float* src = part + blockIdx.y * n_split * n + i;
  float acc = src[0];
  for (int s = 1; s < n_split; ++s) acc += src[s * n];
  (blockIdx.y == 0 ? dk : dv)[i] = __float2bfloat16(acc);
}

template <int D>
cudaError_t launch(const BwdParams& p, cudaStream_t stream) {
  using C = Cfg<D>;
  cudaError_t err = launch_delta<bf16>(p, D, stream);
  if (err != cudaSuccess) return err;
  const int64_t q_ss = (int64_t)p.H * D, k_ss = (int64_t)p.KV * D;
  CUtensorMap tq, tdo, tk, tv, tstat;
  if (!make_map<D>(&tq, p.q, p.Sq, p.H, p.B, q_ss, D, q_ss * p.Sq, R) ||
      !make_map<D>(&tdo, p.dout, p.Sq, p.H, p.B, q_ss, D, q_ss * p.Sq, R) ||
      !make_map<D>(&tk, p.k, p.Sk, p.KV, p.B, k_ss, D, k_ss * p.Sk, R) ||
      !make_map<D>(&tv, p.v, p.Sk, p.KV, p.B, k_ss, D, k_ss * p.Sk, R) ||
      !make_stat_map(&tstat, p.delta, p.Sq, p.Sp, 2 * p.B * p.H))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<D>::SMEM;
  if ((err = cudaFuncSetAttribute(dkdv_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess ||
      (err = cudaFuncSetAttribute(dq_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  (int)smem)) != cudaSuccess)
    return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int kv_items =
      (p.Sk + C::NC * R - 1) / (C::NC * R) * p.KV * p.B * C::PARTS * p.n_split;
  dkdv_kernel<D><<<min(kv_items, sms), C::NT, smem, stream>>>(tq, tdo, tk, tv, tstat, p);
  if ((err = cudaGetLastError()) != cudaSuccess) return err;
  if (p.n_split > 1) {
    const int64_t n = (int64_t)p.B * p.Sk * p.KV * D;
    split_sum_kernel<<<dim3((unsigned)((n + 255) / 256), 2), 256, 0, stream>>>(
        p.part, static_cast<bf16*>(p.dk), static_cast<bf16*>(p.dv), n, p.n_split);
    if ((err = cudaGetLastError()) != cudaSuccess) return err;
  }
  const int q_items = (p.Sq + C::NC * R - 1) / (C::NC * R) * p.H * p.B;
  dq_kernel<D><<<min(q_items, sms), C::NT, smem, stream>>>(tq, tdo, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace wg

// the design follows the dtype: bf16 on the tensor cores, f32 on CUDA cores
cudaError_t launch_d(const BwdParams& p, int dtype, int D, cudaStream_t s) {
  if (dtype == 1) {
    if (D == 16) return wg::launch<16>(p, s);
    if (D == 32) return wg::launch<32>(p, s);
    if (D == 64) return wg::launch<64>(p, s);
    if (D == 128) return wg::launch<128>(p, s);
    if (D == 256) return wg::launch<256>(p, s);
  } else if (dtype == 0) {
    if (D == 16) return cc::launch<16>(p, s);
    if (D == 32) return cc::launch<32>(p, s);
    if (D == 64) return cc::launch<64>(p, s);
    if (D == 128) return cc::launch<128>(p, s);
    if (D == 256) return cc::launch<256>(p, s);
  }
  return cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every pointer 16-byte aligned); every
// tensor contiguous; delta is f32 scratch of 2 B H Sp floats, Sp = Sq
// rounded up to a multiple of 4; n_split (bf16 only, else 1) the head
// groups of a dK / dV item, part f32 scratch of 2 n_split B Sk KV D floats
// when n_split > 1 (else null); q_offset: query row i sits at position
// q_offset + i (>= 0). Returns a cudaError_t (0 = success).
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, const float* lse, float* delta, void* dq,
                                   void* dk, void* dv, float* part, int n_split, int dtype,
                                   int B, int Sq, int Sk, int H, int KV, int D, int causal,
                                   int window, int chunk, int q_offset, float softcap,
                                   float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || n_split < 1 || q_offset < 0 ||
      (H / KV) % n_split != 0 || (n_split > 1 && (part == nullptr || dtype != 1)))
    return (int)cudaErrorInvalidValue;
  // bf16 also keeps lse log2(e) beside delta; both rows padded for TMA
  const int Sp = dtype == 1 ? (Sq + 3) / 4 * 4 : Sq;
  float* lse2 = dtype == 1 ? delta + (int64_t)B * H * Sp : nullptr;
  const BwdParams p{q, k, v, o, dout, lse, delta, lse2, dq, dk, dv, part, n_split, B, Sq, Sk,
                    H, KV, Sp, causal, window, chunk, q_offset, softcap, scale};
  return (int)launch_d(p, dtype, D, static_cast<cudaStream_t>(stream));
}
