// Flash-attention forward for Hopper (sm_90a), plain C interface for ctypes.
//
// Replaces repro/kernels/flash_attention.py::_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.flash_attention). It computes the same function:
// online softmax with running (m, l, acc) in f32, causal / sliding-window /
// chunk masks with where-masking (a masked entry contributes exactly 0),
// GQA as kv_head = h / (H / KV) with no K/V replication, optional tanh
// softcap, l clamped at 1e-20 so a row with no valid key yields 0, output in
// the input dtype.
//
// What bounds it on an H100. At rsc-llm prefill (B 4, S 2048, H 32, KV 8,
// D 128, causal) one layer does 4*B*H*D * S(S+1)/2 ~= 1.37e11 FLOPs and must
// move (2H + 2KV)*B*S*D*2 bytes ~= 168 MB: ~0.139 ms at the 989 TFLOP/s bf16
// tensor-core peak against ~0.05 ms at 3.35 TB/s, so it is compute-bound;
// recurrentgemma-9b's layer (H 16, KV 1, D 256) does the same FLOPs.
//
// Two designs, chosen by dtype at the entry point (flash_attention_fwd):
//
// bf16 -- wgmma on the tensor cores, tiles fed by TMA (namespace wg). A
//   persistent grid of one block per SM walks (q tile, head, batch) items,
//   heaviest causal q tiles first, in reverse block order on odd rounds so
//   that the blocks' loads even out. A block is three warpgroups: one thread
//   of the third issues the TMA loads (Q, then K and V tiles into a ring of
//   mbarrier-guarded stages) and gives its registers to the two consumer
//   warpgroups (setmaxnreg 40 / 232), which own 64 q rows each (BQ 128).
//   S = Q K^T is wgmma m64nBKk16 with Q and K in swizzled shared memory; P
//   stays in registers as the A operand of O += P V, V read N-major through
//   the descriptor's transpose bit. Each warpgroup overlaps tile j's softmax
//   (exp2 with the scale folded into one FMA) with tile j - 1's P V, and the
//   two take turns to issue their products (named barriers) so that one's
//   softmax runs under the other's products. Every (q tile, kv tile) pair is
//   classified once (tile_class): skipped, run unmasked, or masked through a
//   per-row interval of keys. TMA zero-fills rows past S, which the mask
//   still drops. Tiles, shared memory (1 KB alignment and barriers on top):
//     D 256: BK 64, 2 stages: Q 64 KB + K, V 2 x 2 x 32 KB = 192 KB
//     D 128: BK 128, 3 stages: Q 32 KB + 3 x 2 x 32 KB     = 224 KB
//     D 64 / 32 / 16: BK 128, 3 stages (112 / 56 / 28 KB), swizzle 128 / 64
//       / 32 bytes, the width of their rows.
//   Left on the table: more q rows a kv tile (a third consumer warpgroup at
//   D <= 128: K and V are read from L2 once per 128 q rows of each query
//   head), a dynamic tile scheduler, and output through shared memory and a
//   TMA store. Its time against the bound is in PERF.md.
//
// Both designs write the row log-sum-exp m + log(max(l, 1e-20)) to an
// optional (B, H, Sq) f32 output, the input of the backward pass
// (flash_attention_bwd.cu); with a null pointer nothing more is stored.
//
// f32 -- CUDA-core FMA (namespace cc). Tensor cores take f32 only as TF32,
//   about three decimal digits, and the f32 checks (1e-5 against the plain
//   version, 1e-4 on the smoke models' logits) need true f32 products.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "flash_mask.cuh"
#include "hopper.cuh"

namespace {

constexpr float NEG_INF = -1e30f;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  float* lse;  // (B, H, Sq) row log-sum-exp for the backward, or null
  int B, Sq, Sk, H, KV;
  int64_t q_sb, q_ss, q_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t o_sb, o_ss, o_sh;
  int causal, window, chunk;
  int q_off;  // q row i sits at position q_off + i
  float softcap, scale;
};

// ---------------------------------------------------------------------------
// f32: CUDA-core design. One block per (b, h, 64-row q tile), a loop over
// 64-row KV tiles; tiles staged in shared memory as f32 (rows padded by one
// float), 256 threads each own a 4x4 patch of the score tile and 4 rows x
// D/16 columns of the output. All arithmetic is f32 FMA with expf.
namespace cc {

constexpr int BQ = 64;    // q rows per block
constexpr int BK = 64;    // kv rows per tile
constexpr int NT = 256;   // threads: 16 x 16

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

template <int D>
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

  const float* q = static_cast<const float*>(p.q) + b * p.q_sb + h * p.q_sh;
  const float* k = static_cast<const float*>(p.k) + b * p.k_sb + kvh * p.k_sh;
  const float* v = static_cast<const float*>(p.v) + b * p.v_sb + kvh * p.v_sh;
  float* o = static_cast<float*>(p.o) + b * p.o_sb + h * p.o_sh;

  for (int idx = tid; idx < BQ * D; idx += NT) {
    const int r = idx / D, c = idx % D;
    const int qi = q_start + r;
    sQ[r * QS + c] = qi < p.Sq ? q[qi * p.q_ss + c] : 0.f;
  }

  float m[4], l[4], acc[4][DC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[i][c] = 0.f;
  }

  const int n_kv = (p.Sk + BK - 1) / BK;
  for (int kt = 0; kt < n_kv; ++kt) {
    const int k_start = kt * BK;
    if (tile_class(q_start, BQ, k_start, BK, p.Sq, p.Sk,
                   p.causal, p.window, p.chunk, p.q_off) == SKIP)
      continue;  // uniform over the block

    __syncthreads();  // the previous tile's readers of sK / sV / sP are done
    for (int idx = tid; idx < BK * D; idx += NT) {
      const int r = idx / D, c = idx % D;
      const int kj = k_start + r;
      const bool in = kj < p.Sk;
      sK[r * QS + c] = in ? k[kj * p.k_ss + c] : 0.f;
      sV[r * D + c] = in ? v[kj * p.v_ss + c] : 0.f;
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
        float x = s[i][j] * p.scale;
        if (p.softcap > 0.f) x = tanhf(x / p.softcap) * p.softcap;
        ok[j] = attends(qi, k_start + tx + 16 * j, p);
        s[i][j] = ok[j] ? x : NEG_INF;
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
    for (int c = 0; c < DC; ++c) o[qi * p.o_ss + tx + 16 * c] = acc[i][c] / lsafe;
    // as the reference: m + log(max(l, 1e-20)), so -1e30 for a row with no key
    if (p.lse != nullptr && tx == 0) p.lse[((int64_t)b * p.H + h) * p.Sq + qi] = m[i] + logf(lsafe);
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  const dim3 grid((p.Sq + BQ - 1) / BQ, p.H, p.B);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace cc

// ---------------------------------------------------------------------------
// bf16: wgmma with a TMA ring and warp specialisation (see the note at the
// top). Tiles are swizzled as hopper.cuh describes: W columns a row, D / W
// such column blocks a tile.
namespace wg {

using bf16 = __nv_bfloat16;
constexpr int BQ = 128;  // two consumer warpgroups of 64 rows
constexpr int NT = 384;  // 2 consumer warpgroups + 1 producer warpgroup
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

template <int D>
struct Cfg {
  static constexpr int BK = D > 128 ? 64 : 128;  // kv rows a tile
  static constexpr int W = Swizzle<D>::W;        // elements a swizzled row
  static constexpr int NB = D / W;               // column blocks a tile
  static constexpr int Q_BYTES = 64 * D * 2;   // one warpgroup's Q
  static constexpr int KV_BYTES = BK * D * 2;  // one K or V tile
  static constexpr int STAGES = D > 128 ? 2 : 3;  // ring depth that fits in shared memory
  static constexpr size_t SMEM = 2 * Q_BYTES + 2 * STAGES * KV_BYTES + 1024 + 128;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    flash_fwd_wgmma_kernel(__grid_constant__ const CUtensorMap tq,
                           __grid_constant__ const CUtensorMap tk,
                           __grid_constant__ const CUtensorMap tv, const Params p) {
  constexpr int BK = Cfg<D>::BK, W = Cfg<D>::W, NB = Cfg<D>::NB;
  constexpr int Q_BYTES = Cfg<D>::Q_BYTES, KV_BYTES = Cfg<D>::KV_BYTES;
  constexpr int STAGES = Cfg<D>::STAGES;
  constexpr int ROW = W * 2;  // bytes a swizzled row

  extern __shared__ __align__(1024) unsigned char smem_raw[];
  // the 128-byte swizzle repeats every 1024 bytes: align the tiles to it
  const uint32_t raw = smem_u32(smem_raw);
  const uint32_t sQ = (raw + 1023) & ~1023u;     // [2 warpgroups][NB][64][W]
  const uint32_t sK = sQ + 2 * Q_BYTES;          // [STAGES][NB][BK][W]
  const uint32_t sV = sK + STAGES * KV_BYTES;    // [STAGES][NB][BK][W]
  const uint32_t bars = sV + STAGES * KV_BYTES;  // q full / empty, then per stage k/v full, k/v empty
  const uint32_t q_full = bars, q_empty = bars + 8;
  auto k_full = [&](int s) { return bars + 8 * (2 + s); };
  auto v_full = [&](int s) { return bars + 8 * (2 + STAGES + s); };
  auto k_empty = [&](int s) { return bars + 8 * (2 + 2 * STAGES + s); };
  auto v_empty = [&](int s) { return bars + 8 * (2 + 3 * STAGES + s); };

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int n_qt = (p.Sq + BQ - 1) / BQ;
  const int n_items = n_qt * p.H * p.B;
  const int n_kv = (p.Sk + BK - 1) / BK;
  // The grid is persistent: items are (q tile, head, batch); under a causal
  // mask the last q tiles do the most work (at any q_off: a row's keys,
  // min(Sk, q_off + row + 1), grow with its row), so they come first, and
  // heads that share a kv head are neighbours. Round r hands items r * gridDim.x
  // onwards to the blocks, in reverse order on odd rounds, so a block that
  // took a heavy item in one round takes a light one in the next.
  auto round_item = [&](int r) {
    return r * gridDim.x + ((r & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };
  auto item = [&](int i, int& q_start, int& h, int& b) {
    const int qt = i / (p.H * p.B);
    q_start = (p.causal ? n_qt - 1 - qt : qt) * BQ;
    h = i % p.H;
    b = (i / p.H) % p.B;
  };
  // an item's kv tiles in order, skipping those where no pair attends;
  // producer and consumers walk the same sequence
  auto next_tile = [&](int q_start, int kt) {
    for (++kt; kt < n_kv; ++kt)
      if (tile_class(q_start, BQ, kt * BK, BK, p.Sq, p.Sk,
                     p.causal, p.window, p.chunk, p.q_off) != SKIP)
        break;
    return kt;
  };

  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, 256);  // every consumer thread is done with an item's Q
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(k_full(s), 1);
      mbar_init(v_full(s), 1);
      mbar_init(k_empty(s), 256);  // every consumer thread releases a tile
      mbar_init(v_empty(s), 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp >= 8) {
    // producer: one thread keeps the ring full, running into the next item
    // while the consumers finish the last
    asm volatile("setmaxnreg.dec.sync.aligned.u32 40;\n");
    if (warp == 8 && lane == 0) {
      int stage = 0, phase = 0, q_phase = 0;
      for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
        int q_start, h, b;
        item(it, q_start, h, b);
        const int kvh = h / (p.H / p.KV);
        // Q waits until the consumers' last Q K^T of the previous item; the
        // item's first K and V tiles go ahead of it
        auto load_q = [&]() {
          mbar_wait(q_empty, q_phase ^ 1);
          q_phase ^= 1;
          mbar_expect_tx(q_full, 2 * Q_BYTES);
          for (int w = 0; w < 2; ++w)
            for (int c = 0; c < NB; ++c)
              tma_load(sQ + w * Q_BYTES + c * 64 * ROW, &tq, q_full, c * W, q_start + 64 * w, h,
                       b);
        };
        bool q_loaded = false;
        for (int kt = next_tile(q_start, -1); kt < n_kv; kt = next_tile(q_start, kt)) {
          mbar_wait(k_empty(stage), phase ^ 1);
          mbar_expect_tx(k_full(stage), KV_BYTES);
          for (int c = 0; c < NB; ++c)
            tma_load(sK + stage * KV_BYTES + c * BK * ROW, &tk, k_full(stage), c * W, kt * BK,
                     kvh, b);
          mbar_wait(v_empty(stage), phase ^ 1);
          mbar_expect_tx(v_full(stage), KV_BYTES);
          for (int c = 0; c < NB; ++c)
            tma_load(sV + stage * KV_BYTES + c * BK * ROW, &tv, v_full(stage), c * W, kt * BK,
                     kvh, b);
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
    // consumers: warpgroup wg owns q rows row0 .. row0 + 63 of each item.
    // Tile j's softmax runs while the tensor cores do tile j - 1's P V.
    asm volatile("setmaxnreg.inc.sync.aligned.u32 232;\n");
    const int wg = warp >> 2, g = lane >> 2, t = lane & 3;
    const uint32_t q_tile = sQ + wg * Q_BYTES;
    // score -> log2 domain; after a softcap pass the scores are there already
    const float f = p.softcap > 0.f ? 1.f : p.scale * LOG2E;

    // s[4 j + e] and o[4 j + e]: row e < 2 ? qi0 : qi1, column 8 j + 2 t + (e & 1)
    float o[D / 2], s[BK / 2];
    uint32_t pf[BK / 16][4];  // P as the A operand of P V, bf16 pairs
#pragma unroll
    for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
    float m0, m1, l0, l1;  // log2 domain
    float c0, c1;          // o's pending rescale
    int qi0, qi1, row0;    // this thread's two rows, this warpgroup's first
    int lo0, hi0, lo1, hi1;  // the keys rows qi0 and qi1 attend: an interval for every mask

    // S = Q K^T: K-major A and B, k16 steps of 32 bytes inside a swizzled row
    auto issue_qk = [&](int st) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        const uint32_t c = kk * 16 / W, off = (kk * 16 % W) * 2;
        Wgmma<BK>::ss(s, desc<D>(q_tile + c * 64 * ROW + off, 16, 8 * ROW),
                      desc<D>(sK + st * KV_BYTES + c * BK * ROW + off, 16, 8 * ROW),
                      kk > 0 ? 1 : 0);
      }
      wgmma_commit();
    };
    // O += P V: V is N-major (D contiguous), so B is read transposed; 16
    // keys a step are two 8-row groups (SBO), the D blocks are LBO apart
    auto issue_pv = [&](int st) {
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < BK / 16; ++kk)
        Wgmma<D>::rs(o, pf[kk], desc<D>(sV + st * KV_BYTES + kk * 16 * ROW, BK * ROW, 8 * ROW));
      wgmma_commit();
    };
    auto key_range = [&](int qi, int& lo, int& hi) {
      const int qp = qi + p.q_off;  // the row's position
      lo = 0;
      hi = p.Sk - 1;
      if (p.causal) hi = min(hi, qp);
      if (p.window > 0) lo = max(lo, qp - p.window + 1);
      if (p.chunk > 0) {
        const int first = qp / p.chunk * p.chunk;
        lo = max(lo, first);
        hi = min(hi, first + p.chunk - 1);
      }
    };
    // online softmax of the tile at k_start: s becomes P (f32), m and l
    // move on, and (c0, c1) is the factor o still owes
    auto softmax = [&](int k_start) {
      if (p.softcap > 0.f) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i)
          s[i] = tanhf(s[i] * p.scale / p.softcap) * p.softcap * LOG2E;
      }
      if (tile_class(row0, 64, k_start, BK, p.Sq, p.Sk,
                     p.causal, p.window, p.chunk, p.q_off) != FULL) {
#pragma unroll
        for (int i = 0; i < BK / 2; ++i) {
          const int kj = k_start + (i >> 2) * 8 + 2 * t + (i & 1);
          const bool keep = (i & 2) ? (kj >= lo1 && kj <= hi1) : (kj >= lo0 && kj <= hi0);
          s[i] = keep ? s[i] : -INFINITY;  // exp2 gives exactly 0, whatever m is
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float mn0 = fmaxf(m0, mx0 * f), mn1 = fmaxf(m1, mx1 * f);
      c0 = ex2(m0 - mn0);
      c1 = ex2(m1 - mn1);
      m0 = mn0;
      m1 = mn1;
      float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
      for (int j = 0; j < BK / 8; ++j) {
        s[4 * j] = ex2(fmaf(s[4 * j], f, -mn0));
        s[4 * j + 1] = ex2(fmaf(s[4 * j + 1], f, -mn0));
        s[4 * j + 2] = ex2(fmaf(s[4 * j + 2], f, -mn1));
        s[4 * j + 3] = ex2(fmaf(s[4 * j + 3], f, -mn1));
        rs0 += s[4 * j] + s[4 * j + 1];
        rs1 += s[4 * j + 2] + s[4 * j + 3];
      }
      l0 = l0 * c0 + rs0;  // this thread's share of the row sum; summed over the quad at the end
      l1 = l1 * c1 + rs1;
    };
    // o owes the last softmax's factor before that tile's P V adds to it
    auto rescale_o = [&]() {
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        o[4 * j] *= c0;
        o[4 * j + 1] *= c0;
        o[4 * j + 2] *= c1;
        o[4 * j + 3] *= c1;
      }
    };
    // keys 16 kk .. 16 kk + 15 of P are S's n8 blocks 2 kk and 2 kk + 1
    auto pack_p = [&]() { acc_to_a<BK>(pf, s); };

    if (wg == 0) asm volatile("bar.arrive 1, 256;\n" ::: "memory");  // warpgroup 0 goes first
    int stage = 0, phase = 0, q_phase = 0;  // the ring runs on across items
    for (int it = round_item(0); it < n_items; it = round_item(it / gridDim.x + 1)) {
      int q_start, h, b;
      item(it, q_start, h, b);
      row0 = q_start + 64 * wg;
      qi0 = row0 + 16 * (warp & 3) + g;
      qi1 = qi0 + 8;
      key_range(qi0, lo0, hi0);
      key_range(qi1, lo1, hi1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) o[i] = 0.f;
      m0 = m1 = NEG_INF;
      l0 = l1 = 0.f;

      mbar_wait(q_full, q_phase);
      q_phase ^= 1;
      int kt = next_tile(q_start, -1);
      if (kt < n_kv) {
        mbar_wait(k_full(stage), phase);
        turn_wait(wg);
        issue_qk(stage);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_operands(s);
        mbar_arrive(k_empty(stage));
        softmax(kt * BK);
        pack_p();
        int pv_stage = stage, pv_phase = phase;
        if (++stage == STAGES) {
          stage = 0;
          phase ^= 1;
        }
        for (kt = next_tile(q_start, kt); kt < n_kv; kt = next_tile(q_start, kt)) {
          mbar_wait(k_full(stage), phase);
          mbar_wait(v_full(pv_stage), pv_phase);
          turn_wait(wg);
          issue_qk(stage);
          rescale_o();  // while this tile's S is on the tensor cores
          issue_pv(pv_stage);
          turn_pass(wg);
          wgmma_wait<1>();  // S of this tile is done; P V of the last may run on
          fence_operands(s);
          mbar_arrive(k_empty(stage));
          softmax(kt * BK);
          wgmma_wait<0>();
          fence_operands(o);
          mbar_arrive(v_empty(pv_stage));
          pack_p();
          pv_stage = stage;
          pv_phase = phase;
          if (++stage == STAGES) {
            stage = 0;
            phase ^= 1;
          }
        }
        mbar_arrive(q_empty);  // Q is read no more: the next item's may load
        mbar_wait(v_full(pv_stage), pv_phase);
        turn_wait(wg);
        rescale_o();
        issue_pv(pv_stage);
        turn_pass(wg);
        wgmma_wait<0>();
        fence_operands(o);
        mbar_arrive(v_empty(pv_stage));
      } else {
        mbar_arrive(q_empty);
      }

      // epilogue: o[4 j + e] is row e < 2 ? qi0 : qi1, column 8 j + 2 t + (e & 1)
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        l0 += __shfl_xor_sync(0xffffffffu, l0, off);
        l1 += __shfl_xor_sync(0xffffffffu, l1, off);
      }
      const float inv0 = 1.f / fmaxf(l0, 1e-20f), inv1 = 1.f / fmaxf(l1, 1e-20f);
      if (p.lse != nullptr && t == 0) {
        // m is in the log2 domain; a row with no key keeps m = -1e30 and,
        // as in the reference, its log-sum-exp is -1e30
        float* lse = p.lse + ((int64_t)b * p.H + h) * p.Sq;
        if (qi0 < p.Sq) lse[qi0] = m0 <= NEG_INF ? NEG_INF : m0 * LN2 + logf(fmaxf(l0, 1e-20f));
        if (qi1 < p.Sq) lse[qi1] = m1 <= NEG_INF ? NEG_INF : m1 * LN2 + logf(fmaxf(l1, 1e-20f));
      }
      bf16* out = static_cast<bf16*>(p.o) + b * p.o_sb + h * p.o_sh;
#pragma unroll
      for (int j = 0; j < D / 8; ++j) {
        if (qi0 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + qi0 * p.o_ss + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[4 * j] * inv0, o[4 * j + 1] * inv0);
        if (qi1 < p.Sq)
          *reinterpret_cast<__nv_bfloat162*>(out + qi1 * p.o_ss + 8 * j + 2 * t) =
              __floats2bfloat162_rn(o[4 * j + 2] * inv1, o[4 * j + 3] * inv1);
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!make_map<D>(&tq, p.q, p.Sq, p.H, p.B, p.q_ss, p.q_sh, p.q_sb, 64) ||
      !make_map<D>(&tk, p.k, p.Sk, p.KV, p.B, p.k_ss, p.k_sh, p.k_sb, Cfg<D>::BK) ||
      !make_map<D>(&tv, p.v, p.Sk, p.KV, p.B, p.v_ss, p.v_sh, p.v_sb, Cfg<D>::BK))
    return cudaErrorInvalidValue;
  constexpr size_t smem = Cfg<D>::SMEM;
  cudaError_t err = cudaFuncSetAttribute(flash_fwd_wgmma_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  int dev = 0, sms = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev)) != cudaSuccess)
    return err;
  const int items = (p.Sq + BQ - 1) / BQ * p.H * p.B;
  flash_fwd_wgmma_kernel<D><<<min(items, sms), NT, smem, stream>>>(tq, tk, tv, p);
  return cudaGetLastError();
}

}  // namespace wg

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. Returns a cudaError_t (0 = success).
// lse: (B, H, Sq) f32, written when not null (the backward's input).
// q_offset: query row i sits at position q_offset + i (>= 0).
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                                   float* lse, int dtype, int B, int Sq, int Sk, int H, int KV, int D,
                                   int64_t q_sb, int64_t q_ss, int64_t q_sh,
                                   int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                   int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                   int64_t o_sb, int64_t o_ss, int64_t o_sh,
                                   int causal, int window, int chunk, int q_offset,
                                   float softcap, float scale, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 || q_offset < 0)
    return (int)cudaErrorInvalidValue;
  const Params p{q, k, v, o, lse, B, Sq, Sk, H, KV,
                 q_sb, q_ss, q_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, o_sb, o_ss, o_sh,
                 causal, window, chunk, q_offset, softcap, scale};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  // The design follows the dtype. bf16 runs on the tensor cores. f32 keeps
  // the CUDA-core kernel: tensor cores take f32 only as TF32 (about three
  // decimal digits), and the f32 checks (1e-5 against the plain version,
  // 1e-4 on the smoke models' logits) need true f32 products.
  if (dtype == 0) {
    if (D == 16) return (int)cc::launch<16>(p, s);
    if (D == 32) return (int)cc::launch<32>(p, s);
    if (D == 64) return (int)cc::launch<64>(p, s);
    if (D == 128) return (int)cc::launch<128>(p, s);
    if (D == 256) return (int)cc::launch<256>(p, s);
  } else if (dtype == 1) {
    if (D == 16) return (int)wg::launch<16>(p, s);
    if (D == 32) return (int)wg::launch<32>(p, s);
    if (D == 64) return (int)wg::launch<64>(p, s);
    if (D == 128) return (int)wg::launch<128>(p, s);
    if (D == 256) return (int)wg::launch<256>(p, s);
  }
  return (int)cudaErrorInvalidValue;
}

extern "C" const char* repro_cuda_error_string(int err) {
  return cudaGetErrorString(static_cast<cudaError_t>(err));
}
