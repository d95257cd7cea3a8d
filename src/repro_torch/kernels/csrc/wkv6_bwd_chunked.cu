// RWKV-6 (Finch) WKV backward for Hopper (sm_90a), bf16 inputs, as a
// chunked scan on the tensor cores; plain C interface for ctypes.
//
// The VJP of the WKV recurrence that repro/kernels/rwkv6_scan.py::_kernel
// (the Pallas TPU kernel behind repro.kernels.ops.wkv6) computes. The
// Pallas kernel has no backward: the reference trains through jax.grad of
// its lax.scan oracle (repro/kernels/ref.py::wkv6_ref), and this kernel
// computes that gradient for bf16 r, k, v, w and dO: dr, dk, dv, dw in
// bf16, du and the initial state's cotangent dS0 in f32, from an optional
// f32 initial state S0 and final-state cotangent ds. f32 inputs keep the
// CUDA-core kernel in wkv6_bwd.cu (true f32 products); the wrapper
// (kernels/wkv6.py::BWD_DESIGNS) picks one by dtype.
//
// Chunked form. For one (b, h) and a chunk [b0, e) of n <= L = 16 steps,
// t local, S0 the state at b0 and Ge the state's cotangent at e, vectors
// over the key index i:
//
//   pre_t = prod_{tau<t} w_tau     suf_s = prod_{s<tau<n} w_tau
//   Dec(s,t) = prod_{s<tau<t} w_tau      A as in the forward (wkv6_mma.cuh)
//   dA = tril(dO v^T)     P = dO S0^T     Q = v Ge^T
//   G_b0 = diag(pre_n) Ge + (r*pre)^T dO           (the cotangent chain)
//   S_e  = diag(pre_n) S0 + (k*suf)^T v            (the state chain)
//   dv   = A^T dO + (k*suf) Ge
//   dr_t = pre_t P_t + Y_t,t + dA[t,t] u k_t,   Y_t,tau = sum_{s<tau} dA[t,s] k_s Dec(s,tau)
//   dk_s = suf_s Q_s + Z_s,s + dA[s,s] u r_s,   Z_s,tau = sum_{t>tau} dA[t,s] r_t Dec(tau,t)
//   du  += sum_t dA[t,t] r_t k_t
//   dw_tau = pre_tau suf_tau rowsum(S0 * Ge) + pre_tau sum_{t>tau} Dec(tau,t) r_t P_t
//          + suf_tau sum_{s<tau} Dec(s,tau) k_s Q_s + sum_{t>tau} r_t Dec(tau,t) Y_t,tau
//
// Every decay is a running product inside the chunk (Y_t,tau+1 = w_tau
// Y_t,tau + dA[t,tau] k_tau; Z the same in reverse): no log, exp or
// division, so w = 0 and w = 1 are exact. Rows past S are read as r = k =
// v = dO = 0 and w = 1, which change nothing, so a ragged last chunk runs
// the same code and only its stores are masked.
// kernels/wkv6.py::wkv6_chunked_bwd is this arithmetic in plain PyTorch
// (tests/test_torch_wkv6_bwd_chunked.py holds it against jax.vjp).
//
// What bounds it on an H100. At rwkv6-7b training (B 2, S 2048, H 64,
// D 64) the function reads r, k, v, w, dO and writes dr, dk, dv, dw: 302
// MB, 0.090 ms at 3.35 TB/s. Its products (P, Q, (r*pre)^T dO, (k*suf)^T v,
// A^T dO, (k*suf) Ge, dO v^T, and the local kernel's rebuilds) are 3.0e10
// bf16 operations with the splits below, 0.030 ms at the tensor-core peak;
// the O(n^2 D) running products
// (A, Y, Z, the dw sums) ~1e9 f32 operations on CUDA cores. So the bytes
// bound it, and the design's own traffic is the checkpoints.
//
// Design: three kernels, nothing summed across blocks but du, no atomics
// (two calls are bit-identical, as deterministic training needs). The
// checkpoints are the design's own bytes: a D x D f32 matrix of each chain
// every C steps is B H (S / C) D^2 4 bytes written once and read once (268
// MB each at C = 16 and the training shape, almost twice the function's
// bytes). So a checkpoint is kept every C = 2L = 32 steps, and the local
// kernel rebuilds the state and cotangent between, one chunk update each:
// that cut the chain kernel from 0.27 to 0.19 ms (PERF.md).
//  1. wkv6_bwd_chain_kernel, 2 B H blocks of 3D threads: the state chain
//     (blocks < B H, chunks in order) and the cotangent chain (the rest,
//     last chunk first) side by side. Each keeps its D x D matrix
//     transposed in mma.sync accumulators (warp w < D / 16 owns rows j =
//     16w..16w+15, as in the forward, wkv6_chunked.cu), writes it to its
//     checkpoint every other chunk (S at the start of chunks 0, 2, 4, ...;
//     G at the end of chunks 1, 3, 5, ... and of the last), and updates it
//     with one product of each chunk's inputs: M^T <- pre_n M^T + y^T xt (y
//     = v or dO, xt = k*suf or r*pre). The chain is 128 such updates in a
//     row at the training shape, so its step is kept short: D more threads
//     run the next chunk's CUDA-core pass (xt, pre_n) meanwhile, into a
//     second buffer, and inputs come through a cp.async ring, AHEAD chunks
//     ahead. The cotangent chain ends on dS0.
//  2. wkv6_bwd_local_kernel, one block of 2D threads per (b, h, pair of
//     chunks) (8,192 at the training shape): loads both chunks' inputs and
//     runs the second chunk, then the first, with S0 and Ge read from the
//     checkpoints straight into registers, one of the two rebuilt by one
//     update there (the second chunk's S0, the first chunk's Ge). Warp w
//     holds rows i = 16w.. of both, which are the B operands of P and Q as
//     they stand (rowsum(S0 * Ge) needs no shared memory either); Ge's split
//     goes to shared memory for dv. Then (a) A (every thread, as the
//     forward's prep) and, on the tensor cores, P, Q (warp w: columns i =
//     16w..) and dA (warp 0); (b) dv = A^T dO + (k*suf) Ge on the tensor
//     cores, and on CUDA cores thread i < D runs Y for key i (dr, du's
//     partial sum, two dw terms) while thread D + i runs Z (dk, the other
//     two); the last dw term goes to whichever does it in fewer steps.
//  3. wkv6_bwd_du_kernel: du[h] sums the per-(b, h, chunk) partial sums
//     in a fixed order.
//
// Precision. bf16 keeps 8 bits, too few for operands that are not bf16
// inputs: the states and their cotangents sum up to 2048 steps and reach
// the thousands at the training shape. As in the forward, each such
// operand enters a product as a two-term split, hi = bf16(x), lo = bf16(x -
// hi), with f32 sums: P and Q take S0 and Ge in two products each, A^T dO
// and the chains' updates two, (k*suf) Ge three (hi hi, hi lo, lo hi); dO
// v^T is exact in one.
//
// Its times, registers and the checkpoint interval's cost are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_mma.cuh"

namespace {

using namespace wkv6_mma;

constexpr int NSTAGE = 4;          // chunks in the chain kernel's cp.async ring
constexpr int AHEAD = NSTAGE - 2;  // chunks loaded ahead of the prep's

struct Params {
  const __nv_bfloat16* r;  // (B, S, H, D) contiguous, as are k, v, w, dout and the gradients
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* w;
  const __nv_bfloat16* dout;
  const float* u;     // (H, D)
  const float* s0;    // (B, H, D, D), or null (zeros)
  const float* ds;    // (B, H, D, D), or null (zeros)
  __nv_bfloat16* dr;
  __nv_bfloat16* dk;
  __nv_bfloat16* dv;
  __nv_bfloat16* dw;
  float* du;          // (H, D)
  float* ds0;         // (B, H, D, D)
  float* ck_s;        // (B, H, ceil(NC / 2), D, D) scratch: S at each chunk pair's start
  float* ck_g;        // (B, H, ceil(NC / 2), D, D) scratch: G at each chunk pair's end
  float* du_part;     // (B, H, NC, D) scratch
  int B, S, H, NC;
};

__device__ __forceinline__ float bf(__nv_bfloat16 x) { return __bfloat162float(x); }

// a row of L floats (16-byte aligned) from shared memory into registers
__device__ __forceinline__ void load_row(const float* src, float (&x)[L]) {
#pragma unroll
  for (int m = 0; m < L / 4; ++m) {
    const float4 y = reinterpret_cast<const float4*>(src)[m];
    x[4 * m] = y.x, x[4 * m + 1] = y.y, x[4 * m + 2] = y.z, x[4 * m + 3] = y.w;
  }
}

template <int D>
struct ChainSmem {
  static constexpr int DP = D + 8;     // row pitch (bf16): 16-byte rows, conflict-free ldmatrix
  __nv_bfloat16 in[NSTAGE][3][L][DP];  // x (k or r), w, y (v or dO) of a chunk
  __nv_bfloat16 xt[2][2][L][DP];       // [buffer] x * (suf or pre) as hi, lo   [t][i]
  float pre_e[2][D];                   // [buffer] the product of the chunk's w
};

// The chain kernel's CUDA-core pass for one chunk, by thread i < D (key i):
// the running product of w over the chunk, backwards (suf, role 0) or
// forwards (pre, role 1), weighting x, as splits into xt; and pre_e.
template <int D>
__device__ __forceinline__ void chain_prep(ChainSmem<D>& sm, int stage, int buf, int n, int role,
                                           int i) {
  float xv[L], wv[L];
#pragma unroll
  for (int t = 0; t < L; ++t) {
    xv[t] = bf(sm.in[stage][0][t][i]);
    wv[t] = t < n ? bf(sm.in[stage][1][t][i]) : 1.f;
  }
  float prod = 1.f;
  if (role) {
#pragma unroll
    for (int t = 0; t < L; ++t) {
      split1(xv[t] * prod, sm.xt[buf][0][t][i], sm.xt[buf][1][t][i]);
      prod *= wv[t];
    }
  } else {
#pragma unroll
    for (int s = L - 1; s >= 0; --s) {
      split1(xv[s] * prod, sm.xt[buf][0][s][i], sm.xt[buf][1][s][i]);
      prod *= wv[s];
    }
  }
  sm.pre_e[buf][i] = prod;
}

// 1. The two chains: role 0 (blocks < B H) the state, chunks in order, x =
// k weighted by suf, y = v; role 1 the cotangent, last chunk first, x = r
// weighted by pre, y = dO. The first 2D threads (D / 16 warps) own the
// matrix, M^T[j][i] in accumulator layout: st[nt][0..1] = (j0 + g, 8nt + 2c
// + {0, 1}), st[nt][2..3] = (j0 + g + 8, the same i); they issue the loads,
// write the checkpoints and run the updates. The last D threads run the
// next chunk's CUDA-core pass meanwhile, into the other buffer.
template <int D>
__global__ void __launch_bounds__(3 * D) wkv6_bwd_chain_kernel(const Params p) {
  constexpr int NM = 2 * D;      // threads that own the matrix
  constexpr int NI = D / 8;      // n-tiles of i
  constexpr int PIECES = D / 8;  // 16-byte pieces a row
  static_assert(L * PIECES == NM, "one 16-byte piece of each input a thread a chunk");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  ChainSmem<D>& sm = *reinterpret_cast<ChainSmem<D>*>(smem_raw);

  const int BH = p.B * p.H;
  const int role = blockIdx.x >= BH;
  const int bh = blockIdx.x - role * BH;
  const int b = bh / p.H, h = bh % p.H;
  const int S = p.S, NC = p.NC;
  const int tid = threadIdx.x, lane = tid & 31;
  const int g = lane >> 2, c = lane & 3, lr = lane & 7, lq = lane >> 3, j0 = (tid >> 5) * 16;
  const __nv_bfloat16* X = role ? p.r : p.k;
  const __nv_bfloat16* Y = role ? p.dout : p.v;
  const int64_t ss = (int64_t)p.H * D;                   // a step's stride
  const int64_t head = (int64_t)b * S * ss + (int64_t)h * D;
  const int ld_row = tid / PIECES, ld_piece = tid % PIECES;
  auto chunk_of = [&](int it) { return role ? NC - 1 - it : it; };
  auto load_chunk = [&](int it) {  // by the matrix threads
    if (it < NC) {
      const int stage = it % NSTAGE;
      const int t = chunk_of(it) * L + ld_row;
      const bool valid = t < S;  // past S: zeros (w is taken as 1 by the prep)
      const int64_t o = head + (valid ? t : 0) * ss + ld_piece * 8;
      cp_async16(smem_u32(&sm.in[stage][0][ld_row][ld_piece * 8]), X + o, valid);
      cp_async16(smem_u32(&sm.in[stage][1][ld_row][ld_piece * 8]), p.w + o, valid);
      cp_async16(smem_u32(&sm.in[stage][2][ld_row][ld_piece * 8]), Y + o, valid);
    }
    cp_async_commit();  // an empty group past the end keeps the wait counts uniform
  };
  auto n_of = [&](int it) { return min(L, S - chunk_of(it) * L); };

  const int64_t mat = (int64_t)bh * D * D;
  float st[NI][4];
  float* ck = (role ? p.ck_g : p.ck_s) + (int64_t)bh * ((NC + 1) / 2) * D * D;
  if (tid < NM) {
    const float* init = role ? p.ds : p.s0;
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
        st[nt][e] = init != nullptr ? init[mat + (int64_t)i * D + j] : 0.f;
      }
    }
    for (int it = 0; it < AHEAD; ++it) load_chunk(it);
    cp_async_wait<AHEAD - 1>();  // chunk 0
  }
  __syncthreads();
  if (tid >= NM) chain_prep<D>(sm, 0, 0, n_of(0), role, tid - NM);

  // iteration it: the matrix threads update with chunk it (stage it %
  // NSTAGE, buffer it % 2) while the prep threads run chunk it + 1 into the
  // other buffer. A load goes to the stage of chunk it + AHEAD, which is
  // none of chunks it - 1 (a matrix thread may still be reading it), it and
  // it + 1: NSTAGE >= AHEAD + 2.
  static_assert(NSTAGE >= AHEAD + 2, "the ring holds chunks it - 1 .. it + AHEAD");
  for (int it = 0; it < NC; ++it) {
    if (tid < NM) {
      load_chunk(it + AHEAD);
      cp_async_wait<AHEAD - 1>();  // chunks up to it + 1 have landed
    }
    __syncthreads();  // chunk it + 1 is visible; chunk it's pass is complete
    if (tid >= NM) {
      if (it + 1 < NC) chain_prep<D>(sm, (it + 1) % NSTAGE, (it + 1) & 1, n_of(it + 1), role,
                                     tid - NM);
      continue;
    }
    const int stage = it % NSTAGE, buf = it & 1;
    // the checkpoint, [i][j], of each pair of chunks: S at the first's
    // start, G at the last's end
    const int chk = chunk_of(it);
    if (role ? chk % 2 == 1 || chk == NC - 1 : chk % 2 == 0) {
      float* out = ck + (int64_t)(chk / 2) * D * D;
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
          out[(int64_t)i * D + j] = st[nt][e];
        }
      }
    }
    uint32_t yt[4];   // y^T as the A operand: rows j0.., k = t
    ldsm_x4_t(yt, smem_u32(&sm.in[stage][2][(lq >> 1) * 8 + lr][j0 + (lq & 1) * 8]));
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
      const float2 pe = *reinterpret_cast<const float2*>(&sm.pre_e[buf][nt * 8 + 2 * c]);
      st[nt][0] *= pe.x;
      st[nt][1] *= pe.y;
      st[nt][2] *= pe.x;
      st[nt][3] *= pe.y;
    }
#pragma unroll
    for (int np = 0; np < NI / 2; ++np) {  // two n-tiles of i a load
      uint32_t bh_[4], bl_[4];
      const int row = (lq & 1) * 8 + lr, col = np * 16 + (lq >> 1) * 8;
      ldsm_x4_t(bh_, smem_u32(&sm.xt[buf][0][row][col]));
      ldsm_x4_t(bl_, smem_u32(&sm.xt[buf][1][row][col]));
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        mma(st[2 * np + e], yt, bh_[2 * e], bh_[2 * e + 1]);
        mma(st[2 * np + e], yt, bl_[2 * e], bl_[2 * e + 1]);
      }
    }
  }
  if (role && tid < NM) {
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
        p.ds0[mat + (int64_t)i * D + j] = st[nt][e];
      }
    }
  }
}

template <int D>
struct LocalSmem {
  static constexpr int DP = D + 8;  // bf16 row pitch
  static constexpr int LP = L + 8;
  static constexpr int FP = D + 4;  // f32 row pitch
  __nv_bfloat16 in[2][5][L][DP];    // [chunk] r, k, v, w, dO          [t][i or j]
  __nv_bfloat16 kt[2][2][L][DP];    // [chunk] k * suf as hi, lo       [s][i]
  __nv_bfloat16 rt[2][L][DP];       // the second chunk's r * pre      [t][i]
  __nv_bfloat16 ge[2][D][DP];       // Ge as hi, lo                    [i][j]
  __nv_bfloat16 a[2][L][LP];        // A as hi, lo                     [t][s]
  float p[L][FP];                   // P = dO S0^T                     [t][i]
  float q[L][FP];                   // Q = v Ge^T                      [s][i]
  float da[L][L];                   // dA = dO v^T                     [t][s]
  float dat[L][L];                  // dA^T                            [s][t]
  float dw[L][D];                   // the Z threads' share of dw      [tau][i]
  float pre_n[2][D];                // [chunk] the product of its w
  float csum[D];                    // rowsum(S0 * Ge)
  float u[D];
};

// A D x D f32 matrix M[i][j] in the local kernel's accumulator layout:
// warp w holds rows i = 16w + g + {0, 8}, m[nt][0..1] = (16w + g, 8nt + 2c
// + {0, 1}) and m[nt][2..3] = (16w + g + 8, the same j).
template <int D>
__device__ __forceinline__ void load_rows(const float* src, float (&m)[D / 8][4], int n0, int g,
                                          int c) {
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
#pragma unroll
    for (int hh = 0; hh < 2; ++hh) {
      const float2 x = __ldg(reinterpret_cast<const float2*>(
          src + (int64_t)(n0 + g + 8 * hh) * D + nt * 8 + 2 * c));
      m[nt][2 * hh] = x.x;
      m[nt][2 * hh + 1] = x.y;
    }
  }
}

// M <- diag(pre) M + X^T Y over one chunk on the tensor cores (the chains'
// update, in the local kernel's layout): X [t][i] as hi, lo splits (k * suf
// or r * pre), Y [t][j] a bf16 input (v or dO).
template <int D, int DP>
__device__ __forceinline__ void advance(float (&m)[D / 8][4], const float* pre,
                                        const __nv_bfloat16 (*xh)[DP],
                                        const __nv_bfloat16 (*xl)[DP],
                                        const __nv_bfloat16 (*y)[DP], int n0, int lane) {
  const int g = lane >> 2, lr = lane & 7, lq = lane >> 3;
  const float p0 = pre[n0 + g], p1 = pre[n0 + g + 8];
#pragma unroll
  for (int nt = 0; nt < D / 8; ++nt) {
    m[nt][0] *= p0;
    m[nt][1] *= p0;
    m[nt][2] *= p1;
    m[nt][3] *= p1;
  }
  uint32_t ah[4], al[4];  // X^T as the A operand: rows i = n0.., k = t
  const int arow = (lq >> 1) * 8 + lr, acol = n0 + (lq & 1) * 8;
  ldsm_x4_t(ah, smem_u32(&xh[arow][acol]));
  ldsm_x4_t(al, smem_u32(&xl[arow][acol]));
#pragma unroll
  for (int np = 0; np < D / 16; ++np) {  // Y as B (k = t, n = j), two n-tiles a load
    uint32_t by[4];
    ldsm_x4_t(by, smem_u32(&y[(lq & 1) * 8 + lr][np * 16 + (lq >> 1) * 8]));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mma(m[2 * np + e], ah, by[2 * e], by[2 * e + 1]);
      mma(m[2 * np + e], al, by[2 * e], by[2 * e + 1]);
    }
  }
}

// 2. The gradients of a pair of chunks (c0, c0 + 1) from their inputs and
// two checkpoints: S at c0's start and G at the pair's end. The second
// chunk's S and the first chunk's G are rebuilt here, one update each, so
// the chains keep a checkpoint every 2L steps. A lone last chunk takes both
// checkpoints as they are. Two blocks an SM: the CUDA-core pass keeps ~240
// registers a thread at D 64, and capped at three blocks' 168 it spilled
// and ran slower (PERF.md).
template <int D>
__global__ void __launch_bounds__(2 * D, 2) wkv6_bwd_local_kernel(const Params p) {
  using Sm = LocalSmem<D>;
  constexpr int NT = 2 * D;
  constexpr int NI = D / 8;  // n-tiles of j in a warp's rows
  constexpr int PIECES = D / 8;
  static_assert(L * PIECES == NT, "one 16-byte piece of each input a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Sm& sm = *reinterpret_cast<Sm*>(smem_raw);

  const int NC = p.NC, S = p.S, NP = (NC + 1) / 2;
  const int pair = blockIdx.x % NP, bh = blockIdx.x / NP;
  const int b = bh / p.H, h = bh % p.H;
  const int c0 = 2 * pair, nsub = min(2, NC - c0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, c = lane & 3, lr = lane & 7, lq = lane >> 3, n0 = warp * 16;
  const int64_t ss = (int64_t)p.H * D;
  const int64_t base = (int64_t)b * S * ss + (int64_t)h * D;  // (b, 0, h, 0)

  {  // both chunks' inputs; past S r = k = v = dO = 0 and w = 1
    const int row = tid / PIECES, piece = tid % PIECES;
    const __nv_bfloat16* src[5] = {p.r, p.k, p.v, p.w, p.dout};
    for (int sub = 0; sub < nsub; ++sub) {
      const int t = (c0 + sub) * L + row;
      const int64_t o = base + (int64_t)t * ss + piece * 8;
#pragma unroll
      for (int x = 0; x < 5; ++x) {
        const uint32_t fill = x == 3 ? 0x3f803f80u : 0u;  // bf16 1.0 pairs
        uint4 val = make_uint4(fill, fill, fill, fill);
        if (t < S) val = __ldg(reinterpret_cast<const uint4*>(src[x] + o));
        *reinterpret_cast<uint4*>(&sm.in[sub][x][row][piece * 8]) = val;
      }
    }
  }
  if (tid < D) sm.u[tid] = p.u[h * D + tid];
  for (int e = tid; e < 2 * L * Sm::LP; e += NT)
    (&sm.a[0][0][0])[e] = __float2bfloat16_rn(0.f);  // A's upper triangle stays 0
  __syncthreads();
  // k * suf of each chunk and its pre_n (threads D..2D-1); the second
  // chunk's r * pre (threads < D), for the first chunk's G
  if (tid >= D) {
    const int i = tid - D;
    for (int sub = 0; sub < nsub; ++sub) {
      float suf = 1.f;
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        split1(bf(sm.in[sub][1][s][i]) * suf, sm.kt[sub][0][s][i], sm.kt[sub][1][s][i]);
        suf *= bf(sm.in[sub][3][s][i]);
      }
      sm.pre_n[sub][i] = suf;
    }
  } else if (nsub == 2) {
    const int i = tid;
    float pre = 1.f;
#pragma unroll
    for (int t = 0; t < L; ++t) {
      split1(bf(sm.in[1][0][t][i]) * pre, sm.rt[0][t][i], sm.rt[1][t][i]);
      pre *= bf(sm.in[1][3][t][i]);
    }
  }
  __syncthreads();

  const int64_t ck = ((int64_t)bh * NP + pair) * D * D;
  for (int sub = nsub - 1; sub >= 0; --sub) {
    const int ch = c0 + sub, n = min(L, S - ch * L);
    const int64_t head = base + (int64_t)ch * L * ss;
    const __nv_bfloat16(*const in)[L][Sm::DP] = sm.in[sub];

    // (a) this chunk's S0 and Ge (one of them rebuilt), as the B operands of
    // P and Q, Ge's split for dv and rowsum(S0 * Ge); A on CUDA cores; P,
    // Q and dA on the tensor cores
    {
      float s0[NI][4], ge[NI][4];
      load_rows<D>(p.ck_s + ck, s0, n0, g, c);
      load_rows<D>(p.ck_g + ck, ge, n0, g, c);
      if (sub == 1)
        advance<D, Sm::DP>(s0, sm.pre_n[0], sm.kt[0][0], sm.kt[0][1], sm.in[0][2], n0, lane);
      else if (nsub == 2)
        advance<D, Sm::DP>(ge, sm.pre_n[1], sm.rt[0], sm.rt[1], sm.in[1][4], n0, lane);
      float cs0 = 0.f, cs1 = 0.f;
      uint32_t gh[NI][2], gl[NI][2];  // Ge's split by pairs: dv's (in shared memory) and Q's B
#pragma unroll
      for (int nt = 0; nt < NI; ++nt) {
        cs0 = fmaf(s0[nt][0], ge[nt][0], fmaf(s0[nt][1], ge[nt][1], cs0));
        cs1 = fmaf(s0[nt][2], ge[nt][2], fmaf(s0[nt][3], ge[nt][3], cs1));
#pragma unroll
        for (int hh = 0; hh < 2; ++hh) {
          split2(ge[nt][2 * hh], ge[nt][2 * hh + 1], gh[nt][hh], gl[nt][hh]);
          *reinterpret_cast<uint32_t*>(&sm.ge[0][n0 + g + 8 * hh][nt * 8 + 2 * c]) = gh[nt][hh];
          *reinterpret_cast<uint32_t*>(&sm.ge[1][n0 + g + 8 * hh][nt * 8 + 2 * c]) = gl[nt][hh];
        }
      }
#pragma unroll
      for (int o = 1; o < 4; o <<= 1) {
        cs0 += __shfl_xor_sync(0xffffffffu, cs0, o);
        cs1 += __shfl_xor_sync(0xffffffffu, cs1, o);
      }
      if (c == 0) {
        sm.csum[n0 + g] = cs0;
        sm.csum[n0 + g + 8] = cs1;
      }
      float pa[2][4] = {}, qa[2][4] = {}, da[2][4] = {};
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t ad[4], av[4];
        const int row = (lq & 1) * 8 + lr, col = kk * 16 + (lq >> 1) * 8;
        ldsm_x4(ad, smem_u32(&in[4][row][col]));  // dO [t][j] as A
        ldsm_x4(av, smem_u32(&in[2][row][col]));  // v [s][j] as A
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          // S0 and Ge as B (k = j, n = i): n-tiles 2kk and 2kk + 1 of the
          // accumulator layout are the k-halves of this step, rows nt
          uint32_t sh0, sl0, sh1, sl1;
          split2(s0[2 * kk][2 * nt], s0[2 * kk][2 * nt + 1], sh0, sl0);
          split2(s0[2 * kk + 1][2 * nt], s0[2 * kk + 1][2 * nt + 1], sh1, sl1);
          mma(pa[nt], ad, sh0, sh1);
          mma(pa[nt], ad, sl0, sl1);
          mma(qa[nt], av, gh[2 * kk][nt], gh[2 * kk + 1][nt]);
          mma(qa[nt], av, gl[2 * kk][nt], gl[2 * kk + 1][nt]);
        }
        if (warp == 0) {
          uint32_t bv[4];  // v [s][j] as B (k = j, n = s)
          ldsm_x4(bv, smem_u32(&in[2][(lq >> 1) * 8 + lr][kk * 16 + (lq & 1) * 8]));
#pragma unroll
          for (int nt = 0; nt < 2; ++nt) mma(da[nt], ad, bv[2 * nt], bv[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + (e >> 1) * 8, col = nt * 8 + 2 * c + (e & 1);
          sm.p[t][n0 + col] = pa[nt][e];
          sm.q[t][n0 + col] = qa[nt][e];
          if (warp == 0) sm.da[t][col] = sm.dat[col][t] = da[nt][e];
        }
      }
    }
    chunk_a<D, Sm::DP, Sm::LP>(in[0], in[1], in[3], sm.u, sm.a[0], sm.a[1], tid);
    __syncthreads();

    // (b) dv = A^T dO + (k * suf) Ge on the tensor cores (warp w: columns j = 16w..)
    {
      float acc[2][4] = {};
      uint32_t ath[4], atl[4], bd[4];
      const int arow = (lq >> 1) * 8 + lr, acol = (lq & 1) * 8;
      ldsm_x4_t(ath, smem_u32(&sm.a[0][arow][acol]));  // A [t][s] as A^T (m = s, k = t)
      ldsm_x4_t(atl, smem_u32(&sm.a[1][arow][acol]));
      const int brow = (lq & 1) * 8 + lr, bcol = n0 + (lq >> 1) * 8;
      ldsm_x4_t(bd, smem_u32(&in[4][brow][bcol]));  // dO [t][j] as B (k = t, n = j)
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
        mma(acc[nt], ath, bd[2 * nt], bd[2 * nt + 1]);
        mma(acc[nt], atl, bd[2 * nt], bd[2 * nt + 1]);
      }
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
        uint32_t kh[4], kl[4], gh[4], gl[4];
        const int row = (lq & 1) * 8 + lr, col = kk * 16 + (lq >> 1) * 8;
        ldsm_x4(kh, smem_u32(&sm.kt[sub][0][row][col]));  // k * suf [s][i] as A
        ldsm_x4(kl, smem_u32(&sm.kt[sub][1][row][col]));
        ldsm_x4_t(gh, smem_u32(&sm.ge[0][kk * 16 + brow][bcol]));  // Ge [i][j] as B
        ldsm_x4_t(gl, smem_u32(&sm.ge[1][kk * 16 + brow][bcol]));
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma(acc[nt], kh, gh[2 * nt], gh[2 * nt + 1]);
          mma(acc[nt], kh, gl[2 * nt], gl[2 * nt + 1]);
          mma(acc[nt], kl, gh[2 * nt], gh[2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int s = g + half * 8, j = n0 + nt * 8 + 2 * c;
          if (s < n) {
            const uint32_t v2 = pack(__float2bfloat16_rn(acc[nt][2 * half]),
                                     __float2bfloat16_rn(acc[nt][2 * half + 1]));
            *reinterpret_cast<uint32_t*>(p.dv + head + (int64_t)s * ss + j) = v2;
          }
        }
      }
    }

    // (b) the running products on CUDA cores, key i a thread pair. The last
    // dw term, sum_{s<tau<t} dA[t,s] r_t k_s Dec(s,tau) Dec(tau,t), is taken
    // by whichever thread does it in fewer steps: the Y thread as sum_{t>tau}
    // r_t Dec(tau,t) Y_t,tau for tau >= L/2, the Z thread as sum_{s<tau} k_s
    // Dec(s,tau) Z_s,tau for tau < L/2.
    const int i = tid % D;
    float rv[L], kv[L], wv[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      rv[t] = bf(in[0][t][i]);
      kv[t] = bf(in[1][t][i]);
      wv[t] = bf(in[3][t][i]);
    }
    const float ui = sm.u[i];
    float dwy[L];
    if (tid < D) {
      // Y_t,tau for every t > tau while tau runs forward
      float Y[L];
#pragma unroll
      for (int t = 0; t < L; ++t) Y[t] = 0.f;
#pragma unroll
      for (int tau = 0; tau < L; ++tau) {
        dwy[tau] = 0.f;
        if (tau >= L / 2) {
          float d = 1.f;
#pragma unroll
          for (int t = tau + 1; t < L; ++t) {
            dwy[tau] = fmaf(d * rv[t], Y[t], dwy[tau]);
            d *= wv[t];
          }
        }
        float col[L];  // dA[t][tau] over t
        load_row(sm.dat[tau], col);
#pragma unroll
        for (int t = tau + 1; t < L; ++t) Y[t] = fmaf(wv[tau], Y[t], col[t] * kv[tau]);
      }
      float pre = 1.f, du_acc = 0.f;
#pragma unroll
      for (int t = 0; t < L; ++t) {  // Y[t] = Y_t,t now
        const float dat = sm.da[t][t];
        const float g_r = fmaf(pre, sm.p[t][i], Y[t]) + dat * ui * kv[t];
        if (t < n) p.dr[head + (int64_t)t * ss + i] = __float2bfloat16_rn(g_r);
        du_acc = fmaf(dat * rv[t], kv[t], du_acc);
        pre *= wv[t];
      }
      p.du_part[((int64_t)bh * NC + ch) * D + i] = du_acc;
      // suf_tau sum_{s<tau} Dec(s,tau) k_s Q_s
      float l3[L];
      l3[0] = 0.f;
#pragma unroll
      for (int tau = 1; tau < L; ++tau)
        l3[tau] = fmaf(wv[tau - 1], l3[tau - 1], kv[tau - 1] * sm.q[tau - 1][i]);
      float suf = 1.f;
#pragma unroll
      for (int tau = L - 1; tau >= 0; --tau) {
        dwy[tau] = fmaf(suf, l3[tau], dwy[tau]);
        suf *= wv[tau];
      }
    } else {
      // Z_s,tau for every s < tau while tau runs backward
      float Z[L], t4[L];
#pragma unroll
      for (int s = 0; s < L; ++s) Z[s] = t4[s] = 0.f;
#pragma unroll
      for (int tau = L - 1; tau >= 1; --tau) {
        if (tau < L / 2) {
          float d = 1.f, acc = 0.f;
#pragma unroll
          for (int s = tau - 1; s >= 0; --s) {
            acc = fmaf(d * kv[s], Z[s], acc);
            d *= wv[s];
          }
          t4[tau] = acc;
        }
        float row[L];  // dA[tau][s] over s
        load_row(sm.da[tau], row);
#pragma unroll
        for (int s = 0; s < tau; ++s) Z[s] = fmaf(wv[tau], Z[s], row[s] * rv[tau]);
      }
      float sufv[L], suf = 1.f;
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {  // Z[s] = Z_s,s now
        sufv[s] = suf;
        const float g_k = fmaf(suf, sm.q[s][i], Z[s]) + sm.da[s][s] * ui * rv[s];
        if (s < n) p.dk[head + (int64_t)s * ss + i] = __float2bfloat16_rn(g_k);
        suf *= wv[s];
      }
      // pre_tau (suf_tau rowsum(S0 * Ge) + sum_{t>tau} Dec(tau,t) r_t P_t)
      float r2[L];
      r2[L - 1] = 0.f;
#pragma unroll
      for (int tau = L - 2; tau >= 0; --tau)
        r2[tau] = fmaf(wv[tau + 1], r2[tau + 1], rv[tau + 1] * sm.p[tau + 1][i]);
      const float cs = sm.csum[i];
      float pre = 1.f;
#pragma unroll
      for (int tau = 0; tau < L; ++tau) {
        const float part = pre * fmaf(sufv[tau], cs, r2[tau]);
        sm.dw[tau][i] = part + t4[tau];
        pre *= wv[tau];
      }
    }
    __syncthreads();
    if (tid < D) {
#pragma unroll
      for (int tau = 0; tau < L; ++tau)
        if (tau < n)
          p.dw[head + (int64_t)tau * ss + i] = __float2bfloat16_rn(dwy[tau] + sm.dw[tau][i]);
    }
    __syncthreads();  // before the next chunk of the pair reuses the buffers
  }
}

// 3. du[h]: the partial sums over (b, chunk) in a fixed order: DU_PARTS
// threads a key each sum a contiguous run of the (b, chunk) pairs, then one
// sums the runs in order.
constexpr int DU_PARTS = 8;

template <int D>
__global__ void __launch_bounds__(D * DU_PARTS) wkv6_bwd_du_kernel(const Params p) {
  __shared__ float part[DU_PARTS][D];
  const int h = blockIdx.x, i = threadIdx.x % D, q = threadIdx.x / D;
  const int n = p.B * p.NC, per = (n + DU_PARTS - 1) / DU_PARTS;
  float a = 0.f;
  for (int x = q * per; x < min(n, (q + 1) * per); ++x) {
    const int b = x / p.NC, ch = x % p.NC;
    a += p.du_part[(((int64_t)b * p.H + h) * p.NC + ch) * D + i];
  }
  part[q][i] = a;
  __syncthreads();
  if (q == 0) {
#pragma unroll
    for (int r = 1; r < DU_PARTS; ++r) a += part[r][i];
    p.du[h * D + i] = a;
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int chain_smem = (int)sizeof(ChainSmem<D>);
  constexpr int local_smem = (int)sizeof(LocalSmem<D>);
  static uint64_t attribute_set = 0;  // one bit per device, set once a process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(attribute_set >> dev & 1)) {
    err = cudaFuncSetAttribute(wkv6_bwd_local_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, local_smem);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(wkv6_bwd_chain_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, chain_smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attribute_set |= uint64_t{1} << dev;
  }
  wkv6_bwd_chain_kernel<D><<<2 * p.B * p.H, 3 * D, chain_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_local_kernel<D><<<p.B * p.H * ((p.NC + 1) / 2), 2 * D, local_smem, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  wkv6_bwd_du_kernel<D><<<p.H, D * DU_PARTS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 r, k, v, w, dout and dr, dk, dv, dw, all contiguous (B, S, H, D)
// with 16-byte aligned starts; u, state_in, ds_in, du, ds0 and the scratch
// (ck_s, ck_g: B * H * ceil(S / 32) * D * D floats each; du_part: B * H *
// ceil(S / 16) * D floats) f32 and contiguous; state_in and ds_in may be
// null (zeros). The same arguments as wkv6_bwd but one more scratch
// pointer; dtype must be 1 (bf16). Returns a cudaError_t (0 = success).
extern "C" int wkv6_bwd_chunked(const void* r, const void* k, const void* v, const void* w,
                                const float* u, const float* state_in, const void* dout,
                                const float* ds_in, void* dr, void* dk, void* dv, void* dw,
                                float* du, float* ds0, float* ck_s, float* ck_g,
                                float* du_part, int dtype, int B, int S, int H, int D,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || dtype != 1) return (int)cudaErrorInvalidValue;
  using bf16p = const __nv_bfloat16*;
  const Params p{static_cast<bf16p>(r), static_cast<bf16p>(k), static_cast<bf16p>(v),
                 static_cast<bf16p>(w), static_cast<bf16p>(dout), u, state_in, ds_in,
                 static_cast<__nv_bfloat16*>(dr), static_cast<__nv_bfloat16*>(dk),
                 static_cast<__nv_bfloat16*>(dv), static_cast<__nv_bfloat16*>(dw),
                 du, ds0, ck_s, ck_g, du_part, B, S, H, (S + L - 1) / L};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return (int)launch<16>(p, s);
  if (D == 32) return (int)launch<32>(p, s);
  if (D == 64) return (int)launch<64>(p, s);
  return (int)cudaErrorInvalidValue;
}
