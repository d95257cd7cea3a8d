// RWKV-6 (Finch) WKV backward for Hopper (sm_90a), on CUDA cores, plain C
// interface for ctypes.
//
// The VJP of the WKV recurrence that repro/kernels/rwkv6_scan.py::_kernel
// (the Pallas TPU kernel behind repro.kernels.ops.wkv6) computes. The
// Pallas kernel has no backward: the reference trains through jax.grad of
// its lax.scan oracle (repro/kernels/ref.py::wkv6_ref), and this kernel
// computes that gradient. Per (b, h), with S_t the D x D state before step
// t (S_0 = state_in, or zeros) and G_t its cotangent (G_T = ds, or zeros):
//
//   G_t      = diag(w_t) G_{t+1} + r_t^T dO_t
//   dr_t[i]  = sum_j S_t[i][j] dO_t[j] + u_i k_t[i] (v_t . dO_t)
//   dk_t[i]  = sum_j G_{t+1}[i][j] v_t[j] + u_i r_t[i] (v_t . dO_t)
//   dv_t[j]  = sum_i k_t[i] G_{t+1}[i][j] + (sum_i r_t[i] u_i k_t[i]) dO_t[j]
//   dw_t[i]  = sum_j G_{t+1}[i][j] S_t[i][j]
//   du[h][i] = sum_{b, t} r_t[i] k_t[i] (v_t . dO_t)
//
// and writes dr, dk, dv, dw in the input dtype (bf16 or f32), du and
// ds0 = G_0 in f32. All arithmetic is f32.
//
// What bounds it on an H100. At rwkv6-7b training (B 2, S 2048, H 64,
// D 64, bf16) the function reads r, k, v, w, dO and writes dr, dk, dv, dw:
// 9 (B, S, H, D) bf16 tensors, 302 MB, 0.090 ms at 3.35 TB/s. It needs 14
// operations per (b, t, h, i, j) (the state and its cotangent, 3 each, and
// four sums, 2 each): 1.5e10 at that shape, 0.015 ms at the bf16
// tensor-core peak but 0.22 ms on CUDA cores, where this first kernel, right
// and simple, does them. The chunked tensor-core form of the forward
// (wkv6_chunked.cu) is the later step.
//
// Design. The recurrence separates by key row i: S[i][:] and G[i][:] each
// evolve alone, driven by (r, k, w)_t[i] and the vectors v_t, dO_t. So dr,
// dk, dw and du are sums within a row, and only dv sums across rows. Two
// kernels, each scanning backwards in time with no sum across blocks:
//
//  - wkv6_bwd_rows_kernel: a block owns RG = 16 rows of one (b, h) (D / 16
//    blocks a head: 512 blocks of 128 threads at the training shape, where
//    one block a head would leave 128 blocks for 132 SMs). L = 8 lanes
//    share a row, each holding J = D / 8 of its columns (j = q + 8 m) of S
//    and G in registers, so a row's three sums take three 3-step shuffle
//    trees. dw needs S_t while the scan runs backwards, so the block first
//    runs the forward recurrence and writes S at every C = 16 steps to
//    `ckpt` (B * H * ceil(S / 16) * D^2 f32, 268 MB at the training shape,
//    read back by the same block), then for each chunk, last first,
//    rebuilds the chunk's states from its checkpoint into shared memory, 8
//    steps at a time (the second half first; each lane keeps its own
//    elements, as vectors of consecutive lanes side by side; kept in
//    registers, the 8 states spilled), and runs the 8 steps backwards. S_t
//    is never rebuilt by dividing by w_t (bf16 decays round to 0 and to
//    1), and dw is the row sum itself, not a difference of suffix sums.
//  - wkv6_bwd_cols_kernel: a block owns 32 columns of one (b, h) (all D at
//    D 16); KS = 8 lanes share a column, each holding D / 8 of its rows of
//    G, and dv_t[j] is their sum (three shuffles) plus the rank-one term.
//    It needs no state, only G again, which costs 2 operations an element
//    a step. After it, the blocks of b = 0 sum du over b in order, from
//    the per-(b, h) partial sums the row kernel wrote.
//
// Each chunk's inputs are staged in shared memory (padded past S with
// r = k = v = dO = 0 and w = 1, which leave S and G unchanged, so a ragged
// last chunk runs the same loop and only its stores are masked), with the
// chunk's v_t . dO_t (row kernel) or sum_i r_t u k_t (column kernel) summed
// by one warp a step. The next chunk's inputs (and checkpoint) are loaded
// into registers while the block computes this one. Every sum runs in a
// fixed order and nothing is atomic, so two runs are bit-identical, as
// deterministic training needs.
//
// What the simple design leaves on the table (PERF.md has its times): both
// scans are bound by shared-memory wavefronts. Every lane reads each
// step's vectors from shared memory, and the quarter-warps of a warp read
// the same addresses, so a 128-bit load costs 4 wavefronts for 8 distinct
// values; the row kernel also stores and reloads each rebuilt state and
// re-runs 1.4 forward steps a step. A chunked form on the tensor cores
// would turn a chunk's steps into matrix products.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int C = 16;     // steps a chunk: the checkpoint interval (wkv6.CHUNK)
constexpr int HALF = 8;   // states rebuilt at a time
constexpr int RG = 16;    // state rows a block of the row kernel
constexpr int L = 8;      // lanes a row in the row kernel
constexpr int KS = 8;     // lanes a column in the column kernel
constexpr int CG = 32;    // columns a block of the column kernel (at most)

struct Params {
  const void* r;
  const void* k;
  const void* v;
  const void* w;
  const void* dout;
  const float* u;      // (H, D) f32
  const float* s0;     // (B, H, D, D) f32, or null (zeros)
  const float* ds;     // (B, H, D, D) f32, or null (zeros)
  void* dr;
  void* dk;
  void* dv;
  void* dw;
  float* du;           // (H, D)
  float* ds0;          // (B, H, D, D)
  float* ckpt;         // (B, H, NC, D, D) scratch
  float* du_part;      // (B, H, D) scratch
  int B, S, H, NC;
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

// sum over the n adjacent lanes of a group (n a power of two), every lane
// of the group getting the same sum
template <int N>
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 1; off < N; off <<= 1) x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// a lane's J state elements as NV vectors of VW floats in shared memory
template <int VW>
struct Vec;
template <>
struct Vec<2> {
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  }
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x, x[1] = y.y;
  }
};
template <>
struct Vec<4> {
  static __device__ __forceinline__ void store(float* p, const float* x) {
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
  }
  static __device__ __forceinline__ void load(const float* p, float* x) {
    const float4 y = *reinterpret_cast<const float4*>(p);
    x[0] = y.x, x[1] = y.y, x[2] = y.z, x[3] = y.w;
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(RG * L) wkv6_bwd_rows_kernel(const Params p) {
  constexpr int J = D / L;   // columns a lane: j = q + L * m
  constexpr int NG = D / RG; // blocks a head
  constexpr int NT = RG * L;
  constexpr int VW = J >= 4 ? 4 : J;
  constexpr int NV = J / VW;
  constexpr int NRK = C * RG / NT;  // (t, row) entries a thread stages
  constexpr int NVD = C * D / NT;   // (t, j) entries a thread stages
  __shared__ float4 s_rkw[C][RG];  // (r_i, k_i, w_i, 0) of the block's rows, by step
  __shared__ float2 s_vdo[C][D];   // (v_j, dO_j), by step
  __shared__ float s_dot[C];       // v_t . dO_t
  // the rebuilt states of half a chunk, each lane's own (vectors of
  // consecutive lanes adjacent: no bank conflict)
  __shared__ __align__(16) float s_sb[HALF][NV][NT][VW];

  const int tid = threadIdx.x;
  const int g = blockIdx.x % NG;
  const int bh = blockIdx.x / NG;  // b * H + h
  const int h = bh % p.H, b = bh / p.H;
  const int row = tid / L, q = tid % L;
  const int i = g * RG + row;
  const int S = p.S;
  const int64_t ss = (int64_t)p.H * D;  // step stride of a (B, S, H, D) tensor
  const int64_t base = (int64_t)b * S * ss + (int64_t)h * D;
  const T* R = static_cast<const T*>(p.r) + base;
  const T* K = static_cast<const T*>(p.k) + base;
  const T* V = static_cast<const T*>(p.v) + base;
  const T* W = static_cast<const T*>(p.w) + base;
  const T* DO = static_cast<const T*>(p.dout) + base;
  const float ui = p.u[h * D + i];
  const int64_t st_off = (int64_t)bh * D * D + (int64_t)i * D + q;  // (i, q) of this head's state
  float* ck = p.ckpt + (int64_t)bh * p.NC * D * D + (int64_t)i * D + q;
  const T zero = from_f32<T>(0.f), one = from_f32<T>(1.f);

  // A chunk's inputs go through registers (loaded while the block computes
  // the chunk before) into shared memory: k, w (and r, dO going backwards)
  // of the block's rows and v (and dO) of every column; past S the padding
  // leaves S and G unchanged.
  T pr[NRK], pk[NRK], pw[NRK], pv[NVD], pd[NVD];
  auto load = [&](int t0, bool back) {
#pragma unroll
    for (int n = 0; n < NRK; ++n) {
      const int e = tid + n * NT, tt = t0 + e / RG;
      const int64_t o = (int64_t)tt * ss + g * RG + e % RG;
      pr[n] = back && tt < S ? R[o] : zero;
      pk[n] = tt < S ? K[o] : zero;
      pw[n] = tt < S ? W[o] : one;
    }
#pragma unroll
    for (int n = 0; n < NVD; ++n) {
      const int e = tid + n * NT, tt = t0 + e / D;
      const int64_t o = (int64_t)tt * ss + e % D;
      pv[n] = tt < S ? V[o] : zero;
      pd[n] = back && tt < S ? DO[o] : zero;
    }
  };
  // store the loaded chunk; going backwards, also sum v_t . dO_t (one warp
  // a step). Callers synchronise before (readers of the last chunk) and
  // after.
  auto store = [&](bool back) {
#pragma unroll
    for (int n = 0; n < NRK; ++n) {
      const int e = tid + n * NT;
      s_rkw[e / RG][e % RG] = make_float4(to_f32(pr[n]), to_f32(pk[n]), to_f32(pw[n]), 0.f);
    }
#pragma unroll
    for (int n = 0; n < NVD; ++n) {
      const int e = tid + n * NT;
      s_vdo[e / D][e % D] = make_float2(to_f32(pv[n]), to_f32(pd[n]));
    }
    if (!back) return;
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;
    for (int t = warp; t < C; t += NT / 32) {
      float a = 0.f;
      for (int j = lane; j < D; j += 32) a = fmaf(s_vdo[t][j].x, s_vdo[t][j].y, a);
      a = group_sum<32>(a);
      if (lane == 0) s_dot[t] = a;
    }
  };
  // S <- diag(w_t) S + k_t^T v_t on this lane's elements
  auto forward_step = [&](float (&st)[J], int t) {
    const float4 y = s_rkw[t][row];
#pragma unroll
    for (int m = 0; m < J; ++m) st[m] = fmaf(y.z, st[m], y.y * s_vdo[t][q + L * m].x);
  };

  // forward pass: the state at the start of every chunk
  float st[J];
#pragma unroll
  for (int m = 0; m < J; ++m) st[m] = p.s0 != nullptr ? p.s0[st_off + L * m] : 0.f;
  if (p.NC > 1) {
    load(0, false);
    store(false);
    __syncthreads();
  }
  for (int c = 0; c < p.NC; ++c) {
#pragma unroll
    for (int m = 0; m < J; ++m) ck[(int64_t)c * D * D + L * m] = st[m];
    if (c == p.NC - 1) break;
    if (c + 2 < p.NC) load((c + 1) * C, false);  // in flight during the steps
#pragma unroll 4
    for (int t = 0; t < C; ++t) forward_step(st, t);
    __syncthreads();
    if (c + 2 < p.NC) {
      store(false);
      __syncthreads();
    }
  }

  // backward pass, a chunk at a time, last first
  float G[J], sc[J];
#pragma unroll
  for (int m = 0; m < J; ++m) {
    G[m] = p.ds != nullptr ? p.ds[st_off + L * m] : 0.f;
    sc[m] = ck[(int64_t)(p.NC - 1) * D * D + L * m];
  }
  float du_acc = 0.f;
  T* DR = static_cast<T*>(p.dr) + base + i;
  T* DK = static_cast<T*>(p.dk) + base + i;
  T* DW = static_cast<T*>(p.dw) + base + i;
  load((p.NC - 1) * C, true);
  __syncthreads();
  store(true);
  __syncthreads();
  for (int c = p.NC - 1; c >= 0; --c) {
    float sc_next[J];
    if (c > 0) {  // the next chunk's inputs and checkpoint, in flight during this one
      load((c - 1) * C, true);
#pragma unroll
      for (int m = 0; m < J; ++m) sc_next[m] = ck[(int64_t)(c - 1) * D * D + L * m];
    }
#pragma unroll 1
    for (int half = 1; half >= 0; --half) {
      // the states before steps half * 8 ... half * 8 + 7, from the checkpoint
#pragma unroll
      for (int m = 0; m < J; ++m) st[m] = sc[m];
#pragma unroll 1
      for (int t = 0; t < (half + 1) * HALF - 1; ++t) {
        if (t >= half * HALF) {
#pragma unroll
          for (int v = 0; v < NV; ++v) Vec<VW>::store(s_sb[t - half * HALF][v][tid], st + v * VW);
        }
        forward_step(st, t);
      }
#pragma unroll
      for (int v = 0; v < NV; ++v) Vec<VW>::store(s_sb[HALF - 1][v][tid], st + v * VW);
#pragma unroll 1
      for (int tt = HALF - 1; tt >= 0; --tt) {
        const int t = half * HALF + tt;
        const float4 y = s_rkw[t][row];  // r_i, k_i, w_i
        float sb[J];
#pragma unroll
        for (int v = 0; v < NV; ++v) Vec<VW>::load(s_sb[tt][v][tid], sb + v * VW);
        float a_r[2] = {0.f, 0.f}, a_k[2] = {0.f, 0.f}, a_w[2] = {0.f, 0.f};
#pragma unroll
        for (int m = 0; m < J; ++m) {
          const float2 x = s_vdo[t][q + L * m];  // v_j, dO_j
          a_r[m & 1] = fmaf(sb[m], x.y, a_r[m & 1]);
          a_k[m & 1] = fmaf(G[m], x.x, a_k[m & 1]);
          a_w[m & 1] = fmaf(G[m], sb[m], a_w[m & 1]);
          G[m] = fmaf(y.z, G[m], y.x * x.y);  // G_t from G_{t+1}
        }
        const float sr = group_sum<L>(a_r[0] + a_r[1]);
        const float sk = group_sum<L>(a_k[0] + a_k[1]);
        const float sw = group_sum<L>(a_w[0] + a_w[1]);
        const int tg = c * C + t;
        if (tg < S) {
          const float dot = s_dot[t];
          const int64_t o = (int64_t)tg * ss;
          if (q == 0) DR[o] = from_f32<T>(fmaf(ui * y.y, dot, sr));
          if (q == 1) DK[o] = from_f32<T>(fmaf(ui * y.x, dot, sk));
          if (q == 2) DW[o] = from_f32<T>(sw);
          du_acc = fmaf(y.x * y.y, dot, du_acc);
        }
      }
    }
    if (c > 0) {
      __syncthreads();
      store(true);
      __syncthreads();
#pragma unroll
      for (int m = 0; m < J; ++m) sc[m] = sc_next[m];
    }
  }
#pragma unroll
  for (int m = 0; m < J; ++m) p.ds0[st_off + L * m] = G[m];
  if (q == 0) p.du_part[(int64_t)bh * D + i] = du_acc;
}

template <typename T, int D>
__global__ void __launch_bounds__(KS * (D < CG ? D : CG)) wkv6_bwd_cols_kernel(const Params p) {
  constexpr int CGD = D < CG ? D : CG;  // columns a block
  constexpr int NCG = D / CGD;          // blocks a head
  constexpr int M = D / KS;             // rows a lane: i = q + KS * m
  constexpr int NT = KS * CGD;
  constexpr int NRK = C * D / NT;       // (t, i) entries a thread stages
  constexpr int ND = C * CGD / NT;      // (t, j) entries a thread stages
  __shared__ float4 s_rkw[C][D];   // (r_i, k_i, w_i, r_i u_i k_i), by step
  __shared__ float s_do[C][CGD];   // dO of the block's columns, by step
  __shared__ float s_c[C];         // sum_i r_i u_i k_i

  const int tid = threadIdx.x;
  const int cg = blockIdx.x % NCG;
  const int bh = blockIdx.x / NCG;
  const int h = bh % p.H, b = bh / p.H;
  const int jj = tid / KS, q = tid % KS;
  const int j = cg * CGD + jj;
  const int S = p.S;
  const int64_t ss = (int64_t)p.H * D;
  const int64_t base = (int64_t)b * S * ss + (int64_t)h * D;
  const T* R = static_cast<const T*>(p.r) + base;
  const T* K = static_cast<const T*>(p.k) + base;
  const T* W = static_cast<const T*>(p.w) + base;
  const T* DO = static_cast<const T*>(p.dout) + base + cg * CGD;
  T* DV = static_cast<T*>(p.dv) + base + j;
  const T zero = from_f32<T>(0.f), one = from_f32<T>(1.f);
  float uu[NRK];  // u of the rows this thread stages (the same at every step)
#pragma unroll
  for (int n = 0; n < NRK; ++n) uu[n] = p.u[h * D + (tid + n * NT) % D];

  // as in the row kernel: a chunk's inputs through registers, loaded while
  // the block computes the chunk before
  T pr[NRK], pk[NRK], pw[NRK], pd[ND];
  auto load = [&](int t0) {
#pragma unroll
    for (int n = 0; n < NRK; ++n) {
      const int e = tid + n * NT, tt = t0 + e / D;
      const int64_t o = (int64_t)tt * ss + e % D;
      pr[n] = tt < S ? R[o] : zero;
      pk[n] = tt < S ? K[o] : zero;
      pw[n] = tt < S ? W[o] : one;
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int e = tid + n * NT, tt = t0 + e / CGD;
      pd[n] = tt < S ? DO[(int64_t)tt * ss + e % CGD] : zero;
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int n = 0; n < NRK; ++n) {
      const int e = tid + n * NT;
      const float rr = to_f32(pr[n]), kk = to_f32(pk[n]);
      s_rkw[e / D][e % D] = make_float4(rr, kk, to_f32(pw[n]), rr * uu[n] * kk);
    }
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int e = tid + n * NT;
      s_do[e / CGD][e % CGD] = to_f32(pd[n]);
    }
    __syncthreads();
    const int warp = tid / 32, lane = tid % 32;  // sum_i r_t u k_t, one warp a step
    for (int t = warp; t < C; t += NT / 32) {
      float a = 0.f;
      for (int i = lane; i < D; i += 32) a += s_rkw[t][i].w;
      a = group_sum<32>(a);
      if (lane == 0) s_c[t] = a;
    }
  };

  float G[M];
#pragma unroll
  for (int m = 0; m < M; ++m)
    G[m] = p.ds != nullptr ? p.ds[(int64_t)bh * D * D + (int64_t)(q + KS * m) * D + j] : 0.f;
  load((p.NC - 1) * C);
  store();
  __syncthreads();
  for (int c = p.NC - 1; c >= 0; --c) {
    if (c > 0) load((c - 1) * C);  // in flight during this chunk
#pragma unroll 2
    for (int t = C - 1; t >= 0; --t) {
      const float dj = s_do[t][jj];
      float acc[2] = {0.f, 0.f};
#pragma unroll
      for (int m = 0; m < M; ++m) {
        const float4 y = s_rkw[t][q + KS * m];
        acc[m & 1] = fmaf(y.y, G[m], acc[m & 1]);
        G[m] = fmaf(y.z, G[m], y.x * dj);
      }
      const float sv = group_sum<KS>(acc[0] + acc[1]);
      const int tg = c * C + t;
      if (q == 0 && tg < S) DV[(int64_t)tg * ss] = from_f32<T>(fmaf(s_c[t], dj, sv));
    }
    if (c > 0) {
      __syncthreads();
      store();
      __syncthreads();
    }
  }
  // du over the batch, in order, from the row kernel's per-(b, h) sums
  if (b == 0 && cg == 0) {
    for (int e = tid; e < D; e += NT) {
      float a = 0.f;
      for (int bb = 0; bb < p.B; ++bb) a += p.du_part[((int64_t)bb * p.H + h) * D + e];
      p.du[h * D + e] = a;
    }
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  wkv6_bwd_rows_kernel<T, D><<<p.B * p.H * (D / RG), RG * L, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  constexpr int CGD = D < CG ? D : CG;
  wkv6_bwd_cols_kernel<T, D><<<p.B * p.H * (D / CGD), KS * CGD, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (r, k, v, w, dout and dr, dk, dv, dw,
// all contiguous (B, S, H, D)). u, state_in, ds_in, du, ds0 and the scratch
// (ckpt: B * H * ceil(S / 16) * D * D floats, du_part: B * H * D floats) are
// f32 and contiguous; state_in and ds_in may be null (zeros). Returns a
// cudaError_t (0 = success).
extern "C" int wkv6_bwd(const void* r, const void* k, const void* v, const void* w,
                        const float* u, const float* state_in, const void* dout,
                        const float* ds_in, void* dr, void* dk, void* dv, void* dw, float* du,
                        float* ds0, float* ckpt, float* du_part, int dtype, int B, int S, int H,
                        int D, void* stream) {
  if (B <= 0 || S <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  const Params p{r, k, v, w, dout, u, state_in, ds_in, dr, dk, dv, dw, du, ds0, ckpt, du_part,
                 B, S, H, (S + C - 1) / C};
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
