// RWKV-6 (Finch) WKV recurrence for Hopper (sm_90a), bf16 inputs, as a
// chunked scan on the tensor cores; plain C interface for ctypes.
//
// Replaces repro/kernels/rwkv6_scan.py::_kernel (the Pallas TPU kernel
// behind repro.kernels.ops.wkv6) for bf16 r, k, v, w; f32 inputs keep the
// CUDA-core kernel in wkv6.cu (true f32 products for the 5e-5 checks). The
// wrapper (kernels/wkv6.py::design) picks one by dtype. It computes what
// ref.wkv6_ref computes, with the f32 D x D state S[key i][value j]:
//
//   out_t[j] = sum_i r_t[i] * (S[i][j] + u[i] * k_t[i] * v_t[j])
//   S[i][j] <- w_t[i] * S[i][j] + k_t[i] * v_t[j]
//
// from state_in (zero when the pointer is null), writing the final state as
// f32 (state_out may equal state_in: each thread reads its own elements
// before the time loop and writes the same ones after it) and the output in
// bf16.
//
// Chunked form. For one (b, h) and a chunk [b0, e) of L = 16 steps, with S
// the state at b0:
//
//   pre_t  = prod_{tau=b0}^{t-1} w_tau        rt_t = r_t * pre_t   (<= 1)
//   suf_s  = prod_{tau=s+1}^{e-1} w_tau       kt_s = k_s * suf_s   (<= 1)
//   A[t,s] = sum_i r_t,i k_s,i prod_{tau=s+1}^{t-1} w_tau,i  (s < t)
//   A[t,t] = sum_i r_t,i u_i k_t,i
//   out_t  = rt_t . S + sum_{s<=t} A[t,s] v_s
//   S     <- diag(pre_e) S + kt^T v
//
// Every decay is a product of w's over a range inside the chunk, built by
// running products (no log, exp or division), so each factor is <= 1, w = 0
// and w = 1 come out exactly as in the sequential product, and nothing
// overflows. Rows past S are zero-filled (r, k, v = 0) and their w is taken
// as 1, so a ragged last chunk (and S = 1, a decode step) is exact.
//
// Products on the tensor cores: mma.sync m16n8k16 bf16 with f32
// accumulation. The state is kept transposed, S^T[j][i], in accumulator
// registers for the whole sequence (warp w owns rows j = 16w..16w+15), so
// that S^T += v^T kt produces it in the layout that out^T = S^T rt^T takes
// as its A operand. bf16 keeps 8 bits, too few for the slow channels (w
// rounds to 0.99609 or 1.0, the state sums nearly all steps), so every
// operand that is not a bf16 input enters as a two-term split, hi =
// bf16(x), lo = bf16(x - hi): S rt^T takes three products (hi hi, hi lo, lo
// hi), v^T A^T and v^T kt two each (v is a bf16 input). A single bf16 or
// TF32 rounding of those operands fails the bf16 tolerance at the main
// path's values; kernels/wkv6.py::wkv6_chunked mirrors this arithmetic on
// the CPU and tests/test_torch_wkv6_chunked.py holds it there.
//
// Two roles of 2D threads (D / 16 warps each), handing chunks over through
// double buffers guarded by mbarriers (a wait that spins for seconds traps
// instead of hanging the card):
//   prep (CUDA cores, f32): issues the cp.async loads of a ring of NSTAGE
//     chunks (16 bytes a copy, read through the strides, which must be
//     16-byte multiples; AHEAD chunks ahead), then for chunk c: thread i < D
//     runs the prefix products of key i (rt, pre_e), thread D + i the
//     suffix products (kt), each from its column preloaded into registers;
//     then thread (sp, ig) runs the running products of A for columns s =
//     sp and L-1-sp over keys 4ig..4ig+3 (16 values each, balanced), and a
//     butterfly reduce-scatter over the D/4 lanes of a key group sums them
//     over i. Every split is stored as hi and lo bf16 in shared memory.
//   tensor cores: own the state and, for chunk c - 1 while prep runs chunk
//     c, run out^T = S^T rt^T + v^T A^T (ldmatrix operands, the state's
//     hi / lo split from its accumulators), then S^T = pre_e S^T + v^T kt,
//     and write the output through shared memory in 16-byte stores.
//
// What bounds it on an H100. At rwkv6-7b prefill (B 4, S 2048, H 64, D 64)
// the function must move ~344 MB (five (B, S, H, D) bf16 tensors and the
// f32 state read and written), ~0.103 ms at 3.35 TB/s; it is bound by bytes.
// This kernel is not: one block per (b, h) (256 blocks of 256 threads, two
// an SM) walks its 128 chunks in order, and the time is that chain. Of the
// two roles the prep role is the longer (its CUDA-core pass is ~670
// instructions a thread a chunk), and the two share the SM's issue slots.
// ptxas: 119 / 100 / 102 registers at D 64 / 32 / 16, no spill, no stack.
// Its times are in PERF.md.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include "wkv6_mma.cuh"

namespace {

using namespace wkv6_mma;

constexpr int NSTAGE = 4;   // chunks of r, k, v, w in the cp.async ring
constexpr int AHEAD = NSTAGE - 2;  // chunks loaded ahead: two stages are in use

struct Params {
  const __nv_bfloat16* r;
  const __nv_bfloat16* k;
  const __nv_bfloat16* v;
  const __nv_bfloat16* w;
  const float* u;         // (H, D) f32, contiguous
  const float* state_in;  // (B, H, D, D) f32, contiguous, or null
  __nv_bfloat16* o;       // (B, S, H, D) contiguous
  float* state_out;       // (B, H, D, D) f32, contiguous; may equal state_in
  int B, S, H;
  int64_t r_sb, r_ss, r_sh;
  int64_t k_sb, k_ss, k_sh;
  int64_t v_sb, v_ss, v_sh;
  int64_t w_sb, w_ss, w_sh;
};

// mbarrier helpers. A wait that spins for seconds traps, so a lost phase
// faults instead of holding the card.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}
__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint32_t bar, int parity) {
  uint32_t done = 0;
  for (uint32_t spins = 0; !done; ++spins) {
    asm volatile(
        "{\n.reg .pred p;\nmbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (spins > (1u << 26)) __trap();
  }
}
// named barrier over one role's warps (id 0 is __syncthreads)
__device__ __forceinline__ void role_sync(int id, int threads) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(threads) : "memory");
}

template <int D>
struct Smem {
  static constexpr int DP = D + 8;  // row pitch (bf16): 16-byte rows, conflict-free ldmatrix
  static constexpr int LP = L + 8;
  __nv_bfloat16 in[NSTAGE][4][L][DP];  // r, k, v, w of a chunk
  __nv_bfloat16 rt[2][2][L][DP];       // [buffer] rt = r * pre as hi, lo  [t][i]
  __nv_bfloat16 kt[2][2][L][DP];       // [buffer] kt = k * suf as hi, lo  [s][i]
  __nv_bfloat16 a[2][2][L][LP];        // [buffer] A as hi, lo              [t][s]
  __nv_bfloat16 out[2][L][DP];         // [buffer] the chunk's output       [t][j]
  float pre_e[2][D];                   // [buffer] prod of the chunk's w
  float u[D];
  uint64_t ready[2], freed[2];         // prep -> tensor cores, and back, per buffer
};

// The prep role (CUDA cores) for one chunk, into buffer `buf`: thread pt <
// D runs the prefix products of key pt (rt, pre_e), thread D + i the suffix
// products of key i (kt); then every thread runs its share of A.
template <int D>
__device__ __forceinline__ void prep_chunk(Smem<D>& sm, int stage, int buf, int n, int pt) {
  const __nv_bfloat16(*r)[Smem<D>::DP] = sm.in[stage][0];
  const __nv_bfloat16(*k)[Smem<D>::DP] = sm.in[stage][1];
  const __nv_bfloat16(*w)[Smem<D>::DP] = sm.in[stage][3];
  {
    // the key's column of r (or k) and w into registers first, so that no
    // load waits behind the stores of the product chain
    const int i = pt % D;
    const __nv_bfloat16(*x)[Smem<D>::DP] = pt < D ? r : k;
    float xv[L], wv[L];
#pragma unroll
    for (int t = 0; t < L; ++t) {
      xv[t] = __bfloat162float(x[t][i]);
      wv[t] = t < n ? __bfloat162float(w[t][i]) : 1.f;
    }
    float prod = 1.f;
    if (pt < D) {
#pragma unroll
      for (int t = 0; t < L; ++t) {
        split1(xv[t] * prod, sm.rt[buf][0][t][i], sm.rt[buf][1][t][i]);
        prod *= wv[t];
      }
      sm.pre_e[buf][i] = prod;
    } else {
#pragma unroll
      for (int s = L - 1; s >= 0; --s) {
        split1(xv[s] * prod, sm.kt[buf][0][s][i], sm.kt[buf][1][s][i]);
        prod *= wv[s];
      }
    }
  }
  chunk_a<D, Smem<D>::DP, Smem<D>::LP>(r, k, w, sm.u, sm.a[buf][0], sm.a[buf][1], pt);
}

// The tensor-core role for one chunk (warp w owns state rows j0 = 16w..):
// out^T = S^T rt^T + v^T A^T into sm.out[buf], then S^T = pre_e S^T + v^T kt.
template <int D>
__device__ __forceinline__ void mma_chunk(Smem<D>& sm, float (&st)[D / 8][4], int stage, int buf,
                                          int lane, int j0) {
  constexpr int NI = D / 8, KI = D / 16;
  const int g = lane >> 2, c = lane & 3, lr = lane & 7, lq = lane >> 3;
  const __nv_bfloat16(*v)[Smem<D>::DP] = sm.in[stage][2];
  float o[3][2][4] = {};  // S_hi rt_hi | the two cross terms | v^T A^T, summed at the end
#pragma unroll
  for (int kk = 0; kk < KI; ++kk) {
    uint32_t ah[4], al[4];
    split2(st[2 * kk][0], st[2 * kk][1], ah[0], al[0]);
    split2(st[2 * kk][2], st[2 * kk][3], ah[1], al[1]);
    split2(st[2 * kk + 1][0], st[2 * kk + 1][1], ah[2], al[2]);
    split2(st[2 * kk + 1][2], st[2 * kk + 1][3], ah[3], al[3]);
    uint32_t bh[4], bl[4];  // b0, b1 of t-tile 0, then of t-tile 1
    const int row = (lq >> 1) * 8 + lr, col = kk * 16 + (lq & 1) * 8;
    ldsm_x4(bh, smem_u32(&sm.rt[buf][0][row][col]));
    ldsm_x4(bl, smem_u32(&sm.rt[buf][1][row][col]));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma(o[0][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
      mma(o[1][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
      mma(o[1][nt], al, bh[2 * nt], bh[2 * nt + 1]);
    }
  }
  uint32_t vt[4];  // v^T as the A operand: rows j0.., k = s
  {
    const int row = (lq >> 1) * 8 + lr;
    ldsm_x4_t(vt, smem_u32(&v[row][j0 + (lq & 1) * 8]));
    uint32_t bh[4], bl[4];
    ldsm_x4(bh, smem_u32(&sm.a[buf][0][row][(lq & 1) * 8]));
    ldsm_x4(bl, smem_u32(&sm.a[buf][1][row][(lq & 1) * 8]));
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      mma(o[2][nt], vt, bh[2 * nt], bh[2 * nt + 1]);
      mma(o[2][nt], vt, bl[2 * nt], bl[2 * nt + 1]);
    }
  }
#pragma unroll
  for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int t = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
      sm.out[buf][t][j] = __float2bfloat16_rn(o[0][nt][e] + o[1][nt][e] + o[2][nt][e]);
    }
  }
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
    uint32_t bh[4], bl[4];               // b0, b1 of i-tile 2np, then of 2np + 1
    const int row = (lq & 1) * 8 + lr, col = np * 16 + (lq >> 1) * 8;
    ldsm_x4_t(bh, smem_u32(&sm.kt[buf][0][row][col]));
    ldsm_x4_t(bl, smem_u32(&sm.kt[buf][1][row][col]));
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      mma(st[2 * np + e], vt, bh[2 * e], bh[2 * e + 1]);
      mma(st[2 * np + e], vt, bl[2 * e], bl[2 * e + 1]);
    }
  }
}

// Two roles of 2D threads each. The prep warps issue the loads and run the
// CUDA-core pass of chunk c into buffer c % 2 while the tensor-core warps
// run chunk c - 1 from the other buffer; `ready[b]` hands a buffer (and the
// chunk's stage) over, `freed[b]` hands it back. The tensor-core warps own
// the state and write the output.
template <int D>
__global__ void __launch_bounds__(4 * D, 2) wkv6_chunked_kernel(const Params p) {
  constexpr int NR = 2 * D;      // threads a role: D / 16 warps
  constexpr int NI = D / 8;      // n-tiles of i in the state
  constexpr int PIECES = D / 8;  // 16-byte pieces in a row
  static_assert(NR == SP * (D / 4), "one prep thread per (column pair, key group)");
  static_assert(L * PIECES == NR, "one 16-byte piece of a chunk's row a thread");
  extern __shared__ __align__(16) unsigned char smem_raw[];
  Smem<D>& sm = *reinterpret_cast<Smem<D>*>(smem_raw);

  const int tid = threadIdx.x;
  const int h = blockIdx.x % p.H, b = blockIdx.x / p.H;
  const int S = p.S;
  const int n_chunks = (S + L - 1) / L;
  const int64_t st_base = ((int64_t)b * p.H + h) * D * D;

  if (tid == 0) {
    for (int x = 0; x < 2; ++x) {
      mbar_init(smem_u32(&sm.ready[x]), NR);
      mbar_init(smem_u32(&sm.freed[x]), NR);
    }
  }
  for (int i = tid; i < D; i += 4 * D) sm.u[i] = p.u[h * D + i];
  for (int i = tid; i < 2 * 2 * L * Smem<D>::LP; i += 4 * D)
    (&sm.a[0][0][0][0])[i] = __float2bfloat16_rn(0.f);  // A's upper triangle stays 0
  __syncthreads();

  if (tid >= NR) {
    // ---- prep role: loads and the CUDA-core pass
    const int pt = tid - NR;
    const int ld_row = pt / PIECES, ld_piece = pt % PIECES;
    auto load_chunk = [&](int ch) {  // one 16-byte piece of each of r, k, v, w
      if (ch < n_chunks) {
        const int stage = ch % NSTAGE;
        const int t = ch * L + ld_row;
        const bool valid = t < S;
        const int64_t tt = valid ? t : 0;
#pragma unroll
        for (int x = 0; x < 4; ++x) {
          const __nv_bfloat16* src =
              x == 0 ? p.r + b * p.r_sb + h * p.r_sh + tt * p.r_ss
              : x == 1 ? p.k + b * p.k_sb + h * p.k_sh + tt * p.k_ss
              : x == 2 ? p.v + b * p.v_sb + h * p.v_sh + tt * p.v_ss
                       : p.w + b * p.w_sb + h * p.w_sh + tt * p.w_ss;
          cp_async16(smem_u32(&sm.in[stage][x][ld_row][ld_piece * 8]), src + ld_piece * 8,
                     valid);
        }
      }
      cp_async_commit();  // an empty group past the end keeps the wait counts uniform
    };
    for (int ch = 0; ch < AHEAD; ++ch) load_chunk(ch);
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      // chunk ch - 2 is done with this buffer and with stage (ch + AHEAD) % NSTAGE
      if (ch >= 2) mbar_wait(smem_u32(&sm.freed[buf]), ((ch - 2) >> 1) & 1);
      load_chunk(ch + AHEAD);
      cp_async_wait<AHEAD>();
      role_sync(1, NR);  // every prep thread's pieces of chunk ch have landed
      prep_chunk<D>(sm, ch % NSTAGE, buf, min(L, S - ch * L), pt);
      mbar_arrive(smem_u32(&sm.ready[buf]));
    }
  } else {
    // ---- tensor-core role: the state, the products and the output
    const int lane = tid & 31, g = lane >> 2, c = lane & 3, j0 = (tid >> 5) * 16;
    // S^T[j][i] in accumulator layout: st[nt][0..1] = (j0 + g, 8nt + 2c + {0, 1}),
    // st[nt][2..3] = (j0 + g + 8, same i).
    float st[NI][4];
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
        st[nt][e] = p.state_in != nullptr ? p.state_in[st_base + (int64_t)i * D + j] : 0.f;
      }
    }
    const int row = tid / PIECES, piece = tid % PIECES;
    for (int ch = 0; ch < n_chunks; ++ch) {
      const int buf = ch & 1;
      mbar_wait(smem_u32(&sm.ready[buf]), (ch >> 1) & 1);
      mma_chunk<D>(sm, st, ch % NSTAGE, buf, lane, j0);
      if (ch + 2 < n_chunks) mbar_arrive(smem_u32(&sm.freed[buf]));  // only awaited ones
      role_sync(2, NR);  // sm.out[buf] is complete
      if (row < min(L, S - ch * L)) {
        const int64_t t = (int64_t)ch * L + row;
        *reinterpret_cast<uint4*>(p.o + ((b * (int64_t)S + t) * p.H + h) * D + piece * 8) =
            *reinterpret_cast<const uint4*>(&sm.out[buf][row][piece * 8]);
      }
    }
#pragma unroll
    for (int nt = 0; nt < NI; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = nt * 8 + 2 * c + (e & 1), j = j0 + g + (e >> 1) * 8;
        p.state_out[st_base + (int64_t)i * D + j] = st[nt][e];
      }
    }
  }
}

template <int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  constexpr int smem = (int)sizeof(Smem<D>);
  static uint64_t attribute_set = 0;  // one bit per device, set once a process
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 64 || !(attribute_set >> dev & 1)) {
    err = cudaFuncSetAttribute(wkv6_chunked_kernel<D>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return err;
    if (dev < 64) attribute_set |= uint64_t{1} << dev;
  }
  wkv6_chunked_kernel<D><<<p.B * p.H, 4 * D, smem, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

// bf16 r, k, v, w (B, S, H, D), read through their strides (in elements;
// the last dim contiguous, every stride and the start 16-byte aligned); u
// and both states f32 and contiguous; the output contiguous (B, S, H, D)
// bf16. Same arguments as wkv6_fwd; dtype must be 1 (bf16). Returns a
// cudaError_t (0 = success).
extern "C" int wkv6_chunked_fwd(const void* r, const void* k, const void* v, const void* w,
                                const float* u, const float* state_in, void* o,
                                float* state_out, int dtype, int B, int S, int H, int D,
                                int64_t r_sb, int64_t r_ss, int64_t r_sh,
                                int64_t k_sb, int64_t k_ss, int64_t k_sh,
                                int64_t v_sb, int64_t v_ss, int64_t v_sh,
                                int64_t w_sb, int64_t w_ss, int64_t w_sh,
                                void* stream) {
  if (B <= 0 || S <= 0 || H <= 0 || state_out == nullptr || dtype != 1)
    return (int)cudaErrorInvalidValue;
  const Params p{static_cast<const __nv_bfloat16*>(r), static_cast<const __nv_bfloat16*>(k),
                 static_cast<const __nv_bfloat16*>(v), static_cast<const __nv_bfloat16*>(w),
                 u, state_in, static_cast<__nv_bfloat16*>(o), state_out, B, S, H,
                 r_sb, r_ss, r_sh, k_sb, k_ss, k_sh, v_sb, v_ss, v_sh, w_sb, w_ss, w_sh};
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16) return (int)launch<16>(p, s);
  if (D == 32) return (int)launch<32>(p, s);
  if (D == 64) return (int)launch<64>(p, s);
  return (int)cudaErrorInvalidValue;
}
