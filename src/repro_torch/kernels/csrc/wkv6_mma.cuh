// Building blocks shared by the chunked WKV-6 kernels on mma.sync
// (wkv6_chunked.cu, the forward; wkv6_bwd_chunked.cu, its VJP): cp.async
// copies, ldmatrix, the m16n8k16 bf16 product, two-term bf16 splits, and
// the CUDA-core pass that builds a chunk's A matrix from running products.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace wkv6_mma {

constexpr int L = 16;      // steps a chunk (the mma's k depth over steps)
constexpr int SP = L / 2;  // column pairs (s, L-1-s) of A

__device__ __forceinline__ uint32_t smem_u32(const void* ptr) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(ptr));
}

__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src, bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
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

__device__ __forceinline__ uint32_t pack(__nv_bfloat16 lo, __nv_bfloat16 hi) {
  return static_cast<uint32_t>(__bfloat16_as_ushort(lo)) |
         (static_cast<uint32_t>(__bfloat16_as_ushort(hi)) << 16);
}

// two-term split of (x, y) as packed bf16 pairs: hi = bf16(x), lo = bf16(x - hi)
__device__ __forceinline__ void split2(float x, float y, uint32_t& hi, uint32_t& lo) {
  const __nv_bfloat16 hx = __float2bfloat16_rn(x), hy = __float2bfloat16_rn(y);
  hi = pack(hx, hy);
  lo = pack(__float2bfloat16_rn(x - __bfloat162float(hx)),
            __float2bfloat16_rn(y - __bfloat162float(hy)));
}

__device__ __forceinline__ void split1(float x, __nv_bfloat16& hi, __nv_bfloat16& lo) {
  hi = __float2bfloat16_rn(x);
  lo = __float2bfloat16_rn(x - __bfloat162float(hi));
}

// Four consecutive bf16 (8 bytes) as f32.
__device__ __forceinline__ void load4(const __nv_bfloat16* p, float (&x)[4]) {
  const uint2 raw = *reinterpret_cast<const uint2*>(p);
  x[0] = __uint_as_float(raw.x << 16);
  x[1] = __uint_as_float(raw.x & 0xffff0000u);
  x[2] = __uint_as_float(raw.y << 16);
  x[3] = __uint_as_float(raw.y & 0xffff0000u);
}

// Reduce-scatter of val[0..CNT) over the lanes whose xor-distance is below
// 2M: at each step a lane keeps one half of its slots (the upper one if its
// bit M is set), adds the partner's values of the same slots, and base
// moves to the first slot it keeps. Every index is a compile-time constant,
// so val stays in registers.
template <int CNT, int M>
__device__ __forceinline__ void reduce_scatter(float (&val)[L], int ig, int& base) {
  if constexpr (M >= 1) {
    constexpr int HALF = CNT / 2;
    const bool up = (ig & M) != 0;
#pragma unroll
    for (int j = 0; j < HALF; ++j) {
      const float send = up ? val[j] : val[j + HALF];
      const float keep = up ? val[j + HALF] : val[j];
      val[j] = keep + __shfl_xor_sync(0xffffffffu, send, M);
    }
    if (up) base += HALF;
    reduce_scatter<HALF, M / 2>(val, ig, base);
  }
}

// A of one chunk, from its r, k, w ([t][i] bf16 rows of pitch DP in shared
// memory; rows past the sequence hold r = k = 0 and w = 1, so their A is 0)
// and u (f32, shared memory), as two-term bf16 splits into a_hi, a_lo
// ([t][s], pitch LP; the upper triangle is left as it is):
//
//   A[t][s] = sum_i r_t,i k_s,i prod_{s < tau < t} w_tau,i  (s < t)
//   A[t][t] = sum_i r_t,i u_i k_t,i
//
// Each decay is a running product, so w = 0 and w = 1 are exact. Thread pt
// (of 2D, with SP * D / 4 == 2D) takes columns s_a = sp and s_b = L-1-sp
// over keys 4ig..4ig+3 (16 values each, balanced), and a butterfly
// reduce-scatter over the D/4 lanes of a key group sums them over i. Slot
// j < L - sp is (t = s_a + j, s_a), slot 0 the diagonal; slot j >= L - sp
// is (t = s_b + 1 + j - (L - sp), s_b); s_b's diagonal is summed apart.
template <int D, int DP, int LP>
__device__ __forceinline__ void chunk_a(const __nv_bfloat16 (*r)[DP],
                                        const __nv_bfloat16 (*k)[DP],
                                        const __nv_bfloat16 (*w)[DP], const float* u,
                                        __nv_bfloat16 (*a_hi)[LP], __nv_bfloat16 (*a_lo)[LP],
                                        int pt) {
  constexpr int NG = D / 4;
  static_assert(2 * D == SP * NG, "one thread per (column pair, key group)");
  const int sp = pt / NG, ig = pt % NG, i0 = 4 * ig;
  const int s_a = sp, s_b = L - 1 - sp;
  float val[L];
  float q[4], x[4], wt[4], uu[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) uu[e] = u[i0 + e];
  load4(&k[s_a][i0], q);
  load4(&r[s_a][i0], x);
  val[0] = x[0] * uu[0] * q[0] + x[1] * uu[1] * q[1] + x[2] * uu[2] * q[2] + x[3] * uu[3] * q[3];
#pragma unroll
  for (int j = 1; j < L; ++j) {
    const bool second = j >= L - sp;
    if (j == L - sp) load4(&k[s_b][i0], q);
    const int t = second ? s_b + 1 + j - (L - sp) : s_a + j;
    load4(&r[t][i0], x);
    load4(&w[t][i0], wt);
    val[j] = x[0] * q[0] + x[1] * q[1] + x[2] * q[2] + x[3] * q[3];
#pragma unroll
    for (int e = 0; e < 4; ++e) q[e] *= wt[e];
  }
  load4(&k[s_b][i0], q);
  load4(&r[s_b][i0], x);
  float diag = x[0] * uu[0] * q[0] + x[1] * uu[1] * q[1] + x[2] * uu[2] * q[2] + x[3] * uu[3] * q[3];
  int base = 0;
  reduce_scatter<L, NG / 2>(val, ig, base);
#pragma unroll
  for (int m = NG / 2; m >= 1; m /= 2) diag += __shfl_xor_sync(0xffffffffu, diag, m);
#pragma unroll
  for (int j = 0; j < L / NG; ++j) {  // slots base .. base + L / NG - 1
    const int slot = base + j;
    const bool second = slot >= L - sp;
    const int s = second ? s_b : s_a;
    const int t = second ? s_b + 1 + slot - (L - sp) : s_a + slot;
    split1(val[j], a_hi[t][s], a_lo[t][s]);
  }
  if (ig == 0) split1(diag, a_hi[s_b][s_b], a_lo[s_b][s_b]);
}

}  // namespace wkv6_mma
