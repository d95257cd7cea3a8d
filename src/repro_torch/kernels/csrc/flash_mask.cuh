// The attention mask of the flash kernels (forward and backward), shared by
// flash_attention.cu and flash_attention_bwd.cu.
#pragma once

namespace {

// Class of a (q tile, kv tile) pair; mirrors kernels/flash_attention.py::
// tile_class line for line. q rows past Sq are ignored (their output is not
// written) and keys past Sk never attend; q row i sits at position
// q_offset + i (a context-parallel rank's rows). SKIP: no pair attends;
// FULL: every pair attends and every key is real, so no mask is needed;
// PARTIAL: some do.
constexpr int SKIP = 0, FULL = 1, PARTIAL = 2;
constexpr int BIG = 1 << 30;

__host__ __device__ inline int tile_class(int q_start, int block_q, int k_start, int block_k,
                                          int Sq, int Sk, int causal, int window, int chunk,
                                          int q_offset) {
  const int qa = q_offset + q_start, qb = q_offset + min(q_start + block_q, Sq) - 1;
  const int ka = k_start, kb = min(k_start + block_k, Sk) - 1;
  if (qa > qb || ka > kb) return SKIP;
  const int d_lo = causal ? 0 : -BIG;  // q - k must lie in [d_lo, d_hi]
  const int d_hi = window > 0 ? window - 1 : BIG;
  // some pair attends: within one chunk that both ranges touch, the
  // differences q - k cover [a - hi, b - lo] and must meet [d_lo, d_hi]
  const int c_first = chunk > 0 ? max(qa, ka) / chunk : 0;
  const int c_last = chunk > 0 ? min(qb, kb) / chunk : 0;
  bool any = false;
  for (int c = c_first; c <= c_last && !any; ++c) {
    const int a = chunk > 0 ? max(qa, c * chunk) : qa;
    const int b = chunk > 0 ? min(qb, c * chunk + chunk - 1) : qb;
    const int lo = chunk > 0 ? max(ka, c * chunk) : ka;
    const int hi = chunk > 0 ? min(kb, c * chunk + chunk - 1) : kb;
    any = max(a - hi, d_lo) <= min(b - lo, d_hi);
  }
  if (!any) return SKIP;
  const bool all = k_start + block_k <= Sk && qa - kb >= d_lo && qb - ka <= d_hi &&
                   (chunk <= 0 || (qa / chunk == qb / chunk && ka / chunk == kb / chunk &&
                                   qa / chunk == ka / chunk));
  return all ? FULL : PARTIAL;
}

// Does query row qi (at position q_off + qi) attend key kj? P is any
// parameter block with Sk, causal, window, chunk and q_off.
template <class P>
__device__ __forceinline__ bool attends(int qi, int kj, const P& p) {
  const int qp = qi + p.q_off;
  bool keep = kj < p.Sk;
  if (p.causal) keep = keep && (qp >= kj);
  if (p.window > 0) keep = keep && (qp - kj < p.window);
  if (p.chunk > 0) keep = keep && (qp / p.chunk == kj / p.chunk);
  return keep;
}

}  // namespace
