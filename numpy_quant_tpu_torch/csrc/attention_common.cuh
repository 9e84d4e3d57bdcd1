// Building blocks of the int8 attention kernels, shared by
// csrc/attention_hs.cu, csrc/attention_hs_blockq.cu and
// csrc/attention_plain.cu: int8 tensor-core products (mma.sync.m16n8k32,
// fragments loaded with ldmatrix), 4 x 4 byte transposes, asynchronous
// 16-byte copies into shared memory, the correctly rounded division from
// a reciprocal, and the parameters of the two head-split kernels.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

// Mirror of kernels/attention.py::_HSParams (csrc/attention_hs.cu and
// csrc/attention_hs_blockq.cu): ``sum_vec`` and ``sum_lanes`` give torch's
// row-sum order, ``sum_tile`` the plain version's q tile rows; ``skip``
// (masked key tiles) is the blockwise kernel's; ``warps``, ``passes`` and
// ``kv_both`` are the monolithic kernel's launch plan
// (kernels/attention.py::hs_plan).
struct HSParams {
  int B, nq, N, H, D, zq, zk, zv, zp_p, fast, static_shift, need_lo,
      need_hi, out_int8, has_res_zp, causal, window, skip, has_bias, sum_vec,
      sum_lanes, sum_tile, warps, passes, kv_both, head_total, head_base;
  float c_score, scaling, czq, base, sp, zp_pf, c_out, res_scale, res_zp,
      qmin, qmax, mask;
};

constexpr int kOnes = 0x01010101;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], const void* p) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0, %1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1])
               : "r"(smem_addr(p)));
}

// c += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums. Lane
// (g = lane / 4, t = lane % 4) holds a's rows g, g + 8 at bytes 4t.. and
// 16 + 4t.., b's column g at bytes 4t.. and 16 + 4t.., and c's rows g
// (c[0], c[1]) and g + 8 (c[2], c[3]) at columns 2t, 2t + 1.
__device__ __forceinline__ void mma_s8(int (&c)[4], const uint32_t (&a)[4],
                                       uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// y[b] byte a = x[a] byte b: a 4 x 4 byte block transposed
__device__ __forceinline__ void transpose4(const uint32_t (&x)[4],
                                           uint32_t (&y)[4]) {
  const uint32_t t0 = __byte_perm(x[0], x[1], 0x5140);
  const uint32_t t1 = __byte_perm(x[2], x[3], 0x5140);
  const uint32_t t2 = __byte_perm(x[0], x[1], 0x7362);
  const uint32_t t3 = __byte_perm(x[2], x[3], 0x7362);
  y[0] = __byte_perm(t0, t1, 0x5410);
  y[1] = __byte_perm(t0, t1, 0x7632);
  y[2] = __byte_perm(t2, t3, 0x5410);
  y[3] = __byte_perm(t2, t3, 0x7632);
}

// IEEE a / b rounded to nearest (what __fdiv_rn returns), from y = RN(1/b)
// (__frcp_rn, once per divisor): q0 = RN(a y) lies within 1.5 ulp of a/b;
// one residual step (r = a - b q, exact with an fma) makes it faithful,
// and a second one then gives the correctly rounded quotient (Markstein's
// theorem: y within half an ulp of 1/b, q within one ulp of a/b). It holds
// where a/b is a normal number. The kernels divide e in [0, 1] by a row
// sum in [1, N] and a probability in [0, 1] by sp; a quotient below the
// normal range becomes a quantized probability of exactly zp_p whatever
// its last bit, so the quantized probabilities are those of __fdiv_rn.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// The head-split kernels' softmax forms, a template parameter so that the
// code of each score carries no branch on them: the exact form (the JAX
// op order, expf), the fast form (exp2f after a max pass) and the fast
// form with the static score_max shift (exp2f of the clamped score).
constexpr int kExact = 0, kFast = 1, kShift = 2;

// The parts of a dequantized score that depend on the row alone (exact:
// the zk and zq*zk corrections, zq*zk*D - qs*zk in int32) or on the key
// alone (exact: ks*zq; fast: ks*czq + base, or base when zq is 0), so
// that a score is acc + rowc - kz or f32(acc)*c + colc.
template <int MODE, int D>
__device__ __forceinline__ int hs_row_term(const HSParams& p, int qs) {
  return MODE == kExact ? p.zq * p.zk * D - qs * p.zk : 0;
}

template <int MODE>
__device__ __forceinline__ void hs_key_terms(const HSParams& p, int ks,
                                             int& kz, float& colc) {
  kz = ks * p.zq;
  colc = MODE != kExact && p.zq
             ? __fadd_rn(__fmul_rn(__int2float_rn(ks), p.czq), p.base)
             : p.base;
}

// One dequantized (biased) score in the JAX op order: the integer dot
// `acc` of a query row with key `col`, its row and key terms, and the
// row's bias row `brow` (null past nq or N; BIAS compiled in or out). The
// exact form's int32 corrections equal the unfused executor's sequence
// (a - qs*zk - ks*zq + zq*zk*D) in wrapping arithmetic.
template <int MODE, bool BIAS>
__device__ __forceinline__ float hs_score(const HSParams& p, int acc,
                                          int rowc, int kz, float colc,
                                          int col,
                                          const float* __restrict__ brow) {
  float s;
  if (MODE == kExact)
    s = __fmul_rn(__fmul_rn(__int2float_rn(acc + rowc - kz), p.c_score),
                  p.scaling);
  else
    s = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.c_score), colc);
  // the score bias at the graph Add's position (pre-scaled by log2(e) on
  // the fast forms)
  if (BIAS && brow) s = __fadd_rn(s, __ldg(brow + col));
  return s;
}

// The decoder mask at the graph Add's position (pre-scaled by log2(e) on
// the fast forms): s + mask where key `col` is not visible from query row
// `row`. Callers apply it only to tiles hs_tile_masked says need it.
__device__ __forceinline__ float hs_mask(const HSParams& p, float s, int row,
                                         int col) {
  const bool visible = col <= row && (p.window <= 0 || col > row - p.window);
  const float masked = __fadd_rn(s, p.mask);
  return visible ? s : masked;
}

// Whether a causal call masks some key of keys [j0, j0 + keys) for some
// query row of [r0, r0 + rows): else its scores need no mask test.
__device__ __forceinline__ bool hs_tile_masked(const HSParams& p, int r0,
                                               int rows, int j0, int keys) {
  return p.causal && !(j0 + keys - 1 <= r0 &&
                       (p.window <= 0 || j0 > r0 + rows - 1 - p.window));
}

// (m, l) of a row merged with another lane's or key half's (fast form:
// l sums exp2(s - m))
__device__ __forceinline__ void hs_merge_online(float& m, float& l, float mo,
                                                float lo) {
  const float mn = fmaxf(m, mo);
  const float a = m == -INFINITY ? 0.f : __fmul_rn(l, exp2f(__fsub_rn(m, mn)));
  const float b =
      mo == -INFINITY ? 0.f : __fmul_rn(lo, exp2f(__fsub_rn(mo, mn)));
  m = mn;
  l = __fadd_rn(a, b);
}

// exp of a score in each form: expf(s - m), exp2f(s - m), or exp2f of the
// score clamped to [-120, 80] (the static shift; m unused)
template <int MODE>
__device__ __forceinline__ float hs_exp(float s, float m) {
  if (MODE == kExact) return expf(__fsub_rn(s, m));
  if (MODE == kFast) return exp2f(__fsub_rn(s, m));
  return exp2f(fminf(fmaxf(s, -120.f), 80.f));
}

// 16 bytes from global to shared memory without a register round trip;
// zeros when !valid (the source is then not read)
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :
               : "r"(smem_addr(dst)), "l"(src), "r"(valid ? 16 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}
