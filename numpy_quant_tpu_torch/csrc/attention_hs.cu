// Fused int8 attention over head-interleaved [B, N, H*D] Q/K/V, for
// Hopper (sm_90a).
//
// Replaces the TPU kernel numpy_quant_tpu/kernels/attention.py::
// fused_attention_hs (its monolithic grid: exact and fast variants,
// out_requant on/off, narrow q, the decoder causal mask and its
// sliding-window band, and the per-head score-bias operand). Per (batch
// row, head):
//   scores = q @ k^T (int32, zero-point corrected) -> dequant * scaling
//   [+ bias] -> softmax (f32) -> probs quantized to int8 -> probs @ v
//   (int32, zero-point corrected) -> f32 out, or int8 out (out_requant).
//
// Bound at ViT-Base (B=96, N=197, H=12, D=64) on an H100 SXM: the kernel
// is memory-bound. With out_requant it must move 3*96*197*768 B in plus
// 96*197*768 B out = 58.1 MB, 17 us at 3.35 TB/s; with f32 output
// 101.7 MB, 30 us. Its int8 work, 4*B*H*N^2*D = 1.14e10 ops, takes
// 5.8 us at 1,979 TOPS. At T5-small's decoder self-attention (B=8,
// N=128, H=8, D=64, bias [8, 128, 128] f32, int8 out) it moves 3 x 0.5 MB
// in, the 0.5 MB bias and 0.5 MB out, 2.6 MB, 0.8 us; its cross-attention
// (128 query rows against N=512 keys, f32 out) moves 4.7 MB, 1.4 us.
//
// Design: a CTA of `warps` warps (kernels/attention.py::hs_plan) per
// (batch row, head) and range of query rows. It stages its head's K
// ([key][d], 16-byte cp.async copies) and V (transposed to [d][key] with
// byte permutes), keys zero-padded to a multiple of 32, in shared memory,
// with each key's score term (from its sum over D) and each dim's sum
// over the keys, so K/V are read from device memory once per CTA, and by
// the plan once per (batch row, head) where the card stays full. A row
// group of 16 query rows (one mma row tile; rows past nq are zero and
// never stored) belongs to a warp pair on the exact form and to one warp
// on the fast forms, which works through its row groups with no
// block-wide barrier. The integer scores run on the tensor cores
// (mma.sync.m16n8k32, s8 x s8 -> s32; K fragments by ldmatrix from rows
// padded by 16 bytes, conflict-free; q fragments straight from device
// memory, a row group ahead) and are dequantized, biased and masked in
// the JAX op order.
//   Exact form: 1. the scores of the 16 rows against every key into the
//   group's f32 row buffer in shared memory, with each row's max; 2.
//   exp(s - m) in place, and each row's sum; 3. the quantized
//   probabilities into an int8 row buffer. The scores are computed once.
//   The pair splits the keys by 32-key chunk and the rows' sums (8 each),
//   meeting at a named barrier between steps: the row buffers (15 KB per
//   group at ViT's N = 197) cap the groups an SM holds, so each is
//   worked by two warps.
//   Fast forms: A. the row sums (and maxima) straight from the scores;
//   B. the scores again, the quantized probabilities. With K resident a
//   second score pass costs a few mma, and without row buffers an SM
//   holds a warp per group, as many as its registers allow.
//   Both: P.V on the tensor cores against V^T (a pair splits the dims).
// Where K and V do not both fit (long N at D = 128), the plan sets
// kv_both = 0: K is staged for the scores and V then takes its place for
// P.V, the warps meeting at a barrier in between. What bounds the kernel
// is the softmax's float work per score and the latency of each group's
// chain of steps.
//
// The context is centred over the real keys: sum_j (pq_j - zp_p)(v_j -
// zv) = sum pq v - zv sum pq - zp_p sum v + zp_p zv N in int32, the pad
// keys adding nothing (pq = 0 and v = 0 there); it equals the TPU
// kernel's padded algebra. D = 16 pads to the mma's 32 bytes with zeros;
// the zq*zk*D term counts the real D.
//
// The score bias ([H, nq, N] f32, the same for every batch row; template
// flag BIAS, so the bias-free forms carry no code for it) is read from
// global memory at the graph Add's position.
//
// Numerics: the integer products are exact; every float step keeps the
// JAX op order -- int32 corrections; s = f32(scores)*(sq*sk), then
// *scaling; + bias[h, i, j]; + mask where key j is not visible from row i
// (j > i, or j <= i - window); max; expf(s-m); e/sum; rint(clip(p/sp +
// zp_p)) -- with _rn intrinsics (no FMA contraction), IEEE division
// (div_rn from the divisor's reciprocal, or __fdiv_rn), half-to-even
// rounding, and expf/exp2f (never __expf). The exact row sum adds the
// row's exp values from the row buffer in the order of torch's CUDA sum
// (torch_order_warp_sum, the row's alignment from its flat index in the
// unfused [B, H, nq, N] tensor), so where torch reduces the row in one
// warp the kernel equals the unfused executor bit for bit. The fast
// variant folds log2(e) into the dequant constant (and into the bias, on
// the host) and uses exp2f, an optional static score_max shift (clamped
// to [-120, 80], no max pass), drops the zk row term, r = 1/(sum*sp), and
// clips only the bounds the host says can be crossed; its row sum adds
// each lane's keys, then the 4 lanes of the row.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "torch_order.cuh"

namespace {

constexpr int kMaxWarps = 8;
constexpr int kXBytes = 6 * 16 * 4;  // a group's exchange: m, l, ps x 2 warps

// warps per row group: a pair on the exact form (its row buffer caps the
// groups an SM holds, so two warps share each), one on the fast forms
template <int MODE>
constexpr int kGroupWarps = MODE == kExact ? 2 : 1;

__host__ __device__ inline int round_up(int x, int m) {
  return (x + m - 1) / m * m;
}

// The shared memory carve-up (bytes; mirrored by kernels/attention.py::
// hs_smem_bytes): K [Np][DP + 16] int8 and V^T [D][Np + 16] int8 (side by
// side, or one region both take in turns); per row group, on the exact
// form an f32 row buffer [16][Np + 8] (rows 8 banks apart: the float2
// accesses of a quarter warp hit 32 banks), then a probability buffer
// [16][Np + 16] int8 and the group's exchange (row maxima, sums and pq
// sums of each warp); the keys' score terms [Np] (hs_key_terms); the v
// sums [D].
struct Layout {
  int np, kp, vp, ep, pp;
  size_t k, v, e, pq, x, kterm, vsum, total;
  __host__ __device__ Layout(int n, int d, int warps, bool both, bool exact) {
    np = round_up(n, 32);
    kp = (d < 32 ? 32 : d) + 16;
    vp = pp = np + 16;
    ep = np + 8;
    const int groups =
        warps / (exact ? kGroupWarps<kExact> : kGroupWarps<kFast>);
    const size_t kbytes = (size_t)np * kp, vbytes = (size_t)d * vp;
    k = 0;
    v = both ? kbytes : 0;
    const size_t kv =
        both ? kbytes + vbytes : (kbytes > vbytes ? kbytes : vbytes);
    e = (kv + 15) / 16 * 16;
    pq = e + (exact ? (size_t)groups * 16 * ep * 4 : 0);
    x = pq + (size_t)groups * 16 * pp;
    kterm = x + (size_t)groups * kXBytes;
    vsum = kterm + 4 * (size_t)np;
    total = vsum + 4 * (size_t)d;
  }
};

// a row group's barrier: its warp pair's (named barrier 1 + group; 0 is
// __syncthreads), or its one warp's
template <int WG>
__device__ __forceinline__ void group_sync(int grp) {
  if (WG == 2)
    asm volatile("bar.sync %0, 64;\n" ::"r"(1 + grp) : "memory");
  else
    __syncwarp();
}

// K [key][d] into shared memory (keys past N and dims past D zero)
template <int D>
__device__ __forceinline__ void stage_k(int8_t* k, const int8_t* xk,
                                        size_t base, int hd, int n,
                                        const Layout& L) {
  constexpr int C16 = (D < 32 ? 32 : D) / 16;
  for (int idx = threadIdx.x; idx < L.np * C16; idx += blockDim.x) {
    const int key = idx / C16, c = idx - key * C16;
    const bool valid = key < n && 16 * c < D;
    cp_async16(k + key * L.kp + 16 * c,
               xk + base + (valid ? (size_t)key * hd + 16 * c : 0), valid);
  }
  cp_async_commit();
}

// V transposed into [d][key] (keys past N zero): each item is 4 keys x 16
// dims, loaded as four 16-byte rows and stored as 16 words of 4 keys
template <int D>
__device__ __forceinline__ void stage_vt(int8_t* vt, const int8_t* xv,
                                         size_t base, int hd, int n,
                                         const Layout& L) {
  const int kbs = L.np / 4;
  for (int idx = threadIdx.x; idx < kbs * (D / 16); idx += blockDim.x) {
    const int kb = idx % kbs, c16 = idx / kbs;
    uint4 w[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      const int key = 4 * kb + a;
      w[a] = key < n ? __ldg(reinterpret_cast<const uint4*>(
                           xv + base + (size_t)key * hd + 16 * c16))
                     : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int blk = 0; blk < 4; ++blk) {
      const uint32_t x[4] = {(&w[0].x)[blk], (&w[1].x)[blk], (&w[2].x)[blk],
                             (&w[3].x)[blk]};
      uint32_t y[4];
      transpose4(x, y);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(
            vt + (16 * c16 + 4 * blk + c) * L.vp + 4 * kb) = y[c];
    }
  }
}

// each head dim's sum of V over the keys
template <int D>
__device__ __forceinline__ void sum_vt(int* vsum, const int8_t* vt,
                                       const Layout& L) {
  for (int d = threadIdx.x; d < D; d += blockDim.x) {
    const int* row = reinterpret_cast<const int*>(vt + d * L.vp);
    int s = 0;
    for (int w = 0; w < L.np / 4; ++w) s = __dp4a(row[w], kOnes, s);
    vsum[d] = s;
  }
}

// The q fragments of query rows r0.. of head h, batch row b, from device
// memory (zero past nq and past D)
template <int D, int KC = (D < 32 ? 32 : D) / 32>
__device__ __forceinline__ void load_q(uint32_t (&qa)[KC][4],
                                       const int8_t* __restrict__ xq,
                                       const HSParams& p, int b, int h,
                                       int r0) {
  const int tq = threadIdx.x & 3, g = (threadIdx.x & 31) >> 2;
#pragma unroll
  for (int kc = 0; kc < KC; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int row = r0 + g + 8 * (i & 1);
      const int byte = 32 * kc + 16 * (i >> 1) + 4 * tq;
      qa[kc][i] = row < p.nq && byte < D
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            xq + ((size_t)b * p.nq + row) * p.H * D +
                            (size_t)h * D + byte))
                      : 0u;
    }
}

// The warp's 16 x 16 integer scores against keys j0..j0 + 15 (mma's C
// layout: rows g, g + 8 and keys j0 + 8 nt + 2 t (+1) in acc[nt])
template <int DP>
__device__ __forceinline__ void dots16(const int8_t* s_k, int kp,
                                       const uint32_t (&qa)[DP / 32][4],
                                       int j0, int lane, int (&acc)[2][4]) {
  const int8_t* krow = s_k + (j0 + (lane & 7) + 8 * (lane >> 4)) * kp +
                       16 * ((lane >> 3) & 1);
#pragma unroll
  for (int nt = 0; nt < 2; ++nt)
    acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0;
#pragma unroll
  for (int kc = 0; kc < DP / 32; ++kc) {
    uint32_t bf[4];
    ldsm_x4(bf, krow + 32 * kc);
    mma_s8(acc[0], qa[kc], bf[0], bf[1]);
    mma_s8(acc[1], qa[kc], bf[2], bf[3]);
  }
}

// A row group's 16 query rows r0.. of head h, batch row b (warp kh of its
// WG warps), and the epilogue. A pair splits the keys by 32-key chunk
// (warp kh takes chunks kh, kh + 2, ...), then the head dims for P.V.
// `active` is false for a row group past nq (the warps still meet the
// block's barriers when K and V take turns).
//   exact: 1. scores -> the row buffer, with each row's max; 2. expf(s -
//   m) in place; the row sums in torch's order (warp kh sums rows 8 kh..
//   8 kh + 7); 3. the quantized probabilities from the row buffer.
//   fast: A. the row sums (and maxima) from the scores, nothing stored:
//   the clipped-exp2 sum of the static shift, or an online max and sum
//   per lane merged over the 4 lanes of a row; B. the
//   scores again (K is resident: the products are cheap), the quantized
//   probabilities.
//   Both: P.V on the tensor cores, warp kh for head dims D/WG kh...
template <int D, bool BIAS, int MODE>
__device__ __forceinline__ void row_group(
    const HSParams& p, const Layout& L, const int8_t* s_k, const int8_t* s_vt,
    float* e, int8_t* pbuf, float* xch, const int* kterm, int* vsum,
    const uint32_t (&qa)[(D < 32 ? 32 : D) / 32][4],
    const float* __restrict__ bias, void* __restrict__ out, int b, int h,
    int r0, int grp, bool both, bool active, int8_t* kv_region,
    const int8_t* __restrict__ xv, size_t kv_base) {
  constexpr int DP = D < 32 ? 32 : D;
  constexpr int WG = kGroupWarps<MODE>;
  constexpr int NTV = D / (8 * WG);  // context n-tiles per warp (D/WG dims)
  constexpr bool fast = MODE != kExact, shift = MODE == kShift;
  const int lane = threadIdx.x & 31, g = lane >> 2, tq = lane & 3;
  const int kh = WG == 2 ? (threadIdx.x >> 5) & 1 : 0;
  const int n = p.N, hd = p.H * D;
  const int rows[2] = {r0 + g, r0 + g + 8};
  float* xm = xch;                  // [2][16] the warps' row maxima
  float* xl = xch + 32;             // [2][16] their row sums
  int* xps = reinterpret_cast<int*>(xch + 64);  // [2][16] their pq sums

  int qs[2] = {0, 0};
#pragma unroll
  for (int kc = 0; kc < DP / 32; ++kc)
#pragma unroll
    for (int i = 0; i < 4; ++i)
      qs[i & 1] = __dp4a((int)qa[kc][i], kOnes, qs[i & 1]);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    qs[i] += __shfl_xor_sync(0xffffffffu, qs[i], 1);
    qs[i] += __shfl_xor_sync(0xffffffffu, qs[i], 2);
  }
  const int rowc[2] = {hs_row_term<MODE, D>(p, qs[0]),
                       hs_row_term<MODE, D>(p, qs[1])};
  const float* brow[2] = {nullptr, nullptr};
  if (BIAS)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < p.nq) brow[i] = bias + ((size_t)h * p.nq + rows[i]) * n;

  // the dequantized (biased, masked) scores of keys j0..j0 + 15: v[nt][2 i
  // + c] for row rows[i], key j0 + 8 nt + 2 tq + c
  auto scores16 = [&](int j0, float (&v)[2][4]) {
    int acc[2][4];
    dots16<DP>(s_k, L.kp, qa, j0, lane, acc);
#pragma unroll
    for (int nt = 0; nt < 2; ++nt) {
      const int col = j0 + 8 * nt + 2 * tq;
      const int2 kt = *reinterpret_cast<const int2*>(kterm + col);
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int kz = c ? kt.y : kt.x;
#pragma unroll
        for (int i = 0; i < 2; ++i)
          v[nt][2 * i + c] = hs_score<MODE, BIAS>(
              p, acc[nt][2 * i + c], rowc[i], kz, __int_as_float(kz),
              col + c, col + c < n ? brow[i] : nullptr);
      }
    }
    if (hs_tile_masked(p, r0, 16, j0, 16)) {
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          v[nt][j] = hs_mask(p, v[nt][j], rows[j >> 1],
                             j0 + 8 * nt + 2 * tq + (j & 1));
    }
  };

  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (active && !fast) {
    // 1: scores -> the row buffer, and each row's max over the warp's keys
    for (int c0 = 32 * kh; c0 < L.np; c0 += 32 * WG)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j0 = c0 + 16 * half;
        float v[2][4];
        scores16(j0, v);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const int col = j0 + 8 * nt + 2 * tq;
#pragma unroll
          for (int i = 0; i < 2; ++i) {
            if (col < n) m[i] = fmaxf(m[i], v[nt][2 * i]);
            if (col + 1 < n) m[i] = fmaxf(m[i], v[nt][2 * i + 1]);
            *reinterpret_cast<float2*>(&e[(g + 8 * i) * L.ep + col]) =
                make_float2(v[nt][2 * i], v[nt][2 * i + 1]);
          }
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 1));
      m[i] = fmaxf(m[i], __shfl_xor_sync(0xffffffffu, m[i], 2));
      if (tq == 0) xm[16 * kh + g + 8 * i] = m[i];
    }
    group_sync<WG>(grp);
#pragma unroll
    for (int i = 0; i < 2; ++i)
      m[i] = fmaxf(xm[g + 8 * i], xm[16 + g + 8 * i]);
    // 2: exp in place over the warp's keys
    for (int c0 = 32 * kh; c0 < L.np; c0 += 32 * WG)
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float2* at = reinterpret_cast<float2*>(
              &e[(g + 8 * i) * L.ep + c0 + 8 * j + 2 * tq]);
          float2 v = *at;
          v.x = hs_exp<MODE>(v.x, m[i]);
          v.y = hs_exp<MODE>(v.y, m[i]);
          *at = v;
        }
    group_sync<WG>(grp);
    // the row sums in torch's order: row r0 + i of the unfused [B, H, nq,
    // N] exp tensor, rows 16 / WG * kh.. by warp kh; a tensor-parallel
    // rank's heads sit at head_base.. of head_total in that tensor
    const size_t row0 =
        ((size_t)b * p.head_total + p.head_base + h) * p.nq + r0;
#pragma unroll 4
    for (int i = 16 / WG * kh; i < 16 / WG * (kh + 1); ++i) {
      if (r0 + i >= p.nq) break;
      const int sh = (int)(((row0 + i) * (size_t)n) & 3);
      const float sum = torch_order_warp_sum(e + i * L.ep, n, sh, p.sum_vec,
                                             p.sum_lanes, lane);
      if (lane == 0) xl[i] = sum;
    }
    group_sync<WG>(grp);
    l[0] = xl[g];
    l[1] = xl[g + 8];
  } else if (active) {
    // A: the row sums (and maxima) over the warp's keys, nothing stored
    for (int c0 = 32 * kh; c0 < L.np; c0 += 32 * WG)
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int j0 = c0 + 16 * half;
        float v[2][4];
        scores16(j0, v);
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          float x[4];
          bool valid[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            valid[j] = j0 + 8 * (j >> 1) + 2 * tq + (j & 1) < n;
            x[j] = valid[j] ? v[j >> 1][2 * i + (j & 1)] : -INFINITY;
          }
          if (shift) {
#pragma unroll
            for (int j = 0; j < 4; ++j)
              if (valid[j]) l[i] = __fadd_rn(l[i], hs_exp<MODE>(x[j], 0.f));
          } else {
            const float tm = fmaxf(fmaxf(x[0], x[1]), fmaxf(x[2], x[3]));
            if (tm > -INFINITY) {
              const float mn = fmaxf(m[i], tm);
              float add = 0.f;
#pragma unroll
              for (int j = 0; j < 4; ++j)
                add = __fadd_rn(add, hs_exp<MODE>(x[j], mn));
              l[i] = __fadd_rn(
                  m[i] == -INFINITY
                      ? 0.f
                      : __fmul_rn(l[i], exp2f(__fsub_rn(m[i], mn))),
                  add);
              m[i] = mn;
            }
          }
        }
      }
#pragma unroll
    for (int i = 0; i < 2; ++i) {
#pragma unroll
      for (int o = 1; o <= 2; o <<= 1) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
        const float lo = __shfl_xor_sync(0xffffffffu, l[i], o);
        if (shift)
          l[i] = __fadd_rn(l[i], lo);
        else
          hs_merge_online(m[i], l[i], mo, lo);
      }
      if (WG == 2 && tq == 0) {
        xm[16 * kh + g + 8 * i] = m[i];
        xl[16 * kh + g + 8 * i] = l[i];
      }
    }
    if (WG == 2) {
      group_sync<WG>(grp);
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int r = g + 8 * i;
        if (shift) {
          l[i] = __fadd_rn(xl[r], xl[16 + r]);
        } else {
          m[i] = xm[r];
          l[i] = xl[r];
          hs_merge_online(m[i], l[i], xm[16 + r], xl[16 + r]);
        }
      }
    }
  }

  // 3 / B: the quantized probabilities of the warp's keys (step B reads
  // K again, so where K and V take turns V is staged only after it)
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float rsp = __frcp_rn(p.sp);
  float rcp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rcp[i] = fast ? __fdiv_rn(1.f, __fmul_rn(l[i], p.sp)) : 0.f;
  int psum[2] = {0, 0};
  for (int c0 = 32 * kh; active && c0 < L.np; c0 += 32 * WG) {
    // the chunk's exp values: ev[nt][2 i + c], key c0 + 8 nt + 2 tq + c
    float ev[4][4];
    if (fast) {
      float v[2][4];
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        scores16(c0 + 16 * half, v);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt)
#pragma unroll
          for (int j = 0; j < 4; ++j)
            ev[2 * half + nt][j] = hs_exp<MODE>(v[nt][j], m[j >> 1]);
      }
    } else {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 v = *reinterpret_cast<const float2*>(
              &e[(g + 8 * i) * L.ep + c0 + 8 * nt + 2 * tq]);
          ev[nt][2 * i] = v.x;
          ev[nt][2 * i + 1] = v.y;
        }
    }
#pragma unroll
    for (int nt = 0; nt < 4; ++nt) {
      const int col = c0 + 8 * nt + 2 * tq;
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        int pq[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          const float x = ev[nt][2 * i + c];
          float t;
          if (!fast) {
            t = fminf(fmaxf(__fadd_rn(div_rn(div_rn(x, l[i], rl[i]), p.sp,
                                             rsp),
                                      p.zp_pf),
                            p.qmin),
                      p.qmax);
          } else {
            t = __fadd_rn(__fmul_rn(x, rcp[i]), p.zp_pf);
            if (p.need_lo) t = fmaxf(t, p.qmin);
            if (p.need_hi) t = fminf(t, p.qmax);
          }
          pq[c] = col + c < n ? __float2int_rn(t) : 0;  // keys past N: none
        }
        psum[i] += pq[0] + pq[1];
        *reinterpret_cast<uint16_t*>(&pbuf[(g + 8 * i) * L.pp + col]) =
            (uint16_t)((pq[0] & 0xff) | ((pq[1] & 0xff) << 8));
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    if (tq == 0) xps[16 * kh + g + 8 * i] = psum[i];
  }
  group_sync<WG>(grp);

  if (!both) {
    // V takes K's place, once every warp is done with K
    __syncthreads();
    stage_vt<D>(kv_region, xv, kv_base, hd, n, L);
    __syncthreads();
    sum_vt<D>(vsum, kv_region, L);
    __syncthreads();
  }
  if (!active) return;

  // P.V over every key for the warp's head dims D/WG kh..
  int ctx[NTV][4];
#pragma unroll
  for (int nt = 0; nt < NTV; ++nt)
    ctx[nt][0] = ctx[nt][1] = ctx[nt][2] = ctx[nt][3] = 0;
  const int d0 = kh * (D / WG);
  for (int c0 = 0; c0 < L.np; c0 += 32) {
    uint32_t pa[4];
    ldsm_x4(pa, pbuf + ((lane & 7) + 8 * ((lane >> 3) & 1)) * L.pp + c0 +
                    16 * (lane >> 4));
    const int vbyte = c0 + 16 * ((lane >> 3) & 1);
    if constexpr (NTV == 1) {
      uint32_t bf[2];
      ldsm_x2(bf, s_vt + (d0 + (lane & 7)) * L.vp + vbyte);
      mma_s8(ctx[0], pa, bf[0], bf[1]);
    } else {
#pragma unroll
      for (int np2 = 0; np2 < NTV / 2; ++np2) {
        uint32_t bf[4];
        ldsm_x4(bf, s_vt + (d0 + 16 * np2 + (lane & 7) + 8 * (lane >> 4)) *
                               L.vp + vbyte);
        mma_s8(ctx[2 * np2], pa, bf[0], bf[1]);
        mma_s8(ctx[2 * np2 + 1], pa, bf[2], bf[3]);
      }
    }
  }

  // epilogue: centred context, dequantize, optional requantize
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= p.nq) continue;
    const int ps = WG == 2 ? xps[g + 8 * i] + xps[16 + g + 8 * i] : psum[i];
    const size_t o_row = ((size_t)b * p.nq + row) * hd + (size_t)h * D;
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt) {
      const int d = d0 + 8 * nt + 2 * tq;
      float y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        int cx = ctx[nt][2 * i + c];
        if (p.zv) cx -= ps * p.zv;
        if (p.zp_p) cx -= vsum[d + c] * p.zp_p;
        if (p.zv && p.zp_p) cx += p.zp_p * p.zv * n;
        y[c] = __fmul_rn(__int2float_rn(cx), p.c_out);
      }
      if (p.out_int8) {
        int yq[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float z = fast ? y[c] : __fdiv_rn(y[c], p.res_scale);
          if (p.has_res_zp) z = __fadd_rn(z, p.res_zp);
          yq[c] = __float2int_rn(fminf(fmaxf(z, p.qmin), p.qmax));
        }
        *reinterpret_cast<uint16_t*>(static_cast<int8_t*>(out) + o_row + d) =
            (uint16_t)((yq[0] & 0xff) | ((yq[1] & 0xff) << 8));
      } else {
        *reinterpret_cast<float2*>(static_cast<float*>(out) + o_row + d) =
            make_float2(y[0], y[1]);
      }
    }
  }
}

template <int D, bool BIAS, int MODE>
__global__ void __launch_bounds__(kMaxWarps * 32, 2)
    attention_hs_kernel(const int8_t* __restrict__ xq,
                        const int8_t* __restrict__ xk,
                        const int8_t* __restrict__ xv,
                        const float* __restrict__ bias,
                        void* __restrict__ out, const HSParams p) {
  constexpr int DP = D < 32 ? 32 : D;
  extern __shared__ __align__(16) int8_t smem[];
  const bool both = p.kv_both != 0;
  const Layout L(p.N, D, p.warps, both, MODE == kExact);
  int8_t* s_k = smem + L.k;
  int8_t* s_vt = smem + L.v;
  int* kterm = reinterpret_cast<int*>(smem + L.kterm);
  int* vsum = reinterpret_cast<int*>(smem + L.vsum);
  constexpr int WG = kGroupWarps<MODE>;
  const int grp = threadIdx.x / (32 * WG), groups = p.warps / WG;
  float* e = reinterpret_cast<float*>(smem + L.e) + grp * 16 * L.ep;
  int8_t* pbuf = smem + L.pq + grp * 16 * L.pp;
  float* xch = reinterpret_cast<float*>(smem + L.x + grp * kXBytes);

  const int b = blockIdx.z, h = blockIdx.y, n = p.N, hd = p.H * D;
  const size_t kv_base = (size_t)b * n * hd + (size_t)h * D;

  stage_k<D>(s_k, xk, kv_base, hd, n, L);
  // each row group's q fragments are loaded one group ahead
  uint32_t qa[DP / 32][4], qn[DP / 32][4];
  const int rg0 = blockIdx.x * p.passes * groups + grp;
  load_q<D>(qa, xq, p, b, h, 16 * rg0);
  if (both) stage_vt<D>(s_vt, xv, kv_base, hd, n, L);
  cp_async_wait_all();
  __syncthreads();
  // each key's score term from its sum over D (exact: ks*zq; fast: the
  // f32 ks*czq + base, as its bits)
  for (int key = threadIdx.x; key < L.np; key += blockDim.x) {
    const int* row = reinterpret_cast<const int*>(s_k + key * L.kp);
    int s = 0;
#pragma unroll
    for (int w = 0; w < D / 4; ++w) s = __dp4a(row[w], kOnes, s);
    int kz;
    float colc;
    hs_key_terms<MODE>(p, s, kz, colc);
    kterm[key] = MODE == kExact ? kz : __float_as_int(colc);
  }
  if (both) sum_vt<D>(vsum, s_vt, L);
  __syncthreads();

  // K and V side by side: each group walks its row groups on its own; in
  // turns (one pass): every warp meets the barriers of the swap
  for (int pass = 0; pass < p.passes; ++pass) {
    const int r0 = 16 * (rg0 + pass * groups);
    if (both && r0 >= p.nq) break;
    if (pass + 1 < p.passes) load_q<D>(qn, xq, p, b, h, r0 + 16 * groups);
    row_group<D, BIAS, MODE>(p, L, s_k, s_vt, e, pbuf, xch, kterm, vsum, qa,
                             bias, out, b, h, r0, grp, both, r0 < p.nq, s_k,
                             xv, kv_base);
#pragma unroll
    for (int kc = 0; kc < DP / 32; ++kc)
#pragma unroll
      for (int i = 0; i < 4; ++i) qa[kc][i] = qn[kc][i];
  }
}

template <int D, bool BIAS, int MODE>
cudaError_t launch(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                   const float* bias, void* out, const HSParams& p,
                   cudaStream_t stream) {
  const size_t smem =
      Layout(p.N, D, p.warps, p.kv_both != 0, MODE == kExact).total;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_hs_kernel<D, BIAS, MODE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return e;
  }
  const int rows = 16 * p.warps / kGroupWarps<MODE> * p.passes;
  const dim3 grid((p.nq + rows - 1) / rows, p.H, p.B);
  attention_hs_kernel<D, BIAS, MODE><<<grid, 32 * p.warps, smem, stream>>>(
      xq, xk, xv, bias, out, p);
  return cudaGetLastError();
}

// the instantiation of the call's score bias and softmax form
template <int D, bool BIAS>
cudaError_t launch_form(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                        const float* b, void* out, const HSParams& p,
                        cudaStream_t s) {
  if (!p.fast) return launch<D, BIAS, kExact>(xq, xk, xv, b, out, p, s);
  if (!p.static_shift) return launch<D, BIAS, kFast>(xq, xk, xv, b, out, p, s);
  return launch<D, BIAS, kShift>(xq, xk, xv, b, out, p, s);
}

template <int D>
cudaError_t launch_d(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                     const float* b, void* out, const HSParams& p,
                     cudaStream_t s) {
  return p.has_bias ? launch_form<D, true>(xq, xk, xv, b, out, p, s)
                    : launch_form<D, false>(xq, xk, xv, b, out, p, s);
}

}  // namespace

extern "C" long long nq_attention_hs_smem_bytes(int n, int d, int warps,
                                                int kv_both, int exact) {
  return (long long)Layout(n, d, warps, kv_both != 0, exact != 0).total;
}

// Launches on `stream`; returns cudaGetLastError() of the launch. `bias`
// is the [H, nq, N] f32 score bias, or null when params->has_bias is 0.
extern "C" int nq_attention_hs(const void* xq, const void* xk,
                               const void* xv, const void* bias, void* out,
                               const HSParams* params, void* stream) {
  const HSParams p = *params;
  const auto* q = static_cast<const int8_t*>(xq);
  const auto* k = static_cast<const int8_t*>(xk);
  const auto* v = static_cast<const int8_t*>(xv);
  const auto* b = static_cast<const float*>(bias);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.has_bias && !b) return (int)cudaErrorInvalidValue;
  if (p.warps < 1 || p.warps > kMaxWarps || (!p.fast && (p.warps & 1)) ||
      p.passes < 1 || (!p.kv_both && p.passes != 1))
    return (int)cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return (int)launch_d<16>(q, k, v, b, out, p, s);
    case 32: return (int)launch_d<32>(q, k, v, b, out, p, s);
    case 64: return (int)launch_d<64>(q, k, v, b, out, p, s);
    case 128: return (int)launch_d<128>(q, k, v, b, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
