// Blockwise fused int8 attention over head-interleaved [B, N, H*D] Q/K/V,
// for Hopper (sm_90a), for sequences of any length up to 33,000 keys.
//
// Replaces the TPU kernel numpy_quant_tpu/kernels/attention.py::
// _fused_attention_hs_blockq (its q-row-tiled grid, K/V whole per batch
// row): exact and fast variants, the static score_max shift, the decoder
// causal mask and its sliding-window band, the per-head score-bias
// operand, out_requant on/off, every zero-point correction, narrow q
// (fewer query rows than keys, no mask or bias) and ragged N. It computes
// what csrc/attention_hs.cu computes; that kernel stages K/V whole in
// shared memory and so stops at ~1,290 keys at D=64, while this one
// streams them.
//
// Bound at GPT-2 small's full context (B=8, N=1024, H=12, D=64, causal,
// int8 out) on an H100 SXM: it must move q, k, v (3 x 6.3 MB) and the
// int8 output (6.3 MB), 25.2 MB, 7.5 us at 3.35 TB/s; the visible half
// of its int8 products, 2 * 2 * B*H*N*(N+1)/2 * D = 1.29e10 ops, takes
// 6.5 us at 1,979 TOPS. Either way a few microseconds. At T5-small's
// encoder self-attention (B=8, N=512, H=8, D=64, bias [8, 512, 512] f32,
// int8 out) it moves 4 x 2.1 MB of q, k, v and out plus the 8.4 MB bias,
// 16.8 MB, 5.0 us at 3.35 TB/s; its int8 products, 4*B*H*N^2*D = 4.3e9
// ops, take 2.2 us at 1,979 TOPS.
//
// Design: one CTA of 256 threads per (tile of BQ=64 query rows, head,
// batch row). The q tile stays in shared memory; K (and, in the last
// sweep, V, transposed) stream through shared memory in tiles of BK=64
// keys, so a block holds ~18 KB at D=64 whatever N is. Each thread owns
// a 4x4 patch of the 64x64 score tile (rows 4*ty.., keys tx+16*j) and
// computes it with __dp4a on the integer ALUs; row reductions run over
// the 16 threads of a row with warp shuffles.
//   Exact path (fast=0), three sweeps over the key tiles, each
//   recomputing s from the exact integer dots: 1. the row max; 2. the
//   row sum of expf(s - m), in the order of torch's CUDA sum (each
//   warp stages its rows' exp tile in shared memory and streams it into
//   its lanes' accumulators, torch_order.cuh); 3. probs = e /
//   sum (__fdiv_rn), quantized as rint(clip(probs / sp + zp_p)) into a
//   shared int8 tile, then P.V.
//   There is no online rescaling here: the quantized probabilities need
//   the final max and sum, rounded as the unfused executor rounds them.
//   Fast path, two sweeps: 1. the row max and sum with a per-tile online
//   rescale (or, with the static shift, the plain clipped-exp2 sum);
//   2. the probabilities and P.V.
// The context is kept in centred form: sum_j (pq_j - zp_p)(v_j - zv) =
// sum pq v - zv sum pq - zp_p sum v + zp_p zv n over the keys the block
// walked, all in int32 (|.| <= 255^2 * N < 2^31, so N <= 33,000). It
// equals the TPU kernel's uncentred algebra over its padded keys exactly,
// because pad keys have pq = zp_p and v = zv.
//
// The score bias ([H, nq, N] f32, the same for every batch row) is read
// from global memory (L2, after the first batch row) for the thread's 4x4
// patch of each key tile, on every sweep, at the graph Add's position.
//
// Causal tile skipping (``skip``, set by the wrapper only when a static
// bound from the qparams proves it exact, never with a bias): a key tile
// masked for every row of the block is not walked. On the exact path a masked score gives
// e = expf(s + mask - m) = 0 exactly, so pq = rint(0 / sp + zp_p) = zp_p
// and its centred term is 0: skipping changes no bit. On the fast path
// without a shift exp2f gives 0 alike. With the static shift a masked
// score clamps to 2^-120: the skipped keys add (count) * 2^-120 to the
// row sum in closed form, and their one quantized value
// rint(2^-120 * r + zp_p) is checked; if it is not zp_p for some row, the
// block walks every key tile in its last sweep.
//
// Numerics as in csrc/attention_hs.cu: the JAX op order, _rn intrinsics
// (no FMA contraction), IEEE division, half-to-even rounding, expf/exp2f
// (never __expf). The exact row sums take torch's order at every N where
// torch sums a row in one warp (kernels/attention.py::in_torch_order):
// strided loads below 128 keys, 4-vectors with each row's unaligned head
// and tail from 128 on, the row's alignment taken from the plain
// version's q tiles of ``sum_tile`` rows. There the exact path equals the
// plain version bit for bit. The fast path's sums run in its own order.
//
// This simple design runs both products on the integer ALUs with three
// (exact) or two (fast) passes over K; wgmma, TMA and a one-sweep fast
// path are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

// Shared with csrc/attention_hs.cu: ``sum_vec`` and ``sum_lanes`` give
// torch's row-sum order, ``sum_tile`` the plain version's q tile rows.
struct HSParams {
  int B, nq, N, H, D, zq, zk, zv, zp_p, fast, static_shift, need_lo,
      need_hi, out_int8, has_res_zp, causal, window, skip, has_bias, sum_vec,
      sum_lanes, sum_tile;
  float c_score, scaling, czq, base, sp, zp_pf, c_out, res_scale, res_zp,
      qmin, qmax, mask;
};

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int RPT = BQ / 16;    // rows per thread
constexpr int KPT = BK / 16;    // keys per thread
constexpr int PW = BK / 4 + 1;  // padded word stride of P and V^T rows
constexpr int kOnes = 0x01010101;
constexpr float kMaskedExp2 = 0x1p-120f;  // a clamped masked score

template <int D>
struct Tiles {
  int q[BQ][D / 4 + 1];  // q tile, int8x4 words, rows padded one word
  int k[BK][D / 4 + 1];  // key tile
  int vt[D][PW];         // value tile transposed: vt[d] holds keys 0..BK-1
  int p[BQ][PW];         // quantized probabilities, int8 [row][key]
  alignas(16) float e[BQ][BK + 4];  // exact sweep 2: exp(s - m), key tile
  int qsum[BQ];
  int ksum[BK];
};

__device__ __forceinline__ void put4(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// reductions over the 16 threads of one row (a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float row_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the key tile at j0 (zero rows past N) and its row sums
template <int D>
__device__ __forceinline__ void load_k(Tiles<D>& t, const int8_t* xk,
                                       size_t kv_base, int hd, int n, int j0,
                                       int tid) {
  constexpr int C16 = D / 16;  // 16-byte chunks per head row
  // BK * C16 is a multiple of 32, so every warp runs the loop whole and
  // the C16 chunks of a key sit in neighbouring lanes
  for (int idx = tid; idx < BK * C16; idx += kThreads) {
    const int j = idx / C16, c = idx - j * C16;
    int4 v = make_int4(0, 0, 0, 0);
    if (j0 + j < n)
      v = __ldg(reinterpret_cast<const int4*>(xk + kv_base +
                                              (size_t)(j0 + j) * hd + c * 16));
    put4(&t.k[j][c * 4], v);
    int part = __dp4a(v.x, kOnes, __dp4a(v.y, kOnes,
                      __dp4a(v.z, kOnes, __dp4a(v.w, kOnes, 0))));
#pragma unroll
    for (int o = C16 / 2; o > 0; o >>= 1)
      part += __shfl_xor_sync(0xffffffffu, part, o);
    if (c == 0) t.ksum[j] = part;
  }
}

// the value tile at j0, transposed into vt[d][key] bytes (zero past N)
template <int D>
__device__ __forceinline__ void load_vt(Tiles<D>& t, const int8_t* xv,
                                        size_t kv_base, int hd, int n, int j0,
                                        int tid) {
  constexpr int C16 = D / 16;
  for (int idx = tid; idx < BK * C16; idx += kThreads) {
    const int j = idx / C16, c = idx - j * C16;
    int4 v = make_int4(0, 0, 0, 0);
    if (j0 + j < n)
      v = __ldg(reinterpret_cast<const int4*>(xv + kv_base +
                                              (size_t)(j0 + j) * hd + c * 16));
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&v);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      reinterpret_cast<int8_t*>(t.vt[c * 16 + e])[j] = bytes[e];
  }
}

// the thread's 4x4 patch of dequantized (biased, masked) scores of the
// tile at j0: rows 4*ty + i, keys tx + 16*j; `bias` points at the head's
// [nq, N] bias rows, or is null
template <int D>
__device__ __forceinline__ void tile_scores(const Tiles<D>& t,
                                            const HSParams& p, int ty, int tx,
                                            int r0, int j0,
                                            const float* __restrict__ bias,
                                            float (&s)[RPT][KPT]) {
  constexpr int W = D / 4;
  int acc[RPT][KPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j) acc[i][j] = 0;
#pragma unroll 4
  for (int w = 0; w < W; ++w) {
    int qv[RPT], kv[KPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i) qv[i] = t.q[ty * RPT + i][w];
#pragma unroll
    for (int j = 0; j < KPT; ++j) kv[j] = t.k[tx + 16 * j][w];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) acc[i][j] = __dp4a(qv[i], kv[j], acc[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int r = ty * RPT + i, row = r0 + r;
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const int kj = tx + 16 * j, col = j0 + kj;
      float v;
      if (!p.fast) {
        int a = acc[i][j];
        if (p.zk) a -= t.qsum[r] * p.zk;
        if (p.zq) a -= t.ksum[kj] * p.zq;
        if (p.zq && p.zk) a += p.zq * p.zk * D;
        v = __fmul_rn(__fmul_rn(__int2float_rn(a), p.c_score), p.scaling);
      } else {
        const float colc =
            p.zq ? __fadd_rn(__fmul_rn(__int2float_rn(t.ksum[kj]), p.czq),
                             p.base)
                 : p.base;
        v = __fadd_rn(__fmul_rn(__int2float_rn(acc[i][j]), p.c_score), colc);
      }
      // score bias at the graph Add's position (pre-scaled by log2(e) on
      // the fast path)
      if (bias && row < p.nq && col < p.N)
        v = __fadd_rn(v, __ldg(bias + (size_t)row * p.N + col));
      // decoder mask at the graph Add's position (pre-scaled by log2(e)
      // on the fast path)
      if (p.causal && !(col <= row && (p.window <= 0 || col > row - p.window)))
        v = __fadd_rn(v, p.mask);
      s[i][j] = v;
    }
  }
}

__device__ __forceinline__ float clip_prob(float t, const HSParams& p,
                                               bool lo, bool hi) {
  if (lo) t = fmaxf(t, p.qmin);
  if (hi) t = fminf(t, p.qmax);
  return t;
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    blockq_kernel(const int8_t* __restrict__ xq,
                  const int8_t* __restrict__ xk,
                  const int8_t* __restrict__ xv,
                  const float* __restrict__ bias_all, void* __restrict__ out,
                  const HSParams p) {
  constexpr int W = D / 4;
  constexpr int C16 = D / 16;
  constexpr int DPT = D / 16;  // output columns per thread
  __shared__ Tiles<D> t;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int b = blockIdx.z, h = blockIdx.y, r0 = blockIdx.x * BQ;
  const int n = p.N, hd = p.H * D;
  const size_t q_base = (size_t)b * p.nq * hd + (size_t)h * D;
  const size_t kv_base = (size_t)b * n * hd + (size_t)h * D;
  const float* bias =
      p.has_bias ? bias_all + (size_t)h * p.nq * n : nullptr;

  for (int idx = tid; idx < BQ * C16; idx += kThreads) {
    const int r = idx / C16, c = idx - r * C16;
    int4 v = make_int4(0, 0, 0, 0);
    if (r0 + r < p.nq)
      v = __ldg(reinterpret_cast<const int4*>(xq + q_base +
                                              (size_t)(r0 + r) * hd + c * 16));
    put4(&t.q[r][c * 4], v);
  }
  __syncthreads();
  if (tid < BQ) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) s = __dp4a(t.q[tid][w], kOnes, s);
    t.qsum[tid] = s;
  }

  // the key tiles this block walks: all, or (skip) those holding a key
  // visible from one of its rows
  int lo = 0, hi = n;
  if (p.causal && p.skip) {
    hi = min(n, r0 + BQ);
    if (p.window > 0) lo = max(0, r0 - p.window + 1);
  }
  int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;
  int walked = min(n, t_hi * BK) - t_lo * BK;  // real keys walked

  const bool fast = p.fast != 0, shift = fast && p.static_shift;
  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
  }

  // sweep 1: exact -- row max; fast -- max and sum (online per tile);
  // static shift -- the clipped-exp2 sum
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK;
    __syncthreads();
    load_k(t, xk, kv_base, hd, n, j0, tid);
    __syncthreads();
    float s[RPT][KPT];
    tile_scores(t, p, ty, tx, r0, j0, bias, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (!fast) {
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (j0 + tx + 16 * j < n) m[i] = fmaxf(m[i], s[i][j]);
      } else if (shift) {
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (j0 + tx + 16 * j < n)
            l[i] = __fadd_rn(l[i], exp2f(fminf(fmaxf(s[i][j], -120.f), 80.f)));
      } else {
        float tm = -INFINITY;
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          if (j0 + tx + 16 * j < n) tm = fmaxf(tm, s[i][j]);
        if (tm > -INFINITY) {
          const float mn = fmaxf(m[i], tm);
          l[i] = __fmul_rn(l[i], exp2f(__fsub_rn(m[i], mn)));
#pragma unroll
          for (int j = 0; j < KPT; ++j)
            if (j0 + tx + 16 * j < n)
              l[i] = __fadd_rn(l[i], exp2f(__fsub_rn(s[i][j], mn)));
          m[i] = mn;
        }
      }
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    if (!fast) {
      m[i] = row_max(m[i]);
    } else if (shift) {
      // the skipped keys each clamp to exactly 2^-120
      l[i] = __fadd_rn(row_sum(l[i]),
                       __fmul_rn((float)(n - walked), kMaskedExp2));
    } else {
      const float mx = row_max(m[i]);
      l[i] = row_sum(m[i] == -INFINITY
                         ? 0.f
                         : __fmul_rn(l[i], exp2f(__fsub_rn(m[i], mx))));
      m[i] = mx;
    }
  }

  if (!fast) {
    // sweep 2 (exact): the row sum of expf(s - m) in torch's order. Warp w
    // computes rows 8w..8w+7 of each tile's scores; it stages their exp in
    // shared memory and streams them into its lanes' accumulators
    // (torch_order.cuh), row 8w + i in a[i].
    const int warp = tid >> 5, lane = tid & 31;
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int j0 = tile * BK;
      __syncthreads();
      load_k(t, xk, kv_base, hd, n, j0, tid);
      __syncthreads();
      float s[RPT][KPT];
      tile_scores(t, p, ty, tx, r0, j0, bias, s);
#pragma unroll
      for (int i = 0; i < RPT; ++i)
#pragma unroll
        for (int j = 0; j < KPT; ++j)
          t.e[ty * RPT + i][tx + 16 * j] = expf(__fsub_rn(s[i][j], m[i]));
      __syncwarp();
      torch_order_stream_rows(a, t.e[8 * warp], BK + 4, j0, min(BK, n - j0),
                              n, (long long)b * p.H + h, r0 + 8 * warp, p.nq,
                              p.sum_tile, p.sum_vec, p.sum_lanes, lane);
      __syncwarp();
    }
    // the thread's rows 4 ty + i are the warp's rows 4 (ty & 1) + i
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sum = torch_order_finish(a[i], p.sum_lanes);
      if ((i >> 2) == (ty & 1)) l[i & 3] = sum;
    }
  }

  // the fast path's reciprocal r = 1 / (sum * sp)
  float rcp[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i)
    rcp[i] = fast ? __fdiv_rn(1.f, __fmul_rn(l[i], p.sp)) : 0.f;
  const bool need_lo = fast ? p.need_lo != 0 : true;
  const bool need_hi = fast ? p.need_hi != 0 : true;
  if (shift && walked < n) {
    // a skipped key's quantized probability must be zp_p, or the block
    // walks them all
    int need = 0;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      if (r0 + ty * RPT + i >= p.nq) continue;
      const float v = clip_prob(
          __fadd_rn(__fmul_rn(kMaskedExp2, rcp[i]), p.zp_pf), p, need_lo,
          need_hi);
      if (__float2int_rn(v) != p.zp_p) need = 1;
    }
    if (__syncthreads_or(need)) {
      t_lo = 0;
      t_hi = (n + BK - 1) / BK;
      walked = n;
    }
  }

  // last sweep: quantized probabilities, then P.V in int32
  int acc[RPT][DPT], psum[RPT], vsum[DPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    psum[i] = 0;
#pragma unroll
    for (int c = 0; c < DPT; ++c) acc[i][c] = 0;
  }
#pragma unroll
  for (int c = 0; c < DPT; ++c) vsum[c] = 0;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK;
    __syncthreads();
    load_k(t, xk, kv_base, hd, n, j0, tid);
    load_vt(t, xv, kv_base, hd, n, j0, tid);
    __syncthreads();
    float s[RPT][KPT];
    tile_scores(t, p, ty, tx, r0, j0, bias, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int8_t* prow = reinterpret_cast<int8_t*>(t.p[ty * RPT + i]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = tx + 16 * j;
        int8_t q = 0;  // keys past N: no term
        if (j0 + kj < n) {
          float v;
          if (!fast) {
            const float prob = __fdiv_rn(expf(__fsub_rn(s[i][j], m[i])), l[i]);
            v = __fadd_rn(__fdiv_rn(prob, p.sp), p.zp_pf);
          } else {
            const float e = shift ? exp2f(fminf(fmaxf(s[i][j], -120.f), 80.f))
                                  : exp2f(__fsub_rn(s[i][j], m[i]));
            v = __fadd_rn(__fmul_rn(e, rcp[i]), p.zp_pf);
          }
          q = (int8_t)__float2int_rn(clip_prob(v, p, need_lo, need_hi));
        }
        prow[kj] = q;
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int w = 0; w < BK / 4; ++w) {
      int pv[RPT], vv[DPT];
#pragma unroll
      for (int i = 0; i < RPT; ++i) pv[i] = t.p[ty * RPT + i][w];
#pragma unroll
      for (int c = 0; c < DPT; ++c) vv[c] = t.vt[tx + 16 * c][w];
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        psum[i] = __dp4a(pv[i], kOnes, psum[i]);
#pragma unroll
        for (int c = 0; c < DPT; ++c) acc[i][c] = __dp4a(pv[i], vv[c], acc[i][c]);
      }
#pragma unroll
      for (int c = 0; c < DPT; ++c) vsum[c] = __dp4a(vv[c], kOnes, vsum[c]);
    }
  }

  // epilogue: centred context, dequantize, optional requantize
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
    const int row = r0 + ty * RPT + i;
    if (row >= p.nq) continue;
    const size_t o_row = q_base + (size_t)row * hd;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      const long long centred = (long long)acc[i][c] -
                                (long long)p.zv * psum[i] -
                                (long long)p.zp_p * vsum[c] +
                                (long long)p.zp_p * p.zv * walked;
      const float y = __fmul_rn(__int2float_rn((int)centred), p.c_out);
      if (p.out_int8) {
        float yq = fast ? y : __fdiv_rn(y, p.res_scale);
        if (p.has_res_zp) yq = __fadd_rn(yq, p.res_zp);
        yq = fminf(fmaxf(yq, p.qmin), p.qmax);
        static_cast<int8_t*>(out)[o_row + d] = (int8_t)__float2int_rn(yq);
      } else {
        static_cast<float*>(out)[o_row + d] = y;
      }
    }
  }
}

template <int D>
cudaError_t launch(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                   const float* bias, void* out, const HSParams& p,
                   cudaStream_t stream) {
  const dim3 grid((p.nq + BQ - 1) / BQ, p.H, p.B);
  blockq_kernel<D><<<grid, kThreads, 0, stream>>>(xq, xk, xv, bias, out, p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch. `bias`
// is the [H, nq, N] f32 score bias, or null when params->has_bias is 0.
extern "C" int nq_attention_hs_blockq(const void* xq, const void* xk,
                                      const void* xv, const void* bias,
                                      void* out, const HSParams* params,
                                      void* stream) {
  const HSParams p = *params;
  const auto* q = static_cast<const int8_t*>(xq);
  const auto* k = static_cast<const int8_t*>(xk);
  const auto* v = static_cast<const int8_t*>(xv);
  const auto* b = static_cast<const float*>(bias);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.has_bias && !b) return (int)cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return (int)launch<16>(q, k, v, b, out, p, s);
    case 32: return (int)launch<32>(q, k, v, b, out, p, s);
    case 64: return (int)launch<64>(q, k, v, b, out, p, s);
    case 128: return (int)launch<128>(q, k, v, b, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
