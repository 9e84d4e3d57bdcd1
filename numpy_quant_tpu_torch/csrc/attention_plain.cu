// Fused int8 attention over pre-split heads: q [BH, N, D], k^T [BH, D, N]
// and v [BH, N, D], for Hopper (sm_90a), for sequences of up to 33,000 keys.
//
// Replaces the TPU kernel numpy_quant_tpu/kernels/attention.py::
// fused_attention (body _attention_kernel, both of its grids: monolithic,
// and q-row-blockwise at N >= 1024): scores, the exact f32 softmax, the
// quantized probabilities, the context, every zero-point correction, the
// decoder causal mask and its sliding-window band, and the optional int8
// epilogue (out_requant). One kernel serves both grids: a block's rows see
// the same full-row reductions whatever N is.
//
// Bound at the TinyLlama-1.1B scoring shape (BH = 4 x 32 = 128, N = 2048,
// D = 64, causal, int8 out) on an H100 SXM: it must move q, k^T, v (3 x
// 16.8 MB) and the int8 output (16.8 MB), 67 MB, 0.020 ms at 3.35 TB/s;
// the visible half of its int8 products, 2 * 2 * BH * N * (N+1)/2 * D =
// 6.9e10 ops, takes 0.035 ms at 1,979 TOPS. With both products on the
// tensor cores (three QK^T passes, ~2e11 ops, a few tenths of a ms at
// mma.sync rates) what bounds this design is the float work of the exact
// softmax on the CUDA cores: per visible score two accurate expf, one
// IEEE division for the probability and one for its quantization, and its
// place in torch's sum order, about 2.7e8 scores per call.
//
// Design: one CTA of 8 warps per (tile of BQ = 64 query rows, head),
// heaviest (last) q tiles first. The q tile stays in shared memory and in
// registers as mma fragments; K^T and V stream through shared memory in
// tiles of BK = 64 keys (47 KB at D = 128 whatever N is), each fetched
// into registers a tile ahead and stored after the current tile's work
// (K double-buffered). Both products run on the tensor cores with
// mma.sync.m16n8k32 (s8 x s8 -> s32), their fragments loaded with
// ldmatrix from tiles whose rows carry a 16-byte pad (conflict-free,
// 16-byte aligned rows); one more mma with an all-ones A gives each key's
// sum over D (the zq correction). K^T's bytes are transposed to key-major
// and V's to d-major in registers (4 x 4 byte blocks, byte_perm) on their
// way into shared memory. Warp w computes the scores of rows 16 (w/2)..
// and keys 32 (w%2).. of a tile, and the context of the same rows and
// head dims D/2 (w%2)... Three sweeps over the key tiles, each recomputing
// s from the exact integer dots: 1. the row max; 2. the row sum of
// expf(s - m), in torch's CUDA order (below); 3. probs = e / sum,
// quantized as rint(clip(probs / sp + zp_p)) into a shared int8 tile, then
// P.V. Both divisions are IEEE, computed from the divisor's reciprocal
// (div_rn). There is no online rescaling: the quantized probabilities need
// the final max and sum, rounded as the unfused executor rounds them.
//
// The context is kept in centred form: sum_j (pq_j - zp_p)(v_j - zv) =
// sum pq v - zv sum pq - zp_p sum v + zp_p zv n over the keys the block
// walked, all in int32 (|.| <= 255^2 * N < 2^31, so N <= 33,000). It equals
// the TPU kernel's uncentred algebra over its 128-lane padded keys exactly,
// because pad keys have pq = zp_p (their score is -inf) and v = zv. The
// zq*zk term counts the real head dim D (the TPU pads D to 128 with zeros;
// here D = 16 pads to the mma's 32 bytes with zeros, which add nothing).
//
// Causal tile skipping (``skip``, set by the wrapper only when a static
// bound from the qparams proves it exact): a key tile masked for every row
// of the block -- right of the diagonal, or left of the sliding window's
// band -- is not walked. A masked score gives e = expf(s + mask - m) = 0
// exactly, so pq = rint(0 / sp + zp_p) = zp_p and its centred term is 0;
// its exp adds 0 to the row sum: skipping changes no bit.
//
// Numerics: the integer products are exact, so the scores and the context
// are the int32s of the JAX op order; every float step is the JAX op order
// with _rn intrinsics (no FMA contraction), IEEE division, half-to-even
// rounding, expf (never __expf). The row sum of sweep 2 runs in the order
// of torch's CUDA sum (torch_order.cuh): each warp owns 8 rows, stages the
// tile's exp in shared memory and streams it into its lanes' accumulators,
// strided below 128 keys, 4-vectors with each row's unaligned head and
// tail from 128 on, the row's alignment taken from the plain version's q
// tiles (``sum_tile`` rows). Wherever torch sums a row in one warp
// (kernels/attention.py::in_torch_order) the kernel so equals the plain
// version bit for bit.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

// Mirror of kernels/attention.py::_PlainParams.
struct PlainParams {
  int BH, N, D, zq, zk, zv, zp_p, out_int8, has_res_zp, causal, window, skip,
      sum_vec, sum_lanes, sum_tile;
  float c_score, scaling, sp, zp_pf, c_out, res_scale, res_zp, qmin, qmax,
      mask;
};

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PAD = 16;       // bytes of pad per row of an int8 tile
constexpr int VP = BK + PAD;  // row pitch of the v^T and p tiles (bytes)
constexpr int EP = BK + 4;    // row pitch of the exp tile (floats)
constexpr int kOnes = 0x01010101;

template <int D>
struct Tiles {
  static constexpr int DP = D < 32 ? 32 : D;  // the mma's k is 32 bytes
  static constexpr int QP = DP + PAD;         // row pitch of q and k (bytes)
  alignas(16) int8_t q[BQ * QP];     // q tile [row][d]
  alignas(16) int8_t k[2][BK * QP];  // key tiles, key-major [key][d]
  union {
    float e[BQ * EP];  // sweep 2: exp(s - m) [row][key]
    struct {
      int8_t vt[D * VP];  // sweep 3: value tile, d-major [d][key]
      int8_t p[BQ * VP];  // sweep 3: quantized probabilities [row][key]
    } pv;
  } u;
  int qsum[BQ];
  float mx[2][BQ];  // the key halves' row maxima
  int ps[2][BQ];    // the key halves' row sums of pq
  int vsum[D];
  float l[BQ];      // the row sums
};

// The 4 x 4 byte blocks (4 keys x 4 dims) of a K^T or V tile a thread
// moves: fetched from device memory a tile ahead, stored after the
// current tile's work.
template <int D>
struct Fetch {
  static constexpr int NB = (D * BK / 16 + kThreads - 1) / kThreads;
  uint32_t x[NB][4];
};

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

// c += a (16 x 32, row) * b (32 x 8, col), s8 operands, s32 sums
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
// where a/b is a normal number. The kernel divides e in [0, 1] by a row
// sum in [1, N] and a probability in [0, 1] by sp; a quotient below the
// normal range becomes a quantized probability of exactly zp_p whatever
// its last bit, so the quantized probabilities are those of __fdiv_rn.
__device__ __forceinline__ float div_rn(float a, float b, float y) {
  float q = __fmul_rn(a, y);
  q = __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
  return __fmaf_rn(__fmaf_rn(-b, q, a), y, q);
}

// the thread's blocks of the key tile at j0 from k^T (D rows of N keys;
// zero keys past N): block idx = 4 keys 4kb.. x 4 dims 4db..
template <int D>
__device__ __forceinline__ void fetch_kt(Fetch<D>& f, const int8_t* kt,
                                         size_t base, int n, int j0,
                                         int tid) {
  constexpr int DB = D / 4, DL = DB < 8 ? DB : 8;
  const bool words = (n & 3) == 0;  // aligned 4-key words
#pragma unroll
  for (int b = 0; b < Fetch<D>::NB; ++b) {
    const int idx = tid + b * kThreads;
    const int dl = idx % DL, rest = idx / DL;
    const int kb = rest % (BK / 4), db = (rest / (BK / 4)) * DL + dl;
    const int jg = j0 + 4 * kb;
#pragma unroll
    for (int a = 0; a < 4; ++a) {
      uint32_t w = 0;
      if (idx < DB * (BK / 4)) {
        const int8_t* src = kt + base + (size_t)(4 * db + a) * n + jg;
        if (words) {
          if (jg < n) w = __ldg(reinterpret_cast<const unsigned int*>(src));
        } else {
#pragma unroll
          for (int c = 0; c < 4; ++c)
            if (jg + c < n) w |= (uint32_t)(uint8_t)src[c] << (8 * c);
        }
      }
      f.x[b][a] = w;
    }
  }
}

// the fetched blocks transposed into the key-major tile
template <int D>
__device__ __forceinline__ void store_kt(int8_t* k, const Fetch<D>& f,
                                         int tid) {
  constexpr int DB = D / 4, DL = DB < 8 ? DB : 8;
#pragma unroll
  for (int b = 0; b < Fetch<D>::NB; ++b) {
    const int idx = tid + b * kThreads;
    if (idx >= DB * (BK / 4)) break;
    const int dl = idx % DL, rest = idx / DL;
    const int kb = rest % (BK / 4), db = (rest / (BK / 4)) * DL + dl;
    uint32_t y[4];
    transpose4(f.x[b], y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(&k[(4 * kb + c) * Tiles<D>::QP + 4 * db]) =
          y[c];
  }
}

// the thread's blocks of the value tile at j0 (zero keys past N)
template <int D>
__device__ __forceinline__ void fetch_v(Fetch<D>& f, const int8_t* v,
                                        size_t base, int n, int j0, int tid) {
  constexpr int DB = D / 4, DL = DB < 4 ? DB : 4;
#pragma unroll
  for (int b = 0; b < Fetch<D>::NB; ++b) {
    const int idx = tid + b * kThreads;
    const int dl = idx % DL, rest = idx / DL;
    const int kb = rest % (BK / 4), db = (rest / (BK / 4)) * DL + dl;
    const int jg = j0 + 4 * kb;
#pragma unroll
    for (int a = 0; a < 4; ++a)
      f.x[b][a] = idx < DB * (BK / 4) && jg + a < n
                      ? __ldg(reinterpret_cast<const unsigned int*>(
                            v + base + (size_t)(jg + a) * D + 4 * db))
                      : 0u;
  }
}

// the fetched value blocks transposed into the d-major tile
template <int D>
__device__ __forceinline__ void store_vt(int8_t* vt, const Fetch<D>& f,
                                         int tid) {
  constexpr int DB = D / 4, DL = DB < 4 ? DB : 4;
#pragma unroll
  for (int b = 0; b < Fetch<D>::NB; ++b) {
    const int idx = tid + b * kThreads;
    if (idx >= DB * (BK / 4)) break;
    const int dl = idx % DL, rest = idx / DL;
    const int kb = rest % (BK / 4), db = (rest / (BK / 4)) * DL + dl;
    uint32_t y[4];
    transpose4(f.x[b], y);
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<uint32_t*>(&vt[(4 * db + c) * VP + 4 * kb]) = y[c];
  }
}

// The warp's 16 x 32 integer scores of a key tile: rows 16 rg + g (+8),
// keys 32 kh + 8 nt + 2 tq (+1) in acc[nt][0..3] (mma's C layout), and
// the keys' sums over D in ks[nt][0..1] (one more mma, A all ones)
template <int D>
__device__ __forceinline__ void tile_dots(
    const int8_t* k, const uint32_t (&qa)[Tiles<D>::DP / 32][4], int kh,
    int lane, int (&acc)[4][4], int (&ks)[4][2]) {
  constexpr uint32_t kOne = kOnes;
  const uint32_t ones[4] = {kOne, kOne, kOne, kOne};
  const int key = 32 * kh + (lane & 7) + 8 * (lane >> 4);
  const int byte = 16 * ((lane >> 3) & 1);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    int s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};
    acc[2 * np][0] = acc[2 * np][1] = acc[2 * np][2] = acc[2 * np][3] = 0;
    acc[2 * np + 1][0] = acc[2 * np + 1][1] = acc[2 * np + 1][2] =
        acc[2 * np + 1][3] = 0;
#pragma unroll
    for (int kc = 0; kc < Tiles<D>::DP / 32; ++kc) {
      uint32_t b[4];
      ldsm_x4(b, &k[(key + 16 * np) * Tiles<D>::QP + 32 * kc + byte]);
      mma_s8(acc[2 * np], qa[kc], b[0], b[1]);
      mma_s8(acc[2 * np + 1], qa[kc], b[2], b[3]);
      mma_s8(s0, ones, b[0], b[1]);
      mma_s8(s1, ones, b[2], b[3]);
    }
    ks[2 * np][0] = s0[0];
    ks[2 * np][1] = s0[1];
    ks[2 * np + 1][0] = s1[0];
    ks[2 * np + 1][1] = s1[1];
  }
}

// one dequantized (and masked) score in _attention_kernel's op order: the
// integer dot `a` of query row `row` (sum of q over D: qs) and key `col`
// (sum of k over D: ks)
template <int D>
__device__ __forceinline__ float score(const PlainParams& p, int a, int qs,
                                       int ks, int row, int col) {
  if (p.zk) a -= qs * p.zk;
  if (p.zq) a -= ks * p.zq;
  if (p.zq && p.zk) a += p.zq * p.zk * D;
  float v = __fmul_rn(__fmul_rn(__int2float_rn(a), p.c_score), p.scaling);
  // decoder mask at the graph Add's position
  if (p.causal && !(col <= row && (p.window <= 0 || col > row - p.window)))
    v = __fadd_rn(v, p.mask);
  return v;
}

template <int D>
__global__ void __launch_bounds__(kThreads, 2)
    plain_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                 const int8_t* __restrict__ v, void* __restrict__ out,
                 const PlainParams p) {
  using T = Tiles<D>;
  constexpr int DP = T::DP, QP = T::QP;
  constexpr int NTV = D / 16;  // context n-tiles per warp (D/2 dims)
  __shared__ T t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp >> 1, kh = warp & 1;
  const int bh = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int n = p.N;
  const size_t base = (size_t)bh * n * D;  // q, k^T, v and out alike

  // the q tile (zero rows past N, zero dims past D) and the key tiles'
  // zero dims past D
  for (int idx = tid; idx < BQ * (DP / 16); idx += kThreads) {
    const int r = idx / (DP / 16), c = idx % (DP / 16);
    int4 val = make_int4(0, 0, 0, 0);
    if (r0 + r < n && 16 * c < D)
      val = __ldg(reinterpret_cast<const int4*>(q + base +
                                                (size_t)(r0 + r) * D + c * 16));
    *reinterpret_cast<int4*>(&t.q[r * QP + 16 * c]) = val;
    if (16 * c >= D) {
      *reinterpret_cast<int4*>(&t.k[0][r * QP + 16 * c]) = make_int4(0, 0, 0, 0);
      *reinterpret_cast<int4*>(&t.k[1][r * QP + 16 * c]) = make_int4(0, 0, 0, 0);
    }
  }
  __syncthreads();
  if (tid < BQ) {
    const int* row = reinterpret_cast<const int*>(&t.q[tid * QP]);
    int s = 0;
#pragma unroll
    for (int w = 0; w < D / 4; ++w) s = __dp4a(row[w], kOnes, s);
    t.qsum[tid] = s;
  }
  uint32_t qa[DP / 32][4];
#pragma unroll
  for (int kc = 0; kc < DP / 32; ++kc)
    ldsm_x4(qa[kc], &t.q[(16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) * QP +
                         32 * kc + 16 * (lane >> 4)]);

  // the key tiles this block walks: all, or (skip) those holding a key
  // visible from one of its rows
  int lo = 0, hi = n;
  if (p.causal && p.skip) {
    hi = min(n, r0 + BQ);
    if (p.window > 0) lo = max(0, r0 - p.window + 1);
  }
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;
  const int walked = min(n, t_hi * BK) - t_lo * BK;  // real keys walked

  // the thread's two rows (tile rows ra, ra + 8)
  const int ra = 16 * rg + g;
  __syncthreads();
  const int qs[2] = {t.qsum[ra], t.qsum[ra + 8]};
  float m[2] = {-INFINITY, -INFINITY};
  Fetch<D> fk;

  // sweep 1: the row max. Each sweep stores its first key tile, then
  // fetches tile + 1 before the work on tile and stores it after.
  fetch_kt(fk, kt, base, n, t_lo * BK, tid);
  store_kt(t.k[0], fk, tid);
  __syncthreads();
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK, cur = (tile - t_lo) & 1;
    if (tile + 1 < t_hi) fetch_kt(fk, kt, base, n, j0 + BK, tid);
    int acc[4][4], ks[4][2];
    tile_dots<D>(t.k[cur], qa, kh, lane, acc, ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int h = e >> 1, c = e & 1;
        const int r = ra + 8 * h, kj = 32 * kh + 8 * nt + 2 * tq + c;
        if (j0 + kj < n)
          m[h] = fmaxf(m[h], score<D>(p, acc[nt][e], qs[h], ks[nt][c], r0 + r,
                                      j0 + kj));
      }
    if (tile + 1 < t_hi) store_kt(t.k[cur ^ 1], fk, tid);
    __syncthreads();
  }
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 1));
    m[h] = fmaxf(m[h], __shfl_xor_sync(0xffffffffu, m[h], 2));
    if (tq == 0) t.mx[kh][ra + 8 * h] = m[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h)
    m[h] = fmaxf(t.mx[0][ra + 8 * h], t.mx[1][ra + 8 * h]);

  // sweep 2: the row sum of expf(s - m) in torch's order; warp w streams
  // rows 8w..8w+7 of each exp tile, row 8w + i into a[i]
  {
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
    fetch_kt(fk, kt, base, n, t_lo * BK, tid);
    store_kt(t.k[0], fk, tid);
    __syncthreads();
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int j0 = tile * BK, cur = (tile - t_lo) & 1;
      if (tile + 1 < t_hi) fetch_kt(fk, kt, base, n, j0 + BK, tid);
      int acc[4][4], ks[4][2];
      tile_dots<D>(t.k[cur], qa, kh, lane, acc, ks);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int r = ra + 8 * h, kj = 32 * kh + 8 * nt + 2 * tq;
          float2 e2;
          e2.x = expf(__fsub_rn(score<D>(p, acc[nt][2 * h], qs[h], ks[nt][0],
                                         r0 + r, j0 + kj), m[h]));
          e2.y = expf(__fsub_rn(score<D>(p, acc[nt][2 * h + 1], qs[h],
                                         ks[nt][1], r0 + r, j0 + kj + 1),
                                m[h]));
          *reinterpret_cast<float2*>(&t.u.e[r * EP + kj]) = e2;
        }
      if (tile + 1 < t_hi) store_kt(t.k[cur ^ 1], fk, tid);
      __syncthreads();
      torch_order_stream_rows(a, &t.u.e[8 * warp * EP], EP, j0,
                              min(BK, n - j0), n, bh, r0 + 8 * warp, n,
                              p.sum_tile, p.sum_vec, p.sum_lanes, lane);
      __syncthreads();
    }
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sum = torch_order_finish(a[i], p.sum_lanes);
      if (lane == 0) t.l[8 * warp + i] = sum;
    }
  }
  __syncthreads();
  const float l[2] = {t.l[ra], t.l[ra + 8]};
  // the divisors' reciprocals, for div_rn
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float rsp = __frcp_rn(p.sp);

  // sweep 3: quantized probabilities, then P.V on the tensor cores
  int ctx[NTV][4];
#pragma unroll
  for (int nt = 0; nt < NTV; ++nt)
    ctx[nt][0] = ctx[nt][1] = ctx[nt][2] = ctx[nt][3] = 0;
  int psum[2] = {0, 0}, vsum = 0;
  Fetch<D> fv;
  fetch_kt(fk, kt, base, n, t_lo * BK, tid);
  fetch_v(fv, v, base, n, t_lo * BK, tid);
  store_kt(t.k[0], fk, tid);
  store_vt(t.u.pv.vt, fv, tid);
  __syncthreads();
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK, cur = (tile - t_lo) & 1;
    const bool more = tile + 1 < t_hi;
    if (more) {
      fetch_kt(fk, kt, base, n, j0 + BK, tid);
      fetch_v(fv, v, base, n, j0 + BK, tid);
    }
    int acc[4][4], ks[4][2];
    tile_dots<D>(t.k[cur], qa, kh, lane, acc, ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = ra + 8 * h, kj = 32 * kh + 8 * nt + 2 * tq;
        int pq[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pq[c] = 0;  // keys past N: no term
          if (j0 + kj + c < n) {
            const float s = score<D>(p, acc[nt][2 * h + c], qs[h], ks[nt][c],
                                     r0 + r, j0 + kj + c);
            const float prob =
                div_rn(expf(__fsub_rn(s, m[h])), l[h], rl[h]);
            const float x = __fadd_rn(div_rn(prob, p.sp, rsp), p.zp_pf);
            pq[c] = __float2int_rn(fminf(fmaxf(x, p.qmin), p.qmax));
          }
        }
        psum[h] += pq[0] + pq[1];
        *reinterpret_cast<uint16_t*>(&t.u.pv.p[r * VP + kj]) =
            (uint16_t)((pq[0] & 0xff) | ((pq[1] & 0xff) << 8));
      }
    if (more) store_kt(t.k[cur ^ 1], fk, tid);
    __syncthreads();
    if (tid >= 128 && tid < 128 + D) {  // the tile's sum of v per head dim
      const int* row =
          reinterpret_cast<const int*>(&t.u.pv.vt[(tid - 128) * VP]);
#pragma unroll
      for (int w = 0; w < BK / 4; ++w) vsum = __dp4a(row[w], kOnes, vsum);
    }
#pragma unroll
    for (int kc = 0; kc < BK / 32; ++kc) {
      uint32_t pa[4];
      ldsm_x4(pa, &t.u.pv.p[(16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) * VP +
                            32 * kc + 16 * (lane >> 4)]);
      const int byte = 32 * kc + 16 * ((lane >> 3) & 1);
      if constexpr (NTV == 1) {
        uint32_t b[2];
        ldsm_x2(b, &t.u.pv.vt[(kh * (D / 2) + (lane & 7)) * VP + byte]);
        mma_s8(ctx[0], pa, b[0], b[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NTV / 2; ++np) {
          uint32_t b[4];
          ldsm_x4(b, &t.u.pv.vt[(kh * (D / 2) + 16 * np + (lane & 7) +
                                 8 * (lane >> 4)) * VP + byte]);
          mma_s8(ctx[2 * np], pa, b[0], b[1]);
          mma_s8(ctx[2 * np + 1], pa, b[2], b[3]);
        }
      }
    }
    __syncthreads();
    if (more) store_vt(t.u.pv.vt, fv, tid);
  }

  // epilogue: centred context, dequantize, optional requantize
  if (tid >= 128 && tid < 128 + D) t.vsum[tid - 128] = vsum;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 1);
    psum[h] += __shfl_xor_sync(0xffffffffu, psum[h], 2);
    if (tq == 0) t.ps[kh][ra + 8 * h] = psum[h];
  }
  __syncthreads();
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = ra + 8 * h, row = r0 + r;
    if (row >= n) continue;
    const long long ps = (long long)t.ps[0][r] + t.ps[1][r];
    const size_t o_row = base + (size_t)row * D;
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt) {
      const int d = kh * (D / 2) + 8 * nt + 2 * tq;
      float y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const long long centred = (long long)ctx[nt][2 * h + c] -
                                  (long long)p.zv * ps -
                                  (long long)p.zp_p * t.vsum[d + c] +
                                  (long long)p.zp_p * p.zv * walked;
        y[c] = __fmul_rn(__int2float_rn((int)centred), p.c_out);
      }
      if (p.out_int8) {
        int yq[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          float z = __fdiv_rn(y[c], p.res_scale);
          if (p.has_res_zp) z = __fadd_rn(z, p.res_zp);
          z = fminf(fmaxf(z, p.qmin), p.qmax);
          yq[c] = __float2int_rn(z);
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

template <int D>
cudaError_t launch(const int8_t* q, const int8_t* kt, const int8_t* v,
                   void* out, const PlainParams& p, cudaStream_t stream) {
  const dim3 grid((p.N + BQ - 1) / BQ, p.BH);
  plain_kernel<D><<<grid, kThreads, 0, stream>>>(q, kt, v, out, p);
  return cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() of the launch.
extern "C" int nq_attention_plain(const void* q, const void* kt,
                                  const void* v, void* out,
                                  const PlainParams* params, void* stream) {
  const PlainParams p = *params;
  const auto* qq = static_cast<const int8_t*>(q);
  const auto* kk = static_cast<const int8_t*>(kt);
  const auto* vv = static_cast<const int8_t*>(v);
  const auto s = static_cast<cudaStream_t>(stream);
  if (p.BH > 65535 || p.sum_tile < 1) return (int)cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return (int)launch<16>(qq, kk, vv, out, p, s);
    case 32: return (int)launch<32>(qq, kk, vv, out, p, s);
    case 64: return (int)launch<64>(qq, kk, vv, out, p, s);
    case 128: return (int)launch<128>(qq, kk, vv, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
