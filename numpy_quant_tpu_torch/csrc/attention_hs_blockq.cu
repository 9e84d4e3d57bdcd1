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
// shared memory, while this one streams them.
//
// Bound at GPT-2 small's full context (B=8, N=1024, H=12, D=64, causal,
// int8 out) on an H100 SXM: it must move q, k, v (3 x 6.3 MB) and the
// int8 output (6.3 MB), 25.2 MB, 7.5 us at 3.35 TB/s; the visible half
// of its int8 products, 2 * 2 * B*H*N*(N+1)/2 * D = 1.29e10 ops, takes
// 6.5 us at 1,979 TOPS. Either way a few microseconds. At T5-small's
// encoder self-attention (B=8, N=512, H=8, D=64, bias [8, 512, 512] f32,
// int8 out) it moves 4 x 2.1 MB of q, k, v and out plus the 8.4 MB bias,
// 16.8 MB, 5.0 us at 3.35 TB/s; its int8 products, 4*B*H*N^2*D = 4.3e9
// ops, take 2.2 us at 1,979 TOPS. The sweeps below recompute the scores
// on the tensor cores, so what bounds this design is the softmax's float
// work per score and sweep (two exp and two divisions per visible score
// on the exact path, one exp2 and one product on the fast one).
//
// Design (csrc/attention_plain.cu's, on head-interleaved rows): one CTA
// of 8 warps per (tile of BQ = 64 query rows, head, batch row), heaviest
// (last) q tiles first. The q tile stays in shared memory and in
// registers as mma fragments; K streams through shared memory in tiles of
// BK = 64 keys, double-buffered with cp.async (the next tile's copy runs
// while the current one is worked on; one barrier per tile); V streams a tile ahead through registers and is transposed to
// [d][key] with byte permutes on its way into shared memory. Both products
// run on the tensor cores with mma.sync.m16n8k32 (s8 x s8 -> s32),
// fragments loaded with ldmatrix from tiles whose rows carry a 16-byte pad
// (conflict-free); one more mma with an all-ones A gives each key's sum
// over D (the zq correction). Warp w computes the scores of rows 16 (w/2).. and keys 32
// (w%2).. of a tile, and the context of the same rows and head dims
// D/2 (w%2)...
//   Exact path (fast=0), three sweeps over the key tiles, each
//   recomputing s from the exact integer dots: 1. the row max; 2. the
//   row sum of expf(s - m), in the order of torch's CUDA sum (each warp
//   stages its rows' exp tile in shared memory and streams it into its
//   lanes' accumulators, torch_order.cuh); 3. probs = e / sum, quantized
//   as rint(clip(probs / sp + zp_p)) into a shared int8 tile, then P.V.
//   There is no online rescaling here: the quantized probabilities need
//   the final max and sum, rounded as the unfused executor rounds them.
//   Fast path, two sweeps: 1. the row max and sum with a per-lane online
//   rescale (or, with the static shift, the plain clipped-exp2 sum),
//   combined over the 4 lanes and the 2 key halves of a row; 2. the
//   probabilities and P.V.
// The context is kept in centred form: sum_j (pq_j - zp_p)(v_j - zv) =
// sum pq v - zv sum pq - zp_p sum v + zp_p zv n over the keys the block
// walked, all in int32 (|.| <= 255^2 * N < 2^31, so N <= 33,000). It
// equals the TPU kernel's uncentred algebra over its padded keys exactly,
// because pad keys have pq = zp_p and v = zv. D = 16 pads to the mma's 32
// bytes with zeros; the zq*zk*D term counts the real D.
//
// The score bias ([H, nq, N] f32, the same for every batch row) is read
// from global memory (L2, after the first batch row) at the graph Add's
// position, on every sweep. It is a template flag (BIAS), so the
// bias-free forms (GPT-2) carry no code or registers for it.
//
// Causal tile skipping (``skip``, set by the wrapper only when a static
// bound from the qparams proves it exact, never with a bias): a key tile
// masked for every row of the block is not walked. On the exact path a
// masked score gives e = expf(s + mask - m) = 0 exactly, so pq = rint(0 /
// sp + zp_p) = zp_p and its centred term is 0: skipping changes no bit.
// On the fast path without a shift exp2f gives 0 alike. With the static
// shift a masked score clamps to 2^-120: the skipped keys add (count) *
// 2^-120 to the row sum in closed form, and their one quantized value
// rint(2^-120 * r + zp_p) is checked; if it is not zp_p for some row, the
// block walks every key tile in its last sweep.
//
// Numerics as in csrc/attention_hs.cu: the integer products are exact;
// every float step keeps the JAX op order, with _rn intrinsics (no FMA
// contraction), IEEE division (div_rn from the divisor's reciprocal, or
// __fdiv_rn), half-to-even rounding, expf/exp2f (never __expf). The exact
// row sums take torch's order at every N where torch sums a row in one
// warp (kernels/attention.py::in_torch_order): strided loads below 128
// keys, 4-vectors with each row's unaligned head and tail from 128 on,
// the row's alignment taken from the plain version's q tiles of
// ``sum_tile`` rows. There the exact path equals the plain version bit
// for bit. The fast path's sums run in its own order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "attention_common.cuh"
#include "torch_order.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int PAD = 16;       // bytes of pad per row of an int8 tile
constexpr int VP = BK + PAD;  // row pitch of the v^T and p tiles (bytes)
constexpr int EP = BK + 4;    // row pitch of the exp tile (floats)
constexpr float kMaskedExp2 = 0x1p-120f;  // a clamped masked score

template <int D>
struct Tiles {
  static constexpr int DP = D < 32 ? 32 : D;  // the mma's k is 32 bytes
  static constexpr int QP = DP + PAD;         // row pitch of q and k (bytes)
  alignas(16) int8_t q[BQ * QP];     // q tile [row][d]
  alignas(16) int8_t k[2][BK * QP];  // key tiles [key][d]
  union {
    float e[BQ * EP];  // exact sweep 2: exp(s - m) [row][key]
    struct {
      int8_t vt[D * VP];  // last sweep: value tile [d][key]
      int8_t p[BQ * VP];  // last sweep: quantized probabilities [row][key]
    } pv;
  } u;
  int qsum[BQ];
  float mx[2][BQ];  // the key halves' row maxima
  float ls[2][BQ];  // the key halves' row sums (fast path)
  int ps[2][BQ];    // the key halves' row sums of pq
  int vsum[D];
  float l[BQ];      // the row sums (exact path)
};

// The 4 x 4 byte blocks (4 keys x 4 dims) of a V tile a thread moves:
// fetched from device memory a tile ahead, stored after the current
// tile's work.
template <int D>
struct Fetch {
  static constexpr int NB = (D * BK / 16 + kThreads - 1) / kThreads;
  uint32_t x[NB][4];
};

// the key tile at j0 into `k` (zero keys past N, zero dims past D)
template <int D>
__device__ __forceinline__ void stage_k(int8_t* k, const int8_t* xk,
                                        size_t base, int hd, int n, int j0,
                                        int tid) {
  constexpr int C16 = Tiles<D>::DP / 16;
  for (int idx = tid; idx < BK * C16; idx += kThreads) {
    const int key = idx / C16, c = idx - key * C16;
    const bool valid = j0 + key < n && 16 * c < D;
    cp_async16(k + key * Tiles<D>::QP + 16 * c,
               xk + base + (valid ? (size_t)(j0 + key) * hd + 16 * c : 0),
               valid);
  }
  cp_async_commit();
}

// the thread's blocks of the value tile at j0 (zero keys past N)
template <int D>
__device__ __forceinline__ void fetch_v(Fetch<D>& f, const int8_t* v,
                                        size_t base, int hd, int n, int j0,
                                        int tid) {
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
                            v + base + (size_t)(jg + a) * hd + 4 * db))
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
  const uint32_t ones[4] = {kOnes, kOnes, kOnes, kOnes};
  const int key = 32 * kh + (lane & 7) + 8 * (lane >> 4);
  const int byte = 16 * ((lane >> 3) & 1);
#pragma unroll
  for (int np = 0; np < 2; ++np) {
    int s0[4] = {0, 0, 0, 0}, s1[4] = {0, 0, 0, 0};
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[2 * np][e] = acc[2 * np + 1][e] = 0;
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

template <int D, bool BIAS, int MODE>
__global__ void __launch_bounds__(kThreads, 2)
    blockq_kernel(const int8_t* __restrict__ xq,
                  const int8_t* __restrict__ xk,
                  const int8_t* __restrict__ xv,
                  const float* __restrict__ bias, void* __restrict__ out,
                  const HSParams p) {
  using T = Tiles<D>;
  constexpr int DP = T::DP, QP = T::QP;
  constexpr int NTV = D / 16;  // context n-tiles per warp (D/2 dims)
  __shared__ T t;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int rg = warp >> 1, kh = warp & 1;
  const int b = blockIdx.z, h = blockIdx.y;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * BQ;  // heaviest tiles first
  const int n = p.N, hd = p.H * D;
  const size_t q_base = (size_t)b * p.nq * hd + (size_t)h * D;
  const size_t kv_base = (size_t)b * n * hd + (size_t)h * D;
  constexpr bool fast = MODE != kExact, shift = MODE == kShift;

  // the q tile (zero rows past nq, zero dims past D)
  for (int idx = tid; idx < BQ * (DP / 16); idx += kThreads) {
    const int r = idx / (DP / 16), c = idx % (DP / 16);
    const bool valid = r0 + r < p.nq && 16 * c < D;
    cp_async16(&t.q[r * QP + 16 * c],
               xq + q_base + (valid ? (size_t)(r0 + r) * hd + 16 * c : 0),
               valid);
  }
  cp_async_commit();
  cp_async_wait_all();
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
  int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;
  int walked = min(n, t_hi * BK) - t_lo * BK;  // real keys walked

  // the thread's two rows (tile rows ra, ra + 8)
  const int ra = 16 * rg + g;
  const int rows[2] = {r0 + ra, r0 + ra + 8};
  __syncthreads();
  const int rowc[2] = {hs_row_term<MODE, D>(p, t.qsum[ra]),
                       hs_row_term<MODE, D>(p, t.qsum[ra + 8])};
  const float* brow[2] = {nullptr, nullptr};
  if (BIAS)
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < p.nq) brow[i] = bias + ((size_t)h * p.nq + rows[i]) * n;

  // A sweep over the key tiles t_lo..t_hi - 1: tile j's copy into one
  // buffer runs while `body` works on the other; one barrier per tile
  // (after it, the tile has landed and every warp is done with the tile
  // before, so its buffer and the shared tiles may be rewritten).
  auto sweep = [&](auto&& body) {
    stage_k<D>(t.k[0], xk, kv_base, hd, n, t_lo * BK, tid);
    for (int tile = t_lo; tile < t_hi; ++tile) {
      const int cur = (tile - t_lo) & 1;
      cp_async_wait_all();
      __syncthreads();
      if (tile + 1 < t_hi)
        stage_k<D>(t.k[cur ^ 1], xk, kv_base, hd, n, (tile + 1) * BK, tid);
      body(tile, t.k[cur]);
    }
  };
  // the tile's scores of the thread's (row, key) pairs: s[nt][e]
  auto scores = [&](const int8_t* k, int j0, float (&s)[4][4]) {
    int acc[4][4], ks[4][2];
    tile_dots<D>(k, qa, kh, lane, acc, ks);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int col = j0 + 32 * kh + 8 * nt + 2 * tq + c;
        int kz;
        float colc;
        hs_key_terms<MODE>(p, ks[nt][c], kz, colc);
#pragma unroll
        for (int i = 0; i < 2; ++i)
          s[nt][2 * i + c] = hs_score<MODE, BIAS>(
              p, acc[nt][2 * i + c], rowc[i], kz, colc, col,
              col < n ? brow[i] : nullptr);
      }
    if (hs_tile_masked(p, r0, BQ, j0, BK)) {
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[nt][e] = hs_mask(p, s[nt][e], rows[e >> 1],
                             j0 + 32 * kh + 8 * nt + 2 * tq + (e & 1));
    }
  };

  // sweep 1: exact -- the row max; fast -- max and sum, online per lane;
  // static shift -- the clipped-exp2 sum
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  sweep([&](int tile, const int8_t* k) {
    const int j0 = tile * BK;
    float s[4][4];
    scores(k, j0, s);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      // the row's keys in this lane, -inf (exp 0) past N
      float v[8];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int c = 0; c < 2; ++c)
          v[2 * nt + c] = j0 + 32 * kh + 8 * nt + 2 * tq + c < n
                              ? s[nt][2 * i + c]
                              : -INFINITY;
      if (shift) {
#pragma unroll
        for (int j = 0; j < 8; ++j)
          if (j0 + 32 * kh + 8 * (j >> 1) + 2 * tq + (j & 1) < n)
            l[i] = __fadd_rn(l[i], hs_exp<MODE>(v[j], 0.f));
        continue;
      }
      float tm = v[0];
#pragma unroll
      for (int j = 1; j < 8; ++j) tm = fmaxf(tm, v[j]);
      if (!fast) {
        m[i] = fmaxf(m[i], tm);
      } else if (tm > -INFINITY) {
        const float mn = fmaxf(m[i], tm);
        float add = 0.f;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          add = __fadd_rn(add, hs_exp<MODE>(v[j], mn));
        l[i] = __fadd_rn(m[i] == -INFINITY
                             ? 0.f
                             : __fmul_rn(l[i], exp2f(__fsub_rn(m[i], mn))),
                         add);
        m[i] = mn;
      }
    }
  });
  // combine the 4 lanes of a row, then the two key halves
#pragma unroll
  for (int i = 0; i < 2; ++i) {
#pragma unroll
    for (int o = 1; o <= 2; o <<= 1) {
      const float mo = __shfl_xor_sync(0xffffffffu, m[i], o);
      const float lo2 = __shfl_xor_sync(0xffffffffu, l[i], o);
      if (!fast)
        m[i] = fmaxf(m[i], mo);
      else if (shift)
        l[i] = __fadd_rn(l[i], lo2);
      else
        hs_merge_online(m[i], l[i], mo, lo2);
    }
    if (tq == 0) {
      t.mx[kh][ra + 8 * i] = m[i];
      t.ls[kh][ra + 8 * i] = l[i];
    }
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int r = ra + 8 * i;
    if (!fast) {
      m[i] = fmaxf(t.mx[0][r], t.mx[1][r]);
    } else if (shift) {
      // the skipped keys each clamp to exactly 2^-120
      l[i] = __fadd_rn(__fadd_rn(t.ls[0][r], t.ls[1][r]),
                       __fmul_rn((float)(n - walked), kMaskedExp2));
    } else {
      m[i] = t.mx[0][r];
      l[i] = t.ls[0][r];
      hs_merge_online(m[i], l[i], t.mx[1][r], t.ls[1][r]);
    }
  }

  if (!fast) {
    // sweep 2 (exact): the row sum of expf(s - m) in torch's order; warp w
    // streams rows 8w..8w+7 of each exp tile, row 8w + i into a[i]
    float a[8][4];
#pragma unroll
    for (int i = 0; i < 8; ++i) a[i][0] = a[i][1] = a[i][2] = a[i][3] = 0.f;
    sweep([&](int tile, const int8_t* k) {
      const int j0 = tile * BK;
      float s[4][4];
      scores(k, j0, s);
#pragma unroll
      for (int nt = 0; nt < 4; ++nt)
#pragma unroll
        for (int i = 0; i < 2; ++i) {
          const float2 e2 = make_float2(hs_exp<MODE>(s[nt][2 * i], m[i]),
                                        hs_exp<MODE>(s[nt][2 * i + 1], m[i]));
          *reinterpret_cast<float2*>(
              &t.u.e[(ra + 8 * i) * EP + 32 * kh + 8 * nt + 2 * tq]) = e2;
        }
      __syncthreads();
      torch_order_stream_rows(a, &t.u.e[8 * warp * EP], EP, j0,
                              min(BK, n - j0), n,
                              (long long)b * p.head_total + p.head_base + h,
                              r0 + 8 * warp, p.nq, p.sum_tile, p.sum_vec,
                              p.sum_lanes, lane);
    });
#pragma unroll
    for (int i = 0; i < 8; ++i) {
      const float sum = torch_order_finish(a[i], p.sum_lanes);
      if (lane == 0) t.l[8 * warp + i] = sum;
    }
    __syncthreads();
    l[0] = t.l[ra];
    l[1] = t.l[ra + 8];
  }

  // the divisors' reciprocals (exact: for div_rn), the fast path's
  // r = 1 / (sum * sp)
  const float rl[2] = {__frcp_rn(l[0]), __frcp_rn(l[1])};
  const float rsp = __frcp_rn(p.sp);
  float rcp[2];
#pragma unroll
  for (int i = 0; i < 2; ++i)
    rcp[i] = fast ? __fdiv_rn(1.f, __fmul_rn(l[i], p.sp)) : 0.f;
  const bool need_lo = fast ? p.need_lo != 0 : true;
  const bool need_hi = fast ? p.need_hi != 0 : true;
  auto clip = [&](float x) {
    if (need_lo) x = fmaxf(x, p.qmin);
    if (need_hi) x = fminf(x, p.qmax);
    return x;
  };
  if (shift && walked < n) {
    // a skipped key's quantized probability must be zp_p, or the block
    // walks them all
    int need = 0;
#pragma unroll
    for (int i = 0; i < 2; ++i)
      if (rows[i] < p.nq &&
          __float2int_rn(clip(__fadd_rn(__fmul_rn(kMaskedExp2, rcp[i]),
                                        p.zp_pf))) != p.zp_p)
        need = 1;
    if (__syncthreads_or(need)) {
      t_lo = 0;
      t_hi = (n + BK - 1) / BK;
      walked = n;
    }
  }

  // last sweep: quantized probabilities, then P.V on the tensor cores
  int ctx[NTV][4];
#pragma unroll
  for (int nt = 0; nt < NTV; ++nt)
    ctx[nt][0] = ctx[nt][1] = ctx[nt][2] = ctx[nt][3] = 0;
  int psum[2] = {0, 0}, vsum = 0;
  Fetch<D> fv;
  __syncthreads();  // the exp tile (same shared bytes) is no longer read
  fetch_v<D>(fv, xv, kv_base, hd, n, t_lo * BK, tid);
  store_vt<D>(t.u.pv.vt, fv, tid);
  sweep([&](int tile, const int8_t* k) {
    const int j0 = tile * BK;
    const bool more = tile + 1 < t_hi;
    if (more) fetch_v<D>(fv, xv, kv_base, hd, n, j0 + BK, tid);
    float s[4][4];
    scores(k, j0, s);
#pragma unroll
    for (int nt = 0; nt < 4; ++nt)
#pragma unroll
      for (int i = 0; i < 2; ++i) {
        const int kj = 32 * kh + 8 * nt + 2 * tq;
        int pq[2];
#pragma unroll
        for (int c = 0; c < 2; ++c) {
          pq[c] = 0;  // keys past N: no term
          if (j0 + kj + c < n) {
            const float e = hs_exp<MODE>(s[nt][2 * i + c], m[i]);
            const float x =
                fast ? __fadd_rn(__fmul_rn(e, rcp[i]), p.zp_pf)
                     : __fadd_rn(div_rn(div_rn(e, l[i], rl[i]), p.sp, rsp),
                                 p.zp_pf);
            pq[c] = __float2int_rn(clip(x));
          }
        }
        psum[i] += pq[0] + pq[1];
        *reinterpret_cast<uint16_t*>(&t.u.pv.p[(ra + 8 * i) * VP + kj]) =
            (uint16_t)((pq[0] & 0xff) | ((pq[1] & 0xff) << 8));
      }
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
      ldsm_x4(pa, &t.u.pv.p[(16 * rg + (lane & 7) + 8 * ((lane >> 3) & 1)) *
                                VP + 32 * kc + 16 * (lane >> 4)]);
      const int byte = 32 * kc + 16 * ((lane >> 3) & 1);
      if constexpr (NTV == 1) {
        uint32_t bb[2];
        ldsm_x2(bb, &t.u.pv.vt[(kh * (D / 2) + (lane & 7)) * VP + byte]);
        mma_s8(ctx[0], pa, bb[0], bb[1]);
      } else {
#pragma unroll
        for (int np = 0; np < NTV / 2; ++np) {
          uint32_t bb[4];
          ldsm_x4(bb, &t.u.pv.vt[(kh * (D / 2) + 16 * np + (lane & 7) +
                                  8 * (lane >> 4)) * VP + byte]);
          mma_s8(ctx[2 * np], pa, bb[0], bb[1]);
          mma_s8(ctx[2 * np + 1], pa, bb[2], bb[3]);
        }
      }
    }
    __syncthreads();
    if (more) store_vt<D>(t.u.pv.vt, fv, tid);
  });

  // epilogue: centred context, dequantize, optional requantize
  if (tid >= 128 && tid < 128 + D) t.vsum[tid - 128] = vsum;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 1);
    psum[i] += __shfl_xor_sync(0xffffffffu, psum[i], 2);
    if (tq == 0) t.ps[kh][ra + 8 * i] = psum[i];
  }
  __syncthreads();
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = rows[i];
    if (row >= p.nq) continue;
    const int ps = t.ps[0][ra + 8 * i] + t.ps[1][ra + 8 * i];
    const size_t o_row = q_base + (size_t)row * hd;
#pragma unroll
    for (int nt = 0; nt < NTV; ++nt) {
      const int d = kh * (D / 2) + 8 * nt + 2 * tq;
      float y[2];
#pragma unroll
      for (int c = 0; c < 2; ++c) {
        const int centred = ctx[nt][2 * i + c] - p.zv * ps -
                            p.zp_p * t.vsum[d + c] + p.zp_p * p.zv * walked;
        y[c] = __fmul_rn(__int2float_rn(centred), p.c_out);
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
cudaError_t launch(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                   const float* bias, void* out, const HSParams& p,
                   cudaStream_t stream) {
  const dim3 grid((p.nq + BQ - 1) / BQ, p.H, p.B);
  blockq_kernel<D, BIAS, MODE><<<grid, kThreads, 0, stream>>>(xq, xk, xv,
                                                              bias, out, p);
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
  if (p.sum_tile < 1) return (int)cudaErrorInvalidValue;
  switch (p.D) {
    case 16: return (int)launch_d<16>(q, k, v, b, out, p, s);
    case 32: return (int)launch_d<32>(q, k, v, b, out, p, s);
    case 64: return (int)launch_d<64>(q, k, v, b, out, p, s);
    case 128: return (int)launch_d<128>(q, k, v, b, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
