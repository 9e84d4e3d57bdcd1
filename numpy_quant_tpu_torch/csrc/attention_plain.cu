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
// 6.9e10 ops, takes 0.035 ms at 1,979 TOPS. It is bound by operations.
//
// Design (csrc/attention_hs_blockq.cu's exact path, on this layout): one
// CTA of 256 threads per (tile of BQ=64 query rows, head). The q tile stays
// in shared memory; K^T and V stream through shared memory in tiles of
// BK=64 keys, so a block holds ~18 KB at D=64 whatever N is. A K^T tile is
// D rows of BK contiguous keys: it is read coalesced along N (4-byte loads
// when N is a multiple of 4, bytes otherwise) and its bytes land key-major
// in shared memory, so that each key is D/4 int8x4 words for __dp4a. Each
// thread owns a 4x4 patch of the 64x64 score tile (rows 4*ty.., keys
// tx+16*j) and computes it with __dp4a on the integer ALUs; row reductions
// run over the 16 threads of a row with warp shuffles. Three sweeps over
// the key tiles, each recomputing s from the exact integer dots: 1. the
// row max; 2. the row sum of expf(s - m); 3. probs = e / sum (__fdiv_rn),
// quantized as rint(clip(probs / sp + zp_p)) into a shared int8 tile, then
// P.V. There is no online rescaling: the quantized probabilities need the
// final max and sum, rounded as the unfused executor rounds them.
//
// The context is kept in centred form: sum_j (pq_j - zp_p)(v_j - zv) =
// sum pq v - zv sum pq - zp_p sum v + zp_p zv n over the keys the block
// walked, all in int32 (|.| <= 255^2 * N < 2^31, so N <= 33,000). It equals
// the TPU kernel's uncentred algebra over its 128-lane padded keys exactly,
// because pad keys have pq = zp_p (their score is -inf) and v = zv. The
// zq*zk term counts the real head dim D (the TPU pads D to 128 with zeros).
//
// Causal tile skipping (``skip``, set by the wrapper only when a static
// bound from the qparams proves it exact): a key tile masked for every row
// of the block -- right of the diagonal, or left of the sliding window's
// band -- is not walked. A masked score gives e = expf(s + mask - m) = 0
// exactly, so pq = rint(0 / sp + zp_p) = zp_p and its centred term is 0:
// skipping changes no bit.
//
// Numerics: the JAX op order, _rn intrinsics (no FMA contraction), IEEE
// division, half-to-even rounding, expf (never __expf). The row sum of
// sweep 2 runs in the order of torch's CUDA sum (torch_order.cuh): for
// N >= 128 with N % 4 == 0, where torch reduces a row in one warp, it adds
// the same numbers in the same order as the unfused executor's softmax, so
// the kernel equals it bit for bit. At other N torch reduces in other
// orders, and a quantized probability may differ by one step from the
// plain version.
//
// This simple design runs both products on the integer ALUs and reads K^T
// three times; mma.sync/wgmma products and TMA are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

// Mirror of kernels/attention.py::_PlainParams.
struct PlainParams {
  int BH, N, D, zq, zk, zv, zp_p, out_int8, has_res_zp, causal, window, skip;
  float c_score, scaling, sp, zp_pf, c_out, res_scale, res_zp, qmin, qmax,
      mask;
};

namespace {

constexpr int kThreads = 256;
constexpr int BQ = 64;          // query rows per block
constexpr int BK = 64;          // keys per tile
constexpr int RPT = BQ / 16;    // rows per thread
constexpr int KPT = BK / 16;    // keys per thread
constexpr int PW = BK / 4 + 1;  // padded word stride of K-major P and V^T rows
constexpr int kOnes = 0x01010101;

template <int D>
struct Tiles {
  int q[BQ][D / 4 + 1];  // q tile, int8x4 words, rows padded one word
  int k[BK][D / 4 + 1];  // key tile, key-major (transposed from k^T)
  int vt[D][PW];         // value tile transposed: vt[d] holds keys 0..BK-1
  int p[BQ][PW];         // quantized probabilities, int8 [row][key]
  int qsum[BQ];
  int ksum[BK];
};

__device__ __forceinline__ void put4(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

// the max over the 16 threads of one row (a half warp)
__device__ __forceinline__ float row_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// the key tile at j0 from k^T (D rows of N keys; zero keys past N), stored
// key-major; its per-key sums follow after a barrier (load_ksum)
template <int D>
__device__ __forceinline__ void load_kt(Tiles<D>& t, const int8_t* kt,
                                        size_t kt_base, int n, int j0,
                                        int tid) {
  if ((n & 3) == 0) {
    // 4-byte loads of 4 neighbouring keys: aligned, since N, the head's
    // base (bh * D * N) and j0 are multiples of 4
    constexpr int C4 = BK / 4;
    for (int idx = tid; idx < D * C4; idx += kThreads) {
      const int d = idx / C4, c = idx - d * C4;
      int w = 0;
      if (j0 + 4 * c < n)
        w = __ldg(reinterpret_cast<const int*>(kt + kt_base + (size_t)d * n +
                                               j0 + 4 * c));
#pragma unroll
      for (int e = 0; e < 4; ++e)
        reinterpret_cast<int8_t*>(t.k[4 * c + e])[d] =
            (int8_t)(w >> (8 * e));
    }
  } else {
    for (int idx = tid; idx < D * BK; idx += kThreads) {
      const int d = idx / BK, j = idx - d * BK;
      int8_t b = 0;
      if (j0 + j < n) b = kt[kt_base + (size_t)d * n + j0 + j];
      reinterpret_cast<int8_t*>(t.k[j])[d] = b;
    }
  }
}

template <int D>
__device__ __forceinline__ void load_ksum(Tiles<D>& t, int tid) {
  if (tid < BK) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < D / 4; ++w) s = __dp4a(t.k[tid][w], kOnes, s);
    t.ksum[tid] = s;
  }
}

// the value tile at j0, transposed into vt[d][key] bytes (zero past N)
template <int D>
__device__ __forceinline__ void load_vt(Tiles<D>& t, const int8_t* v,
                                        size_t v_base, int n, int j0,
                                        int tid) {
  constexpr int C16 = D / 16;
  for (int idx = tid; idx < BK * C16; idx += kThreads) {
    const int j = idx / C16, c = idx - j * C16;
    int4 val = make_int4(0, 0, 0, 0);
    if (j0 + j < n)
      val = __ldg(reinterpret_cast<const int4*>(v + v_base +
                                                (size_t)(j0 + j) * D + c * 16));
    const int8_t* bytes = reinterpret_cast<const int8_t*>(&val);
#pragma unroll
    for (int e = 0; e < 16; ++e)
      reinterpret_cast<int8_t*>(t.vt[c * 16 + e])[j] = bytes[e];
  }
}

// the thread's 4x4 patch of dequantized (and masked) scores of the tile at
// j0: rows 4*ty + i, keys tx + 16*j, in _attention_kernel's op order
template <int D>
__device__ __forceinline__ void tile_scores(const Tiles<D>& t,
                                            const PlainParams& p, int ty,
                                            int tx, int r0, int j0,
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
      int a = acc[i][j];
      if (p.zk) a -= t.qsum[r] * p.zk;
      if (p.zq) a -= t.ksum[kj] * p.zq;
      if (p.zq && p.zk) a += p.zq * p.zk * D;
      float v = __fmul_rn(__fmul_rn(__int2float_rn(a), p.c_score), p.scaling);
      // decoder mask at the graph Add's position
      if (p.causal && !(col <= row && (p.window <= 0 || col > row - p.window)))
        v = __fadd_rn(v, p.mask);
      s[i][j] = v;
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
    plain_kernel(const int8_t* __restrict__ q, const int8_t* __restrict__ kt,
                 const int8_t* __restrict__ v, void* __restrict__ out,
                 const PlainParams p) {
  constexpr int W = D / 4;
  constexpr int C16 = D / 16;
  constexpr int DPT = D / 16;  // output columns per thread
  __shared__ Tiles<D> t;
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int bh = blockIdx.y, r0 = blockIdx.x * BQ;
  const int n = p.N;
  const size_t base = (size_t)bh * n * D;  // q, k^T, v and out alike

  for (int idx = tid; idx < BQ * C16; idx += kThreads) {
    const int r = idx / C16, c = idx - r * C16;
    int4 val = make_int4(0, 0, 0, 0);
    if (r0 + r < n)
      val = __ldg(reinterpret_cast<const int4*>(q + base +
                                                (size_t)(r0 + r) * D + c * 16));
    put4(&t.q[r][c * 4], val);
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
  const int t_lo = lo / BK, t_hi = (hi + BK - 1) / BK;
  const int walked = min(n, t_hi * BK) - t_lo * BK;  // real keys walked

  float m[RPT], l[RPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) m[i] = -INFINITY;

  // sweep 1: the row max
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK;
    __syncthreads();
    load_kt(t, kt, base, n, j0, tid);
    __syncthreads();
    load_ksum(t, tid);
    __syncthreads();
    float s[RPT][KPT];
    tile_scores(t, p, ty, tx, r0, j0, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j)
        if (j0 + tx + 16 * j < n) m[i] = fmaxf(m[i], s[i][j]);
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) m[i] = row_max(m[i]);

  // sweep 2: the row sum of expf(s - m) in torch's order: the thread's
  // share of the row's 128 partial sums (key tx + 16 j + 64 h, mod 128)
  float part[2][RPT][KPT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int i = 0; i < RPT; ++i)
#pragma unroll
      for (int j = 0; j < KPT; ++j) part[h][i][j] = 0.f;
  for (int tile = t_lo; tile < t_hi; ++tile) {
    const int j0 = tile * BK;
    __syncthreads();
    load_kt(t, kt, base, n, j0, tid);
    __syncthreads();
    load_ksum(t, tid);
    __syncthreads();
    float s[RPT][KPT];
    tile_scores(t, p, ty, tx, r0, j0, s);
    // the parity of the tile is the half of the 128-key period it fills
    if (tile & 1) {
      torch_order_add_exp(part[1], s, m, j0, tx, n);
    } else {
      torch_order_add_exp(part[0], s, m, j0, tx, n);
    }
  }
#pragma unroll
  for (int i = 0; i < RPT; ++i) l[i] = torch_order_tile_sum(part, i);

  // sweep 3: quantized probabilities, then P.V in int32
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
    load_kt(t, kt, base, n, j0, tid);
    load_vt(t, v, base, n, j0, tid);
    __syncthreads();
    load_ksum(t, tid);
    __syncthreads();
    float s[RPT][KPT];
    tile_scores(t, p, ty, tx, r0, j0, s);
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      int8_t* prow = reinterpret_cast<int8_t*>(t.p[ty * RPT + i]);
#pragma unroll
      for (int j = 0; j < KPT; ++j) {
        const int kj = tx + 16 * j;
        int8_t pq = 0;  // keys past N: no term
        if (j0 + kj < n) {
          const float prob = __fdiv_rn(expf(__fsub_rn(s[i][j], m[i])), l[i]);
          const float x = __fadd_rn(__fdiv_rn(prob, p.sp), p.zp_pf);
          pq = (int8_t)__float2int_rn(fminf(fmaxf(x, p.qmin), p.qmax));
        }
        prow[kj] = pq;
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
    if (row >= n) continue;
    const size_t o_row = base + (size_t)row * D;
#pragma unroll
    for (int c = 0; c < DPT; ++c) {
      const int d = tx + 16 * c;
      const long long centred = (long long)acc[i][c] -
                                (long long)p.zv * psum[i] -
                                (long long)p.zp_p * vsum[c] +
                                (long long)p.zp_p * p.zv * walked;
      const float y = __fmul_rn(__int2float_rn((int)centred), p.c_out);
      if (p.out_int8) {
        float yq = __fdiv_rn(y, p.res_scale);
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
  if (p.BH > 65535) return (int)cudaErrorInvalidValue;  // grid.y limit
  switch (p.D) {
    case 16: return (int)launch<16>(qq, kk, vv, out, p, s);
    case 32: return (int)launch<32>(qq, kk, vv, out, p, s);
    case 64: return (int)launch<64>(qq, kk, vv, out, p, s);
    case 128: return (int)launch<128>(qq, kk, vv, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
