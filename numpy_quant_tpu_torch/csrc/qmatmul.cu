// Quantized matmul over packed integer weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels numpy_quant_tpu/kernels/qmatmul.py::
// splitk_qmatmul (split-K payload, 1/2/4/8 bits) and ::packed_qmatmul
// (bit-planes, any width 1..8). For x [M, K] and a packed symmetric
// weight W [K, N]:
//   xq  = x as int8, or quantize(x) (IEEE divide, +zp, clip, rint)
//   acc = xq @ W                  int32, exact
//   acc -= colsum[n] * x_zp       int32
//   y   = f32(acc) * scale_row[n] scale_row = x_scale * w_scale[n] (f32)
//   y  += bias[n]
//   out = y (f32), or int8 clip(rint(y * inv_res + res_zp))
//
// Bound at ViT-Base serving shapes on an H100 SXM (M = 96*197 = 18,912,
// int8 x, f32 out): memory. 768->3072 at 4 bits moves 14.5 MB of x,
// 1.2 MB of weight and 232 MB of f32 output, 74 us at 3.35 TB/s, against
// 2*M*N*K = 8.9e10 int8 operations, 45 us at 1,979 TOPS. The output
// dominates; the design keeps the int32 accumulator and the correction
// terms out of device memory and writes each output once.
//
// Design: one CTA of 8 warps per 128x128 output tile, K walked in steps
// of 64. Each step stages an int8 tile of x ([128][64], quantized on the
// fly when x is f32) and the weight tile decoded to int8 ([128 n][64 k],
// k contiguous) in shared memory, then runs mma.sync.m16n8k32 (s8 x s8 ->
// s32) on the tensor cores: each warp owns a 64x32 sub-tile, 16 mma per
// 32-deep k slice. Shared rows are 80 bytes, so the 8 rows x 4 words of
// a fragment load fall in 32 different banks. The packed payload is
// decoded in the load: split-K element (k, n) is bit field j = k / KR of
// byte (k - j*KR, n); bit-plane element (k, n) gathers bit k % 8 of
// planes[j][k / 8][n] over the planes. x is indexed at its own column k
// directly, so no padding and no re-split of x is needed: columns >= K
// and rows >= M load as 0, and the TPU wrapper's pad bytes (0xFF planes,
// _splitk_pad_byte) have no counterpart. Blocks walk N fastest, so the
// blocks resident together share their x tiles in L2. This simple design
// has no cp.async/TMA pipeline and no wgmma; those are later work.
//
// Numerics: the epilogue keeps the JAX kernels' order, one rounding per
// step, with the _rn intrinsics so that nvcc contracts nothing into an
// FMA; the quantize divides with __fdiv_rn and clips before rounding,
// the requantize multiplies by the host's f32(1/res_scale) and rounds
// before clipping; rounding is half-to-even (rintf, __float2int_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

struct QMMParams {
  int M, N, K, KR, bits, x_type, quantize_x, has_zp, x_zp, has_bias,
      has_wvec, out_int8, has_res_zp, x_vec, w_vec;
  float x_scale, scale, inv_res, res_zp, xq_lo, xq_hi, rq_lo, rq_hi;
};

namespace {

constexpr int kSplitK = 0;
constexpr int kBitPlanes = 1;

constexpr int BM = 128, BN = 128, BK = 64;
constexpr int LDS = BK + 16;  // shared row stride in bytes (20 words)
constexpr int kThreads = 256;

__device__ __forceinline__ void mma_s8(int* c, const uint32_t* a,
                                       const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k32.row.col.s32.s8.s8.s32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+r"(c[0]), "+r"(c[1]), "+r"(c[2]), "+r"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__device__ __forceinline__ uint32_t pack4(int a, int b, int c, int d) {
  return (uint32_t)(a & 0xff) | ((uint32_t)(b & 0xff) << 8) |
         ((uint32_t)(c & 0xff) << 16) | ((uint32_t)(d & 0xff) << 24);
}

// One x element as the int8 the product consumes.
__device__ __forceinline__ int to_q(int8_t v, const QMMParams&) { return v; }
__device__ __forceinline__ int to_q(int32_t v, const QMMParams&) {
  return (int8_t)v;  // astype(int8) of an already-quantized value
}
__device__ __forceinline__ int to_q(float v, const QMMParams& p) {
  float q = __fdiv_rn(v, p.x_scale);
  if (p.has_zp) q = __fadd_rn(q, (float)p.x_zp);
  q = fminf(fmaxf(q, p.xq_lo), p.xq_hi);
  return __float2int_rn(q);
}

// Stage x[m0:m0+BM, k0:k0+BK] as int8 in As, 4 columns (one word) per
// thread and step. Every global load of a batch is issued before the
// first is used, so the batch waits for memory once.
template <typename XT>
__device__ __forceinline__ void load_x(const XT* __restrict__ x, int8_t* As,
                                       int m0, int k0, const QMMParams& p) {
  constexpr int kWords = (BM * BK / 4) / kThreads;  // 8
  if (!p.x_vec) {
    // rows not 4-element aligned: element loads
#pragma unroll 2
    for (int it = 0; it < kWords; ++it) {
      const int idx = threadIdx.x + it * kThreads;
      const int row = idx >> 4, cw = idx & 15;
      const int gm = m0 + row, col = k0 + cw * 4;
      int q[4] = {0, 0, 0, 0};
      if (gm < p.M) {
        const XT* src = x + (size_t)gm * p.K + col;
#pragma unroll
        for (int e = 0; e < 4; ++e)
          if (col + e < p.K) q[e] = to_q(src[e], p);
      }
      *reinterpret_cast<uint32_t*>(As + row * LDS + cw * 4) =
          pack4(q[0], q[1], q[2], q[3]);
    }
    return;
  }
  // K % 4 == 0: a word is wholly inside or outside the row
  constexpr int kBatch = sizeof(XT) == 1 ? kWords : kWords / 2;
#pragma unroll
  for (int b0 = 0; b0 < kWords; b0 += kBatch) {
    uint4 raw[kBatch];
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (b0 + u) * kThreads;
      const int gm = m0 + (idx >> 4), col = k0 + (idx & 15) * 4;
      raw[u] = make_uint4(0, 0, 0, 0);
      if (gm < p.M && col < p.K) {
        const XT* src = x + (size_t)gm * p.K + col;
        if constexpr (sizeof(XT) == 1)
          raw[u].x = *reinterpret_cast<const uint32_t*>(src);
        else
          raw[u] = *reinterpret_cast<const uint4*>(src);
      }
    }
#pragma unroll
    for (int u = 0; u < kBatch; ++u) {
      const int idx = threadIdx.x + (b0 + u) * kThreads;
      const int gm = m0 + (idx >> 4), col = k0 + (idx & 15) * 4;
      uint32_t word = raw[u].x;
      if constexpr (sizeof(XT) == 4) {
        word = 0;
        if (gm < p.M && col < p.K)
          word = pack4(to_q(*reinterpret_cast<const XT*>(&raw[u].x), p),
                       to_q(*reinterpret_cast<const XT*>(&raw[u].y), p),
                       to_q(*reinterpret_cast<const XT*>(&raw[u].z), p),
                       to_q(*reinterpret_cast<const XT*>(&raw[u].w), p));
      }
      *reinterpret_cast<uint32_t*>(As + (idx >> 4) * LDS + (idx & 15) * 4) =
          word;
    }
  }
}

// Four consecutive payload bytes of one row, columns gn..gn+3 (bytes
// past N read as 0).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ src,
                                          int gn, const QMMParams& p) {
  if (p.w_vec) return *reinterpret_cast<const uint32_t*>(src);
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (gn + c < p.N) v |= (uint32_t)src[c] << (8 * c);
  return v;
}

// Decode W[k0:k0+BK, n0:n0+BN] to int8 in Bs, stored [n][k] (k
// contiguous, the mma "col" operand). A thread decodes 4x4 blocks (4
// rows k, 4 columns n) from word loads along n; a warp's loads cover 32
// bytes of each of 4 rows. All loads of the tile are issued first.
template <int LAYOUT>
__device__ __forceinline__ void load_w(const uint8_t* __restrict__ w,
                                       int8_t* Bs, int n0, int k0,
                                       const QMMParams& p) {
  constexpr int kBlocks = (BN / 4) * (BK / 4) / kThreads;  // 2
  constexpr int kRaw = LAYOUT == kSplitK ? 4 : 8;  // rows, or planes
  const int mask = (1 << p.bits) - 1;
  const int offset = 1 << (p.bits - 1);
  uint32_t raw[kBlocks][kRaw];
  int field[kBlocks][4];
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    // idx bits 0-2 and 5-6: column block; bits 3-4 and 7-8: row block
    const int idx = threadIdx.x + b * kThreads;
    const int n4 = (idx & 7) | (((idx >> 5) & 3) << 3);
    const int kq = ((idx >> 3) & 3) | ((idx >> 7) << 2);
    const int gn = n0 + n4 * 4, kv0 = k0 + kq * 4;
    const bool live = gn < p.N && kv0 < p.K;
    if (LAYOUT == kSplitK) {
      int j = p.bits == 8 ? 0 : kv0 / p.KR;
      int i = kv0 - j * p.KR;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        raw[b][e] = (live && kv0 + e < p.K)
                        ? load4(w + (size_t)i * p.N + gn, gn, p) : 0u;
        field[b][e] = j * p.bits;
        if (++i == p.KR) {
          i = 0;
          ++j;
        }
      }
    } else {
      const size_t base = (size_t)(kv0 >> 3) * p.N + gn;
#pragma unroll
      for (int j = 0; j < kRaw; ++j)
        raw[b][j] = (live && j < p.bits)
                        ? load4(w + (size_t)j * p.KR * p.N + base, gn, p)
                        : 0u;
    }
  }
#pragma unroll
  for (int b = 0; b < kBlocks; ++b) {
    const int idx = threadIdx.x + b * kThreads;
    const int n4 = (idx & 7) | (((idx >> 5) & 3) << 3);
    const int kq = ((idx >> 3) & 3) | ((idx >> 7) << 2);
    const int gn = n0 + n4 * 4, kv0 = k0 + kq * 4;
    const int sh = kv0 & 7;  // bit-planes: bit of row kv0 in its byte
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      int q[4] = {0, 0, 0, 0};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        int v;
        if (LAYOUT == kSplitK) {
          const int byte = (raw[b][e] >> (8 * c)) & 0xff;
          v = p.bits == 8 ? (int)(int8_t)byte
                          : ((byte >> field[b][e]) & mask) - offset;
        } else {
          v = 0;
#pragma unroll
          for (int j = 0; j < kRaw; ++j)
            v |= ((raw[b][j] >> (8 * c + sh + e)) & 1) << j;
          v -= offset;
        }
        if (gn + c < p.N && kv0 + e < p.K) q[e] = v;
      }
      *reinterpret_cast<uint32_t*>(Bs + (n4 * 4 + c) * LDS + kq * 4) =
          pack4(q[0], q[1], q[2], q[3]);
    }
  }
}

template <int LAYOUT, typename XT>
__global__ void __launch_bounds__(kThreads)
    qmatmul_kernel(const XT* __restrict__ x, const uint8_t* __restrict__ w,
                   const int* __restrict__ colsum,
                   const float* __restrict__ wvec,
                   const float* __restrict__ bias, void* __restrict__ out,
                   const QMMParams p) {
  __shared__ __align__(16) int8_t As[BM * LDS];
  __shared__ __align__(16) int8_t Bs[BN * LDS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 2, wn = warp & 3;  // 2 x 4 warps, 64x32 each
  const int g = lane >> 2, t = lane & 3;
  const int n0 = blockIdx.x * BN, m0 = blockIdx.y * BM;

  int acc[4][4][4];
#pragma unroll
  for (int mi = 0; mi < 4; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int r = 0; r < 4; ++r) acc[mi][ni][r] = 0;

  for (int k0 = 0; k0 < p.K; k0 += BK) {
    load_x<XT>(x, As, m0, k0, p);
    load_w<LAYOUT>(w, Bs, n0, k0, p);
    __syncthreads();
#pragma unroll
    for (int ks = 0; ks < BK; ks += 32) {
      uint32_t a[4][4], b[4][2];
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
        const int8_t* r0 = As + (wm * 64 + mi * 16 + g) * LDS + ks + t * 4;
        a[mi][0] = *reinterpret_cast<const uint32_t*>(r0);
        a[mi][1] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS);
        a[mi][2] = *reinterpret_cast<const uint32_t*>(r0 + 16);
        a[mi][3] = *reinterpret_cast<const uint32_t*>(r0 + 8 * LDS + 16);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const int8_t* c0 = Bs + (wn * 32 + ni * 8 + g) * LDS + ks + t * 4;
        b[ni][0] = *reinterpret_cast<const uint32_t*>(c0);
        b[ni][1] = *reinterpret_cast<const uint32_t*>(c0 + 16);
      }
#pragma unroll
      for (int mi = 0; mi < 4; ++mi)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) mma_s8(acc[mi][ni], a[mi], b[ni]);
    }
    __syncthreads();
  }

#pragma unroll
  for (int ni = 0; ni < 4; ++ni) {
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int n = n0 + wn * 32 + ni * 8 + t * 2 + e;
      if (n >= p.N) continue;
      const int corr = p.has_zp ? colsum[n] * p.x_zp : 0;
      const float s = p.has_wvec ? __fmul_rn(p.x_scale, wvec[n]) : p.scale;
      const float bn = p.has_bias ? bias[n] : 0.0f;
#pragma unroll
      for (int mi = 0; mi < 4; ++mi) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int m = m0 + wm * 64 + mi * 16 + g + h * 8;
          if (m >= p.M) continue;
          const int v = acc[mi][ni][h * 2 + e] - corr;
          float y = __fmul_rn(__int2float_rn(v), s);
          if (p.has_bias) y = __fadd_rn(y, bn);
          const size_t o = (size_t)m * p.N + n;
          if (p.out_int8) {
            float q = __fmul_rn(y, p.inv_res);
            if (p.has_res_zp) q = __fadd_rn(q, p.res_zp);
            q = fminf(fmaxf(rintf(q), p.rq_lo), p.rq_hi);
            static_cast<int8_t*>(out)[o] = (int8_t)__float2int_rn(q);
          } else {
            static_cast<float*>(out)[o] = y;
          }
        }
      }
    }
  }
}

template <int LAYOUT>
int launch(const void* x, const void* w, const void* colsum,
           const void* wvec, const void* bias, void* out,
           const QMMParams* params, void* stream) {
  const QMMParams p = *params;
  if (p.bits < 1 || p.bits > 8 || p.KR < 1) return (int)cudaErrorInvalidValue;
  const dim3 grid((p.N + BN - 1) / BN, (p.M + BM - 1) / BM);
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* wp = static_cast<const uint8_t*>(w);
  const auto* cs = static_cast<const int*>(colsum);
  const auto* wv = static_cast<const float*>(wvec);
  const auto* bp = static_cast<const float*>(bias);
  switch (p.x_type) {
    case 0:
      qmatmul_kernel<LAYOUT, int8_t><<<grid, kThreads, 0, s>>>(
          static_cast<const int8_t*>(x), wp, cs, wv, bp, out, p);
      break;
    case 1:
      qmatmul_kernel<LAYOUT, int32_t><<<grid, kThreads, 0, s>>>(
          static_cast<const int32_t*>(x), wp, cs, wv, bp, out, p);
      break;
    case 2:
      qmatmul_kernel<LAYOUT, float><<<grid, kThreads, 0, s>>>(
          static_cast<const float*>(x), wp, cs, wv, bp, out, p);
      break;
    default:
      return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() of the launch.
// Pointers: x [M, K] (int8, int32 or f32 by x_type), the packed payload,
// colsum int32 [N], wvec f32 [N] or null, bias f32 [N] or null, out
// [M, N] (f32, or int8 when out_int8).
extern "C" int nq_splitk_qmatmul(const void* x, const void* packed,
                                 const void* colsum, const void* wvec,
                                 const void* bias, void* out,
                                 const QMMParams* params, void* stream) {
  return launch<kSplitK>(x, packed, colsum, wvec, bias, out, params, stream);
}

extern "C" int nq_packed_qmatmul(const void* x, const void* planes,
                                 const void* colsum, const void* wvec,
                                 const void* bias, void* out,
                                 const QMMParams* params, void* stream) {
  return launch<kBitPlanes>(x, planes, colsum, wvec, bias, out, params,
                            stream);
}
