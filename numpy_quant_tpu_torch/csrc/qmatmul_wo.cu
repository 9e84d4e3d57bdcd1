// Weight-only matmul over a split-K packed weight, for Hopper (sm_90a).
//
// Replaces the TPU kernel numpy_quant_tpu/kernels/qmatmul.py::
// splitk_wo_matmul (body _splitk_wo_kernel). For x [M, K] (f32 or bf16)
// and a split-K payload (uint8 [KR, N] at 1/2/4 bits, r = 8/bits values
// per byte; int8 [K, N] at 8 bits) with a per-tensor, per-channel [1, N]
// or grouped [K/gsz, N] scale s:
//   w[v, n]  = bit field j of byte (i, n) minus 2^(bits-1), v = j*KR + i
//   wf[v, n] = to_x_dtype(f32(w) * s[v / gsz, n])   one product, one rounding
//   y[m, n]  = to_x_dtype(sum_v f32(x[m, v]) * f32(wf[v, n]))
// bf16 x runs the sum on the tensor cores (mma.sync m16n8k16, bf16
// operands, f32 sums: the products of two bf16 values are exact in f32).
// f32 x runs it on the CUDA cores (fmaf), never on TF32 tensor cores: the
// TPU kernel's f32 dot runs at Precision.HIGHEST.
//
// Bound at GPT-2 decode shapes (M = 8) on an H100 SXM: memory. The LM head
// 768 -> 50257 at 4 bits moves 19.3 MB of payload and 1.2 MB of g=128
// scales (6.1 us at 3.35 TB/s) against 2*8*768*50257 = 0.62 GFLOP (9 us
// at the 67 TFLOP/s f32 rate of the CUDA cores, 0.6 us on bf16 tensor
// cores); the per-layer shapes move 0.3-1.2 MB each, below a launch's
// own cost, so there the latency of one launch is what counts.
//
// Design: one launch, no workspace. A block of 8 warps owns 32 output
// columns and 8 rows of x; the packed rows are split across the blocks of
// a thread-block cluster along K (grid.y = the cluster size, planned on
// the host by kernels/qmatmul.py::wo_plan so that about one to two blocks
// per SM are in flight), and inside a block across its warps. The K walk
// runs in chunks of 16 values of v (16/r packed rows, all r bit fields):
// a thread holds the chunk's values 2tq, 2tq+1, 2tq+8 and 2tq+9 of the 4
// neighbouring columns 4g..4g+3 of one 4-byte payload word per packed row
// (lane = 4g + tq), decodes each field (its f32 value formed exactly with
// a byte permute into 2^23 + u), scales it and rounds it as the TPU kernel
// does. In bf16 the 16 weights are the A fragments of two m16n8k16
// products, with the operands swapped: A = W^T (16 output columns x 16
// values of v), built in registers straight from the payload; B = x^T (16
// values x the 8 rows of x) from shared memory, where x is staged in chunk
// order with 16-byte loads; the accumulators hold y^T. The weight never
// lands in shared memory. In f32 the same weights meet x in fmaf. The
// decode shapes are latency-bound, so every load a warp needs is issued
// before any is used: the bf16 fast form (4-byte payload words, float4
// scale rows, one scale group per field in a chunk) issues its payload and
// scale loads, then x's, and waits once; the general form stages the
// block's scale rows in shared memory beside x. The warps' sums meet in
// shared memory and are added in warp order; each rank of the cluster
// then sends every output of its tile to the rank that finishes it
// (distributed shared memory), and after one cluster barrier each rank
// adds its slice in rank order. No float atomics: every output is the same
// sum in the same order on every run, so a decode loop gives the same
// tokens run to run. Large M is tiled 8 rows per block (grid.z) and
// re-reads the weight per tile: right, not fast. The TPU wrapper's padding
// (_splitk_pad_byte, per-field re-split of x, per-field scale rows)
// becomes bounds guards: v < K, n < N.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace cg = cooperative_groups;

// Mirror of kernels/qmatmul.py::_WOParams.
struct WOParams {
  int M, N, K, KR, bits, x_bf16, scale_rows, gsz, gsz_log2, cluster,
      rows_per_rank, w_vec, s_vec, scale_smem, fast, x_vec;
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int BN = 32;    // output columns per block
constexpr int MT = 8;     // rows of x per block (the mma's n8)
constexpr int CH = 16;    // values of v per chunk (the mma's k16)
constexpr int XCH = 32;   // chunks of x staged at a time
constexpr int XP = XCH * CH + 8;  // row pitch of the staged x (elements)
constexpr int LB = 8;     // scale staging loads a thread issues at once
constexpr int U = 4;      // chunks whose loads a warp issues before using
constexpr int kOut = MT * BN;

__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}

// Four consecutive payload bytes of one row, columns gn..gn+3 (bytes past
// N read as 0).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ src,
                                          int gn, const WOParams& p) {
  if (gn >= p.N) return 0u;
  if (p.w_vec) return __ldg(reinterpret_cast<const unsigned int*>(src));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (gn + c < p.N) v |= (uint32_t)__ldg(src + c) << (8 * c);
  return v;
}

// c += a (16 x 16, row) * b (16 x 8, col), bf16 operands, f32 sums
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0, %1, %2, %3}, "
      "{%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The four columns' values of bit field j in the payload word raw
// (columns gn..gn+3), minus 2^(bits-1): each formed exactly as the f32
// 2^23 + u (its low byte u placed by a byte permute) minus 2^23 + offset.
template <int BITS>
__device__ __forceinline__ void decode4(uint32_t raw, int j, float (&f)[4]) {
  constexpr uint32_t kMask = ((1u << BITS) - 1) * 0x01010101u;
  constexpr float kBias = 8388608.f + (BITS == 8 ? 128.f : (1 << (BITS - 1)));
  const uint32_t u = BITS == 8 ? raw ^ 0x80808080u : (raw >> (j * BITS)) & kMask;
#pragma unroll
  for (int q = 0; q < 4; ++q)
    f[q] = __fsub_rn(__uint_as_float(__byte_perm(u, 0x4B000000u, 0x7540 | q)),
                     kBias);
}

// One chunk's dequantized weights wf[e][q]: value slot[e] of the chunk
// (packed row row0 + slot / R, bit field slot % R), column gn + q: the
// field times its scale (staged rows sc when p.scale_smem, else read from
// the scale rows), one f32 product as the TPU kernel; the caller rounds it
// to x's type.
template <int BITS>
__device__ __forceinline__ void dequant(const uint32_t (&raw)[4],
                                        const int (&slot)[4], int row0,
                                        const float* sc,
                                        const float* __restrict__ scale,
                                        int gn, int g, const WOParams& p,
                                        float (&wf)[4][4]) {
  constexpr int R = 8 / BITS;
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int j = slot[e] % R, v = j * p.KR + row0 + slot[e] / R;
    float s[4];
    if (p.scale_rows == 0) {
      s[0] = s[1] = s[2] = s[3] = p.scale;
    } else {
      const int grp =
          min(p.gsz_log2 >= 0 ? v >> p.gsz_log2 : v / p.gsz, p.scale_rows - 1);
      if (p.scale_smem) {
        const float4 s4 = *reinterpret_cast<const float4*>(&sc[grp * BN + 4 * g]);
        s[0] = s4.x; s[1] = s4.y; s[2] = s4.z; s[3] = s4.w;
      } else {
        const float* row = scale + (size_t)grp * p.N + gn;
#pragma unroll
        for (int q = 0; q < 4; ++q) s[q] = gn + q < p.N ? __ldg(row + q) : 0.f;
      }
    }
    float f[4];
    decode4<BITS>(raw[e], j, f);
#pragma unroll
    for (int q = 0; q < 4; ++q) wf[e][q] = __fmul_rn(f[q], s[q]);
  }
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// the two bf16 m16n8k16 products of one chunk: weights wf (A = W^T, rows g
// and g + 8 being columns 4g + 2mt and 4g + 2mt + 1), x^T from the staged
// x row g (values 2tq, 2tq + 1 and 2tq + 8, 2tq + 9 of the chunk)
__device__ __forceinline__ void chunk_mma(float (&acc)[2][4],
                                          const float (&wf)[4][4],
                                          const unsigned short* xc, int tq) {
  const uint32_t b0 = *reinterpret_cast<const uint32_t*>(xc + 2 * tq);
  const uint32_t b1 = *reinterpret_cast<const uint32_t*>(xc + 2 * tq + 8);
#pragma unroll
  for (int mt = 0; mt < 2; ++mt) {
    const uint32_t a[4] = {pack_bf16(wf[0][2 * mt], wf[1][2 * mt]),
                           pack_bf16(wf[0][2 * mt + 1], wf[1][2 * mt + 1]),
                           pack_bf16(wf[2][2 * mt], wf[3][2 * mt]),
                           pack_bf16(wf[2][2 * mt + 1], wf[3][2 * mt + 1])};
    mma_bf16(acc[mt], a, b0, b1);
  }
}

template <int BITS, typename T, bool FAST>
__global__ void __launch_bounds__(kThreads)
    wo_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out,
              const WOParams p) {
  constexpr int R = 8 / BITS;    // bit fields per byte
  constexpr int RPC = CH / R;    // packed rows per chunk
  constexpr int SR = XCH * RPC;  // packed rows per staged step
  constexpr bool kBf16 = std::is_same<T, __nv_bfloat16>::value;
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem);  // [kWarps][MT][BN]
  float* recv = red + kWarps * kOut;            // [cluster][kOut / cluster]
  T* xs = reinterpret_cast<T*>(recv + kOut);    // [MT][XP], by chunk value
  float* sc = reinterpret_cast<float*>(xs + MT * XP);  // [scale_rows][BN]

  // a block may write another's shared memory only once every block of
  // the cluster runs: arrive now, wait before the first remote write
  if (p.cluster > 1) asm volatile("barrier.cluster.arrive.relaxed.aligned;\n");
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int g = lane >> 2, tq = lane & 3;
  const int n0 = blockIdx.x * BN, gn = n0 + 4 * g;
  const int m0 = blockIdx.z * MT;
  const int i_begin = blockIdx.y * p.rows_per_rank;
  const int i_end = min(p.KR, i_begin + p.rows_per_rank);
  const int nch = i_end > i_begin ? (i_end - i_begin + RPC - 1) / RPC : 0;
  // the thread's four values of v in a chunk
  const int slot[4] = {2 * tq, 2 * tq + 1, 2 * tq + 8, 2 * tq + 9};

  // bf16: acc[mt][..] = y^T rows (columns 4g + 2mt, +1) x rows (2tq, +1);
  // f32: acc[m][q] = y[m0 + m][gn + q], summed over the thread's values
  float acc[kBf16 ? 2 : MT][4];
#pragma unroll
  for (int a = 0; a < (kBf16 ? 2 : MT); ++a)
    acc[a][0] = acc[a][1] = acc[a][2] = acc[a][3] = 0.f;

  for (int c0 = 0; c0 == 0 || c0 < nch; c0 += XCH) {
    const int cn = max(0, min(XCH, nch - c0));
    const int r_step = i_begin + c0 * RPC;  // first packed row of the step
    const int len = min(SR, i_end - r_step), lenp = cn * RPC;
    // bf16: warp w stages row m0 + w of x, its R runs j * KR + r_step..
    // of len values (zero past the rank's rows, K and M), into
    // xs[w][chunk * 16 + s] (value s of a chunk: row s / R, field s % R);
    // the loads are issued at once, the stores wait for all of them
    auto stage_x_bf16 = [&]() {
      const unsigned short* xh = reinterpret_cast<const unsigned short*>(x);
      const int gm = m0 + warp;
      unsigned short* xr = reinterpret_cast<unsigned short*>(xs) + warp * XP;
      if (p.x_vec) {
        // 16-byte loads: lane t takes values 8 (t + 32 u)..+7 of the R runs
        // (K, KR and the rank's rows are multiples of 8)
        uint4 xv[2];
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = lane + 32 * u, j = idx / (SR / 8);
          const int ii = 8 * (idx % (SR / 8)), v = j * p.KR + r_step + ii;
          xv[u] = ii < len && gm < p.M && v < p.K
                      ? __ldg(reinterpret_cast<const uint4*>(xh + (size_t)gm * p.K + v))
                      : make_uint4(0u, 0u, 0u, 0u);
        }
        if (c0 > 0) __syncthreads();  // the previous step's x is consumed
#pragma unroll
        for (int u = 0; u < 2; ++u) {
          const int idx = lane + 32 * u, j = idx / (SR / 8);
          const int ii = 8 * (idx % (SR / 8));
          const uint32_t wv[4] = {xv[u].x, xv[u].y, xv[u].z, xv[u].w};
#pragma unroll
          for (int e = 0; e < 8; ++e)
            if (ii + e < lenp)
              xr[((ii + e) / RPC) * CH + ((ii + e) % RPC) * R + j] =
                  (unsigned short)(wv[e >> 1] >> (16 * (e & 1)));
        }
        return;
      }
      unsigned short xv[R][SR / 32];
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int k = 0; k < SR / 32; ++k) {
          const int ii = lane + 32 * k, v = j * p.KR + r_step + ii;
          xv[j][k] = ii < len && gm < p.M && v < p.K
                         ? __ldg(xh + (size_t)gm * p.K + v) : (unsigned short)0;
        }
      if (c0 > 0) __syncthreads();  // the previous step's x is consumed
#pragma unroll
      for (int j = 0; j < R; ++j)
#pragma unroll
        for (int k = 0; k < SR / 32; ++k) {
          const int ii = lane + 32 * k;
          if (ii < lenp) xr[(ii / RPC) * CH + (ii % RPC) * R + j] = xv[j][k];
        }
    };
    if constexpr (FAST) {
      // bf16, 4-byte payload words, f32 scale rows read as float4, groups
      // of a multiple of RPC rows (one group per field in a chunk): a
      // group's loads are all issued before any is used, the first
      // group's before x is staged
      constexpr int NS = R > 1 ? 2 : 1;  // scale rows per chunk
      constexpr int NW = R > 1 ? 2 : 4;  // payload words per chunk
      uint32_t wd[U][NW];
      float4 s4[U][NS];
      auto load_group = [&](int cb) {
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cl = cb + kWarps * u, row0 = r_step + cl * RPC;
          const bool ok = cl < cn && gn < p.N;
#pragma unroll
          for (int e = 0; e < NW; ++e) {
            // R > 1: rows of values 2tq and 2tq + 8; R = 1: all four values
            const int i = row0 + (NW == 2 ? slot[2 * e] / R : slot[e]);
            wd[u][e] = ok && i < i_end
                           ? __ldg(reinterpret_cast<const unsigned int*>(
                                 w + (size_t)i * p.N + gn))
                           : 0u;
          }
#pragma unroll
          for (int f = 0; f < NS; ++f) {
            const int grp = min((((slot[f] % R) * p.KR + row0) >> p.gsz_log2),
                                p.scale_rows - 1);
            s4[u][f] = ok ? __ldg(reinterpret_cast<const float4*>(
                                scale + (size_t)grp * p.N + gn))
                          : make_float4(0.f, 0.f, 0.f, 0.f);
          }
        }
      };
      load_group(warp);
      stage_x_bf16();
      __syncthreads();
      for (int cb = warp; cb < cn; cb += kWarps * U) {
        if (cb != warp) load_group(cb);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cl = cb + kWarps * u;
          if (cl >= cn) break;  // uniform over the warp
          float wf[4][4];
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const float4 sv = s4[u][NS == 2 ? (e & 1) : 0];
            const float sq[4] = {sv.x, sv.y, sv.z, sv.w};
            float f[4];
            decode4<BITS>(NW == 2 ? wd[u][e >> 1] : wd[u][e], slot[e] % R, f);
#pragma unroll
            for (int q = 0; q < 4; ++q) wf[e][q] = __fmul_rn(f[q], sq[q]);
          }
          chunk_mma(acc, wf,
                    reinterpret_cast<const unsigned short*>(xs) + g * XP +
                        cl * CH,
                    tq);
        }
      }
    } else {
      uint32_t raw[U][4];
      auto load_raw = [&](int cb) {
#pragma unroll
        for (int u = 0; u < U; ++u)
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int cl = cb + kWarps * u;
            const int i = r_step + cl * RPC + slot[e] / R;
            if (e & 1 && R > 1)
              raw[u][e] = raw[u][e - 1];  // the same row as value e - 1
            else
              raw[u][e] = cl < cn && i < i_end
                              ? load4(w + (size_t)i * p.N + gn, gn, p) : 0u;
          }
      };
      load_raw(warp);  // in flight while x and the scale rows are staged
      if constexpr (kBf16) {
        stage_x_bf16();
      } else {
        if (c0 > 0) __syncthreads();  // the previous step's x is consumed
        // x[m0 + m, v] of the step's chunks -> xs[m][chunk * 16 + s]
        for (int sl = threadIdx.x; sl < lenp * R; sl += kThreads) {
          const int s = sl % CH;
          const int i = r_step + (sl / CH) * RPC + s / R;
          const int v = (s % R) * p.KR + i;
          const bool in = i < i_end && v < p.K;
          float val[MT];
#pragma unroll
          for (int m = 0; m < MT; ++m)
            val[m] = in && m0 + m < p.M
                         ? __ldg(reinterpret_cast<const float*>(x) +
                                 (size_t)(m0 + m) * p.K + v)
                         : 0.f;
#pragma unroll
          for (int m = 0; m < MT; ++m) xs[m * XP + sl] = val[m];
        }
      }
      if (c0 == 0 && p.scale_smem)  // the block's scale rows, once
        for (int b0 = threadIdx.x; b0 < p.scale_rows * BN; b0 += kThreads * LB) {
          float val[LB];
#pragma unroll
          for (int u = 0; u < LB; ++u) {  // LB loads in flight per thread
            const int idx = b0 + u * kThreads, row = idx / BN, c = idx % BN;
            val[u] = idx < p.scale_rows * BN && n0 + c < p.N
                         ? __ldg(scale + (size_t)row * p.N + n0 + c) : 0.f;
          }
#pragma unroll
          for (int u = 0; u < LB; ++u)
            if (b0 + u * kThreads < p.scale_rows * BN) sc[b0 + u * kThreads] = val[u];
        }
      __syncthreads();
      for (int cb = warp; cb < cn; cb += kWarps * U) {
        if (cb != warp) load_raw(cb);
#pragma unroll
        for (int u = 0; u < U; ++u) {
          const int cl = cb + kWarps * u;  // chunk within the step
          if (cl >= cn) break;             // uniform over the warp
          float wf[4][4];
          dequant<BITS>(raw[u], slot, r_step + cl * RPC, sc, scale, gn, g, p,
                        wf);
          if constexpr (kBf16) {
            chunk_mma(acc, wf,
                      reinterpret_cast<const unsigned short*>(xs) + g * XP +
                          cl * CH,
                      tq);
          } else {
            const float* xc = reinterpret_cast<const float*>(xs) + cl * CH;
#pragma unroll
            for (int m = 0; m < MT; ++m) {
              const float2 xa =
                  *reinterpret_cast<const float2*>(&xc[m * XP + 2 * tq]);
              const float2 xb =
                  *reinterpret_cast<const float2*>(&xc[m * XP + 2 * tq + 8]);
              const float xv[4] = {xa.x, xa.y, xb.x, xb.y};
#pragma unroll
              for (int e = 0; e < 4; ++e)
#pragma unroll
                for (int q = 0; q < 4; ++q)
                  acc[m][q] = fmaf(xv[e], wf[e][q], acc[m][q]);
            }
          }
        }
      }
    }
    if (c0 + XCH >= nch) break;
  }

  // the warp's sums -> red[warp]
  float* wred = red + warp * kOut;
  if constexpr (kBf16) {
#pragma unroll
    for (int mt = 0; mt < 2; ++mt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int col = 4 * g + 2 * mt + (e >> 1), m = 2 * tq + (e & 1);
        wred[m * BN + col] = acc[mt][e];
      }
  } else {
    // the four threads of a column group hold other values of v
#pragma unroll
    for (int m = 0; m < MT; ++m)
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        acc[m][q] = __fadd_rn(acc[m][q],
                              __shfl_xor_sync(0xffffffffu, acc[m][q], 1));
        acc[m][q] = __fadd_rn(acc[m][q],
                              __shfl_xor_sync(0xffffffffu, acc[m][q], 2));
      }
#pragma unroll
    for (int m = 0; m < MT; ++m)
      if ((m >> 1) == tq)
#pragma unroll
        for (int q = 0; q < 4; ++q) wred[m * BN + 4 * g + q] = acc[m][q];
  }
  __syncthreads();
  // the block's tile, its warps' sums added in warp order; with a cluster,
  // each output goes to the rank that finishes it: rank r owns outputs
  // [r * per, (r + 1) * per), receives them in slots by sender rank, and
  // adds them in rank order
  const int ranks = p.cluster, per = kOut / ranks;
  cg::cluster_group cluster = cg::this_cluster();
  if (ranks > 1) asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
  for (int o = threadIdx.x; o < kOut; o += kThreads) {
    float s = red[o];
#pragma unroll
    for (int l = 1; l < kWarps; ++l) s = __fadd_rn(s, red[l * kOut + o]);
    const int m = o / BN, col = o - m * BN;
    if (ranks == 1) {
      if (m0 + m < p.M && n0 + col < p.N)
        store(out + (size_t)(m0 + m) * p.N + n0 + col, s);
    } else {
      const int owner = o / per;
      cluster.map_shared_rank(recv, owner)[blockIdx.y * per + o - owner * per] = s;
    }
  }
  if (ranks == 1) return;
  cluster.sync();  // every partial tile has arrived; no remote access follows
  for (int o = threadIdx.x; o < per; o += kThreads) {
    float s = 0.f;
    for (int r = 0; r < ranks; ++r) s = __fadd_rn(s, recv[r * per + o]);
    const int og = blockIdx.y * per + o, m = og / BN, col = og - m * BN;
    if (m0 + m < p.M && n0 + col < p.N)
      store(out + (size_t)(m0 + m) * p.N + n0 + col, s);
  }
}

template <int BITS, typename T, bool FAST>
int launch(const void* x, const void* w, const void* scale, void* out,
           const WOParams& p, cudaStream_t s) {
  auto kernel = wo_kernel<BITS, T, FAST>;
  const size_t smem = sizeof(float) * ((kWarps + 1) * kOut +
                                       (p.scale_smem ? p.scale_rows * BN : 0)) +
                      sizeof(T) * MT * XP;
  int rc = 0;
  if (smem > 48 * 1024)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (rc == 0 && p.cluster > 8)
    rc = (int)cudaFuncSetAttribute(
        kernel, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
  if (rc != 0) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((p.N + BN - 1) / BN, p.cluster, (p.M + MT - 1) / MT);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = 1;
  attr[0].val.clusterDim.y = p.cluster;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = p.cluster > 1 ? 1 : 0;  // one block: no cluster
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, static_cast<const T*>(x),
                               static_cast<const uint8_t*>(w),
                               static_cast<const float*>(scale),
                               static_cast<T*>(out), p);
  if (rc != 0) return rc;
  return (int)cudaGetLastError();
}

template <typename T, bool FAST>
int launch_bits(const void* x, const void* w, const void* scale, void* out,
                const WOParams& p, cudaStream_t s) {
  switch (p.bits) {
    case 1: return launch<1, T, FAST>(x, w, scale, out, p, s);
    case 2: return launch<2, T, FAST>(x, w, scale, out, p, s);
    case 4: return launch<4, T, FAST>(x, w, scale, out, p, s);
    case 8: return launch<8, T, FAST>(x, w, scale, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns the launch's error code. Pointers: x
// [M, K] (f32, or bf16 when x_bf16), the payload, scale f32 [scale_rows,
// N] or null (scale_rows == 0: the scalar p.scale), out [M, N] in x's type.
extern "C" int nq_splitk_wo_matmul(const void* x, const void* packed,
                                   const void* scale, void* out,
                                   const WOParams* params, void* stream) {
  const WOParams p = *params;
  if (p.KR < 1 || p.rows_per_rank < 1 || p.cluster < 1 || p.cluster > 16 ||
      (p.cluster & (p.cluster - 1)) || (p.scale_rows > 0 && p.gsz < 1) ||
      (p.scale_rows > 0 && scale == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  if (!p.x_bf16) return launch_bits<float, false>(x, packed, scale, out, p, s);
  return p.fast ? launch_bits<__nv_bfloat16, true>(x, packed, scale, out, p, s)
                : launch_bits<__nv_bfloat16, false>(x, packed, scale, out, p, s);
}
