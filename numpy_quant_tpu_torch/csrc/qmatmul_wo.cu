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
// The sum runs in f32 on the CUDA cores (fmaf), never on TF32 tensor
// cores: the TPU kernel's f32 dot runs at Precision.HIGHEST.
//
// Bound at GPT-2 decode shapes (M = 8) on an H100 SXM: memory. The LM head
// 768 -> 50257 at 4 bits moves 19.3 MB of payload and 1.2 MB of g=128
// scales (6.1 us at 3.35 TB/s) against 2*8*768*50257 = 0.62 GFLOP (9 us
// at the 67 TFLOP/s f32 rate of the CUDA cores, 0.6 us on bf16 tensor
// cores); the per-layer shapes move 0.3-1.2 MB each, below a launch's
// own cost.
//
// Design: a block of 8 warps owns 128 output columns (a warp reads one
// 4-byte word -- 4 columns -- per lane along N, so a warp load is 128
// contiguous payload bytes) and 8 rows of x, and walks a range of packed
// rows. Each step stages the x values of 32 packed rows (all r bit
// fields: x's own columns j*KR + i, so x is neither padded nor re-split)
// in shared memory, issues the 4 payload words of each warp before using
// any, decodes every field, scales and rounds it as the TPU kernel does,
// and accumulates 8 x 4 outputs per thread. Decode shapes give one block
// per 128 columns, 6 blocks at N = 768 on 132 SMs, so the packed rows are
// also split across blocks (grid.y) until about two blocks per SM are in
// flight; each split writes its partial sums to a workspace and a second
// pass adds them in split order. Inside a block the 8 warps' sums meet in
// shared memory and are added in warp order. No float atomics: every
// output is the same sum in the same order on every run, so a decode
// loop gives the same tokens run to run. Large M is tiled 8 rows per
// block (grid.z) and re-reads the weight per tile: right, not fast; a
// wgmma/TMA design with bf16 tensor cores is later work. The TPU wrapper's
// padding (_splitk_pad_byte, per-field re-split of x, per-field scale
// rows) becomes bounds guards: v < K, n < N.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

struct WOParams {
  int M, N, K, KR, bits, x_bf16, scale_rows, gsz, splits, rows_per_split,
      w_vec;
  float scale;
};

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;  // k-lanes: warp w takes rows w + 8u
constexpr int BN = 128;                // output columns per block
constexpr int MT = 8;                  // rows of x per block
constexpr int U = 4;                   // packed rows per warp per step
constexpr int KSTEP = kWarps * U;      // packed rows per step (32)
constexpr int kMaxFields = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
__device__ __forceinline__ void store(float* p, float v) { *p = v; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16_rn(v);
}
// The dequantized weight as the dot consumes it: rounded to x's type.
template <typename T>
__device__ __forceinline__ float round_w(float w) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value)
    return __bfloat162float(__float2bfloat16_rn(w));
  return w;
}

// Four consecutive payload bytes of one row, columns gn..gn+3 (bytes past
// N read as 0).
__device__ __forceinline__ uint32_t load4(const uint8_t* __restrict__ src,
                                          int gn, const WOParams& p) {
  if (p.w_vec) return __ldg(reinterpret_cast<const unsigned int*>(src));
  uint32_t v = 0;
#pragma unroll
  for (int c = 0; c < 4; ++c)
    if (gn + c < p.N) v |= (uint32_t)__ldg(src + c) << (8 * c);
  return v;
}

template <int BITS, typename T>
__global__ void __launch_bounds__(kThreads)
    wo_kernel(const T* __restrict__ x, const uint8_t* __restrict__ w,
              const float* __restrict__ scale, T* __restrict__ out,
              float* __restrict__ ws, const WOParams p) {
  constexpr int R = 8 / BITS;  // bit fields per byte
  constexpr int MASK = (1 << BITS) - 1;
  constexpr int OFFSET = 1 << (BITS - 1);
  __shared__ float xs[MT * kMaxFields * KSTEP];
  __shared__ __align__(16) float red[kWarps * MT * BN];
  const int lane = threadIdx.x & 31, kl = threadIdx.x >> 5;
  const int n0 = blockIdx.x * BN, gn = n0 + lane * 4;
  const int m0 = blockIdx.z * MT;
  const int i_begin = blockIdx.y * p.rows_per_split;
  const int i_end = min(p.KR, i_begin + p.rows_per_split);

  float acc[MT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[m][c] = 0.0f;

  for (int is = i_begin; is < i_end; is += KSTEP) {
    // x[m0 + m, j*KR + is + t] -> xs[m][j][t], zero outside x
    for (int idx = threadIdx.x; idx < MT * R * KSTEP; idx += kThreads) {
      const int t = idx % KSTEP, j = (idx / KSTEP) % R, m = idx / (KSTEP * R);
      const int i = is + t, v = j * p.KR + i, gm = m0 + m;
      float val = 0.0f;
      if (gm < p.M && i < i_end && v < p.K) val = to_f32(x[(size_t)gm * p.K + v]);
      xs[(m * kMaxFields + j) * KSTEP + t] = val;
    }
    uint32_t raw[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int i = is + kl + kWarps * u;
      raw[u] = (i < i_end && gn < p.N)
                   ? load4(w + (size_t)i * p.N + gn, gn, p) : 0u;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < U; ++u) {
      const int t = kl + kWarps * u, i = is + t;
      if (i >= i_end) break;  // uniform over the warp
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int v = j * p.KR + i;
        if (v >= p.K) break;
        float s[4];
        if (p.scale_rows == 0) {
#pragma unroll
          for (int c = 0; c < 4; ++c) s[c] = p.scale;
        } else {
          const float* row = scale + (size_t)(v / p.gsz) * p.N;
#pragma unroll
          for (int c = 0; c < 4; ++c)
            s[c] = gn + c < p.N ? __ldg(row + gn + c) : 0.0f;
        }
        float wf[4];
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int byte = (raw[u] >> (8 * c)) & 0xff;
          const int q = BITS == 8 ? (int)(int8_t)byte
                                  : ((byte >> (j * BITS)) & MASK) - OFFSET;
          wf[c] = round_w<T>(__fmul_rn((float)q, s[c]));
        }
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const float xv = xs[(m * kMaxFields + j) * KSTEP + t];
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][c] = fmaf(xv, wf[c], acc[m][c]);
        }
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int m = 0; m < MT; ++m)
    *reinterpret_cast<float4*>(&red[(kl * MT + m) * BN + lane * 4]) =
        make_float4(acc[m][0], acc[m][1], acc[m][2], acc[m][3]);
  __syncthreads();
  const size_t mn = (size_t)p.M * p.N;
#pragma unroll
  for (int q = 0; q < MT * BN / kThreads; ++q) {
    const int idx = threadIdx.x + q * kThreads;
    const int m = idx / BN, col = idx % BN;
    const int gm = m0 + m, n = n0 + col;
    if (gm >= p.M || n >= p.N) continue;
    float sum = 0.0f;
#pragma unroll
    for (int l = 0; l < kWarps; ++l) sum += red[(l * MT + m) * BN + col];
    const size_t o = (size_t)gm * p.N + n;
    if (p.splits == 1)
      store(out + o, sum);
    else
      ws[blockIdx.y * mn + o] = sum;
  }
}

// out[o] = the splits' partial sums, added in split order.
template <typename T>
__global__ void wo_reduce(const float* __restrict__ ws, T* __restrict__ out,
                          size_t mn, int splits) {
  const size_t o = (size_t)blockIdx.x * kThreads + threadIdx.x;
  if (o >= mn) return;
  float sum = 0.0f;
  for (int s = 0; s < splits; ++s) sum += ws[s * mn + o];
  store(out + o, sum);
}

template <int BITS, typename T>
int launch(const void* x, const void* w, const void* scale, void* out,
           void* ws, const WOParams& p, cudaStream_t s) {
  const dim3 grid((p.N + BN - 1) / BN, p.splits, (p.M + MT - 1) / MT);
  wo_kernel<BITS, T><<<grid, kThreads, 0, s>>>(
      static_cast<const T*>(x), static_cast<const uint8_t*>(w),
      static_cast<const float*>(scale), static_cast<T*>(out),
      static_cast<float*>(ws), p);
  int rc = (int)cudaGetLastError();
  if (rc != 0 || p.splits == 1) return rc;
  const size_t mn = (size_t)p.M * p.N;
  wo_reduce<T><<<(unsigned)((mn + kThreads - 1) / kThreads), kThreads, 0,
                 s>>>(static_cast<const float*>(ws), static_cast<T*>(out),
                      mn, p.splits);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bits(const void* x, const void* w, const void* scale, void* out,
                void* ws, const WOParams& p, cudaStream_t s) {
  switch (p.bits) {
    case 1: return launch<1, T>(x, w, scale, out, ws, p, s);
    case 2: return launch<2, T>(x, w, scale, out, ws, p, s);
    case 4: return launch<4, T>(x, w, scale, out, ws, p, s);
    case 8: return launch<8, T>(x, w, scale, out, ws, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Launches on `stream` and returns cudaGetLastError() of the launches.
// Pointers: x [M, K] (f32, or bf16 when x_bf16), the payload, scale f32
// [scale_rows, N] or null (scale_rows == 0: the scalar p.scale), out
// [M, N] in x's type, ws f32 [splits, M, N] (null when splits == 1).
extern "C" int nq_splitk_wo_matmul(const void* x, const void* packed,
                                   const void* scale, void* out, void* ws,
                                   const WOParams* params, void* stream) {
  const WOParams p = *params;
  if (p.KR < 1 || p.splits < 1 || p.rows_per_split < 1 ||
      (p.scale_rows > 0 && p.gsz < 1) || (p.splits > 1 && ws == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  return p.x_bf16 ? launch_bits<__nv_bfloat16>(x, packed, scale, out, ws, p, s)
                  : launch_bits<float>(x, packed, scale, out, ws, p, s);
}
