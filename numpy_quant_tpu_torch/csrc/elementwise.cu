// Elementwise quantize and dequantize, for Hopper (sm_90a).
//
// Replaces the TPU kernels numpy_quant_tpu/kernels/elementwise.py::
// quantize_pallas (body _quantize_kernel) and ::dequantize_pallas (body
// _dequantize_kernel), in every form the port's executor calls them with
// (numpy_quant_tpu_torch/kernels/elementwise.py):
//   quantize:   y = cast(rint(clamp(zp + x / s, lo, hi)))
//     x f32 or bf16 (widened exactly); y int8, int32 or int64. The divide
//     is IEEE (__fdiv_rn), never a reciprocal multiply. int8/int32 out:
//     f32 arithmetic (the JAX package's TPU mode); int64 out: the zero
//     point is added in f64 and clamp and rint run in f64 (its x64 mode).
//     With nan_to_zero (a zero scale somewhere: 0/0) a NaN becomes 0
//     before the clamp.
//   dequantize: y = f32(x - zp) * s   for int8/int32 x: int32 subtract,
//     f32 multiply; for int64 x: int64 subtract, f64 multiply rounded
//     once to f32, a scalar scale taken at its f64 value (scale_d, as the
//     chain's float64 tensor of it holds it). y f32, or bf16 rounded from
//     that f32.
// s and zp are scalars passed by value or tensors broadcast against x
// (per-channel scale rows; a matmul accumulator's [M, 1], [1, N] or full
// zero-point corrections), read at offsets walked in x's memory order.
// Every step is the operation of the torch chain the plain version runs,
// with its rounding and its conversions: a clamp that passes NaN through,
// rint half to even, static_cast to the integer type (the card's
// saturating conversion, so the clip bound 2^31 - 1 that f32 rounds to
// 2^31 gives INT32_MAX at 32 bits, and 2^63 gives INT64_MAX at 64 bits,
// as torch's own cast does). Kernel and plain version agree bit for bit.
//
// Bound on an H100 SXM: memory. The largest ViT-Base boundary, bf16
// [18912, 3072] -> int32, moves 116 MB in and 232 MB out (0.10 ms at
// 3.35 TB/s); the few operations per element are far below any peak.
//
// Design: a grid-stride loop over groups of 4 consecutive elements of x's
// storage, writing y with x's strides. Where x and y start on a 4-element
// boundary each group is one vector load and one vector store; otherwise,
// and for the last n % 4 elements, element by element. A broadcast
// operand's offset for storage position j comes from j's digits over the
// operand's (size, stride) dims in x's memory order, which the wrapper
// has merged wherever they run on contiguously (a per-channel row is one
// modulo, a column one divide). The TPU kernel's whole-array VMEM block
// becomes this loop; nothing else carries over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#define NQ_MAX_DIMS 6

struct Bcast {
  int ndim;
  int size[NQ_MAX_DIMS];          // outermost first
  long long stride[NQ_MAX_DIMS];  // in elements, 0 where broadcast
};

struct EWParams {
  long long n;
  int in_type, out_type;  // quantize: f32/bf16 -> int8/int32/int64;
                          // dequantize: int8/int32/int64 -> f32/bf16
  int zp_mode;            // 0 none, 1 the scalar zp, 2 a tensor
  int zp_int64;           // the zero-point tensor is int64 (else int32)
  int scale_vec;          // the scale is a tensor (else the scalar scale)
  int nan_to_zero;
  int vec;                // x and y start on a 4-element boundary
  float scale, lo_f, hi_f;
  long long zp;
  double lo, hi;
  double scale_d;         // the scalar scale in f64 (the wide dequantize)
  Bcast sb, zb;           // scale and zero-point tensors
};

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 4096;

template <typename T>
struct alignas(4 * sizeof(T)) V4 {
  T v[4];
};

__device__ __forceinline__ long long offset_of(const Bcast& b, unsigned j) {
  long long off = 0;
#pragma unroll
  for (int d = NQ_MAX_DIMS - 1; d >= 0; --d) {
    if (d < b.ndim) {
      const unsigned s = (unsigned)b.size[d];
      const unsigned q = j / s;
      off += (long long)(j - q * s) * b.stride[d];
      j = q;
    }
  }
  return off;
}

__device__ __forceinline__ float widen(float v) { return v; }
__device__ __forceinline__ float widen(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename Out>
__device__ __forceinline__ Out narrow_float(float v);
template <>
__device__ __forceinline__ float narrow_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 narrow_float<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}

// the scale at storage position j: a tensor's f32 element, else the
// scalar in f32 or, for S = double, in f64
template <typename S>
__device__ __forceinline__ S scale_at(const float* svec, const EWParams& p,
                                      unsigned j) {
  if (p.scale_vec) return (S)svec[offset_of(p.sb, j)];
  if constexpr (sizeof(S) == 8) return p.scale_d;
  else return p.scale;
}

__device__ __forceinline__ long long zp_at(const void* zvec,
                                           const EWParams& p, unsigned j) {
  if (p.zp_mode != 2) return p.zp;
  const long long off = offset_of(p.zb, j);
  return p.zp_int64 ? static_cast<const long long*>(zvec)[off]
                    : (long long)static_cast<const int*>(zvec)[off];
}

// quantize one value; int64 out is the wide (x64-mode) form
template <typename Out>
__device__ __forceinline__ Out quantize_one(float x, float s, long long zp,
                                            const EWParams& p) {
  constexpr bool kWide = sizeof(Out) == 8;
  float q = __fdiv_rn(x, s);
  if (kWide && p.zp_mode != 0) {
    double d = __dadd_rn(__ll2double_rn(zp), (double)q);
    if (p.nan_to_zero && isnan(d)) d = 0.0;
    if (!isnan(d)) d = fmin(fmax(d, p.lo), p.hi);
    return static_cast<Out>(rint(d));
  }
  if (p.zp_mode != 0) q = __fadd_rn(__ll2float_rn(zp), q);
  if (p.nan_to_zero && isnan(q)) q = 0.0f;
  if (!isnan(q)) q = fminf(fmaxf(q, p.lo_f), p.hi_f);
  return static_cast<Out>(rintf(q));
}

// dequantize one value; int64 in is the wide (x64-mode) form
template <typename In, typename Out>
__device__ __forceinline__ Out dequantize_one(In x, const float* svec,
                                              long long zp, const EWParams& p,
                                              unsigned j) {
  if constexpr (sizeof(In) == 8) {
    long long v = x;
    if (p.zp_mode != 0)
      v = (long long)((unsigned long long)v - (unsigned long long)zp);
    const double r =
        __dmul_rn(__ll2double_rn(v), scale_at<double>(svec, p, j));
    return narrow_float<Out>(__double2float_rn(r));
  } else {
    int v = (int)x;
    if (p.zp_mode != 0) v = (int)((unsigned)v - (unsigned)(int)zp);
    return narrow_float<Out>(
        __fmul_rn(__int2float_rn(v), scale_at<float>(svec, p, j)));
  }
}

template <bool Quantize, typename In, typename Out>
__device__ __forceinline__ Out apply(In x, const float* svec,
                                     const void* zvec, const EWParams& p,
                                     unsigned j) {
  const long long zp = zp_at(zvec, p, j);
  if constexpr (Quantize)
    return quantize_one<Out>(widen(x), scale_at<float>(svec, p, j), zp, p);
  else
    return dequantize_one<In, Out>(x, svec, zp, p, j);
}

template <bool Quantize, typename In, typename Out>
__global__ void __launch_bounds__(kThreads)
    qdq_kernel(const In* __restrict__ x, Out* __restrict__ y,
               const float* __restrict__ svec, const void* __restrict__ zvec,
               const EWParams p) {
  const unsigned n = (unsigned)p.n;
  const unsigned groups = n / 4;
  const unsigned step = gridDim.x * blockDim.x;
  const unsigned tid = blockIdx.x * blockDim.x + threadIdx.x;
  for (unsigned g = tid; g < groups; g += step) {
    const unsigned j0 = 4 * g;
    V4<In> in;
    if (p.vec) {
      in = reinterpret_cast<const V4<In>*>(x)[g];
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) in.v[k] = x[j0 + k];
    }
    V4<Out> out;
#pragma unroll
    for (int k = 0; k < 4; ++k)
      out.v[k] = apply<Quantize, In, Out>(in.v[k], svec, zvec, p, j0 + k);
    if (p.vec) {
      reinterpret_cast<V4<Out>*>(y)[g] = out;
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) y[j0 + k] = out.v[k];
    }
  }
  const unsigned t = 4 * groups + tid;
  if (t < n) y[t] = apply<Quantize, In, Out>(x[t], svec, zvec, p, t);
}

template <bool Quantize, typename In, typename Out>
int launch(const void* x, void* y, const void* svec, const void* zvec,
           const EWParams& p, cudaStream_t stream) {
  const long long groups = p.n / 4;
  long long blocks = (groups + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  qdq_kernel<Quantize, In, Out><<<(int)blocks, kThreads, 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(y),
      static_cast<const float*>(svec), zvec, p);
  return (int)cudaGetLastError();
}

bool valid(const EWParams& p) {
  if (p.n <= 0 || p.n >= (1LL << 31)) return false;
  if (p.sb.ndim < 0 || p.sb.ndim > NQ_MAX_DIMS || p.zb.ndim < 0 ||
      p.zb.ndim > NQ_MAX_DIMS)
    return false;
  for (int d = 0; d < p.sb.ndim; ++d)
    if (p.sb.size[d] < 1) return false;
  for (int d = 0; d < p.zb.ndim; ++d)
    if (p.zb.size[d] < 1) return false;
  return true;
}

}  // namespace

extern "C" int nq_quantize(const void* x, void* y, const void* svec,
                           const void* zvec, const EWParams* params,
                           void* stream) {
  const EWParams p = *params;
  if (!valid(p) || (p.scale_vec && svec == nullptr) ||
      (p.zp_mode == 2 && zvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.in_type * 3 + p.out_type) {
    case 0: return launch<true, float, int8_t>(x, y, svec, zvec, p, s);
    case 1: return launch<true, float, int32_t>(x, y, svec, zvec, p, s);
    case 2: return launch<true, float, long long>(x, y, svec, zvec, p, s);
    case 3:
      return launch<true, __nv_bfloat16, int8_t>(x, y, svec, zvec, p, s);
    case 4:
      return launch<true, __nv_bfloat16, int32_t>(x, y, svec, zvec, p, s);
    case 5:
      return launch<true, __nv_bfloat16, long long>(x, y, svec, zvec, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

extern "C" int nq_dequantize(const void* x, void* y, const void* svec,
                             const void* zvec, const EWParams* params,
                             void* stream) {
  const EWParams p = *params;
  if (!valid(p) || (p.scale_vec && svec == nullptr) ||
      (p.zp_mode == 2 && zvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.in_type * 2 + p.out_type) {
    case 0: return launch<false, int8_t, float>(x, y, svec, zvec, p, s);
    case 1:
      return launch<false, int8_t, __nv_bfloat16>(x, y, svec, zvec, p, s);
    case 2: return launch<false, int32_t, float>(x, y, svec, zvec, p, s);
    case 3:
      return launch<false, int32_t, __nv_bfloat16>(x, y, svec, zvec, p, s);
    case 4: return launch<false, long long, float>(x, y, svec, zvec, p, s);
    case 5:
      return launch<false, long long, __nv_bfloat16>(x, y, svec, zvec, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
