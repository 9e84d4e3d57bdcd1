// Elementwise quantize, dequantize and fake quantize, for Hopper (sm_90a).
//
// Replaces the TPU kernels numpy_quant_tpu/kernels/elementwise.py::
// quantize_pallas (body _quantize_kernel) and ::dequantize_pallas (body
// _dequantize_kernel), in every form the port's executor calls them with
// (numpy_quant_tpu_torch/kernels/elementwise.py); the fake-quantize form
// replaces the composition dequantize(quantize(x)) that XLA fuses into one
// loop inside JAX's DecodeAttention (numpy_quant_tpu/ops/registry.py):
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
//   fake quantize: dequantize(quantize(x)) to f32 through an int8, int32
//     or int64 container, the integer kept in a register.
// Every step is the operation of the torch chain the plain version runs,
// with its rounding and its conversions: a clamp that passes NaN through,
// rint half to even, static_cast to the integer type (the card's
// saturating conversion, so the clip bound 2^31 - 1 that f32 rounds to
// 2^31 gives INT32_MAX at 32 bits, and 2^63 gives INT64_MAX at 64 bits,
// as torch's own cast does); no step is contracted into a fused
// multiply-add (the _rn intrinsics). Kernel and plain version agree bit
// for bit, on the vector and the scalar path alike.
//
// Bound on an H100 SXM: memory. The largest ViT-Base boundary, bf16
// [18912, 3072] -> int32, moves 116 MB in and 232 MB out (0.10 ms at
// 3.35 TB/s); the few operations per element are far below any peak. So
// the design spends nothing per element that is not the arithmetic:
//  * 2-D: x is rows x cols in its memory order (the wrapper's plan merges
//    dims wherever x and every broadcast operand run on contiguously), a
//    row at x + r * x_rs (dense rows read in place: a sliced view such as
//    DecodeAttention's probs[..., :L] is not copied first), y dense.
//    Blocks own column segments of 16-byte vectors and walk rows.
//  * A broadcast operand (per-channel scale, a matmul accumulator's [1, N]
//    or [M, 1] zero-point corrections, a conv's [1, C, 1, 1] on NHWC
//    memory) is read at row_offset(r) + c * col_stride. An operand that
//    varies only along the columns ("inner") is loaded into registers once
//    per segment and reused over every row the thread walks; one constant
//    along them ("outer") once per row; the row offset of a multi-dim row
//    walk takes precomputed multiply-shift divisions, once per row. No
//    element pays a divide or a modulo for its operands.
//  * Registers set how many threads' loads are in flight: every form is
//    held to 64 a thread (four 256-thread blocks an SM), and the kernel is
//    templated on which operands are tensors, so a form carries only its
//    own operand code and caches; a 32-bit dequantize keeps its zero
//    points' low 32 bits, all its subtract reads.
//  * 16 bytes per thread per access on the narrow side or 32 on the wide
//    one, whichever is more elements (16 int8, 8 bf16 or 8 int32/f32 a
//    step), in 16-byte accesses, but at most 32 bytes of stores a thread:
//    int8 -> f32 takes 8 elements (a 64-byte store a thread left a warp's
//    store instructions strided and ran at half the rate on the card). Rows that are ragged or not
//    16-byte aligned take a masked scalar path in which neighbouring
//    threads take neighbouring elements, its loads issued before its
//    results.
//  * A grid sized to the card: at most 8 times the blocks resident on all
//    SMs at once (occupancy, read once per kernel), fewer for a
//    small tensor. A long dense run is cut into rows (the plan) so threads
//    walk rows. A launch with scalar operands whose wide vectors would
//    not fill the card once (DecodeAttention's cache write, p_past) takes
//    vectors of 16 bytes of the wider side instead, so that two to four
//    times as many threads share its serial divides and stores.
// The TPU kernel's whole-array VMEM block becomes this loop; nothing else
// carries over.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

#define NQ_MAX_DIMS 6

// A broadcast operand, read at row_offset(r) + c * col_stride (elements).
struct Operand {
  int rdims;  // digits of the row walk (0: every row offset is 0)
  int inner;  // every row offset is 0: kept in registers per segment
  long long col_stride;
  long long rstride[NQ_MAX_DIMS];       // innermost digit first
  unsigned rsize[NQ_MAX_DIMS];
  unsigned long long magic[NQ_MAX_DIMS];  // q = (r * magic) >> shift
  int shift[NQ_MAX_DIMS];
};

// Everything of a call but its pointers and its scale and zero-point
// values: made once per call signature by the wrapper.
struct EWPlan {
  long long rows, cols, x_rs;  // y's row stride is cols
  int op;                      // 0 quantize, 1 dequantize, 2 fake quantize
  int in_type, out_type;       // quantize: f32/bf16 -> int8/int32/int64;
                               // dequantize: int8/int32/int64 -> f32/bf16;
                               // fake: f32/bf16 in, out_type the container
  int scale_vec;               // the scale is an f32 tensor
  int zp_mode;                 // 0 none, 1 the scalar zp, 2 a tensor
  int zp_int64;                // the zero-point tensor is int64 (else int32)
  int nan_to_zero;
  int bx, by;                  // threads per block along columns, rows
  int narrow;                  // a small scalar-operand launch: narrow_width
  float lo_f, hi_f;
  double lo, hi;
  Operand sb, zb;              // scale and zero-point tensors
};

struct Scalars {
  float scale;
  double scale_d;  // the scalar scale in f64 (the wide dequantize)
  long long zp;
};

namespace {

constexpr int kThreads = 256;

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

// quantize one value; int64 out is the wide (x64-mode) form
template <typename Out>
__device__ __forceinline__ Out quantize_one(float x, float s, long long zp,
                                            const EWPlan& p) {
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

// dequantize one value; int64 in is the wide (x64-mode) form, which
// multiplies by the scale in f64 (sd: the scalar's f64 value, or the
// tensor element widened)
template <typename In, typename Out>
__device__ __forceinline__ Out dequantize_one(In x, float s, double sd,
                                              long long zp,
                                              const EWPlan& p) {
  if constexpr (sizeof(In) == 8) {
    long long v = x;
    if (p.zp_mode != 0)
      v = (long long)((unsigned long long)v - (unsigned long long)zp);
    const double r = __dmul_rn(__ll2double_rn(v), sd);
    return narrow_float<Out>(__double2float_rn(r));
  } else {
    int v = (int)x;
    if (p.zp_mode != 0) v = (int)((unsigned)v - (unsigned)(int)zp);
    return narrow_float<Out>(__fmul_rn(__int2float_rn(v), s));
  }
}

// Op 0 quantize (Q unused), 1 dequantize (Q unused), 2 fake quantize
// through the container Q
template <int kOp, typename In, typename Out, typename Q>
__device__ __forceinline__ Out apply(In x, float s, double sd, long long zp,
                                     const EWPlan& p) {
  if constexpr (kOp == 0) {
    return quantize_one<Out>(widen(x), s, zp, p);
  } else if constexpr (kOp == 1) {
    return dequantize_one<In, Out>(x, s, sd, zp, p);
  } else {
    const Q q = quantize_one<Q>(widen(x), s, zp, p);
    return dequantize_one<Q, Out>(q, s, sd, zp, p);
  }
}

__device__ __forceinline__ long long row_offset(const Operand& o,
                                                unsigned r) {
  if (o.rdims == 0) return 0;
  long long off = 0;
#pragma unroll
  for (int d = 0; d < NQ_MAX_DIMS; ++d) {
    if (d == o.rdims - 1) {
      off += (long long)r * o.rstride[d];
      break;
    }
    const unsigned q = (unsigned)(((unsigned long long)r * o.magic[d]) >>
                                  o.shift[d]);
    off += (long long)(r - q * o.rsize[d]) * o.rstride[d];
    r = q;
  }
  return off;
}

__device__ __forceinline__ long long zp_load(const void* zvec, long long off,
                                             int is64) {
  return is64 ? static_cast<const long long*>(zvec)[off]
              : (long long)static_cast<const int*>(zvec)[off];
}

// N values moved in accesses of min(16, N * sizeof(T)) bytes
template <typename T, int N>
struct alignas(N * sizeof(T) < 16 ? N * sizeof(T) : 16) Vec {
  T v[N];
};

template <int kBytes>
struct Word;  // the access unit of a vector of kBytes bytes
template <>
struct Word<4> { using type = unsigned; };
template <>
struct Word<8> { using type = uint2; };
template <>
struct Word<16> { using type = uint4; };

template <typename T, int N>
using WordOf = typename Word<(N * sizeof(T) < 16 ? N * sizeof(T) : 16)>::type;

template <typename T, int N>
__device__ __forceinline__ Vec<T, N> load_vec(const T* ptr) {
  using W = WordOf<T, N>;
  Vec<T, N> out;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec<T, N>) / sizeof(W)); ++i)
    reinterpret_cast<W*>(&out)[i] = reinterpret_cast<const W*>(ptr)[i];
  return out;
}

template <typename T, int N>
__device__ __forceinline__ void store_vec(T* ptr, const Vec<T, N>& v) {
  using W = WordOf<T, N>;
#pragma unroll
  for (int i = 0; i < (int)(sizeof(Vec<T, N>) / sizeof(W)); ++i)
    reinterpret_cast<W*>(ptr)[i] = reinterpret_cast<const W*>(&v)[i];
}

__device__ __forceinline__ bool aligned16(const void* a, const void* b) {
  return ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) &
          15) == 0;
}

// elements a thread takes per access: 16 bytes of the narrower side or
// 32 bytes of the wider one, whichever is more elements, but at most 32
// bytes of stores (a thread's 64-byte store of 16 int8 -> f32 values
// leaves a warp's store instructions strided)
template <typename A, typename B>
__host__ __device__ constexpr int vec_width() {
  constexpr int lo = (int)(sizeof(A) < sizeof(B) ? sizeof(A) : sizeof(B));
  constexpr int hi = (int)(sizeof(A) < sizeof(B) ? sizeof(B) : sizeof(A));
  constexpr int v = 16 / lo > 32 / hi ? 16 / lo : 32 / hi;
  return v < 32 / (int)sizeof(B) ? v : 32 / (int)sizeof(B);
}

// elements a thread takes per access in a small launch with scalar
// operands: 16 bytes of the wider side, so that two to four times as many
// threads share a tensor that would not fill the card once (each thread's
// serial divides and stores are what such a launch waits on)
template <typename A, typename B>
__host__ __device__ constexpr int narrow_width() {
  return 16 / (int)(sizeof(A) < sizeof(B) ? sizeof(B) : sizeof(A));
}

// blocks an SM holds at once: at least four, so that every form (an
// inner operand's registers included) keeps to 64 registers a thread and
// 1,024 threads' loads in flight on each SM
constexpr int kMinBlocks = 4;
// the grid: at most this many times the blocks resident on the card at
// once, enough to even out the SMs' work, each thread walking rows
constexpr int kWaves = 8;

// kForm: bit 0, the scale is a tensor; bit 1, the zero point is (else
// each is by value and the kernel has no code for it); kNarrow: the
// narrow vector (instantiated for kForm 0 only)
template <int kOp, typename In, typename Out, typename Q, int kForm,
          bool kNarrow>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    qdq_kernel(const In* __restrict__ x, Out* __restrict__ y,
               const float* __restrict__ svec, const void* __restrict__ zvec,
               const EWPlan p, const Scalars sc) {
  constexpr int V = kNarrow ? narrow_width<In, Out>() : vec_width<In, Out>();
  constexpr bool kS = (kForm & 1) != 0, kZ = (kForm & 2) != 0;
  constexpr bool kTensor = kForm != 0;
  // a 32-bit dequantize subtracts the zero point's low 32 bits
  using ZReg = typename std::conditional<kOp == 1 && sizeof(In) <= 4, int,
                                         long long>::type;
  const long long C = p.cols, R = p.rows;
  const int bx = blockDim.x, tx = threadIdx.x;
  const long long seg_step = (long long)gridDim.x * bx * V;
  const long long r_first = (long long)blockIdx.y * blockDim.y + threadIdx.y;
  const long long r_step = (long long)gridDim.y * blockDim.y;
  constexpr bool s_tensor = kS, z_tensor = kZ;
  const bool s_inner = s_tensor && p.sb.inner;
  const bool z_inner = z_tensor && p.zb.inner;
  const bool s_outer = s_tensor && !p.sb.inner && p.sb.col_stride == 0;
  const bool z_outer = z_tensor && !p.zb.inner && p.zb.col_stride == 0;
  for (long long seg = (long long)blockIdx.x * bx * V; seg < C;
       seg += seg_step) {
    // the vector path takes columns c0 .. c0 + V - 1; the scalar path
    // (a ragged segment, an unaligned row) seg + tx + k * bx
    const long long c0 = seg + (long long)tx * V;
    const bool whole = seg + (long long)bx * V <= C;
    float sreg[kS ? V : 1];
    ZReg zreg[kZ ? V : 1];
    if constexpr (kTensor) {
      if (whole && s_inner) {
#pragma unroll
        for (int k = 0; k < V; ++k) sreg[k] = svec[(c0 + k) * p.sb.col_stride];
      }
      if (whole && z_inner) {
#pragma unroll
        for (int k = 0; k < V; ++k)
          zreg[k] = (ZReg)zp_load(zvec, (c0 + k) * p.zb.col_stride,
                                  p.zp_int64);
      }
    }
    for (long long r = r_first; r < R; r += r_step) {
      const In* xr = x + r * p.x_rs;
      Out* yr = y + r * C;
      long long so = 0, zo = 0;
      float s_row = sc.scale;
      long long z_row = sc.zp;
      if constexpr (kTensor) {
        if (s_tensor && !s_inner) so = row_offset(p.sb, (unsigned)r);
        if (z_tensor && !z_inner) zo = row_offset(p.zb, (unsigned)r);
        if (s_outer) s_row = svec[so];
        if (z_outer) z_row = zp_load(zvec, zo, p.zp_int64);
      }
      if (whole && aligned16(xr + seg, yr + seg)) {
        const Vec<In, V> in = load_vec<In, V>(xr + c0);
        Vec<Out, V> out;
#pragma unroll
        for (int k = 0; k < V; ++k) {
          float s = s_row;
          long long z = z_row;
          double sd = sc.scale_d;
          if constexpr (kTensor) {
            if (s_inner) s = sreg[k];
            else if (s_tensor && !s_outer)
              s = svec[so + (c0 + k) * p.sb.col_stride];
            if (s_tensor) sd = (double)s;
            if (z_inner) z = zreg[k];
            else if (z_tensor && !z_outer)
              z = zp_load(zvec, zo + (c0 + k) * p.zb.col_stride,
                          p.zp_int64);
          }
          out.v[k] = apply<kOp, In, Out, Q>(in.v[k], s, sd, z, p);
        }
        store_vec<Out, V>(yr + c0, out);
      } else {
        // every load of the segment's row first, then the results
        In in[V];
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const long long c = seg + tx + (long long)k * bx;
          if (c < C) in[k] = xr[c];
        }
#pragma unroll
        for (int k = 0; k < V; ++k) {
          const long long c = seg + tx + (long long)k * bx;
          if (c < C) {
            float s = s_row;
            long long z = z_row;
            double sd = sc.scale_d;
            if constexpr (kTensor) {
              if (s_tensor && !s_outer) s = svec[so + c * p.sb.col_stride];
              if (s_tensor) sd = (double)s;
              if (z_tensor && !z_outer)
                z = zp_load(zvec, zo + c * p.zb.col_stride, p.zp_int64);
            }
            yr[c] = apply<kOp, In, Out, Q>(in[k], s, sd, z, p);
          }
        }
      }
    }
  }
}

template <int kOp, typename In, typename Out, typename Q, int kForm,
          bool kNarrow = false>
int launch(const void* x, void* y, const void* svec, const void* zvec,
           const EWPlan& p, const Scalars& sc, cudaStream_t stream) {
  constexpr int V = kNarrow ? narrow_width<In, Out>() : vec_width<In, Out>();
  auto kernel = qdq_kernel<kOp, In, Out, Q, kForm, kNarrow>;
  // at most kWaves times the blocks resident on the whole card at once
  // (read once per kernel): enough blocks to even out, each thread then
  // walking rows
  static int resident = 0;
  if (resident == 0) {
    int dev = 0, sms = 0, per_sm = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads,
                                                  0);
    resident = (sms > 0 ? sms : 1) * (per_sm > 0 ? per_sm : 1) * kWaves;
  }
  const long long segs = (p.cols + (long long)p.bx * V - 1) / ((long long)p.bx * V);
  const long long row_blocks = (p.rows + p.by - 1) / p.by;
  long long gx = segs < resident ? segs : resident;
  long long gy_cap = resident / gx;
  if (gy_cap < 1) gy_cap = 1;
  if (gy_cap > 65535) gy_cap = 65535;
  long long gy = row_blocks < gy_cap ? row_blocks : gy_cap;
  kernel<<<dim3((unsigned)gx, (unsigned)gy), dim3(p.bx, p.by), 0, stream>>>(
      static_cast<const In*>(x), static_cast<Out*>(y),
      static_cast<const float*>(svec), zvec, p, sc);
  return (int)cudaGetLastError();
}

template <int kOp, typename In, typename Out, typename Q>
int launch_form(const void* x, void* y, const void* svec, const void* zvec,
                const EWPlan& p, const Scalars& sc, cudaStream_t stream) {
  switch ((p.scale_vec ? 1 : 0) | (p.zp_mode == 2 ? 2 : 0)) {
    case 1: return launch<kOp, In, Out, Q, 1>(x, y, svec, zvec, p, sc, stream);
    case 2: return launch<kOp, In, Out, Q, 2>(x, y, svec, zvec, p, sc, stream);
    case 3: return launch<kOp, In, Out, Q, 3>(x, y, svec, zvec, p, sc, stream);
    default:
      return p.narrow
                 ? launch<kOp, In, Out, Q, 0, true>(x, y, svec, zvec, p, sc,
                                                    stream)
                 : launch<kOp, In, Out, Q, 0>(x, y, svec, zvec, p, sc, stream);
  }
}

bool valid_operand(const Operand& o) {
  if (o.rdims < 0 || o.rdims > NQ_MAX_DIMS) return false;
  for (int d = 0; d + 1 < o.rdims; ++d)
    if (o.rsize[d] < 1 || o.shift[d] < 32 || o.shift[d] > 63) return false;
  return true;
}

bool valid(const EWPlan& p) {
  if (p.rows < 1 || p.cols < 1 || p.rows * p.cols >= (1LL << 31) ||
      p.x_rs < p.cols)
    return false;
  if (p.bx < 1 || p.by < 1 || p.bx * p.by != kThreads) return false;
  if (p.narrow && (p.scale_vec || p.zp_mode == 2)) return false;
  return valid_operand(p.sb) && valid_operand(p.zb);
}

using bf16 = __nv_bfloat16;
using i64 = long long;

}  // namespace

// One entry for the three ops: in_type/out_type index the pairs below.
extern "C" int nq_elementwise(const void* x, void* y, const void* svec,
                              const void* zvec, const EWPlan* plan,
                              float scale, double scale_d, long long zp,
                              void* stream) {
  const EWPlan p = *plan;
  if (!valid(p) || (p.scale_vec && svec == nullptr) ||
      (p.zp_mode == 2 && zvec == nullptr))
    return (int)cudaErrorInvalidValue;
  const Scalars sc{scale, scale_d, zp};
  const auto s = static_cast<cudaStream_t>(stream);
  const int pair = p.in_type * 3 + p.out_type;
  if (p.op == 0) {
    switch (pair) {
      case 0: return launch_form<0, float, int8_t, int>(x, y, svec, zvec, p, sc, s);
      case 1: return launch_form<0, float, int32_t, int>(x, y, svec, zvec, p, sc, s);
      case 2: return launch_form<0, float, i64, int>(x, y, svec, zvec, p, sc, s);
      case 3: return launch_form<0, bf16, int8_t, int>(x, y, svec, zvec, p, sc, s);
      case 4: return launch_form<0, bf16, int32_t, int>(x, y, svec, zvec, p, sc, s);
      case 5: return launch_form<0, bf16, i64, int>(x, y, svec, zvec, p, sc, s);
      default: break;
    }
  } else if (p.op == 1) {
    switch (pair) {  // out_type 0 f32, 1 bf16
      case 0: return launch_form<1, int8_t, float, int>(x, y, svec, zvec, p, sc, s);
      case 1: return launch_form<1, int8_t, bf16, int>(x, y, svec, zvec, p, sc, s);
      case 3: return launch_form<1, int32_t, float, int>(x, y, svec, zvec, p, sc, s);
      case 4: return launch_form<1, int32_t, bf16, int>(x, y, svec, zvec, p, sc, s);
      case 6: return launch_form<1, i64, float, int>(x, y, svec, zvec, p, sc, s);
      case 7: return launch_form<1, i64, bf16, int>(x, y, svec, zvec, p, sc, s);
      default: break;
    }
  } else if (p.op == 2) {
    switch (pair) {  // out_type is the container; y is f32
      case 0: return launch_form<2, float, float, int8_t>(x, y, svec, zvec, p, sc, s);
      case 1: return launch_form<2, float, float, int32_t>(x, y, svec, zvec, p, sc, s);
      case 2: return launch_form<2, float, float, i64>(x, y, svec, zvec, p, sc, s);
      case 3: return launch_form<2, bf16, float, int8_t>(x, y, svec, zvec, p, sc, s);
      case 4: return launch_form<2, bf16, float, int32_t>(x, y, svec, zvec, p, sc, s);
      case 5: return launch_form<2, bf16, float, i64>(x, y, svec, zvec, p, sc, s);
      default: break;
    }
  }
  return (int)cudaErrorInvalidValue;
}
