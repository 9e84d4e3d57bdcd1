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
// Design: one CTA per (tile of ROWS query rows, head, batch row). The
// CTA stages its head's K and V slices ([N, D] int8 each) in shared
// memory once, with 16-byte global loads, so every K/V byte is read from
// device memory once per tile and the [N, N] scores and probabilities
// never leave the SM. A warp owns one query row at a time: integer
// scores by __dp4a (exact in int32), warp-shuffle max and sum, the
// probabilities quantized to int8 in shared memory, then the P.V
// product in int32 with one or more output columns per lane. Shared
// rows are padded by one word so that lanes reading 32 different key
// rows hit 32 different banks. The correction sums (k row sums, v
// column sums) are computed once per CTA. Sequences are not padded: the
// correction term zp_p*zv*n_lane of the TPU kernel is zp_p*zv*N here,
// the same integer, since its pad rows and pad probabilities cancel.
// This simple design runs the products on the integer ALUs, not the
// tensor cores; wgmma and TMA are later work.
//
// The score bias ([H, nq, N] f32, the same for every batch row) is read
// from global memory along the row a warp owns, at the graph Add's
// position.
//
// Numerics: the exact variant (fast=0) keeps the JAX op order -- int32
// corrections; s = f32(scores)*(sq*sk), then *scaling; + bias[h, i, j];
// + mask where key j is not visible from row i (j > i, or j <= i -
// window); max; expf(s-m); e/sum; rint(clip(p/sp + zp_p)). Its row sum
// adds the row's exp values from shared memory in the order of torch's
// CUDA sum (torch_order.cuh), so where torch reduces the row in one warp
// the kernel equals the unfused executor bit for bit. The fast variant
// folds log2(e) into the dequant constant (and into the bias, on the
// host) and uses exp2f, an optional static score_max shift (clamped to
// [-120, 80], no max pass), drops the zk row term, r = 1/(sum*sp), and
// clips only the bounds the host says can be crossed; its row sum is a
// per-lane strided sum and a warp tree. Multiplies and adds use the _rn
// intrinsics so that no FMA contraction changes a rounding; division is
// IEEE (__fdiv_rn); rounding is half-to-even (__float2int_rn).

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "torch_order.cuh"

// Shared with csrc/attention_hs_blockq.cu (``skip`` is that kernel's).
struct HSParams {
  int B, nq, N, H, D, zq, zk, zv, zp_p, fast, static_shift, need_lo,
      need_hi, out_int8, has_res_zp, causal, window, skip, has_bias, sum_vec,
      sum_lanes, sum_tile;  // sum_tile: csrc/attention_hs_blockq.cu's
  float c_score, scaling, czq, base, sp, zp_pf, c_out, res_scale, res_zp,
      qmin, qmax, mask;
};

namespace {

constexpr int kWarps = 8;
constexpr int kRows = 64;  // query rows per CTA

__host__ __device__ inline int round_up4(int x) { return (x + 3) & ~3; }

// shared memory: K [N][D/4+1] words, V [N][D/4+1] words, k row sums [N],
// v column sums [D], per-warp score/exp rows [kWarps][N] f32, per-warp
// quantized probability rows [kWarps][round_up4(N)] int8
__host__ __device__ inline size_t smem_bytes(int n, int d) {
  const int ws = d / 4 + 1;
  return sizeof(int) * (size_t)(2 * n * ws + n + d + kWarps * n) +
         (size_t)kWarps * round_up4(n);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ void put4(int* dst, int4 v) {
  dst[0] = v.x;
  dst[1] = v.y;
  dst[2] = v.z;
  dst[3] = v.w;
}

template <int D>
__global__ void __launch_bounds__(kWarps * 32)
    attention_hs_kernel(const int8_t* __restrict__ xq,
                        const int8_t* __restrict__ xk,
                        const int8_t* __restrict__ xv,
                        const float* __restrict__ bias,
                        void* __restrict__ out, const HSParams p) {
  constexpr int W = D / 4;    // int8x4 words per head row
  constexpr int WS = W + 1;   // padded shared row stride in words
  constexpr int C16 = D / 16; // 16-byte chunks per head row
  constexpr int CPL = (D + 31) / 32;  // output columns per lane
  extern __shared__ int smem[];
  const int n = p.N;
  int* s_k = smem;
  int* s_v = s_k + n * WS;
  int* s_ksum = s_v + n * WS;
  int* s_vsum = s_ksum + n;
  float* s_e = reinterpret_cast<float*>(s_vsum + D);
  int8_t* s_p = reinterpret_cast<int8_t*>(s_e + kWarps * n);

  const int b = blockIdx.z, h = blockIdx.y, row0 = blockIdx.x * kRows;
  const int hd = p.H * D;
  const size_t kv_base = (size_t)b * n * hd + (size_t)h * D;
  for (int idx = threadIdx.x; idx < n * C16; idx += blockDim.x) {
    const int j = idx / C16, c = idx - j * C16;
    const size_t g = kv_base + (size_t)j * hd + c * 16;
    put4(s_k + j * WS + c * 4, __ldg(reinterpret_cast<const int4*>(xk + g)));
    put4(s_v + j * WS + c * 4, __ldg(reinterpret_cast<const int4*>(xv + g)));
  }
  __syncthreads();
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    int s = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) s = __dp4a(s_k[j * WS + w], 0x01010101, s);
    s_ksum[j] = s;
  }
  const int8_t* v_bytes = reinterpret_cast<const int8_t*>(s_v);
  for (int c = threadIdx.x; c < D; c += blockDim.x) {
    int s = 0;
    for (int j = 0; j < n; ++j) s += v_bytes[j * WS * 4 + c];
    s_vsum[c] = s;
  }
  __syncthreads();

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  float* e_row = s_e + warp * n;
  int8_t* p_row = s_p + warp * round_up4(n);
  const int row_end = min(row0 + kRows, p.nq);
  for (int r = row0 + warp; r < row_end; r += kWarps) {
    const size_t q_off = ((size_t)b * p.nq + r) * hd + (size_t)h * D;
    int qw[W];
#pragma unroll
    for (int c = 0; c < C16; ++c) {
      const int4 t = __ldg(reinterpret_cast<const int4*>(xq + q_off + c * 16));
      qw[4 * c] = t.x;
      qw[4 * c + 1] = t.y;
      qw[4 * c + 2] = t.z;
      qw[4 * c + 3] = t.w;
    }
    int q_sum = 0;
#pragma unroll
    for (int w = 0; w < W; ++w) q_sum = __dp4a(qw[w], 0x01010101, q_sum);
    const float* b_row =
        p.has_bias ? bias + ((size_t)h * p.nq + r) * n : nullptr;

    // scores -> dequantized logits (lane owns keys lane, lane+32, ...)
    float local_max = -INFINITY;
    for (int j = lane; j < n; j += 32) {
      const int* kr = s_k + j * WS;
      int acc = 0;
#pragma unroll
      for (int w = 0; w < W; ++w) acc = __dp4a(qw[w], kr[w], acc);
      float s;
      if (!p.fast) {
        if (p.zk) acc -= q_sum * p.zk;
        if (p.zq) acc -= s_ksum[j] * p.zq;
        if (p.zq && p.zk) acc += p.zq * p.zk * D;
        s = __fmul_rn(__fmul_rn(__int2float_rn(acc), p.c_score), p.scaling);
      } else {
        const float col = p.zq ? __fadd_rn(__fmul_rn(__int2float_rn(s_ksum[j]),
                                                     p.czq), p.base)
                               : p.base;
        s = __fadd_rn(__fmul_rn(__int2float_rn(acc), p.c_score), col);
      }
      // score bias: the graph Add(scaled scores, bias) (pre-scaled by
      // log2(e) on the fast path)
      if (b_row) s = __fadd_rn(s, __ldg(b_row + j));
      // decoder mask: the graph Add(scaled scores, mask constant), at its
      // position in the op order (p.mask is pre-scaled by log2(e) on the
      // fast path)
      if (p.causal && !(j <= r && (p.window <= 0 || j > r - p.window)))
        s = __fadd_rn(s, p.mask);
      e_row[j] = s;
      local_max = fmaxf(local_max, s);
    }
    const bool static_shift = p.fast && p.static_shift;
    const float m = static_shift ? 0.f : warp_max(local_max);
    float local_sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float s = e_row[j];
      float e;
      if (!p.fast)
        e = expf(__fsub_rn(s, m));
      else if (static_shift)
        e = exp2f(fminf(fmaxf(s, -120.f), 80.f));
      else
        e = exp2f(__fsub_rn(s, m));
      e_row[j] = e;
      local_sum = __fadd_rn(local_sum, e);
    }
    float sum;
    if (p.fast) {
      sum = warp_sum(local_sum);
    } else {
      // the row is row (b*H + h)*nq + r of the unfused [B, H, nq, N] exp
      __syncwarp();
      const int shift =
          (int)(((((size_t)b * p.H + h) * p.nq + r) * (size_t)n) & 3);
      sum = torch_order_warp_sum(e_row, n, shift, p.sum_vec, p.sum_lanes,
                                 lane);
    }

    // probabilities -> int8 (and their row sum for the zv correction)
    int local_ps = 0;
    if (!p.fast) {
      for (int j = lane; j < n; j += 32) {
        const float prob = __fdiv_rn(e_row[j], sum);
        float t = __fadd_rn(__fdiv_rn(prob, p.sp), p.zp_pf);
        t = fminf(fmaxf(t, p.qmin), p.qmax);
        const int8_t q = (int8_t)__float2int_rn(t);
        p_row[j] = q;
        local_ps += q;
      }
    } else {
      const float rcp = __fdiv_rn(1.f, __fmul_rn(sum, p.sp));
      for (int j = lane; j < n; j += 32) {
        float t = __fadd_rn(__fmul_rn(e_row[j], rcp), p.zp_pf);
        if (p.need_lo) t = fmaxf(t, p.qmin);
        if (p.need_hi) t = fminf(t, p.qmax);
        const int8_t q = (int8_t)__float2int_rn(t);
        p_row[j] = q;
        local_ps += q;
      }
    }
    const int p_sum = warp_sum(local_ps);
    __syncwarp();

    // context = probs_q @ v (lane owns columns lane, lane+32, ...)
    int acc[CPL];
#pragma unroll
    for (int t = 0; t < CPL; ++t) acc[t] = 0;
    for (int j = 0; j < n; ++j) {
      const int pj = p_row[j];
      const int8_t* vr = v_bytes + j * WS * 4;
#pragma unroll
      for (int t = 0; t < CPL; ++t) {
        const int c = lane + 32 * t;
        if (c < D) acc[t] += pj * (int)vr[c];
      }
    }
#pragma unroll
    for (int t = 0; t < CPL; ++t) {
      const int c = lane + 32 * t;
      if (c >= D) continue;
      int ctx = acc[t];
      if (p.zv) ctx -= p_sum * p.zv;
      if (p.zp_p) ctx -= s_vsum[c] * p.zp_p;
      if (p.zv && p.zp_p) ctx += p.zp_p * p.zv * n;
      const float y = __fmul_rn(__int2float_rn(ctx), p.c_out);
      const size_t o = q_off + c;
      if (p.out_int8) {
        float yq = p.fast ? y : __fdiv_rn(y, p.res_scale);
        if (p.has_res_zp) yq = __fadd_rn(yq, p.res_zp);
        yq = fminf(fmaxf(yq, p.qmin), p.qmax);
        static_cast<int8_t*>(out)[o] = (int8_t)__float2int_rn(yq);
      } else {
        static_cast<float*>(out)[o] = y;
      }
    }
    __syncwarp();
  }
}

template <int D>
cudaError_t launch(const int8_t* xq, const int8_t* xk, const int8_t* xv,
                   const float* bias, void* out, const HSParams& p,
                   cudaStream_t stream) {
  const size_t smem = smem_bytes(p.N, D);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        attention_hs_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return e;
  }
  const dim3 grid((p.nq + kRows - 1) / kRows, p.H, p.B);
  attention_hs_kernel<D><<<grid, kWarps * 32, smem, stream>>>(xq, xk, xv,
                                                               bias, out, p);
  return cudaGetLastError();
}

}  // namespace

extern "C" long long nq_attention_hs_smem_bytes(int n, int d) {
  return (long long)smem_bytes(n, d);
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
  switch (p.D) {
    case 16: return (int)launch<16>(q, k, v, b, out, p, s);
    case 32: return (int)launch<32>(q, k, v, b, out, p, s);
    case 64: return (int)launch<64>(q, k, v, b, out, p, s);
    case 128: return (int)launch<128>(q, k, v, b, out, p, s);
    default: return (int)cudaErrorInvalidValue;
  }
}
