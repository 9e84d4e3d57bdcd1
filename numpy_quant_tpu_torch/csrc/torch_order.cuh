// Softmax row sums in the order of torch's CUDA sum, shared by
// csrc/attention_hs.cu, csrc/attention_hs_blockq.cu and
// csrc/attention_plain.cu.
//
// The unfused executor divides each row of exp(s - m) by its torch sum over
// the last dim of a contiguous [rows, N] float32 tensor. ATen's Reduce.cuh
// reduces such a row in one warp of `lanes` (<= 32) threads while rows and
// N leave it so (kernels/attention.py::in_torch_order): each lane adds into
// 4 accumulators, which it combines ((a0 + a1) + a2) + a3, then a
// shfl_down tree with offsets lanes/2..1 adds the lanes.
//   * N >= 128 (vectorized): lane L adds the 4-vectors at 4L, 4L + 4*lanes,
//     ... of the row's 16-byte aligned body; a row that starts `shift`
//     elements past an aligned address first puts its 4 - shift head
//     elements into a0 of lanes shift..3, and the elements after the last
//     full vector go into a0 of lanes 0.. last.
//   * N < 128: lane L's accumulator i adds elements L + i*lanes +
//     4*lanes*k in order of k.
// Adding the same numbers in the same order gives the same float, so an
// exact kernel that sums its rows so equals the unfused executor bit for
// bit. kernels/attention.py::torch_order_sum replays the order on the host,
// and torch_sums_in_kernel_order checks torch against it.
#pragma once

#include <cuda_runtime.h>

// One warp's row sum of e[0..n) (shared memory) in torch's order: `shift`
// is the row's misalignment in elements ((row * n) % 4 in the summed
// tensor), `vec` and `lanes` come from kernels/attention.py::sum_order.
// Returns the sum in every lane of the warp.
__device__ __forceinline__ float torch_order_warp_sum(const float* e, int n,
                                                      int shift, int vec,
                                                      int lanes, int lane) {
  float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f;
  if (lane < lanes) {
    if (vec) {
      int start = 0, end = n;
      if (shift) {
        if (lane >= shift && lane < 4) a0 = e[lane - shift];
        start = 4 - shift;
        end = n + shift - 4;
      }
      const float* body = e + start;
      const int nvec = end >> 2;
      for (int v = lane; v < nvec; v += lanes) {
        a0 = __fadd_rn(a0, body[4 * v]);
        a1 = __fadd_rn(a1, body[4 * v + 1]);
        a2 = __fadd_rn(a2, body[4 * v + 2]);
        a3 = __fadd_rn(a3, body[4 * v + 3]);
      }
      if (lane < (end & 3)) a0 = __fadd_rn(a0, body[4 * nvec + lane]);
    } else {
      for (int k = lane; k < n; k += 4 * lanes) {
        a0 = __fadd_rn(a0, e[k]);
        if (k + lanes < n) a1 = __fadd_rn(a1, e[k + lanes]);
        if (k + 2 * lanes < n) a2 = __fadd_rn(a2, e[k + 2 * lanes]);
        if (k + 3 * lanes < n) a3 = __fadd_rn(a3, e[k + 3 * lanes]);
      }
    }
  }
  float v = __fadd_rn(__fadd_rn(__fadd_rn(a0, a1), a2), a3);
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}

// The tiled kernels (q tiles of 16 threads per row, 4 keys per thread at
// tx + 16*j of each 64-key tile) keep a row's 128 vectorized partial sums
// (one per key mod 128) in part[h][i][j]: key tx + 16 j + 64 h of every
// 128-key period, h being the parity of the 64-key tile. That is torch's
// vectorized order for rows that start aligned, i.e. N % 4 == 0 and
// N >= 128 with 32 lanes.

// exp(s - m) of one 64-key tile into the partial sums of its half period
template <int RPT, int KPT>
__device__ __forceinline__ void torch_order_add_exp(float (&part)[RPT][KPT],
                                                    const float (&s)[RPT][KPT],
                                                    const float (&m)[RPT],
                                                    int j0, int tx, int n) {
#pragma unroll
  for (int i = 0; i < RPT; ++i)
#pragma unroll
    for (int j = 0; j < KPT; ++j)
      if (j0 + tx + 16 * j < n)
        part[i][j] = __fadd_rn(part[i][j], expf(__fsub_rn(s[i][j], m[i])));
}

// Row i's sum from the partial sums: lane L's accumulators 4L..4L+3 sit in
// threads tx = 4c..4c+3 of the row's half warp (L = 16 h + 4 j + c); the
// quad leader tx = 4c forms the lane values, and the tree runs on the
// leaders. Returns the sum in all 16 threads of the row.
template <int RPT, int KPT>
__device__ __forceinline__ float torch_order_tile_sum(
    const float (&part)[2][RPT][KPT], int i) {
  static_assert(KPT == 4, "16 threads of 4 keys per 64-key tile");
  constexpr unsigned kAll = 0xffffffffu;
  float v[2][KPT];
#pragma unroll
  for (int h = 0; h < 2; ++h)
#pragma unroll
    for (int j = 0; j < KPT; ++j) {
      const float x0 = part[h][i][j];
      const float x1 = __shfl_down_sync(kAll, x0, 1);
      const float x2 = __shfl_down_sync(kAll, x0, 2);
      const float x3 = __shfl_down_sync(kAll, x0, 3);
      v[h][j] = __fadd_rn(__fadd_rn(__fadd_rn(x0, x1), x2), x3);
    }
  // offsets 16, 8, 4 within a leader; 2 and 1 across leaders
  const float w2a = __fadd_rn(__fadd_rn(v[0][0], v[1][0]),
                              __fadd_rn(v[0][2], v[1][2]));
  const float w2b = __fadd_rn(__fadd_rn(v[0][1], v[1][1]),
                              __fadd_rn(v[0][3], v[1][3]));
  const float w3 = __fadd_rn(w2a, w2b);
  const float w4 = __fadd_rn(w3, __shfl_down_sync(kAll, w3, 8));
  const float r = __fadd_rn(w4, __shfl_down_sync(kAll, w4, 4));
  // the row's tx = 0 holds the sum: lane 0 or 16 of the warp
  return __shfl_sync(kAll, r, threadIdx.x & 16);
}
