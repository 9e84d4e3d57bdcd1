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

// The tiled kernels (csrc/attention_hs_blockq.cu, csrc/attention_plain.cu)
// see a row one key tile at a time. They stream it into the same lane
// accumulators: lane L of the warp that owns the row keeps a[0..3] for it
// across the tiles, and each key of a tile goes to the (lane, accumulator)
// that torch's order gives it:
//   * vectorized: the head (key k < 4 - shift) into a0 of lane shift + k;
//     body key start + 4v + i (start = (4 - shift) % 4) into a_i of lane
//     v mod lanes; the tail (key start + 4 nvec + L) into a0 of lane L;
//   * strided: key k into a_((k / lanes) mod 4) of lane k mod lanes.
// Each (lane, accumulator) pair receives its keys in increasing order and
// the tiles come in key order, so the streamed sums equal
// torch_order_warp_sum's bit for bit; keys of a tile the kernel skips are
// exact zeros, which change no sum. torch_order_finish then combines the
// accumulators and runs the lane tree as above.

// Adds keys [j0, j0 + tile_keys) of one row whose start lies `shift`
// elements past an aligned address, e[0..tile_keys) in shared memory, to
// lane `lane`'s accumulators of that row.
__device__ __forceinline__ void torch_order_stream(float (&a)[4],
                                                   const float* e, int j0,
                                                   int tile_keys, int n,
                                                   int shift, int vec,
                                                   int lanes, int lane) {
  if (lane >= lanes) return;
  const int jend = j0 + tile_keys;
  if (vec) {
    // lanes == 32 from N >= 128 on. Vectorized loads take the head's
    // 4 - shift keys first (none when shift is 0), then 4-vectors from
    // start = (4 - shift) % 4 up to body_end, then the tail.
    const int start = shift ? 4 - shift : 0;
    const int end = shift ? n + shift - 4 : n;
    const int body_end = start + 4 * (end >> 2);
    if (tile_keys == 64 && (j0 & 63) == 0 && j0 >= start && jend <= body_end) {
      // a 64-key tile of body keys only: accumulator i of lane L takes the
      // key at offset (start + 4L + i - j0) mod 128, where that lies in the
      // tile (body key start + 4v + i goes to lane v mod 32)
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int k = (start + 4 * lane + i - j0) & 127;
        if (k < 64) a[i] = __fadd_rn(a[i], e[k]);
      }
      return;
    }
    if (shift) {
      const int k = lane - shift;  // the head, lanes shift..3
      if (lane >= shift && lane < 4 && k >= j0 && k < jend)
        a[0] = __fadd_rn(a[0], e[k - j0]);
    }
    const int lo = max(j0, start), hi = min(jend, body_end);
    if (lo < hi) {
      const int v_first = (lo - start) >> 2, v_last = (hi - 1 - start) >> 2;
      const int v = v_first + ((lane - v_first) & (lanes - 1));
      if (v <= v_last) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int k = start + 4 * v + i;
          if (k >= j0 && k < jend) a[i] = __fadd_rn(a[i], e[k - j0]);
        }
      }
    }
    const int k = body_end + lane;  // the tail
    if (lane < (end & 3) && k >= j0 && k < jend)
      a[0] = __fadd_rn(a[0], e[k - j0]);
  } else {
    for (int k = j0 + ((lane - j0) & (lanes - 1)); k < jend; k += lanes) {
      const float x = e[k - j0];
      switch ((k / lanes) & 3) {
        case 0: a[0] = __fadd_rn(a[0], x); break;
        case 1: a[1] = __fadd_rn(a[1], x); break;
        case 2: a[2] = __fadd_rn(a[2], x); break;
        default: a[3] = __fadd_rn(a[3], x); break;
      }
    }
  }
}

// (row * n) % 4 of query row `r` of head `head` in the plain version's
// softmax tensor: its q rows run in tiles of `tile` rows, each summed as
// a contiguous [heads, rows of the tile, n] tensor.
__device__ __forceinline__ int torch_order_shift(long long head, int r,
                                                 int rows, int tile, int n) {
  const int r0 = (r / tile) * tile;
  const long long tr = min(tile, rows - r0);
  return (int)(((head * tr + (r - r0)) * (long long)n) & 3);
}

// One warp's step over a key tile for ROWS consecutive query rows
// row0.. of head `head` (of `rows` in all, plain q tiles of `tile` rows):
// row row0 + r has its exp tile at e + r * pitch (16-byte aligned rows)
// and its lane accumulators in a[r]. Where N % 4 == 0 every row starts
// aligned and a full tile holds body keys only, so lane L's 4-vector is
// the one at offset (4L - j0) mod 128, the same for every row.
template <int ROWS>
__device__ __forceinline__ void torch_order_stream_rows(
    float (&a)[ROWS][4], const float* e, int pitch, int j0, int tile_keys,
    int n, long long head, int row0, int rows, int tile, int vec, int lanes,
    int lane) {
  if (vec && (n & 3) == 0 && tile_keys == 64 && (j0 & 63) == 0) {
    const int base = (4 * lane - j0) & 127;
    if (base < 64) {
#pragma unroll
      for (int r = 0; r < ROWS; ++r) {
        const float4 x = *reinterpret_cast<const float4*>(e + r * pitch + base);
        a[r][0] = __fadd_rn(a[r][0], x.x);
        a[r][1] = __fadd_rn(a[r][1], x.y);
        a[r][2] = __fadd_rn(a[r][2], x.z);
        a[r][3] = __fadd_rn(a[r][3], x.w);
      }
    }
    return;
  }
#pragma unroll
  for (int r = 0; r < ROWS; ++r)
    torch_order_stream(
        a[r], e + r * pitch, j0, tile_keys, n,
        torch_order_shift(head, min(row0 + r, rows - 1), rows, tile, n), vec,
        lanes, lane);
}

// The row's sum from its streamed accumulators, in every lane of the warp
// (every lane of the warp must call it).
__device__ __forceinline__ float torch_order_finish(const float (&a)[4],
                                                    int lanes) {
  float v = __fadd_rn(__fadd_rn(__fadd_rn(a[0], a[1]), a[2]), a[3]);
  for (int o = lanes >> 1; o > 0; o >>= 1)
    v = __fadd_rn(v, __shfl_down_sync(0xffffffffu, v, o));
  return __shfl_sync(0xffffffffu, v, 0);
}
