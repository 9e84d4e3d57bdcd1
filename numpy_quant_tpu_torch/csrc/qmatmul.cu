// Quantized matmul over packed integer weights, for Hopper (sm_90a).
//
// Replaces the TPU kernels numpy_quant_tpu/kernels/qmatmul.py:246
// splitk_qmatmul (split-K payload, 1/2/4/8 bits) and :533 packed_qmatmul
// (bit-planes, any width 1..8). For x [M, K] and a packed symmetric
// weight W [K, N]:
//   xq  = x as int8, or quantize(x) (IEEE divide, +zp, clip, rint)
//   acc = xq @ W                  int32, exact
//   acc -= colsum[n] * x_zp       int32
//   y   = f32(acc) * scale_row[n] scale_row = x_scale * w_scale[n] (f32)
//   y  += bias[n]
//   out = y (f32), or int8 clip(rint(y * inv_res + res_zp))
//
// Bounds at ViT-Base serving shapes on an H100 SXM (M = 96*197 = 18,912,
// int8 x, f32 out; 3.35 TB/s, 1,979 int8 TOPS): 768->768 and 768->3072
// are bound by bytes, mostly the f32 output they write (58 and 232 MB:
// 22 and 74 us); 3072->768 by its 8.9e10 int8 operations (45 us).
//
// Design: persistent blocks, each owning one weight panel. The host plan
// (kernels/qmatmul.py::qmm_plan) launches about one block per SM; block b
// takes the N-panel b % panels of BN columns and a contiguous range of
// 64-row M tiles. Its two consumer warpgroups first decode the whole
// panel (K x BN) once into shared memory as int8, in the layout wgmma
// reads B from (K-major, 128-byte swizzle), with word-level decoders: a
// bit-plane nibble spreads into the low bit of 4 bytes with one multiply,
// split-K fields are masked 4 bytes at a time, and 4x4 byte blocks are
// transposed with byte permutes. The block then walks its M tiles, in
// pairs, against the resident panel. x reaches shared memory through a
// ring of stages (128 K bytes of 64 or 128 rows) guarded by mbarriers: a
// producer warpgroup fills it with TMA loads (int8 x, K % 16 == 0,
// 16-byte aligned base: the fast form) or, in the general form (int32 x,
// f32 x to quantize, ragged K), with loads that convert in registers and
// store in the same swizzled layout. Each consumer warpgroup runs
// wgmma.m64nBNk32.s32.s8.s8 on one tile of each pair, one 128-byte K
// chunk per stage, keeping one chunk's products in flight while it
// releases the stage before. With the widest panel (128 columns, whose
// f32 epilogue is long) the warpgroups take turns at the products, so
// that one's epilogue runs under the other's products; with narrower
// panels (K = 3072 leaves room for 32 columns) they run together, as one
// warpgroup's m64n32 products cannot keep the tensor cores busy. The
// epilogue applies the scalar steps below in registers, stages the tile
// in shared memory and hands it to TMA stores in whole lines, which run
// on while the next products start. Where K is too deep for a panel of 32
// columns, the panel holds a K slab and is decoded again per slab and
// tile pair. Blocks that share an M range have consecutive indices and
// walk their tiles in the same order, so the x tiles they all read hit in
// L2.
//
// Numerics: the epilogue keeps the JAX kernels' order, one rounding per
// step, with the _rn intrinsics so that nvcc contracts nothing into an
// FMA; the quantize divides with __fdiv_rn and clips before rounding,
// the requantize multiplies by the host's f32(1/res_scale) and rounds
// before clipping; rounding is half-to-even (rintf, __float2int_rn).

#include <cuda.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

// Mirror of kernels/qmatmul.py::_QMMParams. The last row is the launch
// plan: panel width, ring stages, panels, M ranges, M tiles, K bytes per
// panel slab, slabs, dynamic shared bytes, the x form (1 = TMA), the
// output's (1 = TMA stores: f32 out with N % 4 == 0), and the consumer
// schedule (1 = turns, 0 = together; see ring_index).
struct QMMParams {
  int M, N, K, KR, bits, x_type, quantize_x, has_zp, x_zp, has_bias,
      has_wvec, out_int8, has_res_zp, w_vec;
  float x_scale, scale, inv_res, res_zp, xq_lo, xq_hi, rq_lo, rq_hi;
  int bn, stages, panels, ranges, m_tiles, slab, slabs, smem, tma,
      tma_out, turns;
};

namespace {

constexpr int kSplitK = 0;
constexpr int kBitPlanes = 1;

constexpr int BM = 64;          // rows of x per M tile (a warpgroup's)
constexpr int BK = 128;         // K bytes per ring stage, one swizzle row
constexpr int kThreads = 384;   // warpgroups 0-1 consume, 2 produces
constexpr int kConsumers = 256;
constexpr int kProducers = 128;
constexpr int kBarConsumers = 1;  // named barriers (0 is __syncthreads)
constexpr int kBarGroup = 2;      // + consumer warpgroup index
constexpr int kBarTurn = 4;       // + the warpgroup whose turn ended

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// Byte offset of (row, k) in a tile of 128-byte rows under the 128-byte
// swizzle that TMA writes and wgmma reads: the 16-byte unit k / 16 of a
// row is stored at unit (k / 16) ^ (row % 8). Tiles start 1024-aligned.
__device__ __forceinline__ int swz(int row, int k) {
  return row * BK + ((((k >> 4) ^ row) & 7) << 4) + (k & 15);
}

// wgmma operand descriptor of a K-major tile under the 128-byte swizzle:
// start address / 16, leading offset 16 (unused by this layout), stride
// 1024 bytes between 8-row groups, layout type 1 (128-byte swizzle).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr) {
  return (uint64_t)((addr >> 4) & 0x3FFF) | ((uint64_t)1 << 16) |
         ((uint64_t)(1024 >> 4) << 32) | ((uint64_t)1 << 62);
}

__device__ __forceinline__ void bar_sync(int id, int count) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}
__device__ __forceinline__ void bar_arrive(int id, int count) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(count) : "memory");
}

// Shared-memory writes of the generic proxy made visible to wgmma and TMA.
__device__ __forceinline__ void fence_async_smem() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                   smem_u32(bar)) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
               ::"r"(smem_u32(bar)), "r"(bytes) : "memory");
}

// Wait until the barrier's phase of parity `parity` has completed. A wait
// past ~2^34 cycles (seconds) traps, so that a fault shows as a launch
// error instead of a hung card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const uint32_t addr = smem_u32(bar);
  uint32_t done;
  long long start = -1;
  for (;;) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(addr), "r"(parity) : "memory");
    if (done) return;
    if (start < 0) start = clock64();
    else if (clock64() - start > (1ll << 34)) __trap();
  }
}

// One TMA load of the box at (k, m) of x into shared memory, completing
// its bytes on `bar`.
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map,
                                         uint64_t* bar, int k, int m) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n"
      ::"r"(smem_u32(dst)), "l"(reinterpret_cast<uint64_t>(map)),
      "r"(smem_u32(bar)), "r"(k), "r"(m) : "memory");
}

// One TMA store of a staged 64-row x 32-column f32 box to out at (n, m);
// rows past M and columns past N are not written.
__device__ __forceinline__ void tma_store(const CUtensorMap* map,
                                          const void* src, int n, int m) {
  asm volatile(
      "cp.async.bulk.tensor.2d.global.shared::cta.bulk_group"
      " [%0, {%2, %3}], [%1];\n"
      ::"l"(reinterpret_cast<uint64_t>(map)), "r"(smem_u32(src)), "r"(n),
      "r"(m) : "memory");
}
__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}
// Until the committed stores have read their shared memory / completed.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// Word offset of output (row, col) in a warpgroup's staged f32 tile: one
// 64 x 32 box (8 KB) per 32 columns, each row 128 bytes under the 128-byte
// swizzle, as the TMA store reads it.
__device__ __forceinline__ int staged_f32(int row, int col) {
  return (col >> 5) * (64 * 32) + row * 32 +
         ((((col >> 2) & 7) ^ (row & 7)) << 2) + (col & 3);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wg_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}
// Keeps the compiler from moving accumulator reads or writes across the
// asynchronous products.
template <int R>
__device__ __forceinline__ void fence_acc(int* d) {
#pragma unroll
  for (int i = 0; i < R; ++i) asm volatile("" : "+r"(d[i])::"memory");
}

// d[64 x BN] = A[64 x 32] * B[32 x BN]^T (+ d where `accumulate`), s8 x
// s8 -> s32, both operands in shared memory (K-major). Thread t of the
// warpgroup holds, for each 8-column block j, d[4j + 2h + e] = (row
// 16 (t / 32) + (t % 32) / 4 + 8h, column 8j + 2 (t % 4) + e).
template <int BN>
__device__ __forceinline__ void wgmma(int* d, uint64_t a, uint64_t b,
                                      int accumulate);

#define D(i) "+r"(d[i])
template <>
__device__ __forceinline__ void wgmma<32>(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15"
      "}, %16, %17, p;\n}\n"
      : D(0), D(1), D(2), D(3), D(4), D(5), D(6), D(7), D(8), D(9),
        D(10), D(11), D(12), D(13), D(14), D(15)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<64>(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, %32, %33, p;\n}\n"
      : D(0), D(1), D(2), D(3), D(4), D(5), D(6), D(7), D(8), D(9),
        D(10), D(11), D(12), D(13), D(14), D(15), D(16), D(17), D(18), D(19),
        D(20), D(21), D(22), D(23), D(24), D(25), D(26), D(27), D(28), D(29),
        D(30), D(31)
      : "l"(a), "l"(b), "r"(accumulate));
}

template <>
__device__ __forceinline__ void wgmma<128>(int* d, uint64_t a, uint64_t b,
                                          int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k32.s32.s8.s8 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, "
      "%12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, "
      "%36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, "
      "%60, %61, %62, %63"
      "}, %64, %65, p;\n}\n"
      : D(0), D(1), D(2), D(3), D(4), D(5), D(6), D(7), D(8), D(9),
        D(10), D(11), D(12), D(13), D(14), D(15), D(16), D(17), D(18), D(19),
        D(20), D(21), D(22), D(23), D(24), D(25), D(26), D(27), D(28), D(29),
        D(30), D(31), D(32), D(33), D(34), D(35), D(36), D(37), D(38), D(39),
        D(40), D(41), D(42), D(43), D(44), D(45), D(46), D(47), D(48), D(49),
        D(50), D(51), D(52), D(53), D(54), D(55), D(56), D(57), D(58), D(59),
        D(60), D(61), D(62), D(63)
      : "l"(a), "l"(b), "r"(accumulate));
}

#undef D

// The epilogue of one warpgroup's 64 x BN tile, in the plain version's
// order, into its staging: acc - colsum * x_zp (int32), times the scale
// row, plus the bias, then (int8 out) times 1/res_scale, plus res_zp,
// rint, clip. Each form is its own branch-free loop, so that the compiler
// overlaps the constants' loads of one column pair with the arithmetic
// of the last. Adding a res_zp of 0 changes no int8 result.
template <int BN, bool kBias, bool kInt8>
__device__ __forceinline__ void epilogue_tile(
    const int* acc, const int* corr_s, const float* scale_s,
    const float* bias_s, float* st, const QMMParams& p, int warp, int g,
    int q) {
  constexpr int kLd8 = BN + 16;  // staged int8 row stride
  int8_t* st8 = reinterpret_cast<int8_t*>(st);
  const float res_zp = p.has_res_zp ? p.res_zp : 0.0f;
#pragma unroll
  for (int j = 0; j < BN / 8; ++j) {
    const int col = 8 * j + 2 * q;
    const int2 corr = *reinterpret_cast<const int2*>(corr_s + col);
    const float2 sc = *reinterpret_cast<const float2*>(scale_s + col);
    float2 bi = make_float2(0.0f, 0.0f);
    if (kBias) bi = *reinterpret_cast<const float2*>(bias_s + col);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int row = 16 * warp + g + 8 * h;
      float y0 = __fmul_rn(__int2float_rn(acc[4 * j + 2 * h] - corr.x), sc.x);
      float y1 =
          __fmul_rn(__int2float_rn(acc[4 * j + 2 * h + 1] - corr.y), sc.y);
      if (kBias) {
        y0 = __fadd_rn(y0, bi.x);
        y1 = __fadd_rn(y1, bi.y);
      }
      if (kInt8) {
        float r0 = __fadd_rn(__fmul_rn(y0, p.inv_res), res_zp);
        float r1 = __fadd_rn(__fmul_rn(y1, p.inv_res), res_zp);
        r0 = fminf(fmaxf(rintf(r0), p.rq_lo), p.rq_hi);
        r1 = fminf(fmaxf(rintf(r1), p.rq_lo), p.rq_hi);
        const uint32_t b0 = (uint32_t)__float2int_rn(r0) & 0xff;
        const uint32_t b1 = (uint32_t)__float2int_rn(r1) & 0xff;
        *reinterpret_cast<uint16_t*>(st8 + row * kLd8 + col) =
            (uint16_t)(b0 | (b1 << 8));
      } else {
        *reinterpret_cast<float2*>(st + staged_f32(row, col)) =
            make_float2(y0, y1);
      }
    }
  }
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

// The 4 bits of a nibble, one in the low bit of each byte (bit e in byte
// e): the multiply copies the nibble into every byte, the mask keeps bit
// e of byte e, and adding 0x7F carries a set bit into bit 7 of its byte.
__device__ __forceinline__ uint32_t spread4(uint32_t nib) {
  return ((((nib * 0x01010101u) & 0x08040201u) + 0x7F7F7F7Fu) >> 7) &
         0x01010101u;
}

// 4x4 byte transpose: byte c of r[e] becomes byte e of r[c].
__device__ __forceinline__ void transpose4(uint32_t* r) {
  const uint32_t t0 = __byte_perm(r[0], r[1], 0x5140);
  const uint32_t t1 = __byte_perm(r[0], r[1], 0x7362);
  const uint32_t t2 = __byte_perm(r[2], r[3], 0x5140);
  const uint32_t t3 = __byte_perm(r[2], r[3], 0x7362);
  r[0] = __byte_perm(t0, t2, 0x5410);
  r[1] = __byte_perm(t0, t2, 0x7632);
  r[2] = __byte_perm(t1, t3, 0x5410);
  r[3] = __byte_perm(t1, t3, 0x7632);
}

// Byte offset of W (k, n), k relative to the slab, in the panel: one
// [BN][128] swizzled tile per 128 K bytes.
template <int BN>
__device__ __forceinline__ int panel_off(int n, int k) {
  return (k >> 7) * (BN * BK) + swz(n, k & (BK - 1));
}

// Decode W[k_lo : k_lo + p.slab, n0 : n0 + BN] into the panel as int8,
// by the consumer threads (tid < kConsumers). Rows past K and columns
// past N decode to 0. Each thread issues the loads of a batch of items
// before it decodes any, so that a batch waits for memory once.
template <int LAYOUT, int BN>
__device__ void decode_panel(const uint8_t* __restrict__ w, int8_t* panel,
                             int n0, int k_lo, const QMMParams& p, int tid) {
  constexpr int kN4 = BN / 4;  // 4-column groups of the panel
  const uint32_t off4 = (uint32_t)(1 << (p.bits - 1)) * 0x01010101u;
  if (LAYOUT == kBitPlanes) {
    // plane byte (kg, n) holds rows 8kg..8kg+7 of column n: two words
    // along k per column and plane
    constexpr int kBatch = 4;
    const int items = (p.slab / 8) * kN4;
    for (int i0 = tid; i0 < items; i0 += kBatch * kConsumers) {
      uint32_t raw[kBatch][8];
      bool live[kBatch];
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = i0 + b * kConsumers;
        const int n4 = idx % kN4, kg = (k_lo >> 3) + idx / kN4;
        const int gn = n0 + 4 * n4;
        live[b] = idx < items && kg < p.KR && gn < p.N;
        const uint8_t* src = w + (size_t)kg * p.N + gn;
#pragma unroll
        for (int j = 0; j < 8; ++j)
          raw[b][j] = live[b] && j < p.bits
                          ? load4(src + (size_t)j * p.KR * p.N, gn, p)
                          : 0u;
      }
#pragma unroll
      for (int b = 0; b < kBatch; ++b) {
        const int idx = i0 + b * kConsumers;
        if (idx >= items) break;
        uint32_t lo[4] = {0, 0, 0, 0}, hi[4] = {0, 0, 0, 0};
        if (live[b]) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            if (j >= p.bits) break;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
              lo[c] |= spread4((raw[b][j] >> (8 * c)) & 15u) << j;
              hi[c] |= spread4((raw[b][j] >> (8 * c + 4)) & 15u) << j;
            }
          }
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            lo[c] = __vsub4(lo[c], off4);
            hi[c] = __vsub4(hi[c], off4);
          }
        }
        const int n4 = idx % kN4, g = idx / kN4;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          int8_t* dst = panel + panel_off<BN>(4 * n4 + c, 8 * g);
          *reinterpret_cast<uint32_t*>(dst) = lo[c];
          *reinterpret_cast<uint32_t*>(dst + 4) = hi[c];
        }
      }
    }
    return;
  }
  // split-K: rows k..k+3 (field j of packed row i = k - j*KR, or the int8
  // row k at 8 bits), 4 columns per word; one word per row, then transposed
  constexpr int kBatch = 4;
  const uint32_t mask4 = (uint32_t)((1 << p.bits) - 1) * 0x01010101u;
  const int items = (p.slab / 4) * kN4;
  for (int i0 = tid; i0 < items; i0 += kBatch * kConsumers) {
    uint32_t r[kBatch][4];
    int shift[kBatch][4];  // the field's first bit; -1: a row past K
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = i0 + b * kConsumers;
      const int n4 = idx % kN4, k = k_lo + 4 * (idx / kN4);
      const int gn = n0 + 4 * n4;
      int j = p.bits == 8 ? 0 : k / p.KR;
      int i = k - j * p.KR;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        while (i >= p.KR) {
          i -= p.KR;
          ++j;
        }
        const bool live = idx < items && gn < p.N && k + e < p.K;
        r[b][e] = live ? load4(w + (size_t)i * p.N + gn, gn, p) : 0u;
        shift[b][e] = live ? j * p.bits : -1;
        ++i;
      }
    }
#pragma unroll
    for (int b = 0; b < kBatch; ++b) {
      const int idx = i0 + b * kConsumers;
      if (idx >= items) break;
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        if (shift[b][e] < 0)
          r[b][e] = 0;
        else if (p.bits != 8)
          r[b][e] = __vsub4((r[b][e] >> shift[b][e]) & mask4, off4);
      }
      transpose4(r[b]);
      const int n4 = idx % kN4, q = idx / kN4;
#pragma unroll
      for (int c = 0; c < 4; ++c)
        *reinterpret_cast<uint32_t*>(panel + panel_off<BN>(4 * n4 + c,
                                                           4 * q)) = r[b][c];
    }
  }
}

// The general form's producer: stage x[m0 : m0 + rows, k0 : k0 + 128] as
// int8 in the swizzled layout, 16 K bytes per unit.
// Rows past M and columns past K stage as 0.
template <typename XT>
__device__ __forceinline__ void load_x_general(const XT* __restrict__ x,
                                               int8_t* stage, int m0, int k0,
                                               int rows, const QMMParams& p,
                                               int pt) {
#pragma unroll 2
  for (int it = 0; it < rows * BK / 16 / kProducers; ++it) {
    const int idx = pt + it * kProducers;
    const int row = idx >> 3, u = idx & 7;
    const int gm = m0 + row, col = k0 + 16 * u;
    uint32_t word[4] = {0, 0, 0, 0};
    if (gm < p.M) {
      const XT* src = x + (size_t)gm * p.K + col;
#pragma unroll
      for (int e = 0; e < 16; ++e)
        if (col + e < p.K)
          word[e >> 2] |= (uint32_t)(to_q(src[e], p) & 0xff) << (8 * (e & 3));
    }
    *reinterpret_cast<uint4*>(stage + swz(row, 16 * u)) =
        make_uint4(word[0], word[1], word[2], word[3]);
  }
}

// A consumer warp is done with a ring stage: its lane 0 arrives on the
// stage's empty barrier (a predicated arrive, so that no branch parts the
// warp between asynchronous products).
__device__ __forceinline__ void release(uint64_t* bar, int lane) {
  __syncwarp();
  asm volatile(
      "{\n.reg .pred p;\nsetp.eq.u32 p, %1, 0;\n"
      "@p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n"
      ::"r"(smem_u32(bar)), "r"(lane) : "memory");
}

// The block's work: panel b % panels and M tiles [lo, hi) of range
// b / panels, the ranges splitting the tiles as evenly as integers allow.
__device__ __forceinline__ void block_work(const QMMParams& p, int& panel,
                                           int& lo, int& hi) {
  const int b = blockIdx.x;
  panel = b % p.panels;
  const int r = b / p.panels;
  lo = (int)((long long)r * p.m_tiles / p.ranges);
  hi = (int)((long long)(r + 1) * p.m_tiles / p.ranges);
}

// K chunks (of BK bytes) in all of K, and in slab s.
__device__ __forceinline__ int k_chunks(const QMMParams& p) {
  return (p.K + BK - 1) / BK;
}
__device__ __forceinline__ int slab_chunks(const QMMParams& p, int s) {
  return min(p.slab / BK, k_chunks(p) - s * (p.slab / BK));
}

// The ring's order: the block's tiles in pairs (warpgroup 0 takes the
// first tile of a pair, 1 the second), and within a pair slab by slab.
// Under `turns` a stage holds one tile's chunk, each slab's chunks of the
// first tile come before those of the second, and the warpgroups take
// turns at the products, so that each one's epilogue overlaps the other's
// products (for wide panels, whose epilogue is long). Otherwise a stage
// holds the chunk of both tiles (128 rows) and both warpgroups run their
// products together (for narrow panels, where one warpgroup's products
// cannot keep the tensor cores busy). This is the position in that order
// of the load that brings chunk c of slab s of tile (pair + w), the pair
// the `pairs`-th of the block, `n` (1 or 2) tiles in it.
__device__ __forceinline__ int ring_index(const QMMParams& p, int pairs,
                                          int n, int s, int w, int c) {
  if (!p.turns) return pairs * k_chunks(p) + s * (p.slab / BK) + c;
  return pairs * 2 * k_chunks(p) + s * (p.slab / BK) * n +
         w * slab_chunks(p, s) + c;
}

// Rows of x per ring stage.
__device__ __forceinline__ int stage_rows(const QMMParams& p) {
  return p.turns ? BM : 2 * BM;
}

// The producer warpgroup (tid >= kConsumers): x into the ring, in ring
// order, by one thread's TMA copies or by all 128 threads' loads.
__device__ __forceinline__ void produce(const CUtensorMap& xmap,
                                       const void* x, const QMMParams& p,
                                       int8_t* ring, uint64_t* full,
                                       uint64_t* empty, int t_lo, int t_hi) {
  const int pt = threadIdx.x - kConsumers;
  if (p.tma && pt != 0) return;
  const int rows = stage_rows(p), bytes = rows * BK;
  int stage = 0, phase = 0;
  for (int t0 = t_lo; t0 < t_hi; t0 += 2) {
    // under turns one load per tile and chunk, else one for both tiles
    const int n = p.turns ? min(2, t_hi - t0) : 1;
    for (int s = 0; s < p.slabs; ++s) {
      for (int w = 0; w < n; ++w) {
        for (int c = 0; c < slab_chunks(p, s); ++c) {
          const int m0 = (t0 + w) * BM, k0 = (s * (p.slab / BK) + c) * BK;
          int8_t* dst = ring + stage * bytes;
          mbar_wait(empty + stage, phase ^ 1);
          if (p.tma) {
            mbar_expect_tx(full + stage, bytes);
            tma_load(dst, &xmap, full + stage, k0, m0);
          } else {
            if (p.x_type == 0)
              load_x_general(static_cast<const int8_t*>(x), dst, m0, k0,
                             rows, p, pt);
            else if (p.x_type == 1)
              load_x_general(static_cast<const int32_t*>(x), dst, m0, k0,
                             rows, p, pt);
            else
              load_x_general(static_cast<const float*>(x), dst, m0, k0,
                             rows, p, pt);
            fence_async_smem();
            mbar_arrive(full + stage);
          }
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        }
      }
    }
  }
}

// A consumer warpgroup (tid < kConsumers): decode the panel (with the
// other), then its tiles, one of each pair: products as x arrives, then
// the epilogue, which overlaps the other warpgroup's products.
template <int LAYOUT, int BN>
__device__ __forceinline__ void consume(
    const CUtensorMap& omap, const uint8_t* __restrict__ w, void* out,
    const QMMParams& p, int8_t* panel, int8_t* ring, float* staged,
    const int* corr_s, const float* scale_s, const float* bias_s,
    uint64_t* full, uint64_t* empty, int n0, int t_lo, int t_hi) {
  const int tid = threadIdx.x;
  const int wg = tid >> 7, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, q = lane & 3, wt = tid & 127;
  float* st = staged + wg * BM * BN;
  int8_t* st8 = reinterpret_cast<int8_t*>(st);
  constexpr int kLd8 = BN + 16;  // staged int8 row stride
  int acc[BN / 2];
  int next = 0, stage = 0, phase = 0;  // ring position, its stage and phase
  bool partner = false;  // warpgroup 1 took the last turn
  for (int t0 = t_lo, pairs = 0; t0 < t_hi; t0 += 2, ++pairs) {
    const int n = min(2, t_hi - t0), t = t0 + wg;
    for (int s = 0; s < p.slabs; ++s) {
      if (t0 == t_lo || p.slabs > 1) {
        // (re)decode the panel once both warpgroups are done reading it
        bar_sync(kBarConsumers, kConsumers);
        decode_panel<LAYOUT, BN>(w, panel, n0, s * p.slab, p, tid);
        fence_async_smem();
        bar_sync(kBarConsumers, kConsumers);
      }
      // Under turns the warpgroups take the products in ring order: 0
      // waits for 1's last turn, 1 for 0's turn. A turn then waits only on
      // chunks whose stage was last filled for an earlier turn, so each
      // wait's parity is unambiguous.
      if (wg == 0) {
        if (partner) bar_sync(kBarTurn + 1, kConsumers);
        partner = p.turns && n == 2;
      } else {
        if (p.turns) bar_sync(kBarTurn, kConsumers);
        // the last pair holds one tile; together, the other warpgroup still
        // reads its (empty) half of each stage
        if (n < 2 && p.turns) continue;
      }
      int prev = -1;
      for (int c = 0; c < slab_chunks(p, s); ++c) {
        // step the ring position to this chunk's (past the other's chunks)
        for (const int i = ring_index(p, pairs, n, s, wg, c); next < i;
             ++next)
          if (++stage == p.stages) {
            stage = 0;
            phase ^= 1;
          }
        mbar_wait(full + stage, phase);
        const uint64_t a = desc_sw128(smem_u32(
            ring + stage * stage_rows(p) * BK + (p.turns ? 0 : wg * BM * BK)));
        const uint64_t b = desc_sw128(smem_u32(panel + c * BN * BK));
        wg_fence();
        // the tile's first product overwrites the accumulators
        wgmma<BN>(acc, a, b, s > 0 || c > 0);
#pragma unroll
        for (int kk = 1; kk < BK / 32; ++kk)  // 32 K bytes per product
          wgmma<BN>(acc, a + 2 * kk, b + 2 * kk, 1);
        wg_commit();
        if (prev >= 0) {
          wg_wait<1>();  // the previous chunk's products are done
          release(empty + prev, lane);
        }
        prev = stage;
      }
      wg_wait<0>();
      fence_acc<BN / 2>(acc);
      if (prev >= 0) release(empty + prev, lane);
      if (p.turns) bar_arrive(kBarTurn + wg, kConsumers);  // turn over
    }
    if (wg >= n) continue;  // no tile

    // epilogue: the scalar steps in registers, the tile staged in shared
    // memory (f32: in 64 x 32 boxes under the 128-byte swizzle), then out
    // by TMA stores that proceed while the next products run, or, for
    // int8 out and rows not 16-byte aligned, by the threads' stores
    const int m0 = t * BM;
    if (p.tma_out && wt == 0) bulk_wait_read();  // the last store has read
    bar_sync(kBarGroup + wg, 128);  // the previous tile's rows are out
    if (p.out_int8) {
      if (p.has_bias)
        epilogue_tile<BN, true, true>(acc, corr_s, scale_s, bias_s, st, p,
                                      warp, g, q);
      else
        epilogue_tile<BN, false, true>(acc, corr_s, scale_s, bias_s, st, p,
                                       warp, g, q);
    } else {
      if (p.has_bias)
        epilogue_tile<BN, true, false>(acc, corr_s, scale_s, bias_s, st, p,
                                       warp, g, q);
      else
        epilogue_tile<BN, false, false>(acc, corr_s, scale_s, bias_s, st, p,
                                        warp, g, q);
    }
    if (p.tma_out) {
      fence_async_smem();
      bar_sync(kBarGroup + wg, 128);
      if (wt == 0) {
#pragma unroll
        for (int box = 0; box < BN / 32; ++box)
          tma_store(&omap, st + box * BM * 32, n0 + 32 * box, m0);
        bulk_commit();
      }
    } else {
      bar_sync(kBarGroup + wg, 128);
      for (int u = wt; u < BM * (BN / 4); u += 128) {
        const int row = u / (BN / 4), c4 = 4 * (u % (BN / 4));
        const int gm = m0 + row, gn = n0 + c4;
        if (gm >= p.M || gn >= p.N) continue;
        const size_t o = (size_t)gm * p.N + gn;
        if (p.out_int8) {
          const int8_t* src = st8 + row * kLd8 + c4;
          for (int e = 0; e < 4 && gn + e < p.N; ++e)
            static_cast<int8_t*>(out)[o + e] = src[e];
        } else {
          const float4 v =
              *reinterpret_cast<const float4*>(st + staged_f32(row, c4));
          const float vals[4] = {v.x, v.y, v.z, v.w};
          for (int e = 0; e < 4 && gn + e < p.N; ++e)
            static_cast<float*>(out)[o + e] = vals[e];
        }
      }
    }
  }
  if (wg == 0 && partner) bar_sync(kBarTurn + 1, kConsumers);  // the last
  if (p.tma_out && wt == 0) bulk_wait();  // the stores are complete
}

template <int LAYOUT, int BN>
__global__ void __launch_bounds__(kThreads, 1)
    qmatmul_kernel(__grid_constant__ const CUtensorMap xmap,
                   __grid_constant__ const CUtensorMap omap,
                   const void* __restrict__ x, const uint8_t* __restrict__ w,
                   const int* __restrict__ colsum,
                   const float* __restrict__ wvec,
                   const float* __restrict__ bias, void* __restrict__ out,
                   const QMMParams p) {
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  int8_t* panel = reinterpret_cast<int8_t*>(base);
  int8_t* ring = panel + (size_t)p.slab * BN;
  float* staged =
      reinterpret_cast<float*>(ring + p.stages * stage_rows(p) * BK);
  int* corr_s = reinterpret_cast<int*>(staged + 2 * BM * BN);
  float* scale_s = reinterpret_cast<float*>(corr_s + BN);
  float* bias_s = scale_s + BN;
  uint64_t* full = reinterpret_cast<uint64_t*>(bias_s + BN);
  uint64_t* empty = full + p.stages;

  const int tid = threadIdx.x;
  int pidx, t_lo, t_hi;
  block_work(p, pidx, t_lo, t_hi);
  const int n0 = pidx * BN;
  if (tid == 0) {
    // full: the producer's arrival with the stage's TMA bytes, or each
    // general loader's; empty: one arrival per warp that reads the stage
    for (int s = 0; s < p.stages; ++s) {
      mbar_init(full + s, p.tma ? 1 : kProducers);
      mbar_init(empty + s, p.turns ? 4 : 8);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  // the panel's epilogue constants, read once
  for (int c = tid; c < BN; c += kThreads) {
    const int n = min(n0 + c, p.N - 1);
    corr_s[c] = p.has_zp ? colsum[n] * p.x_zp : 0;
    scale_s[c] = p.has_wvec ? __fmul_rn(p.x_scale, wvec[n]) : p.scale;
    bias_s[c] = p.has_bias ? bias[n] : 0.0f;
  }
  __syncthreads();
  if (tid >= kConsumers)
    produce(xmap, x, p, ring, full, empty, t_lo, t_hi);
  else
    consume<LAYOUT, BN>(omap, w, out, p, panel, ring, staged, corr_s,
                        scale_s, bias_s, full, empty, n0, t_lo, t_hi);
}

typedef CUresult (*EncodeTiled)(CUtensorMap*, CUtensorMapDataType,
                                cuuint32_t, void*, const cuuint64_t*,
                                const cuuint64_t*, const cuuint32_t*,
                                const cuuint32_t*, CUtensorMapInterleave,
                                CUtensorMapSwizzle, CUtensorMapL2promotion,
                                CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled, looked up at run time through the CUDA runtime,
// so that the library needs no -lcuda.
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* ptr = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t rc = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &ptr, 12000, cudaEnableDefault, &found);
#else
    cudaError_t rc = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &ptr, cudaEnableDefault, &found);
#endif
    if (rc == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(ptr);
  }
  return fn;
}

// A 2-D TMA map of a row-major [rows, cols] tensor of `elem_bytes`-byte
// elements, boxes of box_cols x box_rows under the 128-byte swizzle;
// elements out of range read as 0 and are not written.
int tma_map(CUtensorMap* map, CUtensorMapDataType type, int elem_bytes,
            const void* base, int rows, int cols, int box_cols,
            int box_rows) {
  EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorSymbolNotFound;
  const cuuint64_t dims[2] = {(cuuint64_t)cols, (cuuint64_t)rows};
  const cuuint64_t strides[1] = {(cuuint64_t)cols * elem_bytes};
  const cuuint32_t box[2] = {(cuuint32_t)box_cols, (cuuint32_t)box_rows};
  const cuuint32_t elem[2] = {1, 1};
  const CUresult rc = encode(
      map, type, 2, const_cast<void*>(base), dims, strides, box, elem,
      CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
      CU_TENSOR_MAP_L2_PROMOTION_L2_256B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return rc == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <int LAYOUT, int BN>
int launch_bn(const CUtensorMap& xmap, const CUtensorMap& omap,
              const void* x, const void* w, const void* colsum,
              const void* wvec, const void* bias, void* out,
              const QMMParams& p, cudaStream_t s) {
  auto kernel = qmatmul_kernel<LAYOUT, BN>;
  cudaError_t rc = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, p.smem);
  if (rc != cudaSuccess) return (int)rc;
  kernel<<<p.panels * p.ranges, kThreads, p.smem, s>>>(
      xmap, omap, x, static_cast<const uint8_t*>(w),
      static_cast<const int*>(colsum), static_cast<const float*>(wvec),
      static_cast<const float*>(bias), out, p);
  return (int)cudaGetLastError();
}

template <int LAYOUT>
int launch(const void* x, const void* w, const void* colsum,
           const void* wvec, const void* bias, void* out,
           const QMMParams* params, void* stream) {
  const QMMParams p = *params;
  if (p.bits < 1 || p.bits > 8 || p.KR < 1 || p.x_type < 0 ||
      p.x_type > 2 || p.stages < 2 || p.slab < BK || p.slab % BK != 0 ||
      p.panels < 1 || p.ranges < 1 || p.ranges > p.m_tiles ||
      (p.tma_out && p.out_int8))
    return (int)cudaErrorInvalidValue;
  CUtensorMap xmap = {}, omap = {};
  int rc = 0;
  if (p.tma)  // x: 128 K bytes x the rows of a ring stage
    rc = tma_map(&xmap, CU_TENSOR_MAP_DATA_TYPE_UINT8, 1, x, p.M, p.K, BK,
                 p.turns ? BM : 2 * BM);
  if (rc == 0 && p.tma_out)  // out: 32 f32 columns x 64 rows per box
    rc = tma_map(&omap, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, out, p.M, p.N,
                 32, 64);
  if (rc != 0) return rc;
  const auto s = static_cast<cudaStream_t>(stream);
  switch (p.bn) {
    case 32:
      return launch_bn<LAYOUT, 32>(xmap, omap, x, w, colsum, wvec, bias, out,
                                   p, s);
    case 64:
      return launch_bn<LAYOUT, 64>(xmap, omap, x, w, colsum, wvec, bias, out,
                                   p, s);
    case 128:
      return launch_bn<LAYOUT, 128>(xmap, omap, x, w, colsum, wvec, bias,
                                    out, p, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
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
