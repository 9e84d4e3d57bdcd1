"""The host replay of torch's CUDA row-sum order (the order in which the
exact attention kernels add softmax rows, csrc/torch_order.cuh) held
against a thread-by-thread simulation of ATen's Reduce.cuh
(``input_vectorized_thread_reduce_impl`` with its unaligned head and tail,
``thread_reduce_impl``'s four strided accumulators, then
``block_x_reduce``'s shfl_down tree), and the block-shape rule that says
where torch reduces a row in one warp, at the shapes the port's paths run.

Tolerance: the replay equals the simulation bit for bit.
"""
import numpy as np
import pytest

from numpy_quant_tpu_torch.kernels import attention as TA

F32 = np.float32


def _reduce_cuh_row(row: np.ndarray, row_index: int, lanes: int,
                    vec: bool) -> np.float32:
    """One row of a contiguous [rows, N] float32 tensor summed as one warp
    of ``lanes`` threads of Reduce.cuh sums it (row ``row_index``, whose
    start lies (row_index * N) % 4 elements past a 16-byte boundary)."""
    n = row.size
    shift0 = (row_index * n) % 4
    # the row inside an aligned buffer: element k of the row is buf[shift0 + k]
    buf = np.concatenate([np.zeros(shift0, F32), row, np.zeros(8, F32)])
    lane_values = []
    for tid in range(lanes):
        if vec:
            data, end, shift = shift0, n, shift0
            value = F32(0)
            if shift > 0:
                data -= shift
                end += shift
                if shift <= tid < 4:
                    value = F32(value + buf[data + tid])
                end -= 4
                data += 4
            acc = [value, F32(0), F32(0), F32(0)]
            idx = tid
            while idx * 4 + 3 < end:
                for i in range(4):
                    acc[i] = F32(acc[i] + buf[data + idx * 4 + i])
                idx += lanes
            j = end - end % 4 + tid
            if j < end:
                acc[0] = F32(acc[0] + buf[data + j])
        else:
            acc = [F32(0)] * 4
            idx = tid
            while idx + 3 * lanes < n:
                for i in range(4):
                    acc[i] = F32(acc[i] + row[idx + i * lanes])
                idx += 4 * lanes
            for i in range(4):
                if idx >= n:
                    break
                acc[i] = F32(acc[i] + row[idx])
                idx += lanes
        lane_values.append(F32(F32(F32(acc[0] + acc[1]) + acc[2]) + acc[3]))
    offset = lanes // 2
    while offset:
        lane_values = [F32(lane_values[i] + lane_values[i + offset])
                       if i + offset < lanes else lane_values[i]
                       for i in range(lanes)]
        offset //= 2
    return lane_values[0]


@pytest.mark.parametrize("n", [8, 50, 100, 127, 128, 130, 197, 255, 512,
                               1000, 1024])
def test_replay_equals_reduce_cuh(n):
    """Every row misalignment (rows 0..7 of the tensor) and both load
    forms (strided below 128 keys, 4-vectors from 128 on)."""
    rows = 8
    x = np.random.default_rng(n).random((rows, n), dtype=np.float32)
    vec, lanes = TA.sum_order(n)
    want = np.array([_reduce_cuh_row(x[r], r, lanes, vec)
                     for r in range(rows)], np.float32)
    got = TA.torch_order_sum(x)
    np.testing.assert_array_equal(got, want)
    # a row's index changes its order only where N % 4 != 0
    shifted = TA.torch_order_sum(x, row_ids=np.arange(rows) + 1)
    if n % 4 == 0 or not vec:
        np.testing.assert_array_equal(shifted, got)
    np.testing.assert_allclose(got, x.astype(np.float64).sum(axis=1),
                               rtol=n * 2.0 ** -24)


@pytest.mark.parametrize("rows,n,tiled,want", [
    (32 * 12 * 197, 197, False, True),   # ViT-Base, phase 1
    (8 * 12 * 1, 197, False, True),      # ViT's narrowed last layer
    (8 * 12 * 256, 1024, True, True),    # GPT-2 scoring, q tiles of 256
    (8 * 8 * 256, 512, True, True),      # T5 encoder, blockwise
    (8 * 8 * 128, 128, False, True),     # T5 decoder self-attention
    (8 * 8 * 128, 512, False, True),     # T5 cross-attention
    (32 * 256, 2048, True, True),        # TinyLlama, pre-split
    (5 * 50, 50, False, True),           # strided loads, 32 lanes
    (1000, 197, True, False),            # tiled kernels: aligned rows only
    (1000, 100, True, False),            # tiled kernels: N >= 128 only
    (2, 4096, False, False),             # few rows: 256 lanes per row
    (64, 8192, False, False),            # 256 values per thread: split
])
def test_one_warp_per_row(rows, n, tiled, want):
    """Reduce.cuh's block shape (at most 512 threads, width up to a warp,
    height the rows) keeps each row in one warp of sum_order's lanes at
    the paths' shapes; few rows or 8,192 keys split a row across warps."""
    assert TA.in_torch_order(rows, n, tiled) is want
