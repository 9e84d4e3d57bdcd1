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


def _reduce_cuh_row(row: np.ndarray, shift0: int, lanes: int,
                    vec: bool) -> np.float32:
    """One row of a float32 tensor summed as one warp of ``lanes`` threads
    of Reduce.cuh sums it, the row starting ``shift0`` elements past a
    16-byte boundary (row r of a contiguous [rows, N] tensor: (r * N) %
    4)."""
    n = row.size
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
    want = np.array([_reduce_cuh_row(x[r], (r * n) % 4, lanes, vec)
                     for r in range(rows)], np.float32)
    got = TA.torch_order_sum(x)
    np.testing.assert_array_equal(got, want)
    # a row's index changes its order only where N % 4 != 0
    shifted = TA.torch_order_sum(x, row_ids=np.arange(rows) + 1)
    if n % 4 == 0 or not vec:
        np.testing.assert_array_equal(shifted, got)
    np.testing.assert_allclose(got, x.astype(np.float64).sum(axis=1),
                               rtol=n * 2.0 ** -24)


@pytest.mark.parametrize("rows,n,want", [
    (32 * 12 * 197, 197, True),   # ViT-Base, phase 1
    (8 * 12 * 1, 197, True),      # ViT's narrowed last layer
    (8 * 12 * 256, 1024, True),   # GPT-2 scoring, q tiles of 256
    (8 * 8 * 256, 512, True),     # T5 encoder, blockwise
    (8 * 8 * 128, 128, True),     # T5 decoder self-attention
    (8 * 8 * 128, 512, True),     # T5 cross-attention
    (32 * 256, 2048, True),       # TinyLlama, pre-split
    (5 * 50, 50, True),           # strided loads, 32 lanes
    (1000, 197, True),            # unaligned rows (N % 4 != 0), any kernel
    (1000, 100, True),            # N < 128 (strided loads), any kernel
    (2, 4096, False),             # few rows: 256 lanes per row
    (64, 8192, False),            # 256 values per thread: split
])
def test_one_warp_per_row(rows, n, want):
    """Reduce.cuh's block shape (at most 512 threads, width up to a warp,
    height the rows) keeps each row in one warp of sum_order's lanes at
    the paths' shapes; few rows or 8,192 keys split a row across warps.
    Every exact kernel replays every one-warp order, tiled or not."""
    assert TA.in_torch_order(rows, n) is want


TILE = 64  # keys per tile of the tiled exact kernels


def _lane_keys(lane: int, j0: int, jend: int, n: int, shift: int,
               lanes: int, vec: bool):
    """(key, accumulator) pairs that lane ``lane`` adds from the tile of
    keys [j0, jend), in its order: torch_order.cuh's torch_order_stream."""
    if lane >= lanes:
        return []
    out = []
    if vec:
        start, end = (4 - shift, n + shift - 4) if shift else (0, n)
        nvec = end >> 2
        body_end = start + 4 * nvec
        if jend - j0 == TILE and j0 % TILE == 0 and j0 >= start \
                and jend <= body_end:
            # a tile of body keys only: the offset rule
            base = (start + 4 * lane - j0) & 127
            return [(j0 + ((base + i) & 127), i) for i in range(4)
                    if ((base + i) & 127) < TILE]
        if shift:
            k = lane - shift  # the head
            if shift <= lane < 4 and j0 <= k < jend:
                out.append((k, 0))
        lo, hi = max(j0, start), min(jend, body_end)
        if lo < hi:
            v_first, v_last = (lo - start) >> 2, (hi - 1 - start) >> 2
            v = v_first + ((lane - v_first) & (lanes - 1))
            if v <= v_last:
                out += [(start + 4 * v + i, i) for i in range(4)
                        if j0 <= start + 4 * v + i < jend]
        k = body_end + lane  # the tail
        if lane < (end & 3) and j0 <= k < jend:
            out.append((k, 0))
    else:
        k = j0 + ((lane - j0) & (lanes - 1))
        while k < jend:
            out.append((k, (k // lanes) & 3))
            k += lanes
    return out


def _streamed_row(row: np.ndarray, shift: int, lanes: int,
                  vec: bool) -> np.float32:
    """A row summed as the tiled kernels sum it: the keys streamed into
    the lanes' accumulators one tile of TILE keys at a time, then
    torch_order_finish's combine and lane tree."""
    n = row.size
    acc = np.zeros((32, 4), F32)
    seen = np.zeros(n, np.int64)
    for j0 in range(0, n, TILE):
        jend = min(n, j0 + TILE)
        for lane in range(32):
            for k, i in _lane_keys(lane, j0, jend, n, shift, lanes, vec):
                acc[lane, i] = F32(acc[lane, i] + row[k])
                seen[k] += 1
    assert (seen == 1).all(), "every key goes to exactly one accumulator"
    v = [F32(F32(F32(a[0] + a[1]) + a[2]) + a[3]) for a in acc]
    offset = lanes // 2
    while offset:
        v = [F32(v[i] + v[i + offset]) if i + offset < 32 else v[i]
             for i in range(32)]
        offset //= 2
    return v[0]


@pytest.mark.parametrize("n", list(range(1, 301))
                         + [1000, 1023, 1024, 2047, 2048])
def test_streamed_order_equals_torch_order(n):
    """The tiled kernels' streamed row sum, walked in 64-key tiles, equals
    torch's one-warp order at every row alignment (shift 0-3): Reduce.cuh's
    simulation always, and the host replay torch_order_sum for the rows
    of a [rows, n] tensor that start so misaligned."""
    vec, lanes = TA.sum_order(n)
    rng = np.random.default_rng(n)
    for shift in range(4):
        row = rng.random(n, dtype=np.float32)
        got = _streamed_row(row, shift, lanes, vec)
        assert got == _reduce_cuh_row(row, shift if vec else 0, lanes, vec)
        ids = [r for r in range(4) if (r * n) % 4 == shift]
        if ids:
            want = TA.torch_order_sum(row[None], row_ids=ids[:1])[0]
            assert got == want, (n, shift)


def _hs_warp_rows(plan: dict, nq: int):
    """The monolithic kernel's exact row sums by warp (its row-group walk
    in csrc/attention_hs.cu): ((CTA, pass, warp), rows) for every warp
    that sums query rows under an exact form's ``plan``
    (kernels/attention.py::hs_plan). Warp pair w of CTA x takes row group
    (x * passes + pass) * pairs + w, 16 rows; its warp kh sums rows 8
    kh.."""
    pairs, passes = plan["warps"] // 2, plan["passes"]
    for x in range(plan["grid"][0]):
        for pas in range(passes):
            for w in range(plan["warps"]):
                r0 = 16 * ((x * passes + pas) * pairs + w // 2) + 8 * (w % 2)
                if r0 < nq:
                    yield (x, pas, w), range(r0, min(r0 + 8, nq))


@pytest.mark.parametrize("nq,n,d,bh", [(197, 197, 64, 96 * 12),
                                       (197, 197, 64, 8 * 12),
                                       (1, 197, 64, 12), (128, 512, 64, 64),
                                       (1000, 1000, 64, 4),
                                       (300, 896, 16, 24)])
def test_monolithic_warps_own_every_row_once(nq, n, d, bh):
    """The kernel's row-group walk (a warp pair per 16 rows, each warp
    summing 8 of them) gives every query row to exactly one warp."""
    plan = TA.hs_plan(nq, n, d, bh)
    seen = np.zeros(nq, np.int64)
    for (cta, pas, warp), rows in _hs_warp_rows(plan, nq):
        assert cta < plan["grid"][0] and pas < plan["passes"]
        assert warp < plan["warps"] and 0 < len(rows) <= 8
        seen[list(rows)] += 1
    assert (seen == 1).all()


@pytest.mark.parametrize("b,h,nq,n", [(2, 3, 197, 197), (2, 2, 1, 197),
                                      (1, 3, 128, 128), (1, 2, 128, 512),
                                      (1, 2, 50, 50), (1, 3, 127, 130)])
def test_monolithic_rows_sum_in_torch_order(b, h, nq, n):
    """The monolithic kernel's exact row sums replayed by its row-to-warp
    walk (_hs_warp_rows under kernels/attention.py::hs_plan): the warp
    owning query row r of head (bb, hh) sums it alone, as one warp of
    Reduce.cuh does, at the row's misalignment in the unfused [B, H, nq,
    N] exp tensor, ((bb * H + hh) * nq + r) * N % 4; every row so equals
    torch_order_sum of that tensor's rows."""
    vec, lanes = TA.sum_order(n)
    x = np.random.default_rng(n + nq).random((b * h * nq, n), dtype=F32)
    want = TA.torch_order_sum(x)
    plan = TA.hs_plan(nq, n, 64, b * h)
    for bb, hh in np.ndindex(b, h):
        for _, rows in _hs_warp_rows(plan, nq):
            for r in rows:
                flat = (bb * h + hh) * nq + r
                got = _reduce_cuh_row(x[flat], (flat * n) % 4 if vec else 0,
                                      lanes, vec)
                assert got == want[flat], (bb, hh, r)
