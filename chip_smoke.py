#!/usr/bin/env python3
"""Drive the PyTorch port's int8 ViT-Base and weight-only GPT-2 decode
paths on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  0. the card, the software, and the kernels' build (one nvcc per source,
     all started together);
  1. every hand-written kernel against its plain PyTorch version on the
     card, in every variant the paths use, then both timed at ViT-Base
     serving shapes beside the kernel's bound (and, for the packed
     matmuls, beside torch._int_mm plus the eager epilogue);
  2. the main path in f32: random ViT-Base weights (seed 0) -> ONNX ->
     Model.from_onnx -> calibration on 2 images -> quantize(int8,
     quantize_conv) -> unfused forward -> optimize() -> pack_weights()
     -> fused forward under packed_execution="unpack", which must launch
     the attention kernel once per layer and agree with the unfused
     forward (logits within LOGIT_TOL, labels wherever the top-1 margin is
     clear of it);
  3. the bf16 serving mode at batch 96 (the bench.py configuration):
     finite outputs, kernel launches per forward, labels against f32,
     images/s;
  4. the packed paths in f32 at batch 8 -- int8, W4A8 per-channel and
     W3A8, each after optimize() + pack_weights() (72 weights): the
     "kernel" forward launches its packed kernel 72 times and equals the
     "unpack" forward bit for bit;
  5. W4A8 bf16 serving at batch 96 under "kernel" and "unpack": images/s,
     launches per forward, labels against f32;
  6. the weight-only kernel splitk_wo_matmul against its plain version at
     1/2/4/8 bits, per-tensor, per-channel and grouped scales (groups
     within and across the split-K fields), f32 and bf16, on ragged
     shapes; then timed with a cold L2 at the five GPT-2 decode shapes
     (M = 8, W4 g=128) beside its bound, the plain version and torch.matmul
     on the weight dequantized beforehand;
  7. the weight-only decode path at full width: random GPT-2 small
     weights (seed 0) -> gpt_decode_step(B=8, max_len=64) ->
     Model.from_onnx -> quantize_weights(4, group_size=128) (49 weights)
     -> greedy generate (prompt 16, 48 new tokens) under "kernel" and
     "unpack", f32 and bf16: 49 kernel launches per step, f32 "kernel"
     tokens equal to "unpack" tokens (a row may part only where the top-2
     margin is within the measured logit difference), tokens/s (median of
     5 timed decodes per mode, the modes taken in turns).
The last three lines are the kernels JSON line, the card's name and power
limit, and the result line. Imports nothing of JAX or numpy_quant_tpu.
"""
from __future__ import annotations

import contextlib
import json
import os
import statistics
import subprocess
import sys
import time
from concurrent.futures import ThreadPoolExecutor

REPO = os.path.dirname(os.path.abspath(__file__))

# data-sheet peaks (NVIDIA, dense): device memory bytes/s, int8 ops/s,
# bf16 tensor-core flop/s, f32 flop/s outside the tensor cores
PEAKS = {
    "H100 PCIe": dict(bytes=2.0e12, int8=1513e12, bf16=756e12, f32=51e12),
    "H100 NVL": dict(bytes=3.9e12, int8=1671e12, bf16=835e12, f32=60e12),
    "H100": dict(bytes=3.35e12, int8=1979e12, bf16=989e12, f32=67e12)}

B_CHECK, B_TIME, B_F32, B_SERVE = 32, 96, 8, 96
N_TOK, HEADS, HEAD_DIM = 197, 12, 64
QP = dict(scaling=0.125, sq=0.0513, zq=3, sk=0.0437, zk=-5, sv=0.0317,
          zv=7, sp=float(1.0 / 255.0), zp_p=-128, bit_width=8)
OUT_REQUANT = (0.0213, 4)
SCORE_MAX = 3.17
LOGIT_TOL = 0.1  # fused vs unfused f32 logits, relative to max|logits|

# packed matmuls: the ragged check shape (no multiple of 8, 16 or 128;
# K no multiple of r)
QMM_CHECK = (133, 203, 149)  # M, K, N
M_TIME = B_TIME * N_TOK      # ViT-Base rows at batch 96
QMM_SHAPES = ((768, 768), (768, 3072), (3072, 768))  # (K, N) per layer
X_SCALE, X_ZP, W_SCALE = 0.0213, 3, 0.0117
PACKED_PER_FORWARD = 6 * 12  # Q, K, V, out, fc1, fc2 in 12 layers

# weight-only matmul: check shapes with ragged M and N (K = 384 lets every
# width take both group forms), and one ragged K (no multiple of r)
WO_CHECK = ((133, 384, 149), (7, 384, 300))
WO_RAGGED_K = (133, 203, 149)
WO_TOL = {"f32": 2e-5, "bf16": 2.0 ** -7}  # max|kernel - plain| / max|y|
GPT_B, GPT_PROMPT, GPT_NEW, GPT_MAX_LEN, WO_GROUP = 8, 16, 48, 64, 128
# (K, N) of c_attn, attn c_proj, c_fc, mlp c_proj and the tied head
DECODE_SHAPES = ((768, 2304), (768, 768), (768, 3072), (3072, 768),
                 (768, 50257))
WO_PER_STEP = 4 * 12 + 1
TEACHER_TOL = 1e-4  # kernel vs unpack logits on forced steps, of max|logit|
DECODE_REPS = 5  # timed decodes per (dtype, mode), in turns
LEAD_CYCLES = 2_000_000  # ~1 ms of device sleep ahead of a cold timed call


def say(phase: str, **fields) -> None:
    print(f"[{phase}] " + " ".join(f"{k}={v}" for k, v in fields.items()),
          flush=True)


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def peaks(name: str) -> dict:
    for key in ("H100 PCIe", "H100 NVL", "H100"):
        if key in name:
            return PEAKS[key]
    raise RuntimeError(f"no data-sheet peaks for {name!r}")


def build_kernels() -> float:
    from numpy_quant_tpu_torch.kernels import build
    names = sorted(p.stem for p in build.CSRC.glob("*.cu"))
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=len(names)) as pool:
        results = list(pool.map(build.compile_source, names))
    seconds = time.perf_counter() - t0
    for name, (path, report) in zip(names, results):
        for line in report.splitlines():
            if "registers" in line or "spill" in line:
                say("build", kernel=name, ptxas=line.strip().replace(" ", "_"))
        say("build", kernel=name, library=os.path.relpath(path, REPO))
    return seconds


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events).
    With ``flush`` (a device buffer larger than the L2 cache) zeroed before
    each call, outside the timed span, every call finds L2 cold; a device
    sleep queued after it lets the host enqueue the call before the device
    reaches it, so a call whose kernels take less time than its Python
    wrapper is timed on the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b: int, nq: int, seed: int):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (b, N_TOK, HEADS * HEAD_DIM)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=shape)
                                .astype(np.int8)).cuda() for _ in range(3))
    return q[:, :nq].contiguous(), k, v


def check_attention() -> float:
    """Kernel against plain version in every variant; returns the largest
    |difference| over the f32-output variants."""
    import itertools
    import torch
    from numpy_quant_tpu_torch.kernels import attention as A
    worst = 0.0
    cases = [(False, rq, nq, None) for rq, nq in itertools.product(
        (None, OUT_REQUANT), (N_TOK, 1))]
    cases += [(True, rq, nq, sm) for rq, nq, sm in itertools.product(
        (None, OUT_REQUANT), (N_TOK, 1), (None, SCORE_MAX))]
    for i, (fast, rq, nq, sm) in enumerate(cases):
        q, k, v = attention_inputs(B_CHECK, nq, seed=i)
        kw = dict(QP, num_heads=HEADS, fast=fast, out_requant=rq,
                  score_max=sm)
        got = A.fused_attention_hs(q, k, v, **kw)
        want = A.fused_attention_hs_reference(q, k, v, **kw)
        torch.cuda.synchronize()
        assert got.shape == want.shape and got.dtype == want.dtype
        diff = (got.double() - want.double()).abs()
        blocks = diff.reshape(B_CHECK, nq, HEADS, HEAD_DIM).amax(dim=-1)
        flips = int((blocks > 0).sum())
        max_err = float(diff.max())
        per_flip = 1.0 if rq is not None else 255.0 * QP["sp"] * QP["sv"] * 1.000001
        say("kernel-check", kernel="fused_attention_hs", fast=fast,
            out_requant=rq is not None, nq=nq, score_max=sm,
            flipped_blocks=f"{flips}/{blocks.numel()}", max_abs_err=max_err)
        if max_err > per_flip or flips > max(1, 0.01 * blocks.numel()):
            raise AssertionError(f"fused_attention_hs disagrees with its "
                                 f"plain version: {flips} blocks, {max_err}")
        if rq is None:
            worst = max(worst, max_err)
    return worst


def time_attention(name: str) -> dict:
    """The serving form (fast, int8 out, full q) at batch 96: kernel,
    plain version and bound; the exact f32 form is printed beside it."""
    from numpy_quant_tpu_torch.kernels import attention as A
    mem_rate, int8_rate = peaks(name)["bytes"], peaks(name)["int8"]
    q, k, v = attention_inputs(B_TIME, N_TOK, seed=99)
    res = {}
    for label, fast, rq in (("serving", True, OUT_REQUANT),
                            ("exact_f32", False, None)):
        kw = dict(QP, num_heads=HEADS, fast=fast, out_requant=rq,
                  score_max=SCORE_MAX if fast else None)
        ms = cuda_ms(lambda: A.fused_attention_hs(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.fused_attention_hs_reference(q, k, v, **kw))
        out_bytes = q.numel() * (1 if rq is not None else 4)
        nbytes = q.numel() + k.numel() + v.numel() + out_bytes
        ops = 4 * B_TIME * HEADS * N_TOK * N_TOK * HEAD_DIM
        t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / int8_rate * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms,
                          bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations")
        say("kernel-time", kernel="fused_attention_hs", form=label,
            shape=f"B{B_TIME}xN{N_TOK}xH{HEADS}xD{HEAD_DIM}", ms=ms,
            plain_ms=plain_ms, bound_ms=res[label]["bound_ms"],
            bound_by=res[label]["bound_by"], bytes=nbytes, ops=ops,
            card=name.replace(" ", "_"))
    return res["serving"]


def attention_flips(qmodel, x) -> tuple[int, int]:
    """The kernel against its plain version on every attention layer's
    real inputs (one recorded forward): flipped (row, head) blocks."""
    import torch
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.ops.registry import attention_call
    qmodel([x], record=True)
    recorded = {v.name: v.data for v in qmodel.values if v.data is not None}
    flips = blocks = 0
    for node in qmodel.nodes:
        if node.op != "FusedAttentionHS":
            continue
        # the operands as the executor hands them to the op (quantized)
        q, k, v, kw, _ = attention_call(qmodel._node_inputs(node, recorded),
                                        node.attrs)
        got = A.fused_attention_hs(q, k, v, **kw)
        want = A.fused_attention_hs_reference(q, k, v, **kw)
        diff = (got.double() - want.double()).abs()
        b, nq, hd = got.shape
        per_block = diff.reshape(b, nq, kw["num_heads"], -1).amax(dim=-1)
        flips += int((per_block > 0).sum())
        blocks += per_block.numel()
    torch.cuda.synchronize()
    return flips, blocks


def qmm_operands(layout: str, bits: int, m: int, k: int, n: int, seed: int,
                 *, per_channel: bool, quantize_x: bool, bias: bool,
                 requant: bool, x_dtype=None):
    """Random operands and keyword arguments of one packed-matmul call, on
    the card: (x, payload, colsum, bias, w_scale_vec, kwargs, int8 W)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels.pack import pack_bitplanes, pack_splitk
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int32)
    if layout == "splitk":
        payload = w.astype(np.int8) if bits == 8 else pack_splitk(w, bits)
    else:
        payload = pack_bitplanes(w, bits)
    if quantize_x:
        x = torch.from_numpy((rng.normal(size=(m, k)) * 1.3).astype(np.float32))
    else:
        x = torch.from_numpy(rng.integers(-128, 128, size=(m, k))
                             .astype(np.int8)).to(x_dtype or torch.int8)
    kw = dict(bits=bits, bit_width=8, x_scale=X_SCALE,
              x_zp=None if seed % 3 == 0 else X_ZP, quantize_x=quantize_x,
              out_requant=(0.0371, -5, 8) if requant else None)
    wvec = None
    if per_channel:
        wvec = torch.from_numpy(rng.uniform(0.004, 0.02, size=(1, n))
                                .astype(np.float32)).cuda()
    else:
        kw["w_scale"] = W_SCALE
    b = torch.from_numpy(rng.normal(size=(1, n)).astype(np.float32)).cuda() \
        if bias else None
    colsum = torch.from_numpy(w.sum(axis=0, keepdims=True).astype(np.int32))
    return (x.cuda(), torch.from_numpy(payload).cuda(), colsum.cuda(), b,
            wvec, kw, torch.from_numpy(w.astype(np.int8)).cuda())


def check_qmatmul() -> dict:
    """Both packed kernels against their plain versions in every variant
    (per-tensor or per-channel scale, quantize_x, bias, out_requant) at
    every width, on a ragged shape; returns the largest |difference| of
    the f32-output variants per kernel. Bit equality is required."""
    import itertools
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    m, k, n = QMM_CHECK
    worst = {}
    for name, layout, widths in (
            ("splitk_qmatmul", "splitk", (1, 2, 4, 8)),
            ("packed_qmatmul", "bitplanes", range(1, 9))):
        fn = getattr(Q, name)
        ref = getattr(Q, name + "_reference")
        worst[name], mismatches, outputs, calls = 0.0, 0, 0, 0
        for bits in widths:
            for i, (pc, qx, bias, rq) in enumerate(
                    itertools.product((False, True), repeat=4)):
                x, payload, colsum, b, wvec, kw, _ = qmm_operands(
                    layout, bits, m, k, n, seed=16 * bits + i,
                    per_channel=pc, quantize_x=qx, bias=bias, requant=rq,
                    x_dtype=torch.int32 if i % 4 == 1 else torch.int8)
                got = fn(x, payload, colsum, b, wvec, **kw)
                want = ref(x, payload, colsum, b, wvec, **kw)
                torch.cuda.synchronize()
                assert got.shape == want.shape and got.dtype == want.dtype
                mismatches += int((got != want).sum())
                outputs += got.numel()
                calls += 1
                if not rq:
                    worst[name] = max(worst[name],
                                      float((got - want).abs().max()))
        say("kernel-check", kernel=name, variants=calls,
            shape=f"M{m}xK{k}xN{n}", mismatches=f"{mismatches}/{outputs}",
            max_abs_err=worst[name])
        if mismatches:
            raise AssertionError(f"{name} disagrees with its plain version "
                                 f"on {mismatches} outputs")
    return worst


def time_qmatmul(name: str) -> dict:
    """The serving form (int8 x already quantized, f32 out) at the ViT-Base
    shapes at batch 96: kernel, plain version, bound, and torch._int_mm on
    the unpacked int8 weight plus the eager epilogue (not one call: the
    product, then the elementwise correction and dequantize). Returns the
    768->3072 numbers of each kernel at its path's width."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    mem_rate, int8_rate = peaks(name)["bytes"], peaks(name)["int8"]
    res = {}
    for kname, layout, bits, per_channel in (
            ("splitk_qmatmul", "splitk", 8, False),
            ("splitk_qmatmul", "splitk", 4, True),
            ("packed_qmatmul", "bitplanes", 3, False)):
        fn = getattr(Q, kname)
        ref = getattr(Q, kname + "_reference")
        for k, n in QMM_SHAPES:
            x, payload, colsum, _, wvec, kw, w8 = qmm_operands(
                layout, bits, M_TIME, k, n, seed=1, per_channel=per_channel,
                quantize_x=False, bias=False, requant=False)
            scale_row = torch.full((), X_SCALE, device="cuda") * wvec \
                if per_channel else torch.full(
                    (), float(X_SCALE * W_SCALE), device="cuda")
            zp = torch.full((), X_ZP, dtype=torch.int32, device="cuda")

            def library():
                acc = torch._int_mm(x, w8)
                return (acc - colsum * zp).to(torch.float32) * scale_row

            ms = cuda_ms(lambda: fn(x, payload, colsum, None, wvec, **kw))
            plain_ms = cuda_ms(lambda: ref(x, payload, colsum, None, wvec,
                                           **kw))
            library_ms = cuda_ms(library)
            nbytes = (x.numel() + payload.numel() + 4 * n
                      + (4 * n if per_channel else 0) + 4 * M_TIME * n)
            ops = 2 * M_TIME * n * k
            t_bytes, t_ops = nbytes / mem_rate * 1e3, ops / int8_rate * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            say("kernel-time", kernel=kname, bits=bits,
                scale="per_channel" if per_channel else "per_tensor",
                shape=f"M{M_TIME}xK{k}xN{n}", ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="_int_mm+eager_epilogue",
                bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], bytes=nbytes, ops=ops,
                card=name.replace(" ", "_"))
            if (k, n) == (768, 3072) and bits != 8:
                res[kname] = row
    return res


def counted(fn):
    """Run ``fn()`` with every kernel's launch count set to 0 just
    before; returns its result and the counts read just after."""
    from numpy_quant_tpu_torch import kernels as K
    counters = {name: getattr(K, name) for name in (
        "fused_attention_hs", "splitk_qmatmul", "packed_qmatmul",
        "splitk_wo_matmul")}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in counters.items()}


@contextlib.contextmanager
def packed_execution(mode: str):
    from numpy_quant_tpu_torch import config
    prev = config.packed_execution
    config.packed_execution = mode
    try:
        yield
    finally:
        config.packed_execution = prev


def packed_forward(qmodel, x, mode: str):
    """One forward under packed_execution=mode, with its launch counts."""
    with packed_execution(mode):
        return counted(lambda: qmodel([x])[0])


def images_per_s(qmodel, x, mode: str, reps: int = 20) -> float:
    import torch
    with packed_execution(mode):
        for _ in range(3):
            qmodel([x], as_numpy=False)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(reps):
            qmodel([x], as_numpy=False)
        torch.cuda.synchronize()
        return x.shape[0] * reps / (time.perf_counter() - t0)


def wo_operands(bits: int, m: int, k: int, n: int, groups: int, seed: int,
                dtype):
    """Random operands of one weight-only call on the card: (x, payload,
    scale) with a host scalar scale at groups=0, else a [groups, N]
    device tensor (1 = per channel)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels.pack import pack_splitk
    rng = np.random.default_rng(seed)
    lo, hi = -(1 << (bits - 1)), (1 << (bits - 1)) - 1
    w = rng.integers(lo, hi + 1, size=(k, n)).astype(np.int8)
    payload = w if bits == 8 else pack_splitk(w, bits)
    if groups == 0:
        scale = float(np.float32(rng.uniform(0.004, 0.02)))
    else:
        scale = torch.from_numpy(rng.uniform(0.004, 0.02, size=(groups, n))
                                 .astype(np.float32)).cuda()
    x = torch.from_numpy(rng.normal(size=(m, k)).astype(np.float32))
    return x.to(dtype).cuda(), torch.from_numpy(payload).cuda(), scale


def wo_compare(x, payload, scale, bits: int, label: str) -> tuple[float, float]:
    """The kernel against its plain version on one input: (max|diff|,
    max|y|); raises beyond the tolerance of x's type."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    got = Q.splitk_wo_matmul(x, payload, scale, bits=bits)
    want = Q.splitk_wo_matmul_reference(x, payload, scale, bits=bits)
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype == x.dtype
    err = float((got.float() - want.float()).abs().max())
    top = float(want.float().abs().max())
    tol = WO_TOL["bf16" if x.dtype == torch.bfloat16 else "f32"]
    if not err <= tol * top:
        raise AssertionError(f"splitk_wo_matmul disagrees with its plain "
                             f"version ({label}): {err} > {tol} * {top}")
    return err, top


def check_wo() -> float:
    """splitk_wo_matmul against its plain version at every width, scale
    form and float type; returns the largest |difference| of the f32
    variants."""
    import torch
    worst = 0.0
    for bits in (1, 2, 4, 8):
        kr = 384 * bits // 8
        # per tensor, per channel, groups of 16 rows (within a field), of a
        # whole field (K/2 at 8 bits, where a field is all of K) and, at 1
        # and 2 bits, of two whole fields (scale row v // gsz spans fields)
        forms = {"tensor": 0, "channel": 1, "group16": 384 // 16,
                 "group_field": 384 // (kr if bits < 8 else 192)}
        if bits < 4:
            forms["group_2field"] = 384 // (2 * kr)
        cases = [(shape, f) for shape in WO_CHECK for f in forms]
        cases += [(WO_RAGGED_K, f) for f in ("tensor", "channel")]
        for tname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
            err = rel = 0.0
            for i, ((m, k, n), form) in enumerate(cases):
                x, payload, scale = wo_operands(bits, m, k, n, forms[form],
                                                seed=100 * bits + i,
                                                dtype=dtype)
                e, top = wo_compare(x, payload, scale, bits,
                                    f"{bits} bits {tname} M{m}xK{k}xN{n} "
                                    f"{form}")
                err, rel = max(err, e), max(rel, e / top)
            say("kernel-check", kernel="splitk_wo_matmul", bits=bits,
                dtype=tname, variants=len(cases),
                shapes="+".join(f"M{m}xK{k}xN{n}" for m, k, n in
                                WO_CHECK + (WO_RAGGED_K,)),
                max_abs_err=err, max_err_over_max_y=rel, tolerance=WO_TOL[tname])
            if tname == "f32":
                worst = max(worst, err)
    return worst


def time_wo(name: str) -> dict:
    """The decode shapes at M = 8, W4 g=128, f32 and bf16, each first held
    against the plain version: kernel, plain version, bound and the
    library call (torch.matmul on the weight dequantized beforehand, in
    x's type: 8x (f32) or 4x (bf16) the payload's bytes), every call
    with a cold L2, as in a decode step whose weights (62 MB) outrun it.
    Returns the f32 768->3072 numbers."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    rates = peaks(name)
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    res = {}
    for tname, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        for k, n in DECODE_SHAPES:
            x, payload, scale = wo_operands(4, GPT_B, k, n, k // WO_GROUP,
                                            seed=k + n, dtype=dtype)
            err, _ = wo_compare(x, payload, scale, 4, f"decode {k}->{n}")
            w = Q.unpack_splitk(payload, 4, k).float()
            w_deq = (w * torch.repeat_interleave(scale, WO_GROUP, dim=0)) \
                .to(dtype)
            del w
            ms = cuda_ms(lambda: Q.splitk_wo_matmul(x, payload, scale, bits=4),
                         flush=flush)
            plain_ms = cuda_ms(lambda: Q.splitk_wo_matmul_reference(
                x, payload, scale, bits=4), flush=flush)
            library_ms = cuda_ms(lambda: torch.matmul(x, w_deq), flush=flush)
            del w_deq
            size = x.element_size()
            nbytes = (payload.numel() + 4 * scale.numel() + size * x.numel()
                      + size * GPT_B * n)
            ops = 2 * GPT_B * k * n
            t_bytes = nbytes / rates["bytes"] * 1e3
            t_ops = ops / rates[tname] * 1e3
            row = dict(ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                       bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            say("kernel-time", kernel="splitk_wo_matmul", bits=4,
                scale=f"g{WO_GROUP}", dtype=tname,
                shape=f"M{GPT_B}xK{k}xN{n}", ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="matmul_on_dequantized_weight",
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                bytes=nbytes, ops=ops, max_abs_err=err, l2="cold",
                card=name.replace(" ", "_"))
            if (tname, k, n) == ("f32", 768, 3072):
                res = row
    del flush
    return res


def device_bytes(model) -> dict:
    """Bytes the step model keeps on the card, by kind."""
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.tensor import FTensor, PackedQTensor
    out = dict(payload=0, scales=0, colsums=0, float=0, tables=0)
    for v in model.values:
        if not isinstance(v, Constant):
            continue
        d = v.data
        if isinstance(d, PackedQTensor):
            out["payload"] += d.planes.numel() * d.planes.element_size()
            out["colsums"] += d.colsum.numel() * d.colsum.element_size()
            sv = d.scale_vec()
            out["scales"] += 0 if sv is None else sv.numel() * 4
        elif isinstance(d, FTensor):
            out["float"] += d.data.numel() * d.data.element_size()
    for _, table in model.__dict__.get("_table_cache", {}).values():
        out["tables"] += table.numel() * table.element_size()
    return out


@contextlib.contextmanager
def decode_mode(dtype: str, mode: str):
    """packed_execution=mode, in bf16 (low_precision_floats) or f32."""
    from numpy_quant_tpu_torch import config
    floats = config.low_precision_floats() if dtype == "bf16" \
        else contextlib.nullcontext()
    with packed_execution(mode), floats:
        yield


def decode_run(model, proto, prompt, dtype: str, mode: str):
    """One greedy decode; returns (ids, per-step logits, launch counts)."""
    from numpy_quant_tpu_torch.utils import generate_kv
    rows = []
    with decode_mode(dtype, mode):
        ids, counts = counted(lambda: generate_kv(
            model, prompt, proto._wte, proto._wpe, GPT_NEW, step_logits=rows))
    return ids, rows, counts


def decode_seconds(model, proto, prompt, runs: list, reps: int) -> dict:
    """Wall seconds of ``reps`` greedy decodes of each (dtype, mode) in
    ``runs``, taken in turns (forward, then backward order) so that a
    host that slows for a while slows every mode alike."""
    import torch
    from numpy_quant_tpu_torch.utils import generate_kv
    seconds = {run: [] for run in runs}
    for rep in range(reps):
        for run in (runs if rep % 2 == 0 else runs[::-1]):
            with decode_mode(*run):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                generate_kv(model, prompt, proto._wte, proto._wpe, GPT_NEW)
                seconds[run].append(time.perf_counter() - t0)
    return seconds


def compare_decodes(ids_a, rows_a, ids_b, rows_b) -> dict:
    """Greedy runs a and b of one model: the largest |logit difference|
    over the steps whose inputs agree in both (a row's ids equal up to
    the step), that over the teacher-forced steps, and the rows that part,
    each with its top-2 margin (of run b) at the step where they part."""
    import numpy as np
    same_upto = np.cumprod(ids_a == ids_b, axis=1).astype(bool)
    max_diff = forced_diff = max_logit = 0.0
    for t, (ra, rb) in enumerate(zip(rows_a, rows_b)):
        diff = (ra - rb).abs().amax(dim=1).cpu().numpy()
        live = same_upto[:, t]
        if live.any():
            max_diff = max(max_diff, float(diff[live].max()))
        if t < GPT_PROMPT:  # inputs all from the prompt
            forced_diff = max(forced_diff, float(diff.max()))
        max_logit = max(max_logit, float(rb.abs().max()))
    parted = []
    for b in range(ids_a.shape[0]):
        if same_upto[b, -1]:
            continue
        p = int(np.argmin(same_upto[b]))  # first position that differs
        top2 = rows_b[p - 1][b].topk(2).values
        parted.append((b, p, float(top2[0] - top2[1])))
    return dict(max_diff=max_diff, forced_diff=forced_diff,
                max_logit=max_logit, parted=parted)


def decode_phase(card: str) -> dict:
    """Phase 7: returns the f32 "kernel" run's launch counts."""
    import numpy as np
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_decode_step,
                                                  random_gpt2_weights)
    t0 = time.perf_counter()
    proto = gpt_decode_step(random_gpt2_weights(GPT2_SMALL, seed=0),
                            GPT2_SMALL, batch_size=GPT_B, max_len=GPT_MAX_LEN)
    model = Model.from_onnx(proto)
    converted = model.quantize_weights(bit_width=4, group_size=WO_GROUP)
    say("gpt2-setup", seconds=time.perf_counter() - t0, nodes=len(model.nodes),
        converted=converted, device=model.device)
    assert converted == WO_PER_STEP, converted
    prompt = np.random.default_rng(0).integers(
        0, GPT2_SMALL["vocab_size"], size=(GPT_B, GPT_PROMPT)).astype(np.int32)
    steps = GPT_PROMPT + GPT_NEW - 1
    modes = [(d, m) for d in ("f32", "bf16") for m in ("kernel", "unpack")]
    runs = {}
    for dtype, mode in modes:
        ids, rows, counts = decode_run(model, proto, prompt, dtype, mode)
        runs[dtype, mode] = ids, rows, counts
    seconds = decode_seconds(model, proto, prompt, modes, DECODE_REPS)
    for dtype, mode in modes:
        ids, rows, counts = runs[dtype, mode]
        wo = counts["splitk_wo_matmul"]
        finite = all(bool(r.isfinite().all()) for r in rows)
        wall = statistics.median(seconds[dtype, mode])
        say("gpt2-decode", dtype=dtype, packed_execution=mode,
            batch=GPT_B, prompt=GPT_PROMPT, new_tokens=GPT_NEW,
            steps=steps, kernel_launches_per_step=wo / steps,
            other_kernel_launches=sum(counts.values()) - wo,
            tokens_per_s=GPT_B * GPT_NEW / wall,
            ms_per_step=wall / steps * 1e3,
            ms_per_step_runs=",".join(
                f"{s / steps * 1e3:.2f}" for s in seconds[dtype, mode]),
            finite=finite, card=card.replace(" ", "_"))
        assert ids.shape == (GPT_B, GPT_PROMPT + GPT_NEW), ids.shape
        assert (ids[:, :GPT_PROMPT] == prompt).all()
        assert finite, f"{dtype} {mode}: non-finite logits"
        assert wo == (WO_PER_STEP * steps if mode == "kernel" else 0), wo
        assert sum(counts.values()) == wo, counts
    say("gpt2-memory", **{f"{k}_bytes": v
                          for k, v in device_bytes(model).items()})
    ids_k, rows_k, counts = runs["f32", "kernel"]
    ids_u, rows_u, _ = runs["f32", "unpack"]
    cmp = compare_decodes(ids_k, rows_k, ids_u, rows_u)
    # where greedy rows part, the two runs' logits at that step may differ
    # by max_diff each, so the top-2 margin there is at most 2 * max_diff
    unexplained = [c for c in cmp["parted"] if c[2] > 2 * cmp["max_diff"]]
    gen = slice(GPT_PROMPT, None)
    say("gpt2-f32-kernel-vs-unpack",
        tokens_equal=f"{int((ids_k[:, gen] == ids_u[:, gen]).sum())}/"
                     f"{ids_k[:, gen].size}",
        rows_equal=f"{GPT_B - len(cmp['parted'])}/{GPT_B}",
        rows_parted_within_margin=len(cmp["parted"]) - len(unexplained),
        parted=";".join(f"row{b}@{p}:margin{m:.3g}" for b, p, m in cmp["parted"])
        or "none",
        max_abs_logit_diff=cmp["max_diff"],
        teacher_forced_max_diff=cmp["forced_diff"],
        max_abs_logit=cmp["max_logit"])
    assert not unexplained, unexplained
    assert cmp["forced_diff"] <= TEACHER_TOL * cmp["max_logit"], cmp
    for mode in ("kernel", "unpack"):
        ids_b = runs["bf16", mode][0]
        say("gpt2-bf16-vs-f32-kernel", packed_execution=mode,
            tokens_equal=f"{int((ids_b[:, gen] == ids_k[:, gen]).sum())}/"
                         f"{ids_k[:, gen].size}")
    return counts


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, REPO)
    import numpy as np
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.vit import (VIT_BASE, WEIGHT_CONFIGS,
                                                  random_vit_weights,
                                                  vit_image_classifier)
    t_start = time.perf_counter()
    card = card_line()
    name = torch.cuda.get_device_name(0)
    say("card", nvidia_smi=card.replace(" ", "_"), torch=torch.__version__,
        cuda=torch.version.cuda, python=sys.version.split()[0])
    say("build", seconds=build_kernels())

    worst = check_attention()
    timing = time_attention(name)
    qworst = check_qmatmul()
    qtiming = time_qmatmul(name)

    # -- phase 2: the main path in f32 --------------------------------
    t0 = time.perf_counter()
    weights = random_vit_weights(VIT_BASE, seed=0)
    model = Model.from_onnx(vit_image_classifier(weights, VIT_BASE))
    rng = np.random.default_rng(0)
    calib = rng.normal(size=(2, 3, 224, 224)).astype(np.float32) * 0.5
    stats = model.calibration_stats([calib])
    qmodel = model.quantize(bit_width=8, stats=stats, quantize_conv=True)
    say("setup", seconds=time.perf_counter() - t0,
        nodes=len(qmodel.nodes), device=qmodel.device)
    x8 = torch.from_numpy(rng.normal(size=(B_F32, 3, 224, 224))
                          .astype(np.float32) * 0.5).cuda()
    unfused = qmodel([x8])[0]
    report = qmodel.optimize()
    say("optimize", **{k: v for k, v in report.items()})
    assert report["fuse_attention"] == 12 and not report["fusion_failures"]
    packed = qmodel.pack_weights()
    say("pack_weights", mode="int8", packed=packed,
        packed_execution=config.packed_execution)
    assert packed == PACKED_PER_FORWARD, packed
    assert config.packed_execution == "unpack"
    fused, counts = counted(lambda: qmodel([x8])[0])
    launches_f32 = counts["fused_attention_hs"]
    assert fused.shape == (B_F32, 1000) and np.isfinite(fused).all()
    # The card sums the softmax and LayerNorm rows in another order in the
    # fused kernel than in the unfused torch ops, so a few probabilities
    # round one step apart (counted below); twelve quantized layers carry
    # such steps into the logits. Labels must agree wherever the unfused
    # top-1 margin exceeds LOGIT_TOL * max|logits|, and no logit may move
    # further than that.
    scale = float(np.abs(unfused).max())
    diff = float(np.abs(fused - unfused).max())
    top2 = np.sort(unfused, axis=1)[:, -2:]
    margin = top2[:, 1] - top2[:, 0]
    clear = margin > LOGIT_TOL * scale
    same = fused.argmax(1) == unfused.argmax(1)
    flips, blocks = attention_flips(qmodel, x8)
    say("f32", batch=B_F32, launches=launches_f32,
        packed_launches=counts["splitk_qmatmul"] + counts["packed_qmatmul"],
        labels_equal=f"{int(same.sum())}/{B_F32}",
        labels_equal_clear_margin=f"{int(same[clear].sum())}/{int(clear.sum())}",
        max_abs_diff=diff, max_abs_logit=scale,
        top1_margins=",".join(f"{m:.4f}" for m in margin),
        attention_flipped_blocks=f"{flips}/{blocks}")
    assert launches_f32 == 12, launches_f32
    assert counts["splitk_qmatmul"] == counts["packed_qmatmul"] == 0, counts
    assert diff <= LOGIT_TOL * scale, (diff, scale)
    assert same[clear].all(), "fused and unfused labels differ"
    assert flips <= 0.01 * blocks, (flips, blocks)

    # -- phase 3: bf16 serving mode at batch 96 (bench.py's form) -----
    x = torch.from_numpy(rng.normal(size=(B_SERVE, 3, 224, 224))
                         .astype(np.float32) * 0.5).cuda()
    ref32 = qmodel([x])[0]
    with config.low_precision_floats():
        logits, counts = counted(lambda: qmodel([x])[0])
        launches = counts["fused_attention_hs"]
        assert logits.shape == (B_SERVE, 1000) and np.isfinite(logits).all()
        assert launches == 12, launches
        ips = images_per_s(qmodel, x, "unpack")
    agree = float((logits.argmax(1) == ref32.argmax(1)).mean())
    say("bf16", batch=B_SERVE, launches=launches, label_agreement_f32=agree,
        images_per_s=ips, ms_per_forward=B_SERVE / ips * 1e3,
        card=card.replace(" ", "_"))

    # -- phase 4: the packed paths in f32 at batch 8 ------------------
    main_launches = {}
    qmodels = {"int8": qmodel}
    for mode in WEIGHT_CONFIGS:
        t0 = time.perf_counter()
        qm = qmodels.get(mode)
        if qm is None:
            qm = model.quantize(bit_width=8, stats=stats, quantize_conv=True,
                                **WEIGHT_CONFIGS[mode])
            qm.optimize()
            packed = qm.pack_weights()
            say("pack_weights", mode=mode, packed=packed)
            assert packed == PACKED_PER_FORWARD, packed
            qmodels[mode] = qm
        kname = "packed_qmatmul" if mode == "w3a8" else "splitk_qmatmul"
        other = "splitk_qmatmul" if mode == "w3a8" else "packed_qmatmul"
        unpacked, cu = packed_forward(qm, x8, "unpack")
        kernel, ck = packed_forward(qm, x8, "kernel")
        assert kernel.shape == (B_F32, 1000) and np.isfinite(kernel).all()
        equal = bool(np.array_equal(kernel, unpacked))
        say("packed-f32", mode=mode, batch=B_F32, kernel=kname,
            launches=ck[kname], other_launches=ck[other],
            attention_launches=ck["fused_attention_hs"],
            unpack_mode_launches=cu[kname], kernel_equals_unpack=equal,
            max_abs_diff=float(np.abs(kernel - unpacked).max()),
            labels_equal_int8=f"{int((kernel.argmax(1) == fused.argmax(1)).sum())}/{B_F32}",
            seconds=time.perf_counter() - t0)
        assert ck[kname] == PACKED_PER_FORWARD and ck[other] == 0, ck
        assert ck["fused_attention_hs"] == 12 and cu[kname] == 0, (ck, cu)
        assert equal, f"{mode}: kernel and unpack logits differ"
        if mode == "w3a8":
            main_launches[kname] = ck[kname]

    # -- phase 5: W4A8 bf16 serving at batch 96 -----------------------
    w4 = qmodels["w4a8"]
    w4_ref32 = w4([x])[0]
    with config.low_precision_floats():
        w4_kernel, ck = packed_forward(w4, x, "kernel")
        w4_unpack, cu = packed_forward(w4, x, "unpack")
        ips_kernel = images_per_s(w4, x, "kernel")
        ips_unpack = images_per_s(w4, x, "unpack")
    assert np.isfinite(w4_kernel).all() and np.isfinite(w4_unpack).all()
    assert ck["splitk_qmatmul"] == PACKED_PER_FORWARD, ck
    assert ck["fused_attention_hs"] == 12 and cu["splitk_qmatmul"] == 0
    main_launches["splitk_qmatmul"] = ck["splitk_qmatmul"]
    say("w4a8-bf16", batch=B_SERVE, kernel_launches=ck["splitk_qmatmul"],
        attention_launches=ck["fused_attention_hs"],
        images_per_s_kernel=ips_kernel, images_per_s_unpack=ips_unpack,
        label_agreement_f32_kernel=float(
            (w4_kernel.argmax(1) == w4_ref32.argmax(1)).mean()),
        label_agreement_f32_unpack=float(
            (w4_unpack.argmax(1) == w4_ref32.argmax(1)).mean()),
        kernel_equals_unpack=bool(np.array_equal(w4_kernel, w4_unpack)),
        card=card.replace(" ", "_"))

    # -- phase 6: the weight-only kernel against its plain version -----
    wo_worst = check_wo()
    wo_timing = time_wo(name)

    # -- phase 7: the weight-only GPT-2 decode path at full width ------
    wo_counts = decode_phase(card)
    main_launches["splitk_wo_matmul"] = wo_counts["splitk_wo_matmul"]
    say("done", seconds=time.perf_counter() - t_start)

    rows = [{
        "name": "fused_attention_hs", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_hs.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:530",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None}]
    for kname, line in (("splitk_qmatmul", 246), ("packed_qmatmul", 533)):
        t = qtiming[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "numpy_quant_tpu_torch/csrc/qmatmul.cu",
            "replaces": f"numpy_quant_tpu/kernels/qmatmul.py:{line}",
            "launches": main_launches[kname], "max_abs_err": qworst[kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"],
            "bound_ms": t["bound_ms"], "bound_by": t["bound_by"],
            "library_ms": t["library_ms"]})
    rows.append({
        "name": "splitk_wo_matmul", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/qmatmul_wo.cu",
        "replaces": "numpy_quant_tpu/kernels/qmatmul.py:411",
        "launches": main_launches["splitk_wo_matmul"],
        "max_abs_err": wo_worst, "ms": wo_timing["ms"],
        "plain_ms": wo_timing["plain_ms"], "bound_ms": wo_timing["bound_ms"],
        "bound_by": wo_timing["bound_by"],
        "library_ms": wo_timing["library_ms"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
