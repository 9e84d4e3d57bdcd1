#!/usr/bin/env python3
"""Drive the PyTorch port's int8 ViT-Base, weight-only GPT-2 decode, int8
GPT-2 full-context scoring, int8 TinyLlama-1.1B scoring, int8 T5-small
encoder-decoder scoring, W8A16 ViT-Base and 1-16-bit MLP paths on one
NVIDIA GPU.

    python3 chip_smoke.py

Phases, one line each (any failure raises and the script exits non-zero):
  0. the card, the software, and the kernels' build (one nvcc per source,
     all started together);
  1. every hand-written kernel against its plain PyTorch version on the
     card, in every variant the paths use, then both timed at ViT-Base
     serving shapes beside the kernel's bound (and, for the packed
     matmuls, beside torch._int_mm plus the eager epilogue); the exact
     attention forms must show no flipped (row, head) block wherever they
     sum softmax rows in torch's order, which torch's own CUDA sum must
     still take at that shape (probed once per shape);
  2. the main path in f32: random ViT-Base weights (seed 0) -> ONNX ->
     Model.from_onnx -> calibration on 2 images -> quantize(int8,
     quantize_conv) -> unfused forward -> optimize() -> pack_weights()
     -> fused forward under packed_execution="unpack", which must launch
     the attention kernel once per layer, equal its plain version on every
     layer's operands (no flipped block) and agree with the unfused
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
     (M = 8, W4 g=128), each with its launch plan (the cluster along K),
     beside its bound, the plain version and torch.matmul on the weight
     dequantized beforehand, in f32 and bf16;
  7. the weight-only decode path at full width: random GPT-2 small
     weights (seed 0) -> gpt_decode_step(B=8, max_len=64) ->
     Model.from_onnx -> quantize_weights(4, group_size=128) (49 weights)
     -> greedy generate (prompt 16, 48 new tokens) under "kernel" and
     "unpack", f32 and bf16: 49 kernel launches per step, f32 "kernel"
     tokens equal to "unpack" tokens (a row may part only where the top-2
     margin is within the measured logit difference), tokens/s (median of
     5 timed decodes per mode, the modes taken in turns);
  8. the blockwise attention kernel fused_attention_hs_blockq against its
     plain version in every variant (exact, fast, fast with the static
     shift x causal none, full and window 256 x out_requant off and on x
     zero points zero and nonzero) at (B, N, H) = (2, 1024, 12),
     (1, 1000, 4) and (1, 4096, 2), head dims 16, 32 and 128, narrow q at
     N=4096, tile skipping off and the static shift's full walk, the exact
     form at N = 8, 50, 100, 127, 130, 1000 and 1023 (no flipped block
     where torch sums a row in one warp); the monolithic kernel's causal and
     window forms at N=197 and 256; blockwise against monolithic at
     N=1000 (at most 1% of (row, head) blocks may differ, each by one
     probability step); then timed at the GPT-2 shape (B=8, N=1024, H=12,
     causal, int8 out) beside its bound and its plain version;
  9. the int8 GPT-2 scoring path at full width and depth: random GPT-2
     small weights (seed 0) -> gpt_causal_lm(B=8, seq 1024) ->
     Model.from_onnx -> calibration on 2 sequences -> quantize(int8) ->
     unfused forward -> optimize() (12 causal FusedAttentionHS) -> fused
     f32 forward, which must launch the blockwise kernel 12 times and the
     monolithic one never, equal its plain version on every layer's
     operands (no flipped block) and equal the unfused forward bit for bit;
     the bf16 mode; tokens scored per second (median of 5 forwards per
     mode, in turns); one profiled bf16 forward; peak device memory;
 10. the pre-split attention kernel fused_attention against its plain
     version in 525 variants (zero points all nonzero, all zero and each
     alone zero; out_requant off, on, on without res_zp; mask none, causal,
     window 6 and 512; N = 8, 50, 100, 127, 130, 197, 1000, 1023, 1024,
     2048; head dims 16-128; odd BH; a mask too small to skip tiles), with
     0 flipped blocks required wherever torch sums a row in one warp, which
     torch's own CUDA sum must still do in the kernel's order; then at the
     TinyLlama scoring shape (B=4 x 32 heads, N=2048, D=64, causal, int8
     out): against its plain version (0 flips), and timed beside its bound
     and its plain version;
 11. the int8 TinyLlama-1.1B scoring path at full width and depth: random
     weights (seed 0) -> llama_causal_lm(B=4, seq 2048) -> Model.from_onnx
     -> calibration on 2 sequences -> quantize(int8) -> unfused B=1 forward
     in f32 and bf16 -> optimize() (22 FusedAttention plain fusions, 0
     FusedAttentionHS, no failures) -> fused B=1 forward (22 launches,
     whether the kernel skips masked key tiles at these qparams,
     logits within LOGIT_TOL of the unfused ones, argmax equal where the
     margin clears it) -> fused B=1 bf16 forward (22 launches, the kernel
     equal to its plain version on its operands; its distance from f32
     beside the unfused bf16 walk's) -> fused B=4 forward (22 launches; row
     0 against the B=1 forward) -> bf16; tokens/s
     (median of 5 forwards per mode, in turns); one profiled bf16 forward;
     peak device memory of the unfused B=1 and fused B=4 forwards;
 12. the score-bias forms of both head-split kernels against their plain
     versions (monolithic and blockwise x exact, fast, static shift x the
     per-head, head-shared and decoder bias + causal forms x out_requant x
     zero points, H=8 at N = 128, 256, 512, 1024 with D=64 and at N=256
     with D=32 and 128): no flipped block on the exact forms, the one-step
     rule on the fast ones; the bias clause of the dispatch (N=256
     monolithic, 257 blockwise) and narrow q refused; then timed at
     t5-small's three attention shapes beside bound and plain version;
 13. the int8 T5-small scoring path at full width and depth: random
     weights (seed 0) -> t5_conditional_generation(B=8, source 512, target
     128) -> Model.from_onnx -> calibration on 2 sequence pairs ->
     quantize(int8) -> unfused forward -> optimize() (18 FusedAttentionHS,
     12 with the score bias as 4th input, no plain fusion, no failure) ->
     fused f32 forward (6 blockwise and 12 monolithic launches, no flipped
     block, equal to the unfused forward bit for bit) -> bf16 (launches,
     logits against f32); target tokens/s (median of 5 forwards per mode,
     in turns); one profiled bf16 forward; peak device memory.
 14. the quantize boundaries and the 9-16-bit path: (a) the elementwise
     kernels quantize and dequantize (csrc/elementwise.cu) against their
     plain chains bit for bit at widths 1-64 in every form (f32/bf16 in;
     int8/int32/int64 out; zero point none, scalar or a tensor; scale
     scalar or per channel; a zero scale; ties, infinities, NaN and values
     past the clip; contiguous, misaligned, transposed and strided data);
     (b) both timed at ViT-Base's largest boundary and the GPT-2 and
     TinyLlama scoring shapes beside their bytes bound, the chains and
     torch's quantized-tensor calls (another function), and their host
     time per call; (c) the ViT-Base int8 f32 forward equal with the
     kernels and with the chains swapped in, the kernels' launches per
     forward on the ViT, GPT-2, TinyLlama and T5 paths, aten calls and
     wall time per forward of ViT-Base and T5-small with either; (d) the
     reference's bit-width sweep, mlp.onnx at 1-16 bits on the two-circles
     data: the card's integers equal the CPU port's, accuracy > 0.9 from 6
     bits; (e) ViT-Base W8A16 (16-bit activations, 8-bit weights) in f32
     at B=8 after optimize(): no fused attention (JAX's reason), closer to
     the float logits than int8, images/s, idle share, peak memory.
Phase 3 also times the bf16 forward with the plain chains swapped in and
profiles one forward. The last three lines are the kernels JSON line, the
card's name and power limit, and the result line. Imports nothing of JAX or numpy_quant_tpu.
"""
from __future__ import annotations

import contextlib
import itertools
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

# blockwise attention (phase 8), head dim 64
BQ_SHAPES = ((2, 1024, 12), (1, 1000, 4), (1, 4096, 2))  # (B, N, H)
MASK_VAL = -3.2e8  # a dequantized -1e9-style causal mask constant
NOSKIP_MASK = -2000.0  # too small for the kernel to skip masked tiles
DEGENERATE_SCORE_MAX = 200.0  # every score clamps: the full-walk case
QP_ZERO = dict(QP, zq=0, zk=0, zv=0, zp_p=0, sp=float(1.0 / 127.0))
ATT_MODES = {"exact": (False, None), "fast": (True, None),
             "fast_shift": (True, SCORE_MAX)}
CAUSAL = {"none": (None, None), "full": (MASK_VAL, None),
          "window256": (MASK_VAL, 256)}
MONO_N, MONO_WINDOW = (197, 256), 64
# exact forms of the tiled kernels (phases 8, 10) at short N, N % 4 != 0
# and the strided/vectorized edge: 0 flipped blocks where torch sums a row
# in one warp
EXACT_N = (8, 50, 100, 127, 130, 1000, 1023)
# GPT-2 scoring (phase 9): batch GPT_B at the full context
GPT_SEQ = 1024
SCORE_REPS = 5  # timed forwards per mode, in turns
# TinyLlama-1.1B scoring (phases 10-11): batch LLAMA_B at the full context
LLAMA_B, LLAMA_SEQ = 4, 2048
# score-bias forms (phase 12) at t5-small's heads: the encoder's per-head
# relative bias, a head-shared bias and the decoder's combined bias + causal
# constant, at these key counts (and head dims 32 and 128 at SB_D_N)
SB_B, SB_HEADS = 2, 8
SB_N, SB_D_N = (128, 256, 512, 1024), 256
SB_FORMS = ("per_head", "shared", "decoder")
# T5-small scoring (phase 13): B sequences of T5_SRC source and T5_TGT
# target tokens (t5's fine-tuning input length)
T5_B, T5_SRC, T5_TGT = 8, 512, 128
# quantize/dequantize (phase 14): the boundary kernels every path runs
ELEMENTWISE = ("quantize", "dequantize")
EW_WIDTHS = (1, 2, 3, 4, 7, 8, 9, 12, 16, 32, 64)
EW_SHAPE = (37, 29)  # 1,073 elements: no multiple of the 4-wide vector
EW_LAYOUTS = ("contiguous", "offset", "transposed", "strided")
EW_SCALE, EW_ZP = 0.0213, -7  # the timed calls' qparams
MLP_ACC_RULE = 6  # the reference's rule: accuracy > 0.9 from 6 bits


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


def cuda_ms(fn, reps: int = 20, warmup: int = 3, flush=None,
            lead: bool = False) -> float:
    """Median device time of ``fn()`` over ``reps`` calls (CUDA events).
    With ``flush`` (a device buffer larger than the L2 cache) zeroed before
    each call, outside the timed span, every call finds L2 cold. With
    ``flush`` or ``lead`` a device sleep queued before the call lets the
    host enqueue it before the device reaches it, so a call whose kernels
    take less time than its Python wrapper is timed on the device alone."""
    import torch
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        if flush is not None:
            flush.zero_()
        if flush is not None or lead:
            torch.cuda._sleep(LEAD_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def attention_inputs(b: int, nq: int, seed: int, n: int = N_TOK,
                     heads: int = HEADS, d: int = HEAD_DIM):
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    shape = (b, n, heads * d)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=shape)
                                .astype(np.int8)).cuda() for _ in range(3))
    return q[:, :nq].contiguous(), k, v


def attention_diff(got, want, heads: int, rq, qp: dict, label: str,
                   int8_step: float | None = None) -> tuple[int, int, float]:
    """An attention kernel's output against another version's: (flipped
    (row, head) blocks, blocks, max |difference|). Raises unless at most
    1% of the blocks differ (or one), each by at most one probability
    step: 255 * sp * sv on f32 out; on int8 out that over the requant
    scale, rounded, floor(255 * sp * sv / res_scale) + 1 (or
    ``int8_step``)."""
    import torch
    torch.cuda.synchronize()
    assert got.shape == want.shape and got.dtype == want.dtype, label
    diff = (got.double() - want.double()).abs()
    b, nq, hd = got.shape
    blocks = diff.reshape(b, nq, heads, hd // heads).amax(dim=-1)
    flips = int((blocks > 0).sum())
    max_err = float(diff.max())
    per_flip = 255.0 * qp["sp"] * qp["sv"] * 1.000001
    if rq is not None:
        per_flip = int8_step or float(int(per_flip / rq[0]) + 1)
    if max_err > per_flip or flips > max(1, 0.01 * blocks.numel()):
        raise AssertionError(f"{label}: {flips} of {blocks.numel()} blocks "
                             f"differ, max |diff| {max_err}")
    return flips, blocks.numel(), max_err


def check_attention() -> float:
    """Kernel against plain version in every variant; returns the largest
    |difference| over the f32-output variants."""
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
        flips, blocks, max_err = attention_diff(
            A.fused_attention_hs(q, k, v, **kw),
            A.fused_attention_hs_reference(q, k, v, **kw), HEADS, rq, QP,
            "fused_attention_hs against its plain version", int8_step=1.0)
        say("kernel-check", kernel="fused_attention_hs", fast=fast,
            out_requant=rq is not None, nq=nq, score_max=sm,
            flipped_blocks=f"{flips}/{blocks}", max_abs_err=max_err)
        if not fast:
            # the exact form sums rows in torch's order (N % 4 != 0: each
            # row's own unaligned head and tail), so no block may flip
            assert exact_in_order(B_CHECK * HEADS * nq, N_TOK) \
                and flips == 0, (nq, rq, flips)
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


def attention_flips(qmodel, x, skips: list | None = None) -> tuple[int, int]:
    """The attention kernels against their plain versions on every
    attention layer's real inputs (one recorded forward of ``x``, an input
    or a list of inputs): flipped (row, head) blocks. ``skips`` receives,
    per FusedAttention call, whether its kernel skips masked key tiles.
    The recorded values are dropped afterwards."""
    import torch
    from numpy_quant_tpu_torch.graph import Variable
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.ops.registry import (attention_call,
                                                    plain_attention_call)
    qmodel(x if isinstance(x, list) else [x], record=True, as_numpy=False)
    recorded = {v.name: v.data for v in qmodel.values if v.data is not None}
    flips = blocks = 0
    for node in qmodel.nodes:
        if node.op not in ("FusedAttentionHS", "FusedAttention"):
            continue
        # the operands as the executor hands them to the op (quantized)
        ins = qmodel._node_inputs(node, recorded)
        if node.op == "FusedAttention":
            q, kt, v, kw = plain_attention_call(ins, node.attrs)
            if skips is not None:
                skips.append(A.skips_masked_tiles(q.shape[-1], **kw))
            got = A.fused_attention(q, kt, v, **kw)
            want = A.fused_attention_reference(q, kt, v, **kw)
            heads = 1  # one (row, head) block per row of [BH, N, D]
        else:
            q, k, v, kw, _ = attention_call(ins, node.attrs)
            got = A.fused_attention_hs(q, k, v, **kw)
            bias = kw["score_bias"]
            plain = A.fused_attention_hs_blockq_reference \
                if A.blockwise(k.shape[1], None, nq=q.shape[1],
                               bias_heads=None if bias is None
                               else kw["num_heads"]) \
                else A.fused_attention_hs_reference
            want = plain(q, k, v, **kw)
            heads = kw["num_heads"]
        diff = (got.double() - want.double()).abs()
        b, nq, hd = got.shape
        per_block = diff.reshape(b, nq, heads, -1).amax(dim=-1)
        flips += int((per_block > 0).sum())
        blocks += per_block.numel()
    torch.cuda.synchronize()
    del recorded
    for v in qmodel.values:
        if isinstance(v, Variable):
            v.data = None
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
        "fused_attention_hs", "fused_attention_hs_blockq", "splitk_qmatmul",
        "packed_qmatmul", "splitk_wo_matmul", "fused_attention",
        *ELEMENTWISE)}
    for f in counters.values():
        f.launches = 0
    out = fn()
    return out, {name: f.launches for name, f in counters.items()}


def others(counts: dict) -> int:
    """Launches of every kernel but the quantize boundaries', which every
    path runs."""
    return sum(v for k, v in counts.items() if k not in ELEMENTWISE)


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
    with a cold L2, as in a decode step whose weights (62 MB) outrun it;
    each shape's launch plan (the cluster along K) beside it. Returns the
    768->3072 numbers by dtype."""
    import torch
    from numpy_quant_tpu_torch.kernels import qmatmul as Q
    rates = peaks(name)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
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
            plan = Q.wo_plan(GPT_B, n, payload.shape[0], 4, sms)
            say("kernel-time", kernel="splitk_wo_matmul", bits=4,
                scale=f"g{WO_GROUP}", dtype=tname,
                shape=f"M{GPT_B}xK{k}xN{n}", cluster=plan["cluster"],
                blocks=plan["blocks"], ms=ms, plain_ms=plain_ms,
                library_ms=library_ms, library="matmul_on_dequantized_weight",
                bound_ms=row["bound_ms"], bound_by=row["bound_by"],
                bytes=nbytes, ops=ops, max_abs_err=err, l2="cold",
                card=name.replace(" ", "_"))
            if (k, n) == (768, 3072):
                res[tname] = row
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
            other_kernel_launches=others(counts) - wo,
            tokens_per_s=GPT_B * GPT_NEW / wall,
            ms_per_step=wall / steps * 1e3,
            ms_per_step_runs=",".join(
                f"{s / steps * 1e3:.2f}" for s in seconds[dtype, mode]),
            finite=finite, card=card.replace(" ", "_"))
        assert ids.shape == (GPT_B, GPT_PROMPT + GPT_NEW), ids.shape
        assert (ids[:, :GPT_PROMPT] == prompt).all()
        assert finite, f"{dtype} {mode}: non-finite logits"
        assert wo == (WO_PER_STEP * steps if mode == "kernel" else 0), wo
        assert others(counts) == wo, counts
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


def attention_kw(heads: int, mode: str, causal: str, rq, qp: dict,
                 **over) -> dict:
    fast, score_max = ATT_MODES[mode]
    mask, window = CAUSAL[causal]
    kw = dict(qp, num_heads=heads, fast=fast, score_max=score_max,
              out_requant=rq, causal_mask_val=mask, causal_window=window)
    kw.update(over)
    return kw


def check_blockq() -> float:
    """Phase 8: the blockwise kernel against its plain version, the
    monolithic kernel's causal forms against theirs, and blockwise against
    monolithic. Returns the largest |difference| of the f32-output
    blockwise variants."""
    from numpy_quant_tpu_torch.kernels import attention as A
    worst, seed = 0.0, 1000

    def against_plain(b, n, h, nq, rq, qp, kw, label, fn=None, plain=None,
                      d=HEAD_DIM):
        """(flipped blocks, blocks, max |diff| on f32 out, else 0)."""
        nonlocal seed
        seed += 1
        q, k, v = attention_inputs(b, nq, seed, n=n, heads=h, d=d)
        fn = fn or A.fused_attention_hs_blockq
        plain = plain or A.fused_attention_hs_blockq_reference
        flips, blocks, err = attention_diff(
            fn(q, k, v, **kw), plain(q, k, v, **kw), h, rq, qp, label)
        if not kw["fast"]:
            # exact forms: no flip where both sides sum rows in torch's
            # order (the blockwise plain version in BLOCK_Q-row q tiles)
            tiles = {nq}
            if plain is A.fused_attention_hs_blockq_reference:
                tiles = {min(nq, A.BLOCK_Q), nq % A.BLOCK_Q or min(nq, A.BLOCK_Q)}
            if all(exact_in_order(b * h * t, n) for t in tiles):
                assert flips == 0, (label, flips, blocks)
        return flips, blocks, err if rq is None else 0.0

    def summary(kernel, shape, label, results):
        err = max(r[2] for r in results)
        say("kernel-check", kernel=kernel, shape=shape, cases=label,
            variants=len(results),
            flipped_blocks=f"{sum(r[0] for r in results)}/"
                           f"{sum(r[1] for r in results)}",
            max_abs_err_f32_out=err)
        return err

    variants = list(itertools.product(CAUSAL, (None, OUT_REQUANT),
                                      ("nonzero", "zero")))
    for b, n, h in BQ_SHAPES:
        for mode in ATT_MODES:
            res = []
            for causal, rq, zp in variants:
                qp = QP if zp == "nonzero" else QP_ZERO
                res.append(against_plain(
                    b, n, h, n, rq, qp, attention_kw(h, mode, causal, rq, qp),
                    f"blockq B{b} N{n} H{h} {mode} {causal} rq={rq} zp={zp}"))
            worst = max(worst, summary(
                "fused_attention_hs_blockq", f"B{b}xN{n}xH{h}xD{HEAD_DIM}",
                f"{mode}:causal_none/full/window256:rq_off/on:zp_nonzero/zero",
                res))
    # the exact form at short N, N % 4 != 0 and the 128-key edge
    for n in EXACT_N:
        res = []
        for causal, rq, zp in variants:
            qp = QP if zp == "nonzero" else QP_ZERO
            res.append(against_plain(
                1, n, 3, n, rq, qp, attention_kw(3, "exact", causal, rq, qp),
                f"blockq exact N{n} {causal} rq={rq} zp={zp}"))
        worst = max(worst, summary(
            "fused_attention_hs_blockq", f"B1xN{n}xH3xD{HEAD_DIM}",
            "exact_N:causal_none/full/window256:rq_off/on:zp", res))
    # narrow q (no mask) at N = 4096
    res = []
    for nq, mode, rq, zp in itertools.product((1, 3), ATT_MODES,
                                              (None, OUT_REQUANT),
                                              ("nonzero", "zero")):
        qp = QP if zp == "nonzero" else QP_ZERO
        res.append(against_plain(1, 4096, 2, nq, rq, qp,
                                 attention_kw(2, mode, "none", rq, qp),
                                 f"blockq narrow nq={nq} {mode} rq={rq}"))
    worst = max(worst, summary("fused_attention_hs_blockq", "B1xN4096xH2",
                               "narrow_q1/3:all_modes:rq_off/on:zp",
                               res))
    # the other head dims the kernel is built for
    for d in (16, 32, 128):
        res = []
        for mode, causal, rq in itertools.product(ATT_MODES, ("none", "full"),
                                                  (None, OUT_REQUANT)):
            res.append(against_plain(
                1, 1000, 2, 1000, rq, QP, attention_kw(2, mode, causal, rq, QP),
                f"blockq D{d} {mode} {causal} rq={rq}", d=d))
        worst = max(worst, summary("fused_attention_hs_blockq",
                                   f"B1xN1000xH2xD{d}",
                                   "all_modes:causal_none/full:rq_off/on", res))
    # a mask too small to skip tiles; the static shift's full walk
    res = []
    for mode, causal, rq in itertools.product(ATT_MODES, ("full", "window256"),
                                              (None, OUT_REQUANT)):
        res.append(against_plain(
            1, 1000, 4, 1000, rq, QP,
            attention_kw(4, mode, causal, rq, QP, causal_mask_val=NOSKIP_MASK),
            f"blockq noskip {mode} {causal} rq={rq}"))
        if mode == "fast_shift":
            res.append(against_plain(
                1, 1000, 4, 1000, rq, QP,
                attention_kw(4, mode, causal, rq, QP,
                             score_max=DEGENERATE_SCORE_MAX),
                f"blockq full-walk {causal} rq={rq}"))
    worst = max(worst, summary("fused_attention_hs_blockq", "B1xN1000xH4",
                               "mask_-2000_no_skip+score_max_200_full_walk",
                               res))
    # the monolithic kernel's causal and window forms
    for n in MONO_N:
        res = []
        for mode, window, rq, zp in itertools.product(
                ATT_MODES, (None, MONO_WINDOW), (None, OUT_REQUANT),
                ("nonzero", "zero")):
            qp = QP if zp == "nonzero" else QP_ZERO
            res.append(against_plain(
                2, n, HEADS, n, rq, qp,
                attention_kw(HEADS, mode, "full", rq, qp, causal_window=window),
                f"monolithic causal N{n} {mode} window={window} rq={rq}",
                fn=A.fused_attention_hs_monolithic,
                plain=A.fused_attention_hs_reference))
        summary("fused_attention_hs", f"B2xN{n}xH{HEADS}",
                f"causal_full/window{MONO_WINDOW}:all_modes:rq:zp", res)
    # blockwise against monolithic at N = 1000 (K/V still fit one block)
    res = []
    for mode, causal, rq in itertools.product(ATT_MODES, CAUSAL,
                                              (None, OUT_REQUANT)):
        res.append(against_plain(
            1, 1000, 4, 1000, rq, QP, attention_kw(4, mode, causal, rq, QP),
            f"blockq vs monolithic {mode} {causal} rq={rq}",
            plain=A.fused_attention_hs_monolithic))
    summary("fused_attention_hs_blockq_vs_monolithic", "B1xN1000xH4",
            "all_modes:causal_none/full/window256:rq_off/on", res)
    return worst


def time_blockq(name: str) -> dict:
    """The blockwise kernel at the GPT-2 scoring shape (causal, int8 out):
    the serving form (fast, static shift) and the exact form, kernel and
    plain version, beside the bound of the visible half. Returns the
    serving form's numbers."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    b, n, h = GPT_B, GPT_SEQ, HEADS
    q, k, v = attention_inputs(b, n, seed=99, n=n, heads=h)
    res = {}
    for label, mode in (("serving", "fast_shift"), ("exact", "exact")):
        kw = attention_kw(h, mode, "full", OUT_REQUANT, QP)
        ms = cuda_ms(lambda: A.fused_attention_hs_blockq(q, k, v, **kw))
        plain_ms = cuda_ms(lambda: A.fused_attention_hs_blockq_reference(
            q, k, v, **kw))
        nbytes = 4 * q.numel()  # q, k, v read once; int8 out written once
        # both products over the visible (causal) half of the scores
        ops = 2 * 2 * b * h * (n * (n + 1) // 2) * HEAD_DIM
        t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
        res[label] = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                          bound_by="bytes" if t_bytes >= t_ops else "operations")
        say("kernel-time", kernel="fused_attention_hs_blockq", form=label,
            shape=f"B{b}xN{n}xH{h}xD{HEAD_DIM}", causal=True, ms=ms,
            plain_ms=plain_ms, bound_ms=res[label]["bound_ms"],
            bound_by=res[label]["bound_by"], bytes=nbytes, ops=ops,
            library="none", card=name.replace(" ", "_"))
    return res["serving"]


def plain_inputs(bh: int, n: int, d: int, seed: int):
    """Random int8 q [BH, N, D], kt [BH, D, N] and v [BH, N, D] on the
    card."""
    import numpy as np
    import torch
    rng = np.random.default_rng(seed)
    q, k, v = (torch.from_numpy(rng.integers(-128, 128, size=(bh, n, d))
                                .astype(np.int8)).cuda() for _ in range(3))
    return q, k.transpose(1, 2).contiguous(), v


def check_plain() -> tuple[float, int, int]:
    """Phase 10: fused_attention against its plain version in every
    variant: zero points (all nonzero, all zero, and each of zq, zk, zv,
    zp_p alone zero), out_requant off / on / on without res_zp, mask none /
    causal / window 6 / window 512, at N = 50, 197 (byte loads of k^T,
    ragged key tiles), 1000, 1024 and 2048 (word loads), head dims 16, 32,
    64 and 128, odd BH, a mask too small to skip tiles, and the exact
    cases at EXACT_N. Returns (the largest |difference| on f32 out, flipped
    (row, head) blocks, blocks)."""
    from numpy_quant_tpu_torch.kernels import attention as A
    zps = {"nonzero": QP, "zero": QP_ZERO}
    for name in ("zq", "zk", "zv", "zp_p"):
        zps[f"{name}=0"] = dict(QP, **{name: 0})
    rqs = {"off": None, "on": OUT_REQUANT, "on_no_zp": (OUT_REQUANT[0], None)}
    masks = {"none": (None, None), "causal": (MASK_VAL, None),
             "window6": (MASK_VAL, 6), "window512": (MASK_VAL, 512)}
    worst, all_flips, all_blocks, seed = 0.0, 0, 0, 2000

    def run(bh, n, d, qp, rq, mask, window, label):
        nonlocal seed, worst, all_flips, all_blocks
        seed += 1
        q, kt, v = plain_inputs(bh, n, d, seed)
        kw = dict(qp, out_requant=rq, causal_mask_val=mask,
                  causal_window=window)
        flips, blocks, err = attention_diff(
            A.fused_attention(q, kt, v, **kw),
            A.fused_attention_reference(q, kt, v, **kw), 1, rq, qp, label)
        if rq is None:
            worst = max(worst, err)
        all_flips += flips
        all_blocks += blocks
        return flips, blocks, err if rq is None else 0.0

    def summary(shape, n, cases, res):
        flips = sum(r[0] for r in res)
        bh = int(shape.split("BH")[1].split("x")[0])
        say("kernel-check", kernel="fused_attention", shape=shape,
            cases=cases, variants=len(res),
            flipped_blocks=f"{flips}/{sum(r[1] for r in res)}",
            max_abs_err_f32_out=max(r[2] for r in res))
        # where the kernel sums rows in torch's order it equals the plain
        # version (its [BH, rows of a q tile, N] softmax) bit for bit
        tile = min(n, A.plain_tile(n))
        if all(exact_in_order(bh * t, n) for t in {tile, n % tile or tile}):
            assert flips == 0, f"{shape}: {flips} flipped blocks in torch order"

    for bh, n in ((5, 50), (5, 197), (3, 1024), (3, 2048)):
        res = [run(bh, n, HEAD_DIM, zps[z], rqs[r], *masks[m],
                   f"plain BH{bh} N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(zps, rqs, masks)]
        summary(f"BH{bh}xN{n}xD{HEAD_DIM}", n,
                "zp_6_forms:rq_off/on/on_no_zp:mask_none/causal/window6/512",
                res)
    for d, (bh, n) in itertools.product((16, 32, 128), ((7, 197), (3, 1000))):
        res = [run(bh, n, d, zps[z], rqs[r], *masks[m],
                   f"plain D{d} BH{bh} N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(("nonzero", "zero"), rqs,
                                                masks)]
        summary(f"BH{bh}xN{n}xD{d}", n, "zp_nonzero/zero:rq:mask", res)
    res = [run(3, 1024, HEAD_DIM, QP, rqs[r], NOSKIP_MASK, w,
               f"plain noskip rq={r} window={w}")
           for r, w in itertools.product(rqs, (None, 6, 512))]
    summary(f"BH3xN1024xD{HEAD_DIM}", 1024, "mask_-2000_no_skip:rq:causal/window",
            res)
    # short N, N % 4 != 0 and the 128-key edge (every row alignment)
    for n in EXACT_N:
        res = [run(3, n, HEAD_DIM, zps[z], rqs[r], *masks[m],
                   f"plain exact N{n} zp={z} rq={r} mask={m}")
               for z, r, m in itertools.product(("nonzero", "zero"),
                                                ("off", "on"),
                                                ("none", "causal", "window6"))]
        summary(f"BH3xN{n}xD{HEAD_DIM}", n, "exact_N:zp:rq_off/on:mask", res)
    return worst, all_flips, all_blocks


_PROBES: dict = {}


def exact_in_order(rows: int, n: int) -> bool:
    """True where an exact attention kernel must equal its plain version
    (and the unfused executor) bit for bit: the kernel replays torch's row
    sum order for the plain version's softmax tensor [rows, n]
    (kernels/attention.py::in_torch_order), and torch's own CUDA sum takes
    that order there, probed once per shape. A torch whose order changed
    fails the phase."""
    from numpy_quant_tpu_torch.kernels import attention as A
    if not A.in_torch_order(rows, n):
        return False
    if (rows, n) not in _PROBES:
        _PROBES[rows, n] = A.torch_sums_in_kernel_order("cuda", rows, n)
        say("torch-order", rows=rows, n=n,
            torch_sums_in_kernel_order=_PROBES[rows, n])
    assert _PROBES[rows, n], (f"torch's CUDA sum over [{rows}, {n}] no "
                              "longer takes the kernels' order")
    return True


def time_plain(name: str) -> dict:
    """fused_attention at the TinyLlama scoring shape (B=4 x 32 heads,
    N=2048, D=64, causal, int8 out): held against its plain version (no
    flip: N is in torch's order), then kernel and plain version timed
    (median of 20 CUDA-event calls) beside the bound of the visible
    half."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    bh, n, d = LLAMA_B * 32, LLAMA_SEQ, 64
    q, kt, v = plain_inputs(bh, n, d, seed=99)
    kw = dict(QP, out_requant=OUT_REQUANT, causal_mask_val=MASK_VAL)
    flips, blocks, _ = attention_diff(
        A.fused_attention(q, kt, v, **kw),
        A.fused_attention_reference(q, kt, v, **kw), 1, OUT_REQUANT, QP,
        f"plain BH{bh} N{n} timing shape")
    say("kernel-check", kernel="fused_attention", shape=f"BH{bh}xN{n}xD{d}",
        cases="timing_shape:causal:rq_on", flipped_blocks=f"{flips}/{blocks}")
    assert not exact_in_order(bh * A.plain_tile(n), n) \
        or flips == 0, (flips, blocks)
    ms = cuda_ms(lambda: A.fused_attention(q, kt, v, **kw))
    plain_ms = cuda_ms(lambda: A.fused_attention_reference(q, kt, v, **kw))
    nbytes = 4 * q.numel()  # q, kt, v read once; int8 out written once
    ops = 2 * 2 * bh * (n * (n + 1) // 2) * d
    t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
    res = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
               bound_by="bytes" if t_bytes >= t_ops else "operations")
    say("kernel-time", kernel="fused_attention", form="exact",
        shape=f"BH{bh}xN{n}xD{d}", causal=True, out="int8", ms=ms,
        plain_ms=plain_ms, bound_ms=res["bound_ms"], bound_by=res["bound_by"],
        bytes=nbytes, ops=ops, library="none", card=name.replace(" ", "_"))
    return res


def scoring_phase(card: str) -> dict:
    """Phase 9: returns the launch counts of the f32 fused forward."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.gpt import (GPT2_SMALL, gpt_causal_lm,
                                                  random_gpt2_weights)
    t0 = time.perf_counter()
    vocab = GPT2_SMALL["vocab_size"]
    proto = gpt_causal_lm(random_gpt2_weights(GPT2_SMALL, seed=0), GPT2_SMALL,
                          batch_size=GPT_B, seq_len=GPT_SEQ)
    model = Model.from_onnx(proto)
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids: 2 calibration sequences, then
    # the scored batch
    calib = proto._wte[rng.integers(0, vocab, size=(2, GPT_SEQ))]
    embeds = torch.from_numpy(
        proto._wte[rng.integers(0, vocab, size=(GPT_B, GPT_SEQ))]).cuda()
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model
    say("scoring-setup", seconds=time.perf_counter() - t0,
        nodes=len(qmodel.nodes), device=qmodel.device)

    def forward():
        return qmodel([embeds], as_numpy=False)[0]

    torch.cuda.reset_peak_memory_stats()
    unfused = forward()
    peak_unfused = torch.cuda.max_memory_allocated()
    report = qmodel.optimize()
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    say("scoring-optimize", fuse_attention=report["fuse_attention"],
        fuse_gelu=report["fuse_gelu"], int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        causal_mask_vals=",".join(f"{nd.attrs.get('causal_mask_val'):.6g}"
                                  for nd in fnodes),
        windows=sum("causal_window" in nd.attrs for nd in fnodes))
    assert report["fuse_attention"] == 12 and not report["fusion_failures"]
    assert len(fnodes) == 12 and all(
        nd.attrs.get("causal_mask_val") is not None
        and "causal_window" not in nd.attrs for nd in fnodes)
    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (GPT_B, GPT_SEQ, vocab), fused.shape
    assert bool(torch.isfinite(fused).all())
    # The exact blockwise kernel sums softmax rows in torch's order, so it
    # equals its plain version on every layer's operands, and the fused
    # forward equals the unfused one bit for bit.
    parity = logit_parity(fused, unfused)
    flips, blocks = attention_flips(qmodel, embeds)
    equal = bool(torch.equal(fused, unfused))
    say("scoring-f32", batch=GPT_B, seq=GPT_SEQ,
        blockq_launches=counts["fused_attention_hs_blockq"],
        monolithic_launches=counts["fused_attention_hs"],
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=equal, **parity)
    assert counts["fused_attention_hs_blockq"] == 12, counts
    assert others(counts) == 12, counts
    # the plain version's softmax runs in [B, H, BLOCK_Q, N] q tiles
    assert exact_in_order(GPT_B * HEADS * A.BLOCK_Q, GPT_SEQ)
    assert flips == 0 and equal, (flips, blocks, equal)
    del unfused

    with config.low_precision_floats():
        torch.cuda.reset_peak_memory_stats()
        bf, bf_counts = counted(forward)
        peak_bf16 = torch.cuda.max_memory_allocated()
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(torch.isfinite(bf).all())
    agree = float((bf.argmax(-1) == fused.argmax(-1)).float().mean())
    say("scoring-bf16", batch=GPT_B, seq=GPT_SEQ,
        blockq_launches=bf_counts["fused_attention_hs_blockq"],
        monolithic_launches=bf_counts["fused_attention_hs"],
        argmax_agreement_f32=agree,
        max_abs_diff_f32=float((bf - fused).abs().max()))
    assert bf_counts["fused_attention_hs_blockq"] == 12, bf_counts
    assert others(bf_counts) == 12, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("scoring-throughput", dtype=m, batch=GPT_B, seq=GPT_SEQ,
            tokens_per_s=GPT_B * GPT_SEQ / wall, ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("scoring-memory", peak_unfused_f32_bytes=peak_unfused,
        peak_fused_f32_bytes=peak_fused, peak_fused_bf16_bytes=peak_bf16)
    say("scoring-profile", **bf16_profile(forward))
    return counts


def forward_seconds(forward, reps: int) -> dict:
    """Wall seconds of ``reps`` forwards in f32 and in bf16, the modes taken
    in turns, each timed from a synchronize to a synchronize."""
    import torch
    from numpy_quant_tpu_torch import config
    modes = {"f32": contextlib.nullcontext, "bf16": config.low_precision_floats}
    seconds = {m: [] for m in modes}
    for rep in range(reps):
        for m in (list(modes) if rep % 2 == 0 else list(modes)[::-1]):
            with modes[m]():
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                forward()
                torch.cuda.synchronize()
                seconds[m].append(time.perf_counter() - t0)
    return seconds


def bf16_profile(forward) -> dict:
    """One profiled bf16 forward beside one unprofiled: device busy time,
    its share of the unprofiled wall, device kernels, the top five by
    device time. Raises if the profiler saw no device time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from numpy_quant_tpu_torch import config
    with config.low_precision_floats():
        forward()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            forward()
            torch.cuda.synchronize()
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    assert busy > 0, "the profiler saw no device time"
    # the quantize boundaries' kernel, and torch's own elementwise kernels
    qdq = sum(ms for k, ms, _ in rows if "qdq_kernel" in k)
    torch_ew = sum(ms for k, ms, _ in rows
                   if "elementwise_kernel" in k and "qdq_kernel" not in k)
    return dict(dtype="bf16", wall_ms_unprofiled=wall_ms, device_busy_ms=busy,
                busy_share=busy / wall_ms,
                device_kernels=int(sum(r[2] for r in rows)),
                qdq_kernel_ms=qdq, qdq_share_of_busy=qdq / busy,
                torch_elementwise_ms=torch_ew,
                torch_elementwise_share_of_busy=torch_ew / busy,
                top5=";".join(f"{k[:48].replace(' ', '_')}:{ms:.3f}ms:x{c}"
                              for k, ms, c in rows[:5]))


def logit_parity(got, want) -> dict:
    """Fused against unfused logits: max |difference|, max |logit| and the
    argmax agreement overall and where the unfused top-1 margin clears
    LOGIT_TOL * max|logit|. Raises unless the difference stays within that
    and the argmax is equal wherever the margin clears it."""
    scale = float(want.abs().max())
    diff = float((got - want).abs().max())
    top2 = want.topk(2, dim=-1).values
    clear = (top2[..., 0] - top2[..., 1]) > LOGIT_TOL * scale
    same = got.argmax(-1) == want.argmax(-1)
    res = dict(max_abs_diff=diff, max_abs_logit=scale,
               argmax_equal=f"{int(same.sum())}/{same.numel()}",
               argmax_equal_clear_margin=f"{int(same[clear].sum())}/"
                                         f"{int(clear.sum())}")
    assert diff <= LOGIT_TOL * scale, (diff, scale)
    assert bool(same[clear].all()), "fused and unfused argmax differ"
    return res


def llama_phase(card: str) -> dict:
    """Phase 11: TinyLlama-1.1B int8 scoring at full width and depth.
    Returns the launch counts of the f32 fused forward at B=4."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.llama import (TINYLLAMA_1_1B,
                                                    llama_causal_lm,
                                                    random_llama_weights)
    cfg, n = TINYLLAMA_1_1B, LLAMA_SEQ
    layers, vocab = cfg["num_hidden_layers"], cfg["vocab_size"]
    t0 = time.perf_counter()
    proto = llama_causal_lm(random_llama_weights(cfg, seed=0), cfg,
                            batch_size=LLAMA_B, seq_len=n)
    model = Model.from_onnx(proto)
    wte = proto._wte
    del proto
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids: 2 calibration sequences, then
    # the scored batch
    calib = wte[rng.integers(0, vocab, size=(2, n))]
    embeds = torch.from_numpy(
        wte[rng.integers(0, vocab, size=(LLAMA_B, n))]).cuda()
    t_build = time.perf_counter() - t0
    qmodel = model.quantize(bit_width=8,
                            stats=model.calibration_stats([calib]))
    del model, calib
    say("llama-setup", seconds=time.perf_counter() - t0,
        build_seconds=t_build, nodes=len(qmodel.nodes), device=qmodel.device)

    def forward(x=embeds):
        return qmodel([x], as_numpy=False)[0]

    one = embeds[:1]
    torch.cuda.reset_peak_memory_stats()
    unfused = forward(one)
    peak_unfused = torch.cuda.max_memory_allocated()
    # the unfused walk in the bf16 serving mode: a second witness for that
    # mode's distance from f32, with no fused op in it
    with config.low_precision_floats():
        unfused_bf = forward(one)
    report = qmodel.optimize()
    plain = qmodel.fusion_report.get("plain_fusions", [])
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttention"]
    hs = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    say("llama-optimize", fuse_attention=report["fuse_attention"],
        fused_attention_nodes=len(fnodes), hs_nodes=len(hs),
        plain_fusions=len(plain), int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        out_requant=sum(nd.attrs.get("out_requant") is not None
                        for nd in fnodes),
        causal_mask_vals=",".join(f"{nd.attrs.get('causal_mask_val'):.6g}"
                                  for nd in fnodes[:3]) + ",...")
    assert report["fuse_attention"] == layers and not report["fusion_failures"]
    assert len(fnodes) == layers and not hs and len(plain) == layers
    assert all(nd.attrs.get("causal_mask_val") is not None
               and "causal_window" not in nd.attrs for nd in fnodes)

    fused_one, counts_one = counted(lambda: forward(one))
    assert fused_one.shape == (1, n, vocab) and bool(fused_one.isfinite().all())
    skips = []
    flips, blocks = attention_flips(qmodel, one, skips)
    say("llama-f32-b1", batch=1, seq=n,
        fused_attention_launches=counts_one["fused_attention"],
        masked_tiles_skipped=f"{sum(skips)}/{len(skips)}",
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=bool(torch.equal(fused_one, unfused)),
        **logit_parity(fused_one, unfused))
    assert counts_one["fused_attention"] == layers, counts_one
    assert others(counts_one) == layers, counts_one
    assert flips <= 0.01 * blocks, (flips, blocks)

    # bf16 at B=1: the kernel is exact in both modes, so it must equal its
    # plain version on the bf16 walk's operands too. The unfused bf16 walk
    # takes its softmax in bf16, so it need not equal the fused one; how
    # far each bf16 walk lands from its f32 walk is printed side by side.
    with config.low_precision_floats():
        fused_bf, counts_bf1 = counted(lambda: forward(one))
        flips_bf, blocks_bf = attention_flips(qmodel, one)
    assert bool(fused_bf.isfinite().all()) and bool(unfused_bf.isfinite().all())

    def agree(a, b):
        return float((a.argmax(-1) == b.argmax(-1)).float().mean())
    say("llama-bf16-b1", batch=1, seq=n,
        fused_attention_launches=counts_bf1["fused_attention"],
        attention_flipped_blocks=f"{flips_bf}/{blocks_bf}",
        fused_equals_unfused_bitwise=bool(torch.equal(fused_bf, unfused_bf)),
        fused_vs_unfused_max_abs_diff=float((fused_bf - unfused_bf).abs().max()),
        fused_vs_unfused_argmax=agree(fused_bf, unfused_bf),
        fused_vs_f32_argmax=agree(fused_bf, fused_one),
        unfused_vs_f32_argmax=agree(unfused_bf, unfused),
        fused_vs_f32_max_abs_diff=float((fused_bf - fused_one).abs().max()),
        unfused_vs_f32_max_abs_diff=float((unfused_bf - unfused).abs().max()))
    assert counts_bf1["fused_attention"] == layers, counts_bf1
    assert others(counts_bf1) == layers, counts_bf1
    assert not exact_in_order(cfg["num_attention_heads"] * A.plain_tile(n),
                              n) or flips_bf == 0, (flips_bf, blocks_bf)
    del unfused, unfused_bf, fused_bf

    # the main path: the fused f32 forward at B=4
    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (LLAMA_B, n, vocab) and bool(fused.isfinite().all())
    # the graph built for B=4 serves B=1 alike (every reshape copies the
    # batch dim; the RoPE tables and the mask broadcast over it)
    b1 = logit_parity(fused[:1], fused_one)
    say("llama-f32-b4", batch=LLAMA_B, seq=n,
        fused_attention_launches=counts["fused_attention"],
        other_kernel_launches=others(counts) - counts["fused_attention"],
        row0_equals_b1_bitwise=bool(torch.equal(fused[:1], fused_one)),
        row0_vs_b1_max_abs_diff=b1["max_abs_diff"],
        row0_vs_b1_argmax=b1["argmax_equal"])
    assert counts["fused_attention"] == layers, counts
    assert others(counts) == layers, counts
    del fused_one

    with config.low_precision_floats():
        bf, bf_counts = counted(forward)
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(bf.isfinite().all())
    say("llama-bf16-b4", batch=LLAMA_B, seq=n,
        fused_attention_launches=bf_counts["fused_attention"],
        argmax_agreement_f32=float((bf.argmax(-1) == fused.argmax(-1))
                                   .float().mean()),
        max_abs_diff_f32=float((bf - fused).abs().max()))
    assert bf_counts["fused_attention"] == layers, bf_counts
    assert others(bf_counts) == layers, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("llama-throughput", dtype=m, batch=LLAMA_B, seq=n,
            tokens_per_s=LLAMA_B * n / wall, ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("llama-memory", peak_unfused_f32_b1_bytes=peak_unfused,
        peak_fused_f32_b4_bytes=peak_fused)
    say("llama-profile", batch=LLAMA_B, **bf16_profile(forward))
    return counts


def sb_operand(form: str, heads: int, n: int, seed: int):
    """A graph-shaped score-bias constant as the registry hands it to the
    kernels (ops/registry.py::score_bias_operand, broadcast to [H, N, N]
    float32 on the card): "per_head" [1, H, N, N] (T5's relative bias),
    "shared" [1, 1, N, N], or "decoder" [1, H, N, N] plus MASK_VAL above
    the diagonal (T5's combined constant)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.ops.registry import score_bias_operand
    from numpy_quant_tpu_torch.tensor import FTensor
    rng = np.random.default_rng(seed)
    shape = (1, 1, n, n) if form == "shared" else (1, heads, n, n)
    bias = rng.standard_normal(shape, dtype=np.float32) * np.float32(2.0)
    if form == "decoder":
        bias += np.triu(np.full((n, n), MASK_VAL, np.float32), k=1)
    return score_bias_operand(FTensor(torch.from_numpy(bias).cuda()), heads,
                              n, n)


def check_score_bias() -> dict:
    """Phase 12: the score-bias forms of both head-split kernels against
    their plain versions: monolithic and blockwise x exact, fast and fast
    with the static shift x the three bias forms x out_requant off and on
    x zero points nonzero and zero, at H=8, D=64 and N = SB_N (and D = 32,
    128 at N = SB_D_N). The exact forms must show no flipped (row, head)
    block, the fast ones the one-step rule. Then the bias clause of the
    dispatch on the card (N=256 monolithic, 257 blockwise) and narrow q
    with a bias refused. Returns the largest |difference| on f32 out per
    kernel and the variants checked."""
    from numpy_quant_tpu_torch.kernels import attention as A
    kernels = {
        "fused_attention_hs": (A.fused_attention_hs_monolithic,
                               A.fused_attention_hs_reference, False),
        "fused_attention_hs_blockq": (A.fused_attention_hs_blockq,
                                      A.fused_attention_hs_blockq_reference,
                                      True)}
    worst = dict.fromkeys(kernels, 0.0)
    variants = 0
    sizes = [(n, HEAD_DIM) for n in SB_N] + [(SB_D_N, 32), (SB_D_N, 128)]
    for n, d in sizes:
        biases = {f: sb_operand(f, SB_HEADS, n, seed=n + i)
                  for i, f in enumerate(SB_FORMS)}
        q, k, v = attention_inputs(SB_B, n, seed=n + d, n=n, heads=SB_HEADS,
                                   d=d)
        for (kname, (fn, plain, tiled)), mode in itertools.product(
                kernels.items(), ATT_MODES):
            flips = blocks = 0
            err = 0.0
            cases = list(itertools.product(SB_FORMS, (None, OUT_REQUANT),
                                           ("nonzero", "zero")))
            for form, rq, zp in cases:
                qp = QP if zp == "nonzero" else QP_ZERO
                kw = attention_kw(SB_HEADS, mode, "none", rq, qp,
                                  score_bias=biases[form])
                f, bl, e = attention_diff(
                    fn(q, k, v, **kw), plain(q, k, v, **kw), SB_HEADS, rq, qp,
                    f"score bias {kname} N{n} D{d} {mode} {form} rq={rq} "
                    f"zp={zp}")
                flips, blocks = flips + f, blocks + bl
                if rq is None:
                    err = max(err, e)
            variants += len(cases)
            say("kernel-check", kernel=kname, form="score_bias", mode=mode,
                shape=f"B{SB_B}xN{n}xH{SB_HEADS}xD{d}",
                cases="per_head/shared/decoder:rq_off/on:zp_nonzero/zero",
                variants=len(cases), flipped_blocks=f"{flips}/{blocks}",
                max_abs_err_f32_out=err)
            if mode == "exact":
                # the plain version's softmax: [B, H, rows of a q tile, N]
                rows = SB_B * SB_HEADS * (min(n, A.BLOCK_Q) if tiled else n)
                assert exact_in_order(rows, n) and flips == 0, \
                    (kname, n, d, flips, blocks)
            worst[kname] = max(worst[kname], err)
    # the bias clause: at H=8 a [8, 256, 256] bias is exactly 2 MiB
    # (monolithic), N=257 pads to 264 x 384 (blockwise); both against plain
    for n, want in ((256, "fused_attention_hs"),
                    (257, "fused_attention_hs_blockq")):
        q, k, v = attention_inputs(1, n, seed=n, n=n, heads=SB_HEADS)
        kw = attention_kw(SB_HEADS, "exact", "none", None, QP,
                          score_bias=sb_operand("per_head", SB_HEADS, n, n))
        out, counts = counted(lambda: A.fused_attention_hs(q, k, v, **kw))
        flips, blocks, _ = attention_diff(out, kernels[want][1](q, k, v, **kw),
                                          SB_HEADS, None, QP,
                                          f"bias clause N{n}")
        say("kernel-check", kernel=want, form="score_bias_dispatch",
            shape=f"B1xN{n}xH{SB_HEADS}", launches=counts[want],
            flipped_blocks=f"{flips}/{blocks}")
        assert counts[want] == 1 and others(counts) == 1, counts
        try:
            A.fused_attention_hs(q[:, :1].contiguous(), k, v, **kw)
        except ValueError:
            pass
        else:
            raise AssertionError("narrow q with a score bias was not refused")
    say("kernel-check", form="score_bias_narrow_q", refused=True)
    return dict(worst=worst, variants=variants)


def time_score_bias(name: str) -> dict:
    """Phase 12's timing: the head-split forms at t5-small's three
    attention shapes (B=8, H=8, D=64, int8 out) as the path dispatches them
    -- encoder self-attention (N=512, per-head bias, blockwise), decoder
    self-attention (N=128, the combined constant, monolithic) and
    cross-attention (128 query rows against N=512 keys, no bias, unscaled,
    monolithic) -- each in the exact, fast and static-shift forms: median
    of 20 CUDA-event calls, each queued behind a device sleep so that the
    device time is measured, not the host's wrapper; the plain version and
    the bound. The exact and
    fast forms are first held against the plain version (no flip on the
    exact one). Returns {kernel: {shape: {form: numbers}}}."""
    from numpy_quant_tpu_torch.kernels import attention as A
    rates = peaks(name)
    shapes = (("encoder_self", T5_SRC, T5_SRC, "per_head"),
              ("decoder_self", T5_TGT, T5_TGT, "decoder"),
              ("cross", T5_TGT, T5_SRC, None))
    res: dict = {}
    for label, nq, n, form in shapes:
        q, k, v = attention_inputs(T5_B, nq, seed=nq + n, n=n, heads=SB_HEADS)
        bias = None if form is None else sb_operand(form, SB_HEADS, n, seed=n)
        blockq = A.blockwise(n, None, nq=nq,
                             bias_heads=None if bias is None else SB_HEADS)
        kname = "fused_attention_hs_blockq" if blockq else "fused_attention_hs"
        plain = A.fused_attention_hs_blockq_reference if blockq \
            else A.fused_attention_hs_reference
        # q, k, v and the f32 bias read once, the int8 output written once
        nbytes = 2 * q.numel() + k.numel() + v.numel() \
            + (0 if bias is None else 4 * bias.numel())
        # both products; the decoder's constant hides the upper triangle,
        # whose probabilities are exactly zp_p and whose scores are unused
        pairs = nq * (nq + 1) // 2 if form == "decoder" else nq * n
        ops = 2 * 2 * T5_B * SB_HEADS * pairs * HEAD_DIM
        t_bytes, t_ops = nbytes / rates["bytes"] * 1e3, ops / rates["int8"] * 1e3
        for mode in ATT_MODES:
            kw = attention_kw(SB_HEADS, mode, "none", OUT_REQUANT, QP,
                              score_bias=bias)
            if form is None:
                kw["scaling"] = 1.0  # T5 attention is unscaled
            if mode != "fast_shift":
                flips, blocks, _ = attention_diff(
                    A.fused_attention_hs(q, k, v, **kw), plain(q, k, v, **kw),
                    SB_HEADS, OUT_REQUANT, QP, f"t5 {label} {mode}")
                if mode == "exact":
                    rows = T5_B * SB_HEADS * (min(nq, A.BLOCK_Q) if blockq
                                              else nq)
                    assert exact_in_order(rows, n) and flips == 0, \
                        (label, flips, blocks)
            ms = cuda_ms(lambda: A.fused_attention_hs(q, k, v, **kw),
                         lead=True)
            plain_ms = cuda_ms(lambda: plain(q, k, v, **kw), lead=True)
            row = dict(ms=ms, plain_ms=plain_ms, bound_ms=max(t_bytes, t_ops),
                       bound_by="bytes" if t_bytes >= t_ops else "operations")
            res.setdefault(kname, {}).setdefault(label, {})[mode] = row
            say("kernel-time", kernel=kname, form=f"score_bias_{mode}",
                t5=label, bias=form or "none",
                shape=f"B{T5_B}xNq{nq}xN{n}xH{SB_HEADS}xD{HEAD_DIM}",
                out="int8", ms=ms, plain_ms=plain_ms, bound_ms=row["bound_ms"],
                bound_by=row["bound_by"], bytes=nbytes, ops=ops,
                library="none", card=name.replace(" ", "_"))
    return res


def requantize_differences(qmodel, x, cfg: dict) -> tuple[int, int]:
    """One recorded unfused forward of the T5 QModel: the q, k and v
    operand entries of every attention chain (the unfused executor's: the
    projection accumulator dequantized at the head split, quantized at the
    score or context MatMul, x / scale) that the reference's requantize of
    the accumulator (x * (1 / scale)) would round otherwise -- why a fused
    node narrows its accumulator operands the unfused way
    (model.py::QModel._narrow). Returns (differing entries, entries)."""
    from numpy_quant_tpu_torch.graph import Variable
    from numpy_quant_tpu_torch.tensor import quantize_tensor
    qmodel(x, record=True, as_numpy=False)
    rec = {v.name: v.data for v in qmodel.values if v.data is not None}
    pres = [f"encoder.block.{i}.attn" for i in range(cfg["num_layers"])]
    pres += [f"decoder.block.{i}.{kind}" for i in range(cfg["num_decoder_layers"])
             for kind in ("self", "cross")]
    differ = entries = 0
    for pre, (val, proj) in itertools.product(
            pres, (("q_Transpose", "q"), ("k_T", "k"), ("v_Transpose", "v"))):
        qp = qmodel.quant_params[f"{pre}/{val}"]
        t = quantize_tensor(rec[f"{pre}/{val}"], qmodel.bit_width, qp.scale,
                            qp.zero_point).data
        t = t.transpose(-1, -2) if val == "k_T" else t
        acc = rec[f"{pre}.{proj}/MatMul_out"]
        pp = qmodel.quant_params[f"{pre}.{proj}/MatMul_out"]
        req = acc.requantize(qmodel.bit_width, pp.scale, pp.zero_point).data
        b, n, hd = req.shape  # [B, N, H*D] -> [B, H, N, D]
        req = req.reshape(b, n, t.shape[1], -1).permute(0, 2, 1, 3)
        differ += int((req != t).sum())
        entries += t.numel()
    del rec
    for v in qmodel.values:
        if isinstance(v, Variable):
            v.data = None
    return differ, entries


def t5_phase(card: str) -> tuple[dict, dict]:
    """Phase 13: t5-small int8 teacher-forced scoring at full width and
    depth. Returns the launch counts of the f32 fused forward and the host
    cost of its quantize boundaries (``boundary_cost``)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.kernels import attention as A
    from numpy_quant_tpu_torch.models.t5 import (T5_SMALL, random_t5_weights,
                                                 t5_conditional_generation)
    cfg = T5_SMALL
    vocab = cfg["vocab_size"]
    enc, dec = cfg["num_layers"], cfg["num_decoder_layers"]
    n_att = enc + 2 * dec
    t0 = time.perf_counter()
    proto = t5_conditional_generation(random_t5_weights(cfg, seed=0), cfg,
                                      batch_size=T5_B, src_len=T5_SRC,
                                      tgt_len=T5_TGT)
    model = Model.from_onnx(proto)
    wte = proto._wte
    del proto
    rng = np.random.default_rng(0)
    # token embeddings of seeded random ids through `shared`: 2 calibration
    # (source, target) pairs, then the scored batch
    calib = [wte[rng.integers(0, vocab, size=(2, n))] for n in (T5_SRC, T5_TGT)]
    x = [torch.from_numpy(wte[rng.integers(0, vocab, size=(T5_B, n))]).cuda()
         for n in (T5_SRC, T5_TGT)]
    t_build = time.perf_counter() - t0
    qmodel = model.quantize(bit_width=8, stats=model.calibration_stats(calib))
    del model, calib
    say("t5-setup", seconds=time.perf_counter() - t0, build_seconds=t_build,
        nodes=len(qmodel.nodes), device=qmodel.device)

    def forward():
        return qmodel(x, as_numpy=False)[0]

    torch.cuda.reset_peak_memory_stats()
    unfused = forward()
    peak_unfused = torch.cuda.max_memory_allocated()
    op_differ, op_entries = requantize_differences(qmodel, x, cfg)
    report = qmodel.optimize()
    plain = qmodel.fusion_report.get("plain_fusions", [])
    fnodes = [nd for nd in qmodel.nodes if nd.op == "FusedAttentionHS"]
    biased = sum(len(nd.inputs) == 4 for nd in fnodes)
    say("t5-optimize", fuse_attention=report["fuse_attention"],
        hs_nodes=len(fnodes), with_score_bias=biased, plain_fusions=len(plain),
        int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        out_requant=sum(nd.attrs.get("out_requant") is not None
                        for nd in fnodes),
        score_max=sum(nd.attrs.get("score_max") is not None for nd in fnodes),
        unscaled=sum(nd.attrs.get("scaling") == 1.0 for nd in fnodes))
    assert report["fuse_attention"] == n_att and len(fnodes) == n_att
    assert biased == enc + dec and not plain and not report["fusion_failures"]

    torch.cuda.reset_peak_memory_stats()
    fused, counts = counted(forward)
    peak_fused = torch.cuda.max_memory_allocated()
    assert fused.shape == (T5_B, T5_TGT, vocab), fused.shape
    assert bool(fused.isfinite().all())
    # every exact kernel call sums its rows in torch's order, so it equals
    # its plain version on the path's operands, and the fused forward
    # equals the unfused one bit for bit
    heads = cfg["num_heads"]
    for rows, n in ((T5_B * heads * A.BLOCK_Q, T5_SRC),
                    (T5_B * heads * T5_TGT, T5_TGT),
                    (T5_B * heads * T5_TGT, T5_SRC)):
        assert exact_in_order(rows, n), (rows, n)
    flips, blocks = attention_flips(qmodel, x)
    equal = bool(torch.equal(fused, unfused))
    say("t5-f32", batch=T5_B, src=T5_SRC, tgt=T5_TGT,
        blockq_launches=counts["fused_attention_hs_blockq"],
        monolithic_launches=counts["fused_attention_hs"],
        attention_flipped_blocks=f"{flips}/{blocks}",
        operand_entries_requantize_would_change=f"{op_differ}/{op_entries}",
        fused_equals_unfused_bitwise=equal, **logit_parity(fused, unfused))
    assert counts["fused_attention_hs_blockq"] == enc, counts
    assert counts["fused_attention_hs"] == 2 * dec, counts
    assert others(counts) == n_att, counts
    assert flips == 0 and equal, (flips, blocks, equal)
    del unfused

    with config.low_precision_floats():
        torch.cuda.reset_peak_memory_stats()
        bf, bf_counts = counted(forward)
        peak_bf16 = torch.cuda.max_memory_allocated()
    assert bf.shape == fused.shape and bf.dtype == torch.float32
    assert bool(bf.isfinite().all())
    say("t5-bf16", batch=T5_B, src=T5_SRC, tgt=T5_TGT,
        blockq_launches=bf_counts["fused_attention_hs_blockq"],
        monolithic_launches=bf_counts["fused_attention_hs"],
        argmax_agreement_f32=float((bf.argmax(-1) == fused.argmax(-1))
                                   .float().mean()),
        max_abs_diff_f32=float((bf - fused).abs().max()),
        max_abs_logit_f32=float(fused.abs().max()))
    assert bf_counts["fused_attention_hs_blockq"] == enc, bf_counts
    assert bf_counts["fused_attention_hs"] == 2 * dec, bf_counts
    assert others(bf_counts) == n_att, bf_counts
    del bf, fused

    for m, runs in forward_seconds(forward, SCORE_REPS).items():
        wall = statistics.median(runs)
        say("t5-throughput", dtype=m, batch=T5_B, src=T5_SRC, tgt=T5_TGT,
            target_tokens_per_s=T5_B * T5_TGT / wall,
            source_tokens_per_s=T5_B * T5_SRC / wall,
            ms_per_forward=wall * 1e3,
            ms_runs=",".join(f"{r * 1e3:.2f}" for r in runs),
            card=card.replace(" ", "_"))
    say("t5-memory", peak_unfused_f32_bytes=peak_unfused,
        peak_fused_f32_bytes=peak_fused, peak_fused_bf16_bytes=peak_bf16)
    say("t5-profile", **bf16_profile(forward))
    cost = boundary_cost(forward)
    say("t5-boundaries", **cost)
    return counts, cost


@contextlib.contextmanager
def plain_chain():
    """Swap the torch chains (the kernels' plain versions) in for the
    elementwise kernels at every quantize boundary: the module functions
    quantization.quantize/dequantize call."""
    from numpy_quant_tpu_torch.kernels import elementwise as E
    saved = E.quantize, E.dequantize
    E.quantize, E.dequantize = E.quantize_reference, E.dequantize_reference
    try:
        yield
    finally:
        E.quantize, E.dequantize = saved


def ew_layout(x, layout: str):
    """``x`` (2-D, on the card) in one of the layouts the executor hands
    the kernels: contiguous, contiguous from an odd element (no vector
    access), transposed (dense, another dim order) or strided (not
    dense)."""
    import torch
    if layout == "offset":
        flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
        flat[1:] = x.reshape(-1)
        return flat[1:].view(x.shape)
    if layout == "transposed":
        return x.t().contiguous().t()
    if layout == "strided":
        big = torch.zeros(x.shape[0], 2 * x.shape[1], dtype=x.dtype,
                          device=x.device)
        big[:, ::2] = x
        return big[:, ::2]
    return x


def ew_floats(bits: int, scale: float, rng):
    """f32 [37, 29]: values across the grid and past the clip, exact ties
    (k + 1/2) * scale, zeros of both signs, infinities and NaN."""
    import numpy as np
    n = EW_SHAPE[0] * EW_SHAPE[1]
    top = 2.0 ** (bits - 1)
    x = rng.uniform(-1.3, 1.3, size=n) * top * scale
    kmax = int(min(top, 2 ** 20))
    k = rng.integers(-kmax, kmax, size=n // 8, endpoint=True)
    x[:k.size] = (k + 0.5) * scale
    specials = [0.0, -0.0, np.inf, -np.inf, np.nan, 8 * top * scale,
                -8 * top * scale, (top - 1) * scale, -top * scale]
    x[-len(specials):] = specials
    return x.astype(np.float32).reshape(EW_SHAPE)


def ew_report(kname: str, label: str, got, want, state: dict) -> None:
    """Hold one kernel output against the plain version's, bit for bit."""
    import torch
    state["variants"][kname] += 1
    a, b = got, want
    if got.dtype.is_floating_point:  # compare the bits
        view = torch.int32 if got.dtype == torch.float32 else torch.int16
        a, b = got.view(view), want.view(view)
    diff = (got.double() - want.double()).abs()
    diff = diff[torch.isfinite(diff)]
    err = float(diff.max()) if diff.numel() else 0.0
    state["worst"][kname] = max(state["worst"][kname], err)
    if got.stride() != want.stride():
        state["stride_differs"] += 1
    if not torch.equal(a, b):
        state["mismatches"] += 1
        if state["first"] is None:
            idx = tuple((a != b).nonzero()[0].tolist())
            state["first"] = (f"{kname}:{label}:at{list(idx)}:got="
                              f"{got[idx].item()}:want={want[idx].item()}")


def check_elementwise() -> dict:
    """Phase 14(a): both kernels against their plain versions on the card,
    in every form; 0 mismatches required."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    state = {"variants": {k: 0 for k in ELEMENTWISE},
             "worst": {k: 0.0 for k in ELEMENTWISE}, "mismatches": 0,
             "stride_differs": 0, "first": None}
    rng = np.random.default_rng(14)
    rows, cols = EW_SHAPE
    for bits in EW_WIDTHS:
        # a power-of-two scale keeps (k + 1/2) * scale an exact tie; the
        # per-channel scales are not
        scale = np.float32(2.0 ** -(max(bits, 8) - 2))
        channel = (scale * rng.uniform(0.5, 2.0, size=(1, cols))).astype(
            np.float32)
        zp_scalar = np.int64(3 - 2 ** (bits - 2)) if bits >= 2 else np.int64(0)
        span = 2 ** (min(bits, 20) - 1)
        x32 = torch.from_numpy(ew_floats(bits, float(scale), rng)).cuda()
        outs = ([torch.int8] if bits <= 8 else []) + [torch.int32,
                                                      torch.int64]
        for in_dtype, out, zp_kind, per_channel, layout in itertools.product(
                (torch.float32, torch.bfloat16), outs,
                ("none", "scalar", "tensor"), (False, True), EW_LAYOUTS):
            zp = {"none": None, "scalar": zp_scalar,
                  "tensor": torch.from_numpy(rng.integers(
                      -span, span, size=(rows, 1))).to(
                      torch.int64 if out == torch.int64 else torch.int32)
                  .cuda()}[zp_kind]
            s = channel if per_channel else scale
            x = ew_layout(x32.to(in_dtype), layout)
            label = (f"b{bits}:{str(in_dtype)[6:]}->{str(out)[6:]}:zp_"
                     f"{zp_kind}:{'channel' if per_channel else 'scalar'}:"
                     f"{layout}")
            ew_report("quantize", label, E.quantize(x, bits, s, zp, out),
                      E.quantize_reference(x, bits, s, zp, out), state)
    # a zero scale: 0/0 -> 0, x/0 -> the clip bounds
    for bits, out, zp in itertools.product((8, 16, 32), (torch.int32,
                                                         torch.int64),
                                           (None, np.int64(5))):
        x = torch.from_numpy(ew_floats(bits, 0.01, rng)).cuda()
        for s in (np.float32(0.0), np.array([[0.0] + [0.01] * (cols - 1)],
                                            np.float32)):
            ew_report("quantize", f"zero_scale:b{bits}:{out}:{zp}",
                      E.quantize(x, bits, s, zp, out),
                      E.quantize_reference(x, bits, s, zp, out), state)
    # dequantize: int8, int32 (8-bit values, 32-bit accumulators with
    # wrapping corrections) and int64 (x64-mode accumulators past 2^24)
    sources = {
        torch.int8: rng.integers(-128, 128, size=EW_SHAPE),
        torch.int32: np.concatenate([
            rng.integers(-2 ** 31, 2 ** 31, size=rows * cols - 2),
            [-2 ** 31, 2 ** 31 - 1]]).reshape(EW_SHAPE),
        torch.int64: np.concatenate([
            rng.integers(-2 ** 62, 2 ** 62, size=rows * cols - 4),
            [-2 ** 63, 2 ** 63 - 1, 2 ** 24 + 1, -(2 ** 40) - 3]]
        ).reshape(EW_SHAPE)}
    # a float32 scalar, a Python float (f64: the int64 form multiplies by
    # it unrounded) and a per-channel row
    scales = {"scalar": np.float32(0.0137), "f64_scalar": 0.0137,
              "channel": rng.uniform(1e-4, 0.1, size=(1, cols)).astype(
                  np.float32)}
    for in_dtype, q_np in sources.items():
        q32 = torch.from_numpy(q_np).to(in_dtype).cuda()
        zdt = torch.int64 if in_dtype == torch.int64 else torch.int32
        big = 2 ** 62 if in_dtype == torch.int64 else 2 ** 31
        zps = {"none": None, "scalar": np.int64(-3),
               "rows": rng.integers(-big, big, size=(rows, 1)),
               "cols": rng.integers(-big, big, size=(1, cols)),
               "full": rng.integers(-big, big, size=EW_SHAPE),
               "int64_cols": rng.integers(-2 ** 40, 2 ** 40, size=(1, cols))}
        for (zp_kind, zp_np), (s_kind, s), out, layout in itertools.product(
                zps.items(), scales.items(), (torch.float32, torch.bfloat16),
                EW_LAYOUTS):
            zp = zp_np if zp_np is None or np.ndim(zp_np) == 0 else \
                torch.from_numpy(np.asarray(zp_np)).to(
                    torch.int64 if zp_kind == "int64_cols" else zdt).cuda()
            q = ew_layout(q32, layout)
            label = (f"{str(in_dtype)[6:]}->{str(out)[6:]}:zp_{zp_kind}:"
                     f"{s_kind}:{layout}")
            ew_report("dequantize", label, E.dequantize(q, s, zp, out),
                      E.dequantize_reference(q, s, zp, out), state)
    torch.cuda.synchronize()
    say("kernel-check", kernel="quantize,dequantize",
        variants_quantize=state["variants"]["quantize"],
        variants_dequantize=state["variants"]["dequantize"],
        mismatches=state["mismatches"], first_mismatch=state["first"],
        layouts_with_other_strides=state["stride_differs"],
        max_abs_err_quantize=state["worst"]["quantize"],
        max_abs_err_dequantize=state["worst"]["dequantize"])
    assert state["mismatches"] == 0, state["first"]
    return state


def same_bits(a, b) -> bool:
    """Two tensors (or numpy arrays) equal bit for bit: same shape and
    dtype, floats compared as their bit patterns."""
    import numpy as np
    import torch
    if isinstance(a, np.ndarray):
        a, b = torch.from_numpy(np.ascontiguousarray(a)), \
            torch.from_numpy(np.ascontiguousarray(b))
    if a.shape != b.shape or a.dtype != b.dtype:
        return False
    if a.dtype.is_floating_point:
        view = {2: torch.int16, 4: torch.int32, 8: torch.int64}[
            a.element_size()]
        a, b = a.contiguous().view(view), b.contiguous().view(view)
    return torch.equal(a, b)


def time_elementwise(name: str) -> dict:
    """Phase 14(b): both kernels and their plain chains at the largest ViT
    boundary (bf16, B=96 fc1 output), the GPT-2 and TinyLlama scoring
    shapes (f32) and ViT W8A16's fc1 output (f32 -> int64 at 16 bits,
    int64 accumulators), device time alone, beside the bytes bound; and
    each kernel's and each chain's host time per call at a small shape.
    At each shape both kernels first equal their chains bit for bit in
    the forms the paths pass there: f32 and bf16 in and out (f32 only in
    int64), a scalar and a per-channel [1, N] scale, zero points scalar,
    [1, N] (column sums) and [M, 1] (row sums)."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    from numpy_quant_tpu_torch.models.llama import TINYLLAMA_1_1B
    rate = peaks(name)["bytes"]
    # label: ((rows, cols), float dtype, container, bits)
    shapes = {"vit_fc1_bf16": ((B_TIME * N_TOK, 3072), torch.bfloat16,
                               torch.int32, 8),
              "gpt2_fc_f32": ((GPT_B * GPT_SEQ, 3072), torch.float32,
                              torch.int32, 8),
              "tinyllama_mlp_f32": ((LLAMA_B * LLAMA_SEQ,
                                     TINYLLAMA_1_1B["intermediate_size"]),
                                    torch.float32, torch.int32, 8),
              "vit_w8a16_fc1_f32": ((B_F32 * N_TOK, 3072), torch.float32,
                                    torch.int64, 16)}
    res = {k: {"shapes": {}} for k in ELEMENTWISE}
    g = torch.Generator(device="cuda").manual_seed(14)
    compared = {"forms": 0, "elements": 0, "mismatched_forms": []}

    def hold(label: str, got, want) -> None:
        compared["forms"] += 1
        compared["elements"] += want.numel()
        if not same_bits(got, want):
            compared["mismatched_forms"].append(label)

    for label, ((rows, cols), dtype, container, bits) in shapes.items():
        x32 = torch.randn(rows, cols, device="cuda", generator=g)
        x = x32.to(dtype)
        span = 2 ** 40 if container == torch.int64 else 2 ** 20
        acc = torch.randint(-span, span, (rows, cols), device="cuda",
                            dtype=container, generator=g)
        zrow = torch.randint(-span, span, (1, cols), device="cuda",
                             dtype=container, generator=g)
        zcol = torch.randint(-span, span, (rows, 1), device="cuda",
                             dtype=container, generator=g)
        channel = (EW_SCALE * np.random.default_rng(rows).uniform(
            0.5, 2.0, size=(1, cols))).astype(np.float32)
        n = rows * cols
        # the path's forms at this shape, each kernel against its chain
        floats = (torch.float32,) if container == torch.int64 \
            else (torch.float32, torch.bfloat16)
        for fdt in floats:
            xf = x32.to(fdt)
            for s, zp in ((EW_SCALE, EW_ZP), (channel, None)):
                form = f"{label}:quantize:{str(fdt)[6:]}:" \
                    f"{'channel' if zp is None else 'scalar'}"
                hold(form, E.quantize(xf, bits, s, zp, container),
                     E.quantize_reference(xf, bits, s, zp, container))
            for (zname, z), s in itertools.product(
                    (("scalar", EW_ZP), ("cols", zrow), ("rows", zcol)),
                    (EW_SCALE, channel)):
                form = f"{label}:dequantize:{str(fdt)[6:]}:zp_{zname}:" \
                    f"{'scalar' if np.ndim(s) == 0 else 'channel'}"
                hold(form, E.dequantize(acc, s, z, fdt),
                     E.dequantize_reference(acc, s, z, fdt))
        # torch's own quantized-tensor calls compute another function
        # (rounding before the zero point, a reciprocal multiply; a scalar
        # zero point): timed as a yardstick only
        qt = torch.quantize_per_tensor(x32, EW_SCALE, EW_ZP, torch.qint32)
        calls = {
            "quantize": (lambda: E.quantize(x, bits, EW_SCALE, EW_ZP,
                                            container),
                         lambda: E.quantize_reference(x, bits, EW_SCALE,
                                                      EW_ZP, container),
                         lambda: torch.quantize_per_tensor(
                             x32, EW_SCALE, EW_ZP, torch.qint32),
                         n * x.element_size() + n * acc.element_size()),
            "dequantize": (lambda: E.dequantize(acc, EW_SCALE, zrow, dtype),
                           lambda: E.dequantize_reference(acc, EW_SCALE,
                                                          zrow, dtype),
                           qt.dequantize,
                           (n + cols) * acc.element_size()
                           + n * x.element_size())}
        for kname, (kernel, plain, other, nbytes) in calls.items():
            row = dict(ms=cuda_ms(kernel, lead=True),
                       plain_ms=cuda_ms(plain, lead=True),
                       different_function_ms=cuda_ms(other, lead=True),
                       bound_ms=nbytes / rate * 1e3, bytes=nbytes)
            res[kname]["shapes"][label] = row
            say("kernel-time", kernel=kname, shape=f"{rows}x{cols}",
                dtype=str(dtype)[6:], container=str(container)[6:],
                bits=bits, label=label, **row,
                different_function="torch.quantize_per_tensor" if
                kname == "quantize" else "QTensor.dequantize(qint32)",
                card=name.replace(" ", "_"))
        del x32, x, acc, zcol, qt
    torch.cuda.synchronize()
    say("kernel-check", kernel="quantize,dequantize", scope="path_shapes",
        forms=compared["forms"], elements_compared=compared["elements"],
        mismatched_forms="|".join(compared["mismatched_forms"]) or None)
    assert not compared["mismatched_forms"], compared["mismatched_forms"]
    for kname in ELEMENTWISE:
        res[kname].update(res[kname]["shapes"]["vit_fc1_bf16"])
    # host time per call where the device is not the limit
    small = torch.randn(8, 64, device="cuda")
    small_acc = torch.randint(-99, 99, (8, 64), device="cuda",
                              dtype=torch.int32)
    zs = torch.randint(-99, 99, (1, 64), device="cuda", dtype=torch.int32)
    host = {}
    for label, fn in (
            ("quantize_kernel", lambda: E.quantize(small, 8, EW_SCALE, EW_ZP)),
            ("quantize_plain", lambda: E.quantize_reference(
                small, 8, EW_SCALE, EW_ZP)),
            ("dequantize_kernel", lambda: E.dequantize(small_acc, EW_SCALE,
                                                       zs)),
            ("dequantize_plain", lambda: E.dequantize_reference(
                small_acc, EW_SCALE, zs))):
        for _ in range(50):
            fn()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(500):
            fn()
        torch.cuda.synchronize()
        host[f"{label}_us"] = (time.perf_counter() - t0) / 500 * 1e6
    say("host-per-call", **host)
    return res


def boundary_cost(forward) -> dict:
    """The host's share of the quantize boundaries in one f32 forward:
    aten calls (the profiler's count of every aten op, nested ones
    included) and wall ms with the kernels, then with the plain chains,
    the two in turns (3 forwards each)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    def aten_calls():
        forward()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            forward()
            torch.cuda.synchronize()
        return sum(e.count for e in prof.key_averages()
                   if e.key.startswith("aten::"))

    def wall_ms():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) * 1e3

    res = {"aten_calls_kernel": aten_calls()}
    with plain_chain():
        res["aten_calls_plain"] = aten_calls()
    runs = {"kernel": [], "plain": []}
    for rep in range(3):
        for mode in (("kernel", "plain") if rep % 2 == 0
                     else ("plain", "kernel")):
            with plain_chain() if mode == "plain" else contextlib.nullcontext():
                runs[mode].append(wall_ms())
    res.update({f"ms_{m}": statistics.median(r) for m, r in runs.items()})
    res.update({f"ms_runs_{m}": ",".join(f"{v:.2f}" for v in r)
                for m, r in runs.items()})
    return res


def routing_phase(qmodel, x8, launches: dict, t5_cost: dict) -> None:
    """Phase 14(c): every path took the boundary kernels; the ViT-Base
    int8 f32 forward equals itself with the plain chains swapped in, bit
    for bit."""
    kernel, kc = counted(lambda: qmodel([x8])[0])
    with plain_chain():
        plain, pc = counted(lambda: qmodel([x8])[0])
    equal = same_bits(kernel, plain)
    say("routing", vit_int8_f32_kernel_equals_plain_chain=equal,
        logits_compared=plain.size,
        vit_kernel_launches=f"{kc['quantize']}+{kc['dequantize']}",
        vit_plain_chain_launches=f"{pc['quantize']}+{pc['dequantize']}",
        **{f"{path}_launches": f"{c['quantize']}+{c['dequantize']}"
           for path, c in launches.items()})
    assert equal, "kernel and plain-chain ViT-Base forwards differ"
    assert pc["quantize"] == pc["dequantize"] == 0, pc
    for path, c in launches.items():
        assert c["quantize"] > 0 and c["dequantize"] > 0, (path, c)
    cost = boundary_cost(lambda: qmodel([x8], as_numpy=False)[0])
    say("vit-boundaries", **cost)
    assert t5_cost["aten_calls_kernel"] < t5_cost["aten_calls_plain"]


def mlp_sweep_phase() -> None:
    """Phase 14(d): the reference's bit-width sweep on the card. mlp.onnx
    at 1-16 bits on the two-circles data (numpy, seed 3), calibrated once
    on the CPU; the card's integer intermediates equal the CPU port's, its
    labels equal, its accuracy above 0.9 from 6 bits."""
    import numpy as np
    import torch
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models.mlp import load_mlp, two_circles
    from numpy_quant_tpu_torch.tensor import QTensor
    x, y = two_circles()
    cpu = Model.from_onnx(load_mlp(), device="cpu")
    card = Model.from_onnx(load_mlp())
    stats = cpu.calibration_stats([x])
    accs, compared = [], 0
    for bits in range(1, 17):
        qc = cpu.quantize(bit_width=bits, stats=stats)
        qg = card.quantize(bit_width=bits, stats=stats)
        (yc,), (yg,) = qc([x], record=True), qg([x], record=True)
        ref = {v.name: v.data for v in qc.values}
        for v in qg.values:
            if isinstance(v.data, QTensor):
                assert torch.equal(v.data.data.cpu(), ref[v.name].data), \
                    (bits, v.name)
                compared += 1
        assert np.array_equal(yg.argmax(1), yc.argmax(1)), bits
        assert np.abs(yg - yc).max() <= 1e-6, (bits, np.abs(yg - yc).max())
        acc = float(np.mean(yg.argmax(1) == y))
        accs.append(acc)
        if bits >= MLP_ACC_RULE:
            assert acc > 0.9, (bits, acc)
    say("mlp-sweep", widths="1-16", integer_values_compared=compared,
        accuracy=",".join(f"{a:.3f}" for a in accs),
        min_accuracy_from_6_bits=min(accs[MLP_ACC_RULE - 1:]))


def w8a16_phase(card: str, model, stats, x8, int8_logits) -> None:
    """Phase 14(e): ViT-Base in W8A16 at full width and depth, f32, B=8,
    after optimize(): no fused attention (JAX's reason), logits against
    the float forward beside int8's, images/s, idle share, peak memory."""
    import numpy as np
    import torch
    from torch.profiler import ProfilerActivity, profile
    from numpy_quant_tpu_torch.models.vit import WEIGHT_CONFIGS
    t0 = time.perf_counter()
    q16 = model.quantize(stats=stats, quantize_conv=True,
                         **WEIGHT_CONFIGS["w8a16"])
    report = q16.optimize()
    reasons = {r for _, r in report["fusion_failures"]}
    say("w8a16-optimize", seconds=time.perf_counter() - t0,
        fuse_attention=report["fuse_attention"],
        fuse_gelu=report["fuse_gelu"], narrow_gather=report["narrow_gather"],
        int8_dataflow=report["int8_dataflow"],
        fusion_failures=len(report["fusion_failures"]),
        reasons="|".join(sorted(reasons)).replace(" ", "_"))
    assert report["fuse_attention"] == 0
    assert len(report["fusion_failures"]) == 12
    assert reasons == {"bit_width 16 > 8: the int8 attention kernels do "
                       "not apply"}, reasons
    ref = model([x8])[0]
    torch.cuda.reset_peak_memory_stats()
    logits, counts = counted(lambda: q16([x8])[0])
    peak = torch.cuda.max_memory_allocated()
    assert logits.shape == ref.shape and np.isfinite(logits).all()
    # the int64 boundary forms at the path's shapes: the forward with the
    # plain chains swapped in gives the same logits bit for bit
    with plain_chain():
        plain_equal = same_bits(logits, q16([x8])[0])
    d16 = float(np.abs(logits - ref).max())
    d8 = float(np.abs(int8_logits - ref).max())
    agree16 = float((logits.argmax(1) == ref.argmax(1)).mean())
    agree8 = float((int8_logits.argmax(1) == ref.argmax(1)).mean())

    def forward():
        return q16([x8], as_numpy=False)[0]

    for _ in range(2):
        forward()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(5):
        forward()
    torch.cuda.synchronize()
    wall = (time.perf_counter() - t0) / 5
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t1 = time.perf_counter()
        forward()
        torch.cuda.synchronize()
        wall_prof = time.perf_counter() - t1
    rows = sorted(((e.key, e.self_device_time_total / 1e3, e.count)
                   for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    assert busy > 0, "the profiler saw no device time"
    say("w8a16", batch=B_F32, quantize_launches=counts["quantize"],
        dequantize_launches=counts["dequantize"],
        other_kernel_launches=others(counts),
        kernel_equals_plain_chain_bitwise=plain_equal,
        logits_compared=logits.size,
        max_abs_diff_float=d16, int8_max_abs_diff_float=d8,
        max_abs_logit_float=float(np.abs(ref).max()),
        argmax_agreement_float=agree16, int8_argmax_agreement_float=agree8,
        images_per_s=B_F32 / wall, ms_per_forward=wall * 1e3,
        device_busy_ms=busy, idle_share=max(0.0, 1 - busy / (wall_prof * 1e3)),
        peak_bytes=peak,
        top5=";".join(f"{k[:48].replace(' ', '_')}:{ms:.3f}ms:x{c}"
                      for k, ms, c in rows[:5]),
        card=card.replace(" ", "_"))
    assert counts["quantize"] > 0 and counts["dequantize"] > 0, counts
    assert others(counts) == 0, counts
    assert plain_equal, "W8A16: kernel and plain-chain logits differ"
    assert d16 < d8, (d16, d8)


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
    counts_f32 = counts
    launches_f32 = counts["fused_attention_hs"]
    assert fused.shape == (B_F32, 1000) and np.isfinite(fused).all()
    # The exact kernel sums softmax rows in torch's order, so it equals its
    # plain version on every layer's operands (no flipped block, N=197 and
    # the narrowed last layer's one query row). The narrowed LayerNorm
    # before that layer reduces its rows in another torch order than the
    # full one, so the logits may still move: labels must agree wherever
    # the unfused top-1 margin exceeds LOGIT_TOL * max|logits|, and no
    # logit may move further than that.
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
        attention_flipped_blocks=f"{flips}/{blocks}",
        fused_equals_unfused_bitwise=bool(np.array_equal(fused, unfused)))
    assert launches_f32 == 12, launches_f32
    assert counts["splitk_qmatmul"] == counts["packed_qmatmul"] == 0, counts
    assert diff <= LOGIT_TOL * scale, (diff, scale)
    assert same[clear].all(), "fused and unfused labels differ"
    for nq in (N_TOK, 1):
        assert exact_in_order(B_F32 * HEADS * nq, N_TOK)
    assert flips == 0, (flips, blocks)

    # -- phase 3: bf16 serving mode at batch 96 (bench.py's form) -----
    x = torch.from_numpy(rng.normal(size=(B_SERVE, 3, 224, 224))
                         .astype(np.float32) * 0.5).cuda()
    ref32 = qmodel([x])[0]
    with config.low_precision_floats():
        logits, counts = counted(lambda: qmodel([x])[0])
        launches = counts["fused_attention_hs"]
        assert logits.shape == (B_SERVE, 1000) and np.isfinite(logits).all()
        assert launches == 12, launches
        # the boundary kernels against the plain chains, in turns
        ips_runs = {"kernel": [], "plain": []}
        for mode in ("kernel", "plain", "plain", "kernel"):
            with plain_chain() if mode == "plain" \
                    else contextlib.nullcontext():
                ips_runs[mode].append(images_per_s(qmodel, x, "unpack"))
        ips = statistics.median(ips_runs["kernel"])
        # the bf16 boundary forms at the path's shapes: the forward with
        # the plain chains swapped in gives the same logits bit for bit
        with plain_chain():
            plain_logits = qmodel([x])[0]
    bf16_equal = same_bits(logits, plain_logits)
    agree = float((logits.argmax(1) == ref32.argmax(1)).mean())
    say("bf16", batch=B_SERVE, launches=launches, label_agreement_f32=agree,
        kernel_equals_plain_chain_bitwise=bf16_equal,
        logits_compared=plain_logits.size,
        images_per_s=ips, ms_per_forward=B_SERVE / ips * 1e3,
        images_per_s_runs_kernel=",".join(f"{v:.1f}"
                                          for v in ips_runs["kernel"]),
        images_per_s_runs_plain_chain=",".join(f"{v:.1f}"
                                               for v in ips_runs["plain"]),
        quantize_launches=counts["quantize"],
        dequantize_launches=counts["dequantize"],
        card=card.replace(" ", "_"))
    assert bf16_equal, "bf16 B=96: kernel and plain-chain logits differ"
    say("bf16-profile", **bf16_profile(lambda: qmodel([x], as_numpy=False)[0]))

    # -- phase 4: the packed paths in f32 at batch 8 ------------------
    main_launches = {}
    qmodels = {"int8": qmodel}
    # the 8-bit-activation configurations, whose weights pack for the
    # int8 kernels
    for mode in (k for k, c in WEIGHT_CONFIGS.items() if c["bit_width"] <= 8):
        t0 = time.perf_counter()
        qm = qmodels.get(mode)
        if qm is None:
            qm = model.quantize(stats=stats, quantize_conv=True,
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

    # -- phase 8: the blockwise attention kernel ----------------------
    bq_worst = check_blockq()
    bq_timing = time_blockq(name)

    # -- phase 9: the int8 GPT-2 scoring path at full context ---------
    score_counts = scoring_phase(card)
    main_launches["fused_attention_hs_blockq"] = \
        score_counts["fused_attention_hs_blockq"]

    # -- phase 10: the pre-split attention kernel ---------------------
    plain_worst, plain_flips, plain_blocks = check_plain()
    say("kernel-check", kernel="fused_attention", scope="phase_10_total",
        flipped_blocks=f"{plain_flips}/{plain_blocks}",
        flipped_share=plain_flips / plain_blocks, max_abs_err_f32_out=plain_worst)
    assert plain_flips <= 0.001 * plain_blocks, (plain_flips, plain_blocks)
    plain_timing = time_plain(name)

    # -- phase 11: TinyLlama-1.1B int8 scoring at full context --------
    llama_counts = llama_phase(card)
    main_launches["fused_attention"] = llama_counts["fused_attention"]

    # -- phase 12: the score-bias forms of the head-split kernels -----
    sb_check = check_score_bias()
    sb_timing = time_score_bias(name)

    # -- phase 13: T5-small int8 scoring ------------------------------
    t5_counts, t5_cost = t5_phase(card)

    # -- phase 14: quantize/dequantize at every boundary; 9-16 bits -----
    ew_check = check_elementwise()
    ew_timing = time_elementwise(name)
    ew_launches = {"vit_int8_f32_b8": counts_f32, "gpt2_scoring": score_counts,
                   "tinyllama_scoring": llama_counts, "t5_scoring": t5_counts}
    routing_phase(qmodel, x8, ew_launches, t5_cost)
    mlp_sweep_phase()
    w8a16_phase(card, model, stats, x8, fused)
    say("done", seconds=time.perf_counter() - t_start)

    def score_bias(kname: str) -> dict:
        return {"launches_per_t5_forward": t5_counts[kname],
                "variants_checked": sb_check["variants"] // 2,
                "max_abs_err": sb_check["worst"][kname],
                "t5_shapes": sb_timing[kname]}

    rows = [{
        "name": "fused_attention_hs", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_hs.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:530",
        "launches": launches, "max_abs_err": worst,
        "ms": timing["ms"], "plain_ms": timing["plain_ms"],
        "bound_ms": timing["bound_ms"], "bound_by": timing["bound_by"],
        "library_ms": None, "score_bias": score_bias("fused_attention_hs")}]
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
    wo32, wo16 = wo_timing["f32"], wo_timing["bf16"]
    rows.append({
        "name": "splitk_wo_matmul", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/qmatmul_wo.cu",
        "replaces": "numpy_quant_tpu/kernels/qmatmul.py:411",
        "launches": main_launches["splitk_wo_matmul"],
        "max_abs_err": wo_worst, "ms": wo32["ms"],
        "plain_ms": wo32["plain_ms"], "bound_ms": wo32["bound_ms"],
        "bound_by": wo32["bound_by"], "library_ms": wo32["library_ms"],
        "bf16": {key: wo16[key] for key in ("ms", "plain_ms", "bound_ms",
                                            "bound_by", "library_ms")}})
    rows.append({
        "name": "fused_attention_hs_blockq", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_hs_blockq.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:634",
        "launches": main_launches["fused_attention_hs_blockq"],
        "max_abs_err": bq_worst, "ms": bq_timing["ms"],
        "plain_ms": bq_timing["plain_ms"], "bound_ms": bq_timing["bound_ms"],
        "bound_by": bq_timing["bound_by"], "library_ms": None,
        "score_bias": score_bias("fused_attention_hs_blockq")})
    rows.append({
        "name": "fused_attention", "route": "cuda",
        "source": "numpy_quant_tpu_torch/csrc/attention_plain.cu",
        "replaces": "numpy_quant_tpu/kernels/attention.py:724",
        "launches": main_launches["fused_attention"],
        "max_abs_err": plain_worst, "ms": plain_timing["ms"],
        "plain_ms": plain_timing["plain_ms"],
        "bound_ms": plain_timing["bound_ms"],
        "bound_by": plain_timing["bound_by"], "library_ms": None})
    for kname, line in (("quantize", 39), ("dequantize", 64)):
        t = ew_timing[kname]
        rows.append({
            "name": kname, "route": "cuda",
            "source": "numpy_quant_tpu_torch/csrc/elementwise.cu",
            "replaces": f"numpy_quant_tpu/kernels/elementwise.py:{line}",
            "launches": counts_f32[kname],
            "max_abs_err": ew_check["worst"][kname],
            "ms": t["ms"], "plain_ms": t["plain_ms"], "bound_ms": t["bound_ms"],
            "bound_by": "bytes", "library_ms": None,
            "different_function_ms": t["different_function_ms"],
            "variants_checked": ew_check["variants"][kname],
            "launches_per_forward": {p: c[kname]
                                     for p, c in ew_launches.items()},
            "shapes": t["shapes"]})
    print(json.dumps({"kernels": rows}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
