#!/usr/bin/env python3
"""Time the port's hand-written kernels on one NVIDIA GPU, in the checkout
this is run from:

    python3 kernel_times.py <tag>

- the head-split attention kernels: the monolithic fused_attention_hs at
  ViT-Base B=96 (N=197, H=12, D=64; serving: fast, static shift, int8 out;
  exact f32), the blockwise fused_attention_hs_blockq at GPT-2's scoring
  shape (B=8, N=1024, H=12, causal, int8 out; serving and exact), and both
  at t5-small's three attention shapes (B=8, H=8, int8 out, exact and
  fast): the encoder's per-head bias (blockwise), the decoder's combined
  bias + causal constant and cross-attention (monolithic);
- a breakdown of the head-split kernels' time by scaling: the same calls
  at head dim 16 (the products and their shared loads shrink 4x, the
  softmax's float work does not) and, for the monolithic kernel, with one
  query row (K/V staging alone);
- fused_attention at the TinyLlama-1.1B scoring shape (BH = 4 x 32,
  N = 2048, D = 64, causal, int8 out);
- splitk_wo_matmul at GPT-2's 768 -> 3072 decode shape (M = 8, W4 g=128,
  bf16 and f32, cold L2) beside torch.matmul on the weight dequantized
  beforehand;
- splitk_qmatmul (W4, per-channel scale) and packed_qmatmul (W3
  bit-planes) at ViT-Base's three packed shapes at batch 96 (M = 18,912;
  int8 x, f32 out) beside torch._int_mm on the unpacked weight plus the
  eager epilogue;
- quantize and dequantize at ViT-Base's bf16 fc1 output at batch 96;
- the quantize boundaries in every path form at the four large shapes
  (ViT-Base bf16 fc1 at batch 96, GPT-2 fc and TinyLlama MLP scoring in
  f32, ViT-Base W8A16 fc1 f32 -> int64 at 16 bits): quantize with a scalar
  and a per-channel scale, dequantize with a scalar, a [1, N] and an
  [M, 1] zero point, each with its bytes bound; DecodeAttention's key-cache
  fake quantization [8, 32, 2048, 64] (f32 and bf16 in) and p_past
  [8, 32, 1, 2048] as one fake_quantize launch, where the checkout has
  it, and as the two-launch chain quantize -> dequantize;
- the TinyLlama-1.1B decode and prefill shapes: splitk_wo_matmul at M = 8,
  W4 g=128 for 2048 -> 2048, 256, 5632, 32000 and 5632 -> 2048 (f32 and
  bf16, cold L2), quantize/dequantize at the int8 cache write
  [8, 4, 1, 64] and DecodeAttention's cache probabilities [8, 32, 1, 2048]
  (a strided slice, f32 -> int8 and back), fused_attention at the int8
  prefill's BH = 32, N = 512 (causal, int8 out);
- the serving paths' one new call shape: quantize of a prefill
  admission's presents [1, 4, 512, 64] into the int8 cache (the launches
  per engine step, admission and forward are chip_smoke.py's phase 16).

Each is the median of 20 CUDA-event timed calls (chip_smoke.py's helpers),
the calls shorter than their Python wrapper behind a device sleep. Prints
one line, ``[compare] {json}``. ``python3 kernel_times.py <tag>
elementwise`` times the quantize boundaries alone (the last three items
and the fc1 pair). To hold two commits against each other,
run it in a checkout of each, in turns (parent, change, change, parent),
one after another on one card.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def head_split_times(C, A) -> dict:
    """The head-split kernels at the paths' shapes, and the breakdown."""
    import torch
    res = {}
    vit_q, vit_k, vit_v = C.attention_inputs(C.B_TIME, C.N_TOK, seed=99)
    for label, mode, rq in (("serving", "fast_shift", C.OUT_REQUANT),
                            ("exact_f32", "exact", None)):
        kw = C.attention_kw(C.HEADS, mode, "none", rq, C.QP)
        res[f"hs_vit_{label}_ms"] = C.cuda_ms(
            lambda: A.fused_attention_hs(vit_q, vit_k, vit_v, **kw))
        # breakdown: one query row (staging alone), head dim 16
        q1 = vit_q[:, :1].contiguous()
        res[f"hs_vit_{label}_nq1_ms"] = C.cuda_ms(
            lambda: A.fused_attention_hs(q1, vit_k, vit_v, **kw), lead=True)
        q16, k16, v16 = C.attention_inputs(C.B_TIME, C.N_TOK, seed=98, d=16)
        res[f"hs_vit_{label}_d16_ms"] = C.cuda_ms(
            lambda: A.fused_attention_hs(q16, k16, v16, **kw))
        del q1, q16, k16, v16
    del vit_q, vit_k, vit_v
    b, n, h = C.GPT_B, C.GPT_SEQ, C.HEADS
    for d in (64, 16):
        q, k, v = C.attention_inputs(b, n, seed=99, n=n, heads=h, d=d)
        for label, mode in (("serving", "fast_shift"), ("exact", "exact")):
            kw = C.attention_kw(h, mode, "full", C.OUT_REQUANT, C.QP)
            key = f"blockq_gpt2_{label}" + ("" if d == 64 else f"_d{d}")
            res[f"{key}_ms"] = C.cuda_ms(
                lambda: A.fused_attention_hs_blockq(q, k, v, **kw))
        del q, k, v
    for label, nq, n, form in (("encoder", C.T5_SRC, C.T5_SRC, "per_head"),
                               ("decoder", C.T5_TGT, C.T5_TGT, "decoder"),
                               ("cross", C.T5_TGT, C.T5_SRC, None)):
        q, k, v = C.attention_inputs(C.T5_B, nq, seed=nq + n, n=n,
                                     heads=C.SB_HEADS)
        bias = None if form is None else C.sb_operand(form, C.SB_HEADS, n,
                                                      seed=n)
        for mode in ("exact", "fast"):
            kw = C.attention_kw(C.SB_HEADS, mode, "none", C.OUT_REQUANT, C.QP,
                                score_bias=bias)
            if form is None:
                kw["scaling"] = 1.0
            res[f"t5_{label}_{mode}_ms"] = C.cuda_ms(
                lambda: A.fused_attention_hs(q, k, v, **kw), lead=True)
        del q, k, v, bias
    torch.cuda.synchronize()
    return res


def llama_decode_times(C, A, Q, E, elementwise_only: bool = False) -> dict:
    """The kernels at the TinyLlama-1.1B decode and prefill shapes (the
    quantize boundaries alone with ``elementwise_only``)."""
    import torch
    res = {}
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        for k, n in () if elementwise_only else C.LLAMA_WO_SHAPES:
            x, pl, sc = C.wo_operands(4, C.DEC_B, k, n, k // C.WO_GROUP,
                                      seed=k + n, dtype=dt)
            res[f"wo_llama_{name}_{k}x{n}_ms"] = C.cuda_ms(
                lambda: Q.splitk_wo_matmul(x, pl, sc, bits=4), flush=flush)
            del x, pl, sc
    del flush
    g = torch.Generator(device="cuda").manual_seed(15)
    present = torch.randn(C.DEC_B, 4, 1, 64, device="cuda", generator=g)
    probs = torch.softmax(torch.randn(C.DEC_B, 32, 1, C.DEC_LEN + 1,
                                      device="cuda", generator=g), dim=-1)
    p_past = probs[..., :C.DEC_LEN]
    q8 = E.quantize(p_past, 8, 1.0 / 255.0, -128, torch.int8)
    for label, fn in (
            ("quantize_cache_write", lambda: E.quantize(
                present, 8, C.EW_SCALE, C.EW_ZP, torch.int8)),
            ("quantize_p_past", lambda: E.quantize(
                p_past, 8, 1.0 / 255.0, -128, torch.int8)),
            ("dequantize_p_past", lambda: E.dequantize(
                q8, 1.0 / 255.0, -128, torch.float32))):
        res[f"{label}_ms"] = C.cuda_ms(fn, lead=True)
    if elementwise_only:
        return res
    q, kt, v = C.plain_inputs(32, C.PREFILL_N, 64, seed=15)
    kw = dict(C.QP, out_requant=C.OUT_REQUANT, causal_mask_val=C.MASK_VAL)
    res["fused_attention_prefill_ms"] = C.cuda_ms(
        lambda: A.fused_attention(q, kt, v, **kw), lead=True)
    torch.cuda.synchronize()
    return res


def elementwise_times(C, E) -> dict:
    """The quantize boundaries in every path form at the four large
    shapes, and the decode path's fake quantizations, each beside its
    bytes bound (``*_bound_ms``: each input read once, each output written
    once, at the card's data-sheet rate)."""
    import torch
    from numpy_quant_tpu_torch.models.llama import TINYLLAMA_1_1B
    rate = C.peaks(torch.cuda.get_device_name(0))["bytes"]
    res = {}
    g = torch.Generator(device="cuda").manual_seed(22)
    shapes = {"vit_fc1_bf16": ((C.B_TIME * C.N_TOK, 3072), torch.bfloat16,
                               torch.int32, 8),
              "gpt2_fc_f32": ((C.GPT_B * C.GPT_SEQ, 3072), torch.float32,
                              torch.int32, 8),
              "tinyllama_mlp_f32": ((C.LLAMA_B * C.LLAMA_SEQ,
                                     TINYLLAMA_1_1B["intermediate_size"]),
                                    torch.float32, torch.int32, 8),
              "w8a16_fc1_f32": ((C.B_F32 * C.N_TOK, 3072), torch.float32,
                                torch.int64, 16)}
    for label, ((rows, cols), dtype, container, bits) in shapes.items():
        x = torch.randn(rows, cols, device="cuda", generator=g).to(dtype)
        span = 2 ** 40 if container == torch.int64 else 2 ** 20
        acc = torch.randint(-span, span, (rows, cols), device="cuda",
                            dtype=container, generator=g)
        zrow = torch.randint(-span, span, (1, cols), device="cuda",
                             dtype=container, generator=g)
        zcol = torch.randint(-span, span, (rows, 1), device="cuda",
                             dtype=container, generator=g)
        channel = (C.EW_SCALE * torch.rand(1, cols, device="cuda",
                                           generator=g) + 1e-3).cpu().numpy()
        n, isz, asz = rows * cols, x.element_size(), acc.element_size()
        for form, fn, nbytes in (
                ("quantize_scalar", lambda: E.quantize(
                    x, bits, C.EW_SCALE, C.EW_ZP, container), n * (isz + asz)),
                ("quantize_channel", lambda: E.quantize(
                    x, bits, channel, None, container),
                 n * (isz + asz) + 4 * cols),
                ("dequantize_scalar", lambda: E.dequantize(
                    acc, C.EW_SCALE, C.EW_ZP, dtype), n * (isz + asz)),
                ("dequantize_cols", lambda: E.dequantize(
                    acc, C.EW_SCALE, zrow, dtype),
                 n * (isz + asz) + asz * cols),
                ("dequantize_rows", lambda: E.dequantize(
                    acc, C.EW_SCALE, zcol, dtype),
                 n * (isz + asz) + asz * rows)):
            res[f"{form}_{label}_ms"] = C.cuda_ms(fn, lead=True)
            res[f"{form}_{label}_bound_ms"] = nbytes / rate * 1e3
        del x, acc, zrow, zcol
    fake = getattr(E, "fake_quantize", None)
    probs = torch.softmax(torch.randn(C.DEC_B, 32, 1, C.DEC_LEN + 1,
                                      device="cuda", generator=g), dim=-1)
    keys = torch.randn(C.DEC_B, 32, C.DEC_LEN, 64, device="cuda",
                       generator=g)
    for label, x, scale, zp in (
            ("key_cache_f32", keys, C.EW_SCALE, C.EW_ZP),
            ("key_cache_bf16", keys.to(torch.bfloat16), C.EW_SCALE, C.EW_ZP),
            ("p_past", probs[..., :C.DEC_LEN], 1.0 / 255.0, -128)):
        n = x.numel()
        res[f"fake_quantize_{label}_bound_ms"] = \
            n * (x.element_size() + 4) / rate * 1e3
        res[f"fake_quantize_chain_{label}_ms"] = C.cuda_ms(
            lambda: E.dequantize(E.quantize(x, 8, scale, zp, torch.int8),
                                 scale, zp), lead=True)
        if fake is not None:
            res[f"fake_quantize_{label}_ms"] = C.cuda_ms(
                lambda: fake(x, 8, scale, zp, torch.int8), lead=True)
    torch.cuda.synchronize()
    return res


def serving_times(C, E) -> dict:
    """The serving paths' one new call shape: quantize of a prefill
    admission's presents [1, 4, 512, 64] (f32 -> int8) into the slot's
    cache rows."""
    import torch
    g = torch.Generator(device="cuda").manual_seed(16)
    present = torch.randn(1, 4, C.PREFILL_N, 64, device="cuda", generator=g)
    res = {"quantize_prefill_cache_write_ms": C.cuda_ms(
        lambda: E.quantize(present, 8, C.EW_SCALE, C.EW_ZP, torch.int8),
        lead=True)}
    torch.cuda.synchronize()
    return res


def main() -> int:
    import torch
    import chip_smoke as C
    from numpy_quant_tpu_torch.kernels import attention as A, qmatmul as Q
    from numpy_quant_tpu_torch.kernels import elementwise as E
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    res = {"tag": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": C.card_line()}
    if sys.argv[2:] == ["elementwise"]:
        res.update(elementwise_times(C, E))
        res.update(llama_decode_times(C, A, Q, E, elementwise_only=True))
        res.update(serving_times(C, E))
        print("[compare]", json.dumps(res), flush=True)
        return 0
    res.update(head_split_times(C, A))
    bh, n, d = C.LLAMA_B * 32, C.LLAMA_SEQ, 64
    q, kt, v = C.plain_inputs(bh, n, d, seed=99)
    kw = dict(C.QP, out_requant=C.OUT_REQUANT, causal_mask_val=C.MASK_VAL)
    res["fused_attention_ms"] = C.cuda_ms(
        lambda: A.fused_attention(q, kt, v, **kw))
    del q, kt, v
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    for name, dt in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        x, pl, sc = C.wo_operands(4, 8, 768, 3072, 6, seed=768 + 3072,
                                  dtype=dt)
        w = (Q.unpack_splitk(pl, 4, 768).float()
             * torch.repeat_interleave(sc, 128, dim=0)).to(dt)
        res[f"wo_{name}_ms"] = C.cuda_ms(
            lambda: Q.splitk_wo_matmul(x, pl, sc, bits=4), flush=flush)
        res[f"library_{name}_ms"] = C.cuda_ms(lambda: torch.matmul(x, w),
                                              flush=flush)
    del flush
    zp = torch.full((), C.X_ZP, dtype=torch.int32, device="cuda")
    for kname, layout, bits, per_channel in (
            ("splitk_qmatmul", "splitk", 4, True),
            ("packed_qmatmul", "bitplanes", 3, False)):
        fn = getattr(Q, kname)
        for k, n in C.QMM_SHAPES:
            x, payload, colsum, _, wvec, kw, w8 = C.qmm_operands(
                layout, bits, C.M_TIME, k, n, seed=1,
                per_channel=per_channel, quantize_x=False, bias=False,
                requant=False)
            scale_row = torch.full((), C.X_SCALE, device="cuda") * wvec \
                if per_channel else torch.full(
                    (), float(C.X_SCALE * C.W_SCALE), device="cuda")

            def library():
                acc = torch._int_mm(x, w8)
                return (acc - colsum * zp).to(torch.float32) * scale_row

            res[f"{kname}_w{bits}_{k}x{n}_ms"] = C.cuda_ms(
                lambda: fn(x, payload, colsum, None, wvec, **kw), lead=True)
            res[f"int_mm_epilogue_{kname}_{k}x{n}_ms"] = C.cuda_ms(
                library, lead=True)
            del x, payload, w8
    # the quantize boundaries at ViT-Base's bf16 fc1 output, batch 96
    g = torch.Generator(device="cuda").manual_seed(14)
    rows, cols = C.B_TIME * C.N_TOK, 3072
    x = torch.randn(rows, cols, device="cuda", generator=g).to(torch.bfloat16)
    acc = torch.randint(-2 ** 20, 2 ** 20, (rows, cols), device="cuda",
                        dtype=torch.int32, generator=g)
    zrow = torch.randint(-2 ** 20, 2 ** 20, (1, cols), device="cuda",
                         dtype=torch.int32, generator=g)
    res["quantize_vit_fc1_bf16_ms"] = C.cuda_ms(
        lambda: E.quantize(x, 8, C.EW_SCALE, C.EW_ZP, torch.int32), lead=True)
    res["dequantize_vit_fc1_bf16_ms"] = C.cuda_ms(
        lambda: E.dequantize(acc, C.EW_SCALE, zrow, torch.bfloat16),
        lead=True)
    res.update(elementwise_times(C, E))
    res.update(llama_decode_times(C, A, Q, E))
    res.update(serving_times(C, E))
    print("[compare]", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
