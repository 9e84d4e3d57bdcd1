#!/usr/bin/env python3
"""Time fused_attention, splitk_wo_matmul, splitk_qmatmul and
packed_qmatmul on one NVIDIA GPU, in the checkout this is run from:

    python3 kernel_times.py <tag>

fused_attention at the TinyLlama-1.1B scoring shape (BH = 4 x 32, N = 2048,
D = 64, causal, int8 out); splitk_wo_matmul at GPT-2's 768 -> 3072 decode
shape (M = 8, W4 g=128, bf16 and f32, cold L2) beside torch.matmul on the
weight dequantized beforehand; splitk_qmatmul (W4, per-channel scale) and
packed_qmatmul (W3 bit-planes) at ViT-Base's three packed shapes at batch
96 (M = 18,912; int8 x, f32 out) beside torch._int_mm on the unpacked
weight plus the eager epilogue. Each is the median of 20 CUDA-event timed
calls (chip_smoke.py's helpers), the packed matmuls behind a device sleep.
Prints one line, ``[compare] {json}``. To hold two commits against each
other, run it in a checkout of each, in turns (parent, change, change,
parent), one after another on one card.
"""
import json
import os
import sys

sys.path.insert(0, os.getcwd())


def main() -> int:
    import torch
    import chip_smoke as C
    from numpy_quant_tpu_torch.kernels import attention as A, qmatmul as Q
    if not torch.cuda.is_available():
        print("kernel_times: no CUDA device", file=sys.stderr)
        return 2
    res = {"tag": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": C.card_line()}
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
    print("[compare]", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
