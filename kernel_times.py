#!/usr/bin/env python3
"""Time fused_attention and splitk_wo_matmul on one NVIDIA GPU, in
the checkout this is run from:

    python3 kernel_times.py <tag>

fused_attention at the TinyLlama-1.1B scoring shape (BH = 4 x 32, N = 2048,
D = 64, causal, int8 out) and splitk_wo_matmul at GPT-2's 768 -> 3072
decode shape (M = 8, W4 g=128, bf16 and f32, cold L2) beside torch.matmul
on the weight dequantized beforehand; median of 20 CUDA-event timed calls
(chip_smoke.py's helpers). Prints one line, ``[compare] {json}``. To hold
two commits against each other, run it in a checkout of each, in turns
(parent, change, change, parent), one after another on one card.
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
    print("[compare]", json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
