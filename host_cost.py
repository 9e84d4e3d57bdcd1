#!/usr/bin/env python3
"""Host cost of the port's eager calls on one NVIDIA GPU, in the checkout
this is run from:

    python3 host_cost.py <tag>

- quantize, dequantize and fake_quantize (where the checkout has it):
  host µs per eager call at chip_smoke.py phase 14's small shape ([8, 64]
  f32 -> int32, scalar scale and zero point; int32 -> f32 with a [1, 64]
  zero-point tensor; f32 -> int8 -> f32, scalar scale and zero point),
  500 calls after 50 warm-up calls, with autograd on (phase 14's form)
  and under ``torch.inference_mode`` (the form every forward walk takes);
- one eager TinyLlama-1.1B decode step at full width and chip_smoke.py's
  LLAMA_LAYERS layers (B=8, cache 2048, int8 with DecodeAttention fused,
  int8 cache, f32: phase 15's int8_fused_int8_cache mode) under
  ``config.eager_forward``: ms per step of a generate_kv of DEC_PROMPT
  teacher-forced and HOST_NEW new tokens, the median of HOST_REPS decodes.

Prints one line, ``[host-cost] {json}``; ``python3 host_cost.py <tag>
elementwise`` leaves the decode step out. To hold two commits against each
other, run it in a checkout of each, in turns (parent, change, change,
parent), one after another on one card.
"""
import json
import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

HOST_NEW, HOST_REPS = 8, 3


def per_call_us(fn, calls: int = 500) -> float:
    import torch
    for _ in range(50):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / calls * 1e6


def elementwise_us(C) -> dict:
    import torch
    from numpy_quant_tpu_torch.kernels import elementwise as E
    small = torch.randn(8, 64, device="cuda")
    acc = torch.randint(-99, 99, (8, 64), device="cuda", dtype=torch.int32)
    zs = torch.randint(-99, 99, (1, 64), device="cuda", dtype=torch.int32)
    calls = {"quantize": lambda: E.quantize(small, 8, C.EW_SCALE, C.EW_ZP),
             "dequantize": lambda: E.dequantize(acc, C.EW_SCALE, zs)}
    if hasattr(E, "fake_quantize"):
        calls["fake_quantize"] = lambda: E.fake_quantize(
            small, 8, C.EW_SCALE, C.EW_ZP, torch.int8)
    res = {}
    for name, fn in calls.items():
        res[f"{name}_us"] = per_call_us(fn)
        with torch.inference_mode():
            res[f"{name}_inference_us"] = per_call_us(fn)
    return res


def llama_step_ms(C) -> dict:
    import numpy as np
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.llama import (llama_decode_step,
                                                    random_llama_weights)
    from numpy_quant_tpu_torch.utils import (decode_calibration, generate_kv,
                                             merge_calibration_stats)
    cfg = C.tinyllama()
    proto = llama_decode_step(random_llama_weights(cfg, seed=0), cfg,
                              batch_size=C.DEC_B, max_len=C.DEC_LEN)
    wte, rope = proto._wte, proto._rope_tables
    model = Model.from_onnx(proto)
    del proto
    prompt = np.random.default_rng(15).integers(
        0, cfg["vocab_size"], size=(C.DEC_B, C.DEC_PROMPT)).astype(np.int32)
    stats = merge_calibration_stats(*[
        model.calibration_stats(b)
        for b in decode_calibration(model, prompt, wte, None, rope=rope)])
    qmodel = model.quantize(bit_width=8, stats=stats)
    del model
    assert qmodel.optimize()["fuse_decode_attention"] == \
        cfg["num_hidden_layers"]
    steps = C.DEC_PROMPT + HOST_NEW - 1
    runs = []
    with config.eager_forward():
        for rep in range(HOST_REPS + 1):  # the first one warms up
            t0 = time.perf_counter()
            generate_kv(qmodel, prompt, wte, None, HOST_NEW, rope=rope,
                        kv_cache_dtype="int8")
            if rep:
                runs.append((time.perf_counter() - t0) / steps * 1e3)
    return {"llama_eager_ms_per_step": statistics.median(runs),
            "llama_eager_ms_per_step_runs": ",".join(f"{v:.2f}"
                                                     for v in runs),
            "llama_layers": cfg["num_hidden_layers"], "steps": steps}


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("host_cost: no CUDA device", file=sys.stderr)
        return 2
    import chip_smoke as C
    whole = sys.argv[2:] != ["elementwise"]
    if whole:
        C.build_kernels()
    res = {"tag": sys.argv[1] if len(sys.argv) > 1 else "",
           "card": C.card_line()}
    res.update(elementwise_us(C))  # a first call builds its kernel
    if whole:
        res.update(llama_step_ms(C))
    print("[host-cost] " + json.dumps(res), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
