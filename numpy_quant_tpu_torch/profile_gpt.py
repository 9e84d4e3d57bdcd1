"""Where the time of one weight-only GPT-2 decode step goes on the GPU.

    python3 -m numpy_quant_tpu_torch.profile_gpt [--f32]
        [--packed-execution {kernel,unpack}]

Builds the chip_smoke.py decode path (random GPT-2 small weights, seed 0;
gpt_decode_step at batch 8 and cache length 64; quantize_weights at 4 bits,
groups of 128), runs one greedy decode to warm up, then
profiles a second one (prompt 16, 48 new tokens: 63 steps) in the bf16
mode (or f32 with ``--f32``) under the chosen packed execution with
torch.profiler, and prints: wall time per step, device busy time per
step, the device's idle share, host operator calls per step, and the
device time by kernel per step, largest first.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from . import Model, config
from .models.gpt import GPT2_SMALL, gpt_decode_step, random_gpt2_weights
from .utils import generate_kv

BATCH, PROMPT, NEW, MAX_LEN = 8, 16, 48, 64
BITS, GROUP = 4, 128


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--f32", action="store_true",
                    help="profile the f32 mode instead of bf16")
    ap.add_argument("--packed-execution", choices=("kernel", "unpack"),
                    default="kernel",
                    help="how MatMuls with packed weights run")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("profile_gpt: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    proto = gpt_decode_step(random_gpt2_weights(GPT2_SMALL, seed=0),
                            GPT2_SMALL, batch_size=BATCH, max_len=MAX_LEN)
    model = Model.from_onnx(proto)
    converted = model.quantize_weights(bit_width=BITS, group_size=GROUP)
    config.packed_execution = args.packed_execution
    prompt = np.random.default_rng(0).integers(
        0, GPT2_SMALL["vocab_size"], size=(BATCH, PROMPT)).astype(np.int32)
    steps = PROMPT + NEW - 1
    mode = contextlib.nullcontext() if args.f32 \
        else config.low_precision_floats()
    from torch.profiler import ProfilerActivity, profile
    with mode:
        generate_kv(model, prompt, proto._wte, proto._wpe, NEW)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        generate_kv(model, prompt, proto._wte, proto._wpe, NEW)
        plain_wall = (time.perf_counter() - t0) / steps
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            generate_kv(model, prompt, proto._wte, proto._wpe, NEW)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / steps
    events = prof.key_averages()
    # device-side rows only: each kernel once (the aten op that launched
    # it carries the same time again)
    rows = sorted(((e.key, e.self_device_time_total / steps / 1e3,
                    e.count / steps) for e in events
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    aten_calls = sum(e.count for e in events
                     if e.device_type == torch.autograd.DeviceType.CPU
                     and e.key.startswith("aten::")) / steps
    launches = sum(r[2] for r in rows)
    print(f"card: {card}")
    print(f"config: W{BITS} g{GROUP}, {converted} weights, "
          f"packed_execution={args.packed_execution}, "
          f"{'f32' if args.f32 else 'bf16'}, batch {BATCH}, {steps} steps")
    print(f"wall {plain_wall * 1e3:.3f} ms/step unprofiled, "
          f"{wall * 1e3:.3f} ms/step profiled; device busy {busy:.3f} "
          f"ms/step; idle share {max(0.0, 1 - busy / (plain_wall * 1e3)):.3f}"
          f" of the unprofiled step; "
          f"{aten_calls:.0f} aten calls/step; {launches:.0f} device "
          f"kernels/step")
    for key, ms, count in rows[:30]:
        print(f"{ms:10.4f} ms {ms / busy * 100:6.2f}% x{count:<6.1f} "
              f"{key[:110]}")


if __name__ == "__main__":
    main()
