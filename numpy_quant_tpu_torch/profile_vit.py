"""Where the time of one int8 ViT-Base forward goes on the GPU.

    python3 -m numpy_quant_tpu_torch.profile_vit [--batch 96] [--f32]
        [--mode {int8,w4a8,w3a8,w8a16}] [--packed-execution {unpack,kernel}]

Builds the chip_smoke.py main path (random ViT-Base weights, seed 0;
calibration on 2 images; quantize with quantize_conv in the chosen
configuration -- int8, W4A8 per-channel, W3A8 or, with --f32, W8A16;
optimize(); pack_weights(), which in W8A16 packs the 8-bit MatMul
weights for the exact int64 product of their unpacked values), then
profiles three forwards in the bf16 serving mode
(or f32 with ``--f32``) under the chosen packed execution with
torch.profiler and prints: wall time per forward, device busy time per
forward, the device's idle share, and the device time by kernel, largest
first.
"""
from __future__ import annotations

import argparse
import contextlib
import subprocess
import time

import numpy as np
import torch

from . import Model, config
from .models.vit import (VIT_BASE, WEIGHT_CONFIGS, random_vit_weights,
                         vit_image_classifier)

REPS = 3


def main() -> None:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--batch", type=int, default=96)
    ap.add_argument("--f32", action="store_true",
                    help="profile the f32 mode instead of bf16 serving")
    ap.add_argument("--mode", choices=list(WEIGHT_CONFIGS), default="int8",
                    help="quantize configuration (w8a16 needs --f32)")
    ap.add_argument("--packed-execution", choices=("unpack", "kernel"),
                    default="unpack",
                    help="how MatMuls with packed weights run")
    args = ap.parse_args()
    if args.mode == "w8a16" and not args.f32:
        ap.error("w8a16 runs in f32 only (pass --f32)")
    if not torch.cuda.is_available():
        raise SystemExit("profile_vit: no CUDA device")
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True,
                          text=True, check=True).stdout.strip()
    rng = np.random.default_rng(0)
    model = Model.from_onnx(vit_image_classifier(
        random_vit_weights(VIT_BASE, seed=0), VIT_BASE))
    calib = rng.normal(size=(2, 3, 224, 224)).astype(np.float32) * 0.5
    qmodel = model.quantize(stats=model.calibration_stats([calib]),
                            quantize_conv=True, **WEIGHT_CONFIGS[args.mode])
    qmodel.optimize()
    packed = qmodel.pack_weights()
    config.packed_execution = args.packed_execution
    x = torch.from_numpy(rng.normal(size=(args.batch, 3, 224, 224))
                         .astype(np.float32) * 0.5).cuda()
    mode = contextlib.nullcontext() if args.f32 \
        else config.low_precision_floats()
    from torch.profiler import ProfilerActivity, profile
    with mode:
        for _ in range(2):
            qmodel([x], as_numpy=False)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(REPS):
                qmodel([x], as_numpy=False)
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / REPS
    # device-side rows only: each kernel once (the aten op that launched
    # it carries the same time again)
    rows = sorted(((e.key, e.self_device_time_total / REPS / 1e3,
                    e.count // REPS) for e in prof.key_averages()
                   if e.device_type == torch.autograd.DeviceType.CUDA),
                  key=lambda r: -r[1])
    busy = sum(r[1] for r in rows)
    print(f"card: {card}")
    print(f"config: {args.mode}, {packed} packed weights, packed_execution="
          f"{args.packed_execution}")
    print(f"mode: {'f32' if args.f32 else 'bf16'} batch {args.batch}; "
          f"wall {wall * 1e3:.3f} ms/forward; device busy {busy:.3f} "
          f"ms/forward; idle share {max(0.0, 1 - busy / (wall * 1e3)):.3f}")
    for key, ms, count in rows[:30]:
        print(f"{ms:10.3f} ms {ms / busy * 100:6.2f}% x{count:<5d} {key[:110]}")


if __name__ == "__main__":
    main()
