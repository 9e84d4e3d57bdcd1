"""The int8 ViT-Base-patch16-224 classifier (vit_base_int8.json): built,
quantized and packed through the program's entry points, the work of its
products, and the comparison with the plain reference."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.common import traffic
from benchmark.reference.vit_int8 import ViTInt8


def weights(spec: dict, seed: int, device) -> dict:
    """A seeded ViTForImageClassification state dict (HF keys), drawn on
    ``device`` in one call and handed over as host float32 arrays."""
    hid, inter = spec["hidden_size"], spec["intermediate_size"]
    p, ch = spec["patch_size"], spec["num_channels"]
    n_tok = (spec["image_size"] // p) ** 2 + 1
    drawn = {"vit.embeddings.cls_token": (1, 1, hid),
             "vit.embeddings.position_embeddings": (1, n_tok, hid),
             "vit.embeddings.patch_embeddings.projection.weight":
                 (hid, ch, p, p)}
    zeros = {"vit.embeddings.patch_embeddings.projection.bias": (hid,)}
    ones = {}
    for i in range(spec["num_hidden_layers"]):
        key = f"vit.encoder.layer.{i}"
        for part, (n_out, n_in) in (
                ("attention.attention.query", (hid, hid)),
                ("attention.attention.key", (hid, hid)),
                ("attention.attention.value", (hid, hid)),
                ("attention.output.dense", (hid, hid)),
                ("intermediate.dense", (inter, hid)),
                ("output.dense", (hid, inter))):
            drawn[f"{key}.{part}.weight"] = (n_out, n_in)
            zeros[f"{key}.{part}.bias"] = (n_out,)
        for ln in ("layernorm_before", "layernorm_after"):
            ones[f"{key}.{ln}.weight"] = (hid,)
            zeros[f"{key}.{ln}.bias"] = (hid,)
    ones["vit.layernorm.weight"] = (hid,)
    zeros["vit.layernorm.bias"] = (hid,)
    drawn["classifier.weight"] = (spec["num_labels"], hid)
    zeros["classifier.bias"] = (spec["num_labels"],)
    std = float(spec["initializer_range"])
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.stream_seed(seed, "weights"))
    sizes = [int(np.prod(s)) for s in drawn.values()]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, std, generator=gen).clamp_(-2 * std, 2 * std)
    flat = flat.cpu().numpy()
    out, at = {}, 0
    for (key, shape), size in zip(drawn.items(), sizes):
        out[key] = flat[at:at + size].reshape(shape)
        at += size
    out.update({k: np.zeros(s, np.float32) for k, s in zeros.items()})
    out.update({k: np.ones(s, np.float32) for k, s in ones.items()})
    return out


def calibration_images(spec: dict, seed: int, device) -> np.ndarray:
    mix = {"distinct": 1, "batch": spec["calibration"]["images"],
           "image_std": spec["calibration"]["std"]}
    shape = (spec["num_channels"], spec["image_size"], spec["image_size"])
    return traffic.images(mix, seed, shape, device,
                          stream="calibration")[0].cpu().numpy()


def build(spec: dict, mix: dict, seed: int, device):
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.vit import vit_image_classifier
    w = weights(spec, seed, device)
    calib = calibration_images(spec, seed, device)
    model = Model.from_onnx(vit_image_classifier(w, spec), device=device)
    qmodel = model.quantize(stats=model.calibration_stats([calib]),
                            **spec["quantize"])
    del model
    qmodel.optimize()
    qmodel.pack_weights()
    config.packed_execution = spec["packed_execution"]
    low = spec["precision"]["float_dtype"] == "bfloat16"
    return SimpleNamespace(
        model=qmodel, device=device, weights=w, calib=calib,
        mode=config.low_precision_floats if low else contextlib.nullcontext,
        image_shape=(spec["num_channels"], spec["image_size"],
                     spec["image_size"]))


def free(system) -> dict:
    """Drops the program; returns what the check keeps: the benchmark's
    own weights and calibration images."""
    kept = {"weights": system.weights, "calib": system.calib}
    system.model = None
    return kept


def check(spec: dict, mix: dict, kept: dict, record, seed: int,
          device) -> list:
    """The worst sampled image's logit error against the reference:
    rms(program - reference) / rms(reference) over its logits."""
    ref = ViTInt8(kept["weights"], spec, device)
    ref.calibrate(kept["calib"])
    images = record.sample["images"]
    want = {}
    worst = 0.0 if record.sample["outputs"] else float("inf")
    for j, got in record.sample["outputs"]:
        if j not in want:
            want[j] = ref.logits(images[j])
        r = want[j]
        g = torch.as_tensor(got, device=r.device, dtype=torch.float32)
        err = ((g - r).pow(2).mean(-1).sqrt()
               / r.pow(2).mean(-1).sqrt().clamp_min(1e-30))
        worst = max(worst, float(err.max()))
    return [(spec["check"]["name"], worst, spec["check"]["limit"])]


# ------------------------------------------------------------------ work

def ops_per_image(spec: dict) -> float:
    """Operations of one image's products at the published shapes: the
    patch conv, Q/K/V/O, the two attention products, the MLP and the
    head (2 per multiply-add)."""
    d, f = spec["hidden_size"], spec["intermediate_size"]
    patches = (spec["image_size"] // spec["patch_size"]) ** 2
    n = patches + 1
    conv = 2 * patches * d * spec["num_channels"] * spec["patch_size"] ** 2
    layer = 2 * n * (4 * d * d + 2 * d * f) + 2 * 2 * n * n * d
    return float(conv + spec["num_hidden_layers"] * layer
                 + 2 * d * spec["num_labels"])


def qmatmul_products(spec: dict, batch: int) -> list:
    """The packed int8 products of one forward as the program launches
    them: Q/K/V/O and the two MLP products of every layer over every
    token, except where the program's dead-token pass leaves the last
    layer the CLS token alone (its Q, O and MLP). Each a dict of shape and
    bytes: int8 x, 8-bit weight, int32 column sums, float32 y (the
    kernel's output; the bias adds after it)."""
    d, f = spec["hidden_size"], spec["intermediate_size"]
    m = batch * ((spec["image_size"] // spec["patch_size"]) ** 2 + 1)
    layers = spec["num_hidden_layers"]

    def prod(rows, k, n, count):
        return dict(m=rows, k=k, n=n, count=count, x_bytes=1, w_bits=8,
                    out_bytes=4, scale_bytes=4 * n, precision="int8")

    return [prod(m, d, d, 4 * layers - 2), prod(batch, d, d, 2),
            prod(m, d, f, layers - 1), prod(batch, d, f, 1),
            prod(m, f, d, layers - 1), prod(batch, f, d, 1)]


def attention_products(spec: dict, batch: int) -> list:
    """The fused attention of one forward: per layer both int8 products
    over B x N x N x hidden (every head); q, k, v and the int8 context each
    read or written once."""
    d = spec["hidden_size"]
    n = (spec["image_size"] // spec["patch_size"]) ** 2 + 1
    layers = spec["num_hidden_layers"]
    # the last layer's attention computes the CLS query row alone
    return [dict(ops=4.0 * batch * n * n * d, bytes=4.0 * batch * n * d,
                 precision="int8", count=layers - 1),
            dict(ops=4.0 * batch * n * d, bytes=batch * d * (3.0 * n + 2),
                 precision="int8", count=1)]
