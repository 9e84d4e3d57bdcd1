"""CNN graph generators (port of ``numpy_quant_tpu/models/cnn.py``): a
Conv/Relu/MaxPool classifier, MobileNet-style depthwise-separable and
ResNet-style residual classifiers, a small U-Net segmenter and an LSTM
sequence classifier, their weights drawn from ``seed``. The same
arguments give the JAX package's serialized graph byte for byte.

Each model carries ``_torch_forward(x, device="cpu")``: the same network
in plain torch ops (the float oracle), on ``device``. With
``quantize(quantize_conv=True)`` the convolutions run on the integer path
(im2col + integer product + requantize); otherwise they stay float.
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder


def cnn_classifier(batch: int, image_size: int = 32, channels: int = 3,
                   widths=(16, 32), n_classes: int = 10,
                   seed: int = 0) -> O.ModelProto:
    rng = np.random.default_rng(seed)
    g = GraphBuilder("cnn_classifier")
    x = g.input("input", [batch, channels, image_size, image_size])

    c_in = channels
    h = x
    size = image_size
    for i, c_out in enumerate(widths):
        w = g.init(f"conv{i}.weight",
                   (rng.standard_normal((c_out, c_in, 3, 3)) /
                    np.sqrt(9 * c_in)).astype(np.float32))
        b = g.init(f"conv{i}.bias",
                   (rng.standard_normal(c_out) * 0.1).astype(np.float32))
        h = g.node("Conv", [h, w, b], out=f"/conv{i}_out",
                   kernel_shape=[3, 3], pads=[1, 1, 1, 1], strides=[1, 1])
        h = g.node("Relu", [h], out=f"/relu{i}_out")
        h = g.node("MaxPool", [h], out=f"/pool{i}_out",
                   kernel_shape=[2, 2], strides=[2, 2])
        size //= 2
        c_in = c_out

    h = g.node("GlobalAveragePool", [h], out="/gap_out")
    h = g.node("Flatten", [h], out="/flat_out", axis=1)
    wf = g.init("fc.weight",
                (rng.standard_normal((n_classes, c_in)) /
                 np.sqrt(c_in)).astype(np.float32))
    bf = g.init("fc.bias",
                (rng.standard_normal(n_classes) * 0.1).astype(np.float32))
    g.node("Gemm", [h, wf, bf], out="logits", alpha=1.0, beta=1.0, transB=1)
    g.output("logits", [batch, n_classes])
    model = g.model()

    def torch_forward(x_np, device="cpu"):
        import torch
        t = torch.tensor(x_np, device=device)
        inits = {i.name: torch.tensor(O.to_array(i), device=device)
                 for i in model.graph.initializer}
        for i in range(len(widths)):
            t = torch.nn.functional.conv2d(t, inits[f"conv{i}.weight"],
                                           inits[f"conv{i}.bias"], padding=1)
            t = torch.relu(t)
            t = torch.nn.functional.max_pool2d(t, 2)
        t = t.mean(dim=(2, 3))
        t = t @ inits["fc.weight"].T + inits["fc.bias"]
        return t.cpu().numpy()

    model._torch_forward = torch_forward
    return model


def mobilenet_classifier(batch: int, image_size: int = 32,
                         channels: int = 3, widths=(16, 32),
                         n_classes: int = 10, seed: int = 0) -> O.ModelProto:
    """Depthwise-separable CNN (MobileNet-style): each block is a
    3x3 DEPTHWISE Conv (group = channels) + 1x1 pointwise Conv, both
    quantizable. Exercises grouped Conv through the full import ->
    calibrate -> quantize -> execute path."""
    rng = np.random.default_rng(seed)
    g = GraphBuilder("mobilenet_classifier")
    x = g.input("input", [batch, channels, image_size, image_size])

    c_in = channels
    h = x
    for i, c_out in enumerate(widths):
        wd = g.init(f"dw{i}.weight",
                    (rng.standard_normal((c_in, 1, 3, 3)) / 3.0)
                    .astype(np.float32))
        bd = g.init(f"dw{i}.bias",
                    (rng.standard_normal(c_in) * 0.1).astype(np.float32))
        h = g.node("Conv", [h, wd, bd], out=f"/dw{i}_out",
                   kernel_shape=[3, 3], pads=[1, 1, 1, 1],
                   strides=[2, 2], group=c_in)
        h = g.node("Relu", [h], out=f"/dwrelu{i}_out")
        wp = g.init(f"pw{i}.weight",
                    (rng.standard_normal((c_out, c_in, 1, 1)) /
                     np.sqrt(c_in)).astype(np.float32))
        bp = g.init(f"pw{i}.bias",
                    (rng.standard_normal(c_out) * 0.1).astype(np.float32))
        h = g.node("Conv", [h, wp, bp], out=f"/pw{i}_out",
                   kernel_shape=[1, 1], pads=[0, 0, 0, 0], strides=[1, 1])
        h = g.node("Relu", [h], out=f"/pwrelu{i}_out")
        c_in = c_out

    h = g.node("GlobalAveragePool", [h], out="/gap_out")
    h = g.node("Flatten", [h], out="/flat_out", axis=1)
    wf = g.init("fc.weight",
                (rng.standard_normal((n_classes, c_in)) /
                 np.sqrt(c_in)).astype(np.float32))
    bf = g.init("fc.bias",
                (rng.standard_normal(n_classes) * 0.1).astype(np.float32))
    g.node("Gemm", [h, wf, bf], out="logits", alpha=1.0, beta=1.0, transB=1)
    g.output("logits", [batch, n_classes])
    model = g.model()

    def torch_forward(x_np, device="cpu"):
        import torch
        t = torch.tensor(x_np, device=device)
        inits = {i.name: torch.tensor(O.to_array(i), device=device)
                 for i in model.graph.initializer}
        groups = channels
        for i in range(len(widths)):
            t = torch.nn.functional.conv2d(
                t, inits[f"dw{i}.weight"], inits[f"dw{i}.bias"],
                stride=2, padding=1, groups=groups)
            t = torch.relu(t)
            t = torch.nn.functional.conv2d(
                t, inits[f"pw{i}.weight"], inits[f"pw{i}.bias"])
            t = torch.relu(t)
            groups = t.shape[1]
        t = t.mean(dim=(2, 3))
        t = t @ inits["fc.weight"].T + inits["fc.bias"]
        return t.cpu().numpy()

    model._torch_forward = torch_forward
    return model


def resnet_classifier(batch: int, image_size: int = 32, channels: int = 3,
                      widths=(16, 32), n_classes: int = 10,
                      seed: int = 0) -> O.ModelProto:
    """ResNet-style residual classifier: stem Conv+BN+ReLU, one basic
    block per width (Conv+BN+ReLU+Conv+BN, 1x1 Conv+BN projection skip
    on stride/width changes, Add, ReLU), GAP head. Every Conv is
    bias-free with a trailing BatchNormalization -- the canonical CNN
    export shape -- so this is the fold_batchnorm + quantize_conv
    exercise: after folding, the whole residual trunk runs on the integer
    conv path."""
    rng = np.random.default_rng(seed)
    g = GraphBuilder("resnet_classifier")
    x = g.input("input", [batch, channels, image_size, image_size])
    params = {}

    def conv_bn(name, h, c_in, c_out, stride, k=3):
        w = (rng.standard_normal((c_out, c_in, k, k)) /
             np.sqrt(k * k * c_in)).astype(np.float32)
        gamma = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        beta = (rng.standard_normal(c_out) * 0.1).astype(np.float32)
        mean = (rng.standard_normal(c_out) * 0.2).astype(np.float32)
        var = rng.uniform(0.5, 1.5, c_out).astype(np.float32)
        params[name] = (w, gamma, beta, mean, var)
        h = g.node("Conv", [h, g.init(f"{name}.weight", w)],
                   out=f"/{name}_conv",
                   kernel_shape=[k, k], pads=[(k - 1) // 2] * 4,
                   strides=[stride, stride])
        return g.node("BatchNormalization",
                      [h, g.init(f"{name}.gamma", gamma),
                       g.init(f"{name}.beta", beta),
                       g.init(f"{name}.mean", mean),
                       g.init(f"{name}.var", var)],
                      out=f"/{name}_bn", epsilon=1e-5)

    h = conv_bn("stem", x, channels, widths[0], 1)
    h = g.node("Relu", [h], out="/stem_relu")
    c_in = widths[0]
    for i, c_out in enumerate(widths):
        stride = 1 if c_out == c_in else 2
        main = conv_bn(f"block{i}.conv1", h, c_in, c_out, stride)
        main = g.node("Relu", [main], out=f"/block{i}_relu1")
        main = conv_bn(f"block{i}.conv2", main, c_out, c_out, 1)
        skip = h if stride == 1 and c_in == c_out else \
            conv_bn(f"block{i}.proj", h, c_in, c_out, stride, k=1)
        h = g.node("Add", [main, skip], out=f"/block{i}_add")
        h = g.node("Relu", [h], out=f"/block{i}_relu2")
        c_in = c_out

    h = g.node("GlobalAveragePool", [h], out="/gap_out")
    h = g.node("Flatten", [h], out="/flat_out", axis=1)
    wf = g.init("fc.weight",
                (rng.standard_normal((n_classes, c_in)) /
                 np.sqrt(c_in)).astype(np.float32))
    bf = g.init("fc.bias",
                (rng.standard_normal(n_classes) * 0.1).astype(np.float32))
    g.node("Gemm", [h, wf, bf], out="logits", alpha=1.0, beta=1.0, transB=1)
    g.output("logits", [batch, n_classes])
    model = g.model()

    def torch_forward(x_np, device="cpu"):
        import torch

        def cbn(name, t, stride=1):
            w, gamma, beta, mean, var = (torch.tensor(a, device=device)
                                         for a in params[name])
            pad = (w.shape[-1] - 1) // 2
            t = torch.nn.functional.conv2d(t, w, stride=stride, padding=pad)
            return torch.nn.functional.batch_norm(
                t, mean, var, weight=gamma, bias=beta, eps=1e-5)

        t = torch.relu(cbn("stem", torch.tensor(x_np, device=device)))
        ci = widths[0]
        for i, co in enumerate(widths):
            stride = 1 if co == ci else 2
            main = torch.relu(cbn(f"block{i}.conv1", t, stride))
            main = cbn(f"block{i}.conv2", main)
            skip = t if stride == 1 and ci == co else \
                cbn(f"block{i}.proj", t, stride)
            t = torch.relu(main + skip)
            ci = co
        t = t.mean(dim=(2, 3))
        inits = {i.name: torch.tensor(O.to_array(i), device=device)
                 for i in model.graph.initializer}
        return (t @ inits["fc.weight"].T + inits["fc.bias"]).cpu().numpy()

    model._torch_forward = torch_forward
    return model


def unet_segmenter(batch: int, image_size: int = 32, channels: int = 3,
                   width: int = 8, n_classes: int = 4,
                   seed: int = 0) -> O.ModelProto:
    """Tiny encoder-decoder segmentation net: two strided Conv encoder
    stages, a nearest-neighbor Resize (2x) decoder stage with a skip
    Concat, and a 1x1 head producing per-pixel class logits. Exercises
    Resize through the full quantization path (the Resize scales
    constant must stay float -- shape-domain constants are excluded from
    PTQ)."""
    rng = np.random.default_rng(seed)
    g = GraphBuilder("unet_segmenter")
    x = g.input("input", [batch, channels, image_size, image_size])

    def conv(name, h, c_in, c_out, stride, k=3):
        w = g.init(f"{name}.weight",
                   (rng.standard_normal((c_out, c_in, k, k)) /
                    np.sqrt(k * k * c_in)).astype(np.float32))
        b = g.init(f"{name}.bias",
                   (rng.standard_normal(c_out) * 0.1).astype(np.float32))
        pad = (k - 1) // 2
        return g.node("Conv", [h, w, b], out=f"/{name}_out",
                      kernel_shape=[k, k], pads=[pad] * 4,
                      strides=[stride, stride])

    e1 = conv("enc1", x, channels, width, 1)
    e1 = g.node("Relu", [e1], out="/enc1_relu")
    e2 = conv("enc2", e1, width, 2 * width, 2)
    e2 = g.node("Relu", [e2], out="/enc2_relu")
    mid = conv("mid", e2, 2 * width, 2 * width, 1)
    mid = g.node("Relu", [mid], out="/mid_relu")

    scales = g.init("up.scales", np.array([1, 1, 2, 2], np.float32))
    up = g.node("Resize", [mid, "", scales], out="/up_out",
                mode="nearest", coordinate_transformation_mode="asymmetric",
                nearest_mode="floor")
    cat = g.node("Concat", [up, e1], out="/cat_out", axis=1)
    d1 = conv("dec1", cat, 3 * width, width, 1)
    d1 = g.node("Relu", [d1], out="/dec1_relu")
    g.node("Conv", [d1,
                    g.init("head.weight",
                           (rng.standard_normal((n_classes, width, 1, 1)) /
                            np.sqrt(width)).astype(np.float32)),
                    g.init("head.bias",
                           (rng.standard_normal(n_classes) * 0.1)
                           .astype(np.float32))],
           out="mask_logits", kernel_shape=[1, 1], pads=[0, 0, 0, 0],
           strides=[1, 1])
    g.output("mask_logits", [batch, n_classes, image_size, image_size])
    model = g.model()

    def torch_forward(x_np, device="cpu"):
        import torch

        inits = {i.name: torch.tensor(O.to_array(i), device=device)
                 for i in model.graph.initializer}

        def c(name, t, stride=1, pad=1):
            return torch.nn.functional.conv2d(
                t, inits[f"{name}.weight"], inits[f"{name}.bias"],
                stride=stride, padding=pad)

        t = torch.tensor(x_np, device=device)
        e1t = torch.relu(c("enc1", t))
        e2t = torch.relu(c("enc2", e1t, stride=2))
        midt = torch.relu(c("mid", e2t))
        upt = torch.nn.functional.interpolate(midt, scale_factor=2,
                                              mode="nearest")
        d1t = torch.relu(c("dec1", torch.cat([upt, e1t], dim=1)))
        return c("head", d1t, pad=0).cpu().numpy()

    model._torch_forward = torch_forward
    return model


def lstm_classifier(seq: int, batch: int, input_size: int = 8,
                    hidden: int = 16, n_classes: int = 4,
                    seed: int = 0) -> O.ModelProto:
    """Sequence classifier: LSTM -> last hidden state -> Gemm head. The LSTM runs float (like every non-matmul op
    in the reference's quantized executor); the head quantizes."""
    rng = np.random.default_rng(seed)
    g = GraphBuilder("lstm_classifier")
    x = g.input("input", [seq, batch, input_size])

    def u(shape):
        bound = 1.0 / np.sqrt(hidden)
        return rng.uniform(-bound, bound, size=shape).astype(np.float32)

    w = g.init("lstm.W", u((1, 4 * hidden, input_size)))
    r = g.init("lstm.R", u((1, 4 * hidden, hidden)))
    b = g.init("lstm.B", u((1, 8 * hidden)))
    y = g.node("LSTM", [x, w, r, b], out="/lstm", n_outputs=3,
               hidden_size=hidden)
    yh = y[1]  # [1, batch, hidden] final hidden state
    flat = g.node("Squeeze", [yh, g.init("axes0", np.array([0], np.int64))],
                  out="/yh_flat")
    wf = g.init("fc.weight", u((n_classes, hidden)))
    bf = g.init("fc.bias", u((n_classes,)))
    g.node("Gemm", [flat, wf, bf], out="logits", alpha=1.0, beta=1.0,
           transB=1)
    g.output("logits", [batch, n_classes])
    model = g.model()

    def torch_forward(x_np, device="cpu"):
        import torch
        inits = {i.name: O.to_array(i) for i in model.graph.initializer}
        h = inits["lstm.W"].shape[1] // 4
        lstm = torch.nn.LSTM(x_np.shape[2], h).to(device)
        # ONNX iofc -> torch ifgo row order
        perm = np.concatenate([np.arange(0, h),          # i
                               np.arange(2 * h, 3 * h),  # f (onnx row 2)
                               np.arange(3 * h, 4 * h),  # g <- onnx c
                               np.arange(h, 2 * h)])     # o (onnx row 1)
        with torch.no_grad():
            lstm.weight_ih_l0.copy_(torch.tensor(inits["lstm.W"][0][perm]))
            lstm.weight_hh_l0.copy_(torch.tensor(inits["lstm.R"][0][perm]))
            lstm.bias_ih_l0.copy_(
                torch.tensor(inits["lstm.B"][0, :4 * h][perm]))
            lstm.bias_hh_l0.copy_(
                torch.tensor(inits["lstm.B"][0, 4 * h:][perm]))
            _, (hT, _) = lstm(torch.tensor(x_np, device=device))
            logits = hT[0] @ torch.tensor(inits["fc.weight"],
                                          device=device).T \
                + torch.tensor(inits["fc.bias"], device=device)
        return logits.cpu().numpy()

    model._torch_forward = torch_forward
    return model
