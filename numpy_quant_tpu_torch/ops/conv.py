"""Conv2d: the float path and the im2col patch extraction of the integer
path (port of ``numpy_quant_tpu/ops/conv.py``)."""
from __future__ import annotations

import torch
import torch.nn.functional as F


def conv2d_nchw(x, w, b, pads, strides, dilations=(1, 1), group=1):
    """x: [B, C, H, W]; w: [O, C/group, KH, KW]; b: [O] or None.
    pads: ONNX order (PH0, PW0, PH1, PW1); strides: (SH, SW)."""
    ph0, pw0, ph1, pw1 = (int(p) for p in pads)
    if (ph0, pw0) != (ph1, pw1):
        x = F.pad(x, (pw0, pw1, ph0, ph1))
        ph0 = pw0 = 0
    y = F.conv2d(x, w, None, stride=tuple(int(s) for s in strides),
                 padding=(ph0, pw0),
                 dilation=tuple(int(d) for d in dilations),
                 groups=int(group))
    if b is not None:
        y = y + b.reshape(1, -1, 1, 1)
    return y


def extract_patches_exact(x, ksize, pads, strides, pad_value,
                          dilations=(1, 1)):
    """im2col patches by pure data movement, exact for integer data and
    padded with ``pad_value`` (asymmetric activations pad with their
    zero point). x: [B, H, W, C] -> [B, OH, OW, KH*KW*C], patch layout
    (KH, KW, C)."""
    kh, kw = ksize
    ph0, pw0, ph1, pw1 = (int(p) for p in pads)
    sh, sw = (int(s) for s in strides)
    dh, dw = (int(d) for d in dilations)
    x = F.pad(x, (0, 0, pw0, pw1, ph0, ph1), value=pad_value)
    b, h, w_, c = x.shape
    ekh = dh * (kh - 1) + 1
    ekw = dw * (kw - 1) + 1
    oh = (h - ekh) // sh + 1
    ow = (w_ - ekw) // sw + 1
    if (dh, dw) == (1, 1) and (sh, sw) == (kh, kw) \
            and h % kh == 0 and w_ % kw == 0:
        # non-overlapping windows (ViT patch embed): pure reshape
        p = x.reshape(b, oh, kh, ow, kw, c).permute(0, 1, 3, 2, 4, 5)
        return p.reshape(b, oh, ow, kh * kw * c)
    slices = []
    for i in range(kh):
        for j in range(kw):
            i0, j0 = i * dh, j * dw
            slices.append(x[:, i0:i0 + (oh - 1) * sh + 1:sh,
                            j0:j0 + (ow - 1) * sw + 1:sw, :])
    p = torch.stack(slices, dim=3)
    return p.reshape(b, oh, ow, kh * kw * c)


def conv1d_ncl(x, w, b, pads, strides, dilations=(1,), group=1):
    """x: [B, C, L]; w: [O, C/group, K]; b: [O] or None. pads: ONNX order
    (P0, P1); strides: (S,). The one-spatial-dim variant of
    :func:`conv2d_nchw`."""
    p0, p1 = (int(p) for p in pads)
    if p0 != p1:
        x = F.pad(x, (p0, p1))
        p0 = 0
    y = F.conv1d(x, w, None, stride=int(strides[0]), padding=p0,
                 dilation=int(dilations[0]), groups=int(group))
    if b is not None:
        y = y + b.reshape(1, -1, 1)
    return y


def extract_sliding_windows_nhwc(x, ksize, pads, strides):
    """im2col patches of float data: x [B, H, W, C] -> [B, OH, OW,
    KH*KW*C], patch layout (KH, KW, C), zero padding. JAX builds them with
    ``conv_general_dilated_patches``, a product with one-hot filters;
    here they are the same values moved (:func:`extract_patches_exact`)."""
    return extract_patches_exact(x, ksize, pads, strides, 0.0)


def conv2d_im2col(x, w, pads, strides, matmul):
    """Conv as im2col and a caller's ``matmul(patches_2d, w_2d)`` (the
    integer path passes a quantized matmul). x: [B, H, W, C]; w: [KH, KW,
    C, O]. Returns [B, OH, OW, O]."""
    kh, kw, c, o = w.shape
    patches = extract_sliding_windows_nhwc(x, (kh, kw), pads, strides)
    b, oh, ow, _ = patches.shape
    y = matmul(patches.reshape(b * oh * ow, kh * kw * c),
               w.reshape(kh * kw * c, o))
    return y.reshape(b, oh, ow, o)
