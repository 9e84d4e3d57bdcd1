"""ONNX LSTM and GRU (port of ``numpy_quant_tpu/ops/registry.py::
_recurrent``) as a torch loop over time, the input projections hoisted
out of it as one product.

The subset JAX takes: layout 0 (sequence-major), the default activations
(sigmoid, tanh), forward, reverse and bidirectional, the optional bias,
``sequence_lens`` (uniform only), initial states, GRU's
``linear_before_reset`` both ways. Peephole weights are refused."""
from __future__ import annotations

import numpy as np
import torch

from ..tensor import FTensor


def recurrent(op: str, inputs: list, attrs: dict) -> list:
    hidden = int(attrs["hidden_size"])
    direction = attrs.get("direction", "forward")
    if isinstance(direction, bytes):
        direction = direction.decode()
    if int(attrs.get("layout", 0)) != 0:
        raise ValueError(f"{op} layout=1 not supported")
    n_gates = 4 if op == "LSTM" else 3
    lbr = int(attrs.get("linear_before_reset", 0))

    def opt(i):
        return inputs[i] if len(inputs) > i else None

    x, w, r = inputs[0], inputs[1], inputs[2]
    xd = x.data  # [seq, batch, input]
    seq, batch, _ = xd.shape
    # optional inputs by position: [X, W, R, B, sequence_lens, initial_h,
    # initial_c, P] (LSTM); [X, W, R, B, sequence_lens, initial_h] (GRU)
    b = opt(3).data if opt(3) is not None else None
    seq_lens = np.asarray(opt(4).data) if opt(4) is not None else None
    h_init = opt(5)
    c_init = opt(6) if op == "LSTM" else None
    if op == "LSTM" and opt(7) is not None:
        raise ValueError("LSTM peephole weights not supported")
    if seq_lens is not None and not np.all(seq_lens == seq):
        raise ValueError(f"{op} per-sample sequence_lens not supported")

    def zeros(*shape):
        return torch.zeros(shape, dtype=xd.dtype, device=xd.device)

    dirs = []
    for d in range(w.data.shape[0]):
        wd, rd = w.data[d], r.data[d]  # [G*H, input], [G*H, H]
        if b is not None:
            wb, rb = b[d, :n_gates * hidden], b[d, n_gates * hidden:]
        else:
            wb = rb = zeros(n_gates * hidden)
        h = h_init.data[d] if h_init is not None else zeros(batch, hidden)
        c = c_init.data[d] if c_init is not None else zeros(batch, hidden)
        reverse = direction == "reverse" or d == 1
        xs = xd.flip(0) if reverse else xd
        xproj = torch.matmul(xs, wd.T) + wb
        ys = []
        for t in range(seq):
            xp = xproj[t]
            if op == "LSTM":  # ONNX iofc gate order
                gates = xp + torch.matmul(h, rd.T) + rb
                i, o, f, g = gates.split(hidden, dim=-1)
                c = torch.sigmoid(f) * c + torch.sigmoid(i) * torch.tanh(g)
                h = torch.sigmoid(o) * torch.tanh(c)
            else:  # GRU, ONNX zrh order
                z_x, r_x, h_x = xp.split(hidden, dim=-1)
                rproj = torch.matmul(h, rd.T) + rb
                z_r, r_r, h_r = rproj.split(hidden, dim=-1)
                z = torch.sigmoid(z_x + z_r)
                rt = torch.sigmoid(r_x + r_r)
                if lbr:
                    ht = torch.tanh(h_x + rt * h_r)
                else:
                    ht = torch.tanh(h_x + torch.matmul(
                        rt * h, rd[2 * hidden:].T) + rb[2 * hidden:])
                h = (1 - z) * ht + z * h
            ys.append(h)
        ys = torch.stack(ys)
        dirs.append((ys.flip(0) if reverse else ys, h, c))

    outs = [FTensor(torch.stack([y for y, _, _ in dirs], dim=1)),
            FTensor(torch.stack([h for _, h, _ in dirs]))]
    if op == "LSTM":
        outs.append(FTensor(torch.stack([c for _, _, c in dirs])))
    return outs
