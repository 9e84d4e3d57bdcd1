"""Where the port's float forward first parts from the JAX package's on
the CPU, and whether XLA's CPU orders can be replayed there.

On the small trained ViT fixture at B=4 (``make_batch`` seed 7) it prints:

* the calibration stats of both packages bit-equal, of how many;
* the first value in node order whose entries differ, and the share;
* layer 0's Q/K/V products fed JAX's own input: equal to a standalone
  jitted ``jnp.matmul``, to torch's ``matmul`` and to a replay of
  512-wide k blocks of in-order fused multiply-adds;
* XLA's CPU row sum of [4, 65, 128] over the last axis against the exactly
  rounded float64 sum and against candidate orders (a sequential chain,
  strided lanes finished by halves, adjacent pairs or a chain, unrolled
  accumulators, pairwise blocks, and the mapped one: windows of 32, each
  chained from 0, the partials reduced by the same rule, which the port
  replays on CPU tensors as ``intops.xla_cpu_row_sum``): the best share
  of rows each matches;
* the first value apart, when it is a MatMul or Gemm, against the mapped
  order of XLA's CPU dot (``ops/registry.py::_xla_cpu_dot``: YNNPACK's k
  lanes where XLA hands it the dot, else Eigen's chain) on JAX's operands.
  The port's CPU softmax (XLA's exp and row sums), exact-form erf and
  batched dots of two activations replay XLA's orders, so the fixture's
  first value apart is the classifier's Gemm (a weight product, which
  keeps torch's order).

    JAX_PLATFORMS=cpu python extras/xla_cpu_order_probe.py

About half a minute on one CPU host.
"""
from __future__ import annotations

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def fma_replay(a, b, block: int = 512):
    """a [M, K] @ b [K, N]: 512-wide k blocks, each an in-order chain of
    float32 fused multiply-adds from 0, the blocks added in order (a whole
    chain at M = 1)."""
    import torch
    from numpy_quant_tpu_torch.ops.registry import _fma_f32
    a2 = torch.from_numpy(np.ascontiguousarray(a.reshape(-1, a.shape[-1])))
    bb = torch.from_numpy(np.ascontiguousarray(b))
    m, k = a2.shape
    step = k if m == 1 else block
    out = None
    for s in range(0, k, step):
        acc = torch.zeros(m, bb.shape[1], dtype=torch.float32)
        for j in range(s, min(k, s + step)):
            acc = _fma_f32(a2[:, j:j + 1], bb[j:j + 1, :], acc)
        out = acc if out is None else out + acc
    return out.numpy().reshape(*a.shape[:-1], b.shape[1])


def lanes4_replay(a, b):
    """a [..., M, K] @ b [..., K, N]: k in four lanes (k mod 4), each a
    chain of float32 fused multiply-adds from 0, finished
    (l0 + l1) + (l2 + l3)."""
    import torch
    from numpy_quant_tpu_torch.ops.registry import _fma_f32
    ta, tb = torch.from_numpy(np.array(a)), torch.from_numpy(np.array(b))
    shape = torch.broadcast_shapes(ta.shape[:-2], tb.shape[:-2]) \
        + (ta.shape[-2], tb.shape[-1])
    lanes = [torch.zeros(shape) for _ in range(4)]
    for k in range(ta.shape[-1]):
        lanes[k % 4] = _fma_f32(ta[..., k:k + 1], tb[..., k:k + 1, :],
                                lanes[k % 4])
    return ((lanes[0] + lanes[1]) + (lanes[2] + lanes[3])).numpy()


def sum_orders(x: np.ndarray) -> dict:
    """{order: row sums of x [rows, n] in float32} for candidate orders."""
    def chain(cols):
        s = cols[:, 0].copy()
        for j in range(1, cols.shape[1]):
            s = (s + cols[:, j]).astype(np.float32)
        return s

    def halves(acc):
        while acc.shape[1] > 1:
            h = acc.shape[1] // 2
            acc = (acc[:, :h] + acc[:, h:]).astype(np.float32)
        return acc[:, 0]

    def adjacent(acc):
        while acc.shape[1] > 1:
            acc = (acc[:, 0::2] + acc[:, 1::2]).astype(np.float32)
        return acc[:, 0]

    def pairwise(cols):
        if cols.shape[1] <= 8:
            return chain(cols)
        h = cols.shape[1] // 2
        return (pairwise(cols[:, :h]) + pairwise(cols[:, h:])) \
            .astype(np.float32)

    def windows32(cols):
        # XLA's CPU rewrite: zero-pad to a multiple of 32, (pad // 2) in
        # front, chain each window from 0, reduce the partials alike
        while cols.shape[1] > 32:
            w = -(-cols.shape[1] // 32)
            pad = 32 * w - cols.shape[1]
            cols = np.pad(cols, ((0, 0), (pad // 2, pad - pad // 2)))
            part = cols.reshape(cols.shape[0], w, 32)
            acc = np.zeros(part.shape[:2], np.float32)
            for j in range(32):
                acc = (acc + part[:, :, j]).astype(np.float32)
            cols = acc
        acc = np.zeros(cols.shape[0], np.float32)
        for j in range(cols.shape[1]):
            acc = (acc + cols[:, j]).astype(np.float32)
        return acc

    out = {"chain": chain(x), "pairwise8": pairwise(x),
           "windows32": windows32(x)}
    n = x.shape[1]
    for width in (2, 4, 8, 16, 32, 64, 128):
        acc = np.zeros((x.shape[0], width), np.float32)
        for j in range(0, n, width):
            acc = (acc + x[:, j:j + width]).astype(np.float32)
        for unroll in (1, 2, 4, 8):
            if width % unroll:
                continue
            lanes = width // unroll
            comb = acc[:, :lanes].copy()
            for u in range(1, unroll):
                comb = (comb + acc[:, u * lanes:(u + 1) * lanes]) \
                    .astype(np.float32)
            for name, fn in (("halves", halves), ("adjacent", adjacent),
                             ("chain", chain)):
                out[f"lanes{width}/unroll{unroll}/{name}"] = fn(comb)
    return out


def main() -> None:
    import jax
    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    import torch

    import numpy_quant_tpu as nq
    from numpy_quant_tpu.models import fixtures as JF
    from numpy_quant_tpu.utils.parity import record_all_values as jrec
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.graph import Constant
    from numpy_quant_tpu_torch.ops.registry import _xla_cpu_dot as xla_cpu_dot
    from numpy_quant_tpu_torch.ops.registry import _ynn_lanes as ynn_lanes

    def consts_of(model):
        return {v.name: v for v in model.values if isinstance(v, Constant)}
    from numpy_quant_tpu_torch.models import fixtures as TF
    from numpy_quant_tpu_torch.utils.parity import record_all_values as trec

    b = 4
    calib, _ = TF.make_batch(np.random.default_rng(7), b)
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(JF.trained_vit_onnx(batch_size=b))
        js = jm.calibration_stats([calib])
        jv = {k: np.asarray(v) for k, v in jrec(jm, [calib]).items()}
    tm = Model.from_onnx(TF.trained_vit_onnx(batch_size=b), device="cpu")
    ts = tm.calibration_stats([calib])
    tv = trec(tm, [calib])
    same = sum(js[k] == ts[k] for k in js)
    print(f"calibration stats bit-equal: {same} of {len(js)}")
    for node in tm.nodes:
        name = node.outputs[0].name
        a, t = jv.get(name), tv.get(name)
        if a is None or t is None or a.shape != t.shape \
                or a.dtype != t.dtype:
            continue
        if not np.array_equal(a, t):
            print(f"first value apart: {name} ({node.op}), "
                  f"{(a != t).mean():.3f} of its entries")
            if node.op in ("MatMul", "Gemm"):
                lhs = jv[node.inputs[0].name]
                rhs = jv.get(node.inputs[1].name)
                if rhs is None:  # a weight
                    rhs = consts_of(tm)[node.inputs[1].name].data.data \
                        .numpy()
                if node.op == "Gemm" and node.attrs.get("transB"):
                    rhs = rhs.T
                m, k, n = lhs.shape[-2], lhs.shape[-1], rhs.shape[-1]
                rep = xla_cpu_dot(torch.from_numpy(np.ascontiguousarray(lhs)),
                                  torch.from_numpy(np.ascontiguousarray(rhs)))
                if node.op == "Gemm" and len(node.inputs) > 2:
                    rep = rep + consts_of(tm)[node.inputs[2].name].data.data
                print(f"  the mapped dot order ({ynn_lanes(m, k, n)} k "
                      f"lanes; 0: Eigen's chain) on JAX's operands "
                      f"{lhs.shape} @ {rhs.shape}, then the bias: "
                      f"{(rep.numpy() == a).mean():.3f} of entries")
            break
    consts = {v.name: v for v in tm.values if isinstance(v, Constant)}
    for proj in ("query", "key", "value"):
        node = next(n for n in tm.nodes if n.op == "MatMul"
                    and n.outputs[0].name.startswith(
                        f"encoder.layer.0.attention.{proj}/"))
        x = jv[node.inputs[0].name]
        w = consts[node.inputs[1].name].data.data.numpy()
        y = jv[node.outputs[0].name]
        with jax.enable_x64(False):
            jd = np.asarray(jax.jit(jnp.matmul)(x, w))
        td = (torch.from_numpy(x) @ torch.from_numpy(w)).numpy()
        print(f"{proj} {x.shape} @ {w.shape}: graph == jitted dot "
              f"{(y == jd).mean():.3f}, == torch {(y == td).mean():.3f}, "
              f"== fma replay {(y == fma_replay(x, w)).mean():.3f}")
    x = np.random.default_rng(0).normal(size=(b, 65, 128)) \
        .astype(np.float32) * 0.7 + 0.1
    with jax.enable_x64(False):
        xla = np.asarray(jnp.sum(jnp.asarray(x), axis=-1)).reshape(-1)
    rows = x.reshape(-1, 128)
    exact = rows.astype(np.float64).sum(1).astype(np.float32)
    print(f"XLA row sums [4, 65, 128]: equal to the exactly rounded sum on "
          f"{(xla == exact).mean():.3f} of rows")
    ranked = sorted(((float((s == xla).mean()), k)
                     for k, s in sum_orders(rows).items()), reverse=True)
    for share, order in ranked[:3]:
        print(f"  order {order}: {share:.3f} of rows")


if __name__ == "__main__":
    main()
