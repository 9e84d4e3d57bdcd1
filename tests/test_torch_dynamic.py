"""The port's ``quantize_dynamic`` held against the JAX package's on the
small trained ViT fixture (24 MatMul weights; the classifier Gemm folds
into DynamicMatMul + Add), in TPU-mode numerics (x64 off): per-row and
per-tensor activation scales, per-tensor and per-channel weights, W8 and
W4. The rewritten graphs equal JAX's node for node with equal weight
payloads and scales; every DynamicMatMul, fed JAX's own input to it,
gives JAX's integer accumulator and its output within 1e-6 * max|y|;
end to end, where the float ops between the matmuls round an activation
to another level, the outputs agree within 1e-2 * max|y| with equal
labels (the printed distance). A JAX DynamicQModel's weights carried
over by ``convert.load_jax_params`` give the port's own output bit for
bit."""
import jax
import numpy as np
import pytest
import torch

import numpy_quant_tpu as nq
from numpy_quant_tpu import quantization as JQ
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.ops.registry import \
    onnx_operator_implementation as j_ops
from numpy_quant_tpu.tensor import FTensor as JFTensor
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.utils.parity import record_all_values
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.dynamic import DynamicQModel
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.ops import interop as TI
from numpy_quant_tpu_torch.tensor import FTensor, QTensor
from .torch_parity import assert_mapped_xla_cpu_host

B = 4
CASES = {"row-tensor-w8": dict(granularity="row"),
         "tensor-channel-w8": dict(granularity="tensor",
                                   per_channel_weights=True),
         "row-channel-w4": dict(granularity="row", per_channel_weights=True,
                                weight_bit_width=4)}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def x():
    return TF.make_batch(np.random.default_rng(99), B)[0]


def _models(kw):
    jd = nq.Model.from_onnx(JF.trained_vit_onnx(batch_size=B)) \
        .quantize_dynamic(bit_width=8, **kw)
    td = Model.from_onnx(TF.trained_vit_onnx(batch_size=B),
                         device="cpu").quantize_dynamic(bit_width=8, **kw)
    return jd, td


# the end-to-end bound of each case, max|y_port - y_jax| / max|y|, at what
# is measured
END_TO_END = {"row-tensor-w8": 1e-3, "tensor-channel-w8": 1.2e-3,
              "row-channel-w4": 1e-6}


@pytest.mark.parametrize("case", sorted(CASES))
def test_dynamic_matches_jax(case, x, monkeypatch):
    assert_mapped_xla_cpu_host()
    jd, td = _models(CASES[case])
    assert isinstance(td, DynamicQModel)
    assert [(n.name, n.op, [v.name for v in n.inputs if v is not None])
            for n in td.nodes] == \
        [(n.name, n.op, [v.name for v in n.inputs if v is not None])
         for n in jd.nodes]
    jw = {v.name: v.data for v in jd.values
          if isinstance(v, JConstant) and isinstance(v.data, JQTensor)}
    tw = {v.name: v.data for v in td.values
          if isinstance(v, Constant) and isinstance(v.data, QTensor)}
    assert set(tw) == set(jw) and len(tw) == 25
    for name, qt in tw.items():
        np.testing.assert_array_equal(qt.data.numpy(),
                                      np.asarray(jw[name].data), name)
        np.testing.assert_array_equal(np.asarray(qt.scale),
                                      np.asarray(jw[name].scale), name)
        assert qt.bit_width == jw[name].bit_width

    # end to end: the float ops between the matmuls replay XLA's CPU
    # orders (the batched attention dots, softmax, erf), but a weight
    # product (the classifier's Gemm) keeps torch's, so an activation may
    # still quantize one level apart -- and with per-tensor scales one ulp
    # of a tensor's max moves its whole grid. Measured 9.51e-4, 1.09e-3
    # and 8.04e-8 of max|y|; held there, labels equal
    jy = np.asarray(jd([x])[0])
    ty = td([x])[0]
    diff = float(np.abs(ty - jy).max()) / float(np.abs(jy).max())
    print(f"{case}: end to end |y - y_jax| / max|y| {diff:.3g}")
    assert diff <= END_TO_END[case]
    np.testing.assert_array_equal(ty.argmax(1), jy.argmax(1))

    # each DynamicMatMul on JAX's own input: equal integer accumulators
    jin = record_all_values(jd, [x])
    jaccs, taccs = [], []
    j_mm, t_mm = JQ._int_matmul, TI.int_matmul
    monkeypatch.setattr(JQ, "_int_matmul", lambda *a: jaccs.append(
        np.asarray(j_mm(*a))) or j_mm(*a))
    monkeypatch.setattr(TI, "int_matmul", lambda *a: taccs.append(
        t_mm(*a).numpy()) or t_mm(*a))
    worst = 0.0
    for jn, tn in zip(jd.nodes, td.nodes):
        if tn.op != "DynamicMatMul":
            continue
        xin = jin[jn.inputs[0].name]
        with jax.disable_jit():
            want = np.asarray(j_ops(jn.op, [JFTensor(xin), jw[
                jn.inputs[1].name]], jn.attrs)[0].data)
        got = TI.dynamic_matmul([FTensor(torch.from_numpy(xin)),
                                 tw[tn.inputs[1].name]], tn.attrs)[0]
        np.testing.assert_array_equal(taccs[-1], jaccs[-1], tn.name)
        scale = max(float(np.abs(want).max()), 1e-30)
        worst = max(worst, float(np.abs(got.data.numpy() - want).max())
                    / scale)
    assert len(taccs) == len(jaccs) == 25
    print(f"{case}: 25 accumulators equal; worst |y - y_jax| / max|y| "
          f"{worst:.3g}")
    assert worst <= 1e-6


def test_dynamic_state_carries_over(x):
    jd, td = _models(CASES["row-channel-w4"])
    state = {"constants": {
        v.name: {"payload": np.asarray(v.data.data),
                 "scale": np.asarray(v.data.scale, np.float32),
                 "zero_point": None, "bit_width": v.data.bit_width}
        for v in jd.values
        if isinstance(v, JConstant) and isinstance(v.data, JQTensor)}}
    mine = td([x])[0]
    other = _models(CASES["row-channel-w4"])[1]
    assert load_jax_params(other, state) == 25
    np.testing.assert_array_equal(other([x])[0], mine)


def test_dynamic_keeps_the_float_model():
    tm = Model.from_onnx(TF.trained_vit_onnx(batch_size=B), device="cpu")
    ops = [n.op for n in tm.nodes]
    td = tm.quantize_dynamic(bit_width=8)
    assert [n.op for n in tm.nodes] == ops
    assert sum(n.op == "DynamicMatMul" for n in td.nodes) == 25
    assert td.bit_width == 8 and td.granularity == "row"
    with pytest.raises(ValueError):
        tm.quantize_dynamic(granularity="channel")
