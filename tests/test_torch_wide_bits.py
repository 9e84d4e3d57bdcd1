"""The port's 9-16-bit integer path held against the JAX package in x64
mode, the mode in which JAX computes those widths exactly (int64
containers, float64 zero-point and scale arithmetic).

* ``q_matmul`` and ``requantize`` at 9, 12 and 16 bits: bit for bit.
* The reference's bit-width sweep: ``mlp.onnx`` quantized at every width
  from 1 to 16 (TPU mode up to 8 bits, x64 mode above) on the two-circles
  data: integer intermediates equal, outputs within 1e-6 (the sigmoid's
  exp is each framework's own), labels equal, accuracy > 0.9 from 6 bits
  (the reference's rule).
* A small ViT (2 layers, hidden 64) in W8A16 and A12 with quantize_conv
  and optimize(), the JAX payloads carried across by load_jax_params. Op
  by op (each node fed JAX's recorded inputs) the integer ops equal JAX
  and a float op's quantized output may differ by 1 LSB on at most 1% of
  entries, where the op rounds in another order (the count is printed). End to end labels are equal and logits within 1e-2 *
  max|logit|; fuse_attention declines with JAX's reason."""
import jax
import numpy as np
import pytest
import torch
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu import quantization as JQ
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch import quantization as TQ
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant, Variable
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.models.mlp import MLP_PATH, load_mlp, two_circles
from numpy_quant_tpu_torch.ops.registry import onnx_operator_implementation
from numpy_quant_tpu_torch.passes.toolkit import PASSTHROUGH_OPS
from numpy_quant_tpu_torch.tensor import FTensor, ITensor, QTensor

from .test_torch_vit import CFG, _jax_state

JAX_MLP = MLP_PATH.parents[2] / "numpy_quant_tpu" / "models" / "mlp.onnx"
VIT_MODES = {"w8a16": TV.WEIGHT_CONFIGS["w8a16"], "a12": dict(bit_width=12)}


def _t(a):
    return torch.from_numpy(np.array(a))


def _qparams(x, bits, asym):
    mn = np.minimum(x.min(), np.float32(0.0))
    mx = np.maximum(x.max(), np.float32(0.0))
    s, z = JQ.quant_parameters(mn, mx, bits, asym)
    ts, tz = TQ.quant_parameters(mn, mx, bits, asym)
    np.testing.assert_array_equal(s, ts)
    assert z == tz
    return s, z


@pytest.mark.parametrize("zp_b", [False, True])
@pytest.mark.parametrize("zp_a", [False, True])
@pytest.mark.parametrize("bits", [9, 12, 16])
def test_q_matmul_and_requantize_bit_equal_x64(bits, zp_a, zp_b):
    rng = np.random.default_rng(10 * bits + 2 * zp_a + zp_b)
    a = (rng.normal(size=(2, 19, 24)) + 0.7).astype(np.float32)
    b = (rng.normal(size=(24, 13)) - 0.3).astype(np.float32)
    with jax.enable_x64(True):
        sa, za = _qparams(a, bits, zp_a)
        sb, zb = _qparams(b, bits, zp_b)
        qa = np.asarray(JQ.quantize(a, bits, sa, za))
        qb = np.asarray(JQ.quantize(b, bits, sb, zb))
        jacc, jscale, jzp = JQ.q_matmul(qa, sa, za, qb, sb, zb,
                                        bit_width=bits)
        y = np.asarray(JQ.dequantize(jacc, jscale, jzp))
        rs, rz = _qparams(y, bits, True)
        jr = np.asarray(JQ.requantize(jacc, jscale, jzp, rs, rz, bits))
    assert qa.dtype == np.int64
    np.testing.assert_array_equal(TQ.quantize(_t(a), bits, sa, za).numpy(),
                                  qa)
    tacc, tscale, tzp = TQ.q_matmul(_t(qa), sa, za, _t(qb), sb, zb,
                                    bit_width=bits)
    assert tacc.dtype == torch.int64
    np.testing.assert_array_equal(tacc.numpy(), np.asarray(jacc))
    np.testing.assert_array_equal(np.asarray(tscale), np.asarray(jscale))
    if jzp is None:
        assert tzp is None
    else:
        assert tzp.dtype == torch.int64
        np.testing.assert_array_equal(tzp.numpy(), np.asarray(jzp))
    np.testing.assert_array_equal(TQ.dequantize(tacc, tscale, tzp).numpy(), y)
    tr = TQ.requantize(tacc, tscale, tzp, rs, rz, bits)
    assert tr.dtype == torch.int64
    np.testing.assert_array_equal(tr.numpy(), jr)


def test_port_ships_the_reference_mlp():
    assert MLP_PATH.read_bytes() == JAX_MLP.read_bytes()


def test_two_circles_are_the_reference_data():
    from sklearn.datasets import make_circles
    x, y = make_circles(n_samples=1000, noise=0.03, random_state=3)
    tx, ty = two_circles()
    np.testing.assert_array_equal(tx, x.astype(np.float32))
    np.testing.assert_array_equal(ty, y)


@pytest.mark.parametrize("bit_width", list(range(1, 17)))
def test_mlp_bit_width_sweep_matches_jax(bit_width):
    x, y = two_circles()
    with jax.enable_x64(bit_width > 8):
        jm = nq.Model.from_onnx(nq.onnx.load(JAX_MLP))
        stats = jm.calibration_stats([x])
        jq = jm.quantize(bit_width=bit_width, stats=stats)
        jy = jq([x], record=True)[0]
        jdata = {v.name: v.data for v in jq.values}
    tq = Model.from_onnx(load_mlp(), device="cpu").quantize(
        bit_width=bit_width, stats=stats)
    assert tq.container == (torch.int64 if bit_width > 8 else torch.int32)
    ty = tq([x], record=True)[0]
    compared = 0
    for v in tq.values:
        if isinstance(v.data, QTensor):
            want = np.asarray(jdata[v.name].data)
            got = v.data.data.numpy()
            np.testing.assert_array_equal(got, want, err_msg=v.name)
            compared += 1
    assert compared >= 6  # inputs, weights, biases, Gemm and Relu outputs
    np.testing.assert_allclose(ty, jy, rtol=0, atol=1e-6)
    np.testing.assert_array_equal(ty.argmax(1), jy.argmax(1))
    acc = float(np.mean(ty.argmax(1) == y))
    if bit_width >= 6:
        assert acc > 0.9, (bit_width, acc)


def test_widths_above_16_are_refused():
    model = Model.from_onnx(load_mlp(), device="cpu")
    x, _ = two_circles(64)
    with pytest.raises(ValueError, match="1 to 16"):
        model.quantize([x], bit_width=17)


@pytest.fixture(scope="module")
def vit():
    weights = TV.random_vit_weights(CFG, seed=0)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    x = np.random.default_rng(0).normal(size=(4, 3, 32, 32)).astype(
        np.float32)
    with jax.enable_x64(True):
        jproto = JV.vit_image_classifier(module=hf)
        stats = nq.Model.from_onnx(jproto).calibration_stats([x])
    return dict(jproto=jproto, tproto=TV.vit_image_classifier(weights, CFG),
                x=x, stats=stats)


def _vit_pair(s, mode):
    """The JAX x64-mode QModel and the port's, quantized alike, after
    optimize(), the port holding JAX's payloads and qparams."""
    kw = dict(VIT_MODES[mode], stats=s["stats"], quantize_conv=True)
    with jax.enable_x64(True):
        jq = nq.Model.from_onnx(s["jproto"]).quantize(**kw)
        jrep = jq.optimize()
    tq = Model.from_onnx(s["tproto"], device="cpu").quantize(**kw)
    assert tq.container == torch.int64
    assert load_jax_params(tq, _jax_state(jq)) == sum(
        isinstance(v, Constant) and isinstance(v.data, QTensor)
        for v in tq.values)
    return jq, jrep, tq, tq.optimize()


def _port_value(j):
    """A value JAX recorded, as the port's tensor."""
    kind = type(j).__name__
    if kind == "QTensor":
        zp = j.zero_point
        if zp is not None:
            zp = torch.from_numpy(np.array(zp)) if np.ndim(zp) > 0 \
                else np.int64(zp)
        return QTensor(torch.from_numpy(np.array(j.data)), j.bit_width,
                       j.scale, zp)
    if kind == "FTensor":
        return FTensor(torch.from_numpy(np.array(j.data)))
    return ITensor(np.asarray(j.data))


@pytest.mark.parametrize("mode", list(VIT_MODES))
def test_small_vit_wide_matches_jax_x64(vit, mode):
    """Op by op, each port node fed JAX's recorded inputs: the integer ops
    (MatMul/Gemm/Conv with their quantize and requantize boundaries, the
    shape ops of int8_dataflow) equal JAX; a float op's output quantized
    at its producer may differ by 1 LSB where the op rounds in another
    order. End to end the flips carry on through the integer ops (a
    16-bit grid is fine enough that 1 LSB upstream moves products by a
    few steps): labels equal, logits within 1e-2 * max|logit|, every
    difference counted."""
    jq, jrep, tq, trep = _vit_pair(vit, mode)
    for key in ("fuse_attention", "fuse_gelu", "narrow_gather",
                "int8_dataflow"):
        assert trep[key] == jrep[key], key
    assert trep["fuse_attention"] == 0
    # fuse_attention declines every Softmax with JAX's reason
    assert trep["fusion_failures"] == jrep["fusion_failures"]
    assert len(trep["fusion_failures"]) == CFG["num_hidden_layers"]
    bits = VIT_MODES[mode]["bit_width"]
    assert all(r == f"bit_width {bits} > 8: the int8 attention kernels do "
               "not apply" for _, r in trep["fusion_failures"])
    x = vit["x"]
    with jax.enable_x64(True):
        jy = jq([x], record=True)[0]
        jdata = {v.name: v.data for v in jq.values}
    graph_inputs = {v.name: tq._wrap_input(x, v) for v in tq.inputs}
    exact = flips = total = 0
    for node in tq.nodes:
        data = {}
        for v in node.inputs:
            if v is None:
                continue
            data[v.name] = tq._wrap_constant(v) if isinstance(v, Constant) \
                else graph_inputs.get(v.name) or _port_value(jdata[v.name])
        ins = tq._node_inputs(node, data)
        outs = tq._post_node(node, onnx_operator_implementation(
            node.op, ins, node.attrs))
        for o, t in zip(node.outputs, outs):
            if not isinstance(t, QTensor):
                continue
            want = np.asarray(jdata[o.name].data).astype(np.int64)
            got = t.data.numpy()
            assert got.dtype == np.int64 and got.shape == want.shape, o.name
            diff = np.abs(got - want)
            if node.op in tq.quantized_ops or node.op in PASSTHROUGH_OPS:
                np.testing.assert_array_equal(got, want, err_msg=o.name)
                exact += want.size
            else:
                assert diff.max(initial=0) <= 1, o.name
                flips += int((diff > 0).sum())
                total += want.size
    print(f"{mode}, op by op: {exact} integer-op entries equal; float-op "
          f"outputs quantized at {bits} bits differing by 1 LSB: {flips} "
          f"of {total}")
    # 1% at most: a 16-bit grid is fine enough that one float32 ulp of a
    # softmax probability is ~1/30 of a step (W8A16: 219 of 58,144 differ;
    # A12: 17)
    assert exact > 0 and total > 0 and flips <= 0.01 * total
    ty = tq([x], record=True)[0]
    moved = entries = 0
    for v in tq.values:
        if isinstance(v, Variable) and isinstance(v.data, QTensor) \
                and v.data.bit_width <= bits:
            want = np.asarray(jdata[v.name].data).astype(np.int64)
            moved += int((v.data.data.numpy() != want).sum())
            entries += want.size
    print(f"{mode}, end to end: {moved} of {entries} {bits}-bit entries "
          f"differ; max |logit difference| {np.abs(ty - jy).max():.3g} of "
          f"max |logit| {np.abs(jy).max():.3g}")
    np.testing.assert_array_equal(ty.argmax(1), jy.argmax(1))
    np.testing.assert_allclose(ty, jy, rtol=0,
                               atol=1e-2 * float(np.abs(jy).max()))


def test_w8a16_packed_weights_take_the_exact_product(vit, monkeypatch):
    """W8A16's 8-bit MatMul weights pack; under packed_execution="kernel"
    their 16-bit activations still take the exact int64 product of the
    unpacked weight (the packed kernels take int8 activations)."""
    tq = Model.from_onnx(vit["tproto"], device="cpu").quantize(
        stats=vit["stats"], quantize_conv=True, **VIT_MODES["w8a16"])
    tq.optimize()
    want = tq([vit["x"]])[0]
    assert tq.pack_weights() == 6 * CFG["num_hidden_layers"]
    assert np.array_equal(tq([vit["x"]])[0], want)
    monkeypatch.setattr(TC, "packed_execution", "kernel")
    assert np.array_equal(tq([vit["x"]])[0], want)
