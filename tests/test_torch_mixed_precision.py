"""The port's sensitivity-planned mixed weight precision held against the
JAX package's on a small random ViT (1 layer, hidden 32, 4 heads, MLP 64,
16x16 images, 8x8 patches -> 5 tokens, 10 labels: 7 weights), both
quantized from the same JAX stats in TPU-mode numerics (x64 off):
``weight_sensitivity`` ranks the weights as JAX does (the values within
1e-3 relative, printed) and ``plan_mixed_precision`` makes JAX's plan; the
planned QModel packs every weight at its width, runs under both packed
executions to equal outputs, and a JAX QModel at the plan's mixed widths
carried over by ``convert.load_jax_params`` gives the port's own output
bit for bit."""
import jax
import numpy as np
import pytest
import torch
from transformers import ViTConfig
from transformers.models.vit.modeling_vit import ViTForImageClassification

import numpy_quant_tpu as nq
from numpy_quant_tpu.graph import Constant as JConstant
from numpy_quant_tpu.models import vit as JV
from numpy_quant_tpu.tensor import QTensor as JQTensor
from numpy_quant_tpu.utils import sensitivity as JS
from numpy_quant_tpu_torch import Model, config as TC
from numpy_quant_tpu_torch.convert import load_jax_params
from numpy_quant_tpu_torch.graph import Constant
from numpy_quant_tpu_torch.models import vit as TV
from numpy_quant_tpu_torch.tensor import PackedQTensor
from numpy_quant_tpu_torch.utils import sensitivity as TS

CFG = dict(hidden_size=32, num_hidden_layers=1, num_attention_heads=4,
           intermediate_size=64, image_size=16, patch_size=8,
           num_labels=10)


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def vit():
    weights = TV.random_vit_weights(CFG, seed=0)
    hf = ViTForImageClassification(
        ViTConfig(**CFG, attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    x = np.random.default_rng(0).normal(size=(4, 3, 16, 16)) \
        .astype(np.float32)
    with jax.enable_x64(False):
        jproto = JV.vit_image_classifier(module=hf)
        stats = nq.Model.from_onnx(jproto).calibration_stats([x])
    return dict(jproto=jproto, tproto=TV.vit_image_classifier(weights, CFG),
                x=x, stats=stats)


def _jm(s):
    return nq.Model.from_onnx(s["jproto"])


def _tm(s):
    return Model.from_onnx(s["tproto"], device="cpu")


def test_sensitivity_ranking_matches_jax(vit):
    kw = dict(stats=vit["stats"], per_channel_weights=True)
    js = JS.weight_sensitivity(_jm(vit), [vit["x"]], **kw)
    ts = TS.weight_sensitivity(_tm(vit), [vit["x"]], **kw)
    assert list(ts) == list(js) and len(ts) == 7
    print("sensitivity port / JAX: " + ", ".join(
        f"{k.split('.')[-2]}={ts[k]:.4g}/{js[k]:.4g}" for k in js))
    for k in js:
        np.testing.assert_allclose(ts[k], js[k], rtol=1e-3, err_msg=k)
    assert sorted(ts, key=ts.get) == sorted(js, key=js.get)


def test_plan_matches_jax_and_runs_packed(vit):
    kw = dict(stats=vit["stats"], per_channel_weights=True)
    jplan = JS.plan_mixed_precision(_jm(vit), [vit["x"]], low_frac=0.5,
                                    **kw)
    tplan = TS.plan_mixed_precision(_tm(vit), [vit["x"]], low_frac=0.5,
                                    **kw)
    print(f"plan: {sorted(tplan)}")
    assert tplan == jplan and 0 < len(tplan) < 7
    tq = _tm(vit).quantize(stats=vit["stats"], bit_width=8,
                           weight_bit_width=tplan, per_channel_weights=True)
    tq.optimize()
    x = vit["x"]
    unpacked = tq([x])[0]
    assert tq.pack_weights() == 6
    widths = {v.name: v.data.bit_width for v in tq.values
              if isinstance(v, Constant) and isinstance(v.data, PackedQTensor)}
    assert {k: b for k, b in widths.items() if b != 8} == \
        {k: b for k, b in tplan.items() if k in widths}
    packed = tq([x])[0]
    TC.packed_execution = "kernel"
    try:
        kernel = tq([x])[0]
    finally:
        TC.packed_execution = "unpack"
    np.testing.assert_array_equal(packed, unpacked)
    np.testing.assert_array_equal(kernel, unpacked)


def test_mixed_width_state_carries_over(vit):
    plan = TS.plan_mixed_precision(_tm(vit), [vit["x"]], low_frac=0.5,
                                   stats=vit["stats"],
                                   per_channel_weights=True)
    kw = dict(stats=vit["stats"], bit_width=8, weight_bit_width=plan,
              per_channel_weights=True)
    jq = _jm(vit).quantize(**kw)
    tq = _tm(vit).quantize(**kw)
    consts = {}
    for v in jq.values:
        if isinstance(v, JConstant) and isinstance(v.data, JQTensor):
            zp = v.data.zero_point
            consts[v.name] = {"payload": np.asarray(v.data.data),
                              "scale": np.asarray(v.data.scale, np.float32),
                              "zero_point": None if zp is None else int(zp),
                              "bit_width": v.data.bit_width}
    state = {"constants": consts, "quant_params": {
        n: (np.asarray(qp.scale, np.float32),
            None if qp.zero_point is None else int(qp.zero_point))
        for n, qp in jq.quant_params.items()}}
    carried = _tm(vit).quantize(**kw)
    assert load_jax_params(carried, state) == len(consts)
    assert {v.name: v.data.bit_width for v in carried.values
            if v.name in plan} == plan
    np.testing.assert_array_equal(carried([vit["x"]])[0], tq([vit["x"]])[0])
