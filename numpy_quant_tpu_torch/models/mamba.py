"""Mamba-style selective state-space (SSM) ONNX graphs, built from numpy
weights.

Port of ``numpy_quant_tpu/models/mamba.py``: node for node, from a state
dict in HuggingFace's ``MambaForCausalLM`` key names
(``backbone.layers.{i}.mixer.in_proj.weight``, ...). Each layer mixes
tokens through a causal depthwise Conv1d and the selective recurrence

    h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * x_t
    y_t = C_t . h_t + D * x_t

whose (dt, B, C) are projections of the input. At the graph's fixed length
the recurrence unrolls into L steps of elementwise ops plus one
[B, d_inner, state] x [B, state, 1] MatMul each, HF's
``MambaMixer.slow_forward`` op for op. The causal conv is the rank-3 Conv
path with left-only padding [k-1, 0]. The projections (in/x/dt/out) and
the per-step products are MatMuls, which int8 PTQ quantizes; the
recurrence's elementwise ops stay float.

``mamba_decode_step`` is the one-token form: it carries a conv window
[B, d_inner, k-1] and an SSM state [B, d_inner, state] per layer, which
the caller swaps in wholesale each step (``utils.generate_mamba``).
"""
from __future__ import annotations

import numpy as np

from .. import onnx as O
from ..onnx.builder import GraphBuilder
from .llama import _matmul_w, _rms_norm
from .vit import _f32

# state-spaces/mamba-130m-hf (huggingface.co/state-spaces/mamba-130m-hf/
# config.json): d_model 768, 24 layers, d_state 16, expand 2 (d_inner
# 1536), conv 4, dt_rank ceil(768 / 16) = 48, the head tied to the
# embedding
MAMBA_130M = {
    "vocab_size": 50280, "hidden_size": 768, "num_hidden_layers": 24,
    "state_size": 16, "expand": 2, "conv_kernel": 4, "time_step_rank": 48,
    "layer_norm_epsilon": 1e-5, "initializer_range": 0.02,
    "time_step_min": 0.001, "time_step_max": 0.1,
    "time_step_floor": 1e-4, "tie_word_embeddings": True,
}


def tiny_config() -> dict:
    """The tiny Mamba of the JAX package's tests: hidden 32, state 4, 2
    layers, conv 4, expand 2, dt rank 8, vocabulary 96."""
    return dict(MAMBA_130M, vocab_size=96, hidden_size=32, state_size=4,
                num_hidden_layers=2, conv_kernel=4, expand=2,
                time_step_rank=8)


def _dims(cfg: dict) -> tuple[int, int, int, int]:
    """(d_inner, d_state, dt_rank, conv kernel)."""
    return (int(cfg["expand"]) * int(cfg["hidden_size"]),
            int(cfg["state_size"]), int(cfg["time_step_rank"]),
            int(cfg["conv_kernel"]))


def _silu(g: GraphBuilder, x: str, name: str) -> str:
    sig = g.node("Sigmoid", [x], out=f"{name}/Sigmoid_out")
    return g.node("Mul", [x, sig], out=f"{name}/SiLU_out")


def _in_proj(g: GraphBuilder, w: dict, x: str, key: str, d_inner: int,
             name: str) -> tuple[str, str, str, str, str]:
    """in_proj into the channel-first layout, split into (states, gate);
    returns them with the zero/axis constants the callers reuse."""
    proj = _matmul_w(g, x, w[f"{key}.in_proj.weight"], f"{name}.in_proj")
    proj = g.node("Transpose", [proj], out=f"{name}/proj_T", perm=[0, 2, 1])
    z0 = g.const(np.array([0], dtype=np.int64), "mb_zero")
    di = g.const(np.array([d_inner], dtype=np.int64), f"mb_di{d_inner}")
    di2 = g.const(np.array([2 * d_inner], dtype=np.int64),
                  f"mb_di2{d_inner}")
    ax1 = g.const(np.array([1], dtype=np.int64), "mb_ax1")
    return proj, z0, di, di2, ax1


def _x_proj(g: GraphBuilder, w: dict, hs: str, key: str, dims: tuple,
            name: str) -> tuple[str, str, str, str]:
    """x_proj of the conv output ([B, L, dt_rank + 2 state]) with the
    bounds of its (dt | B | C) split."""
    _, d_state, dt_rank, _ = dims
    hs_t = g.node("Transpose", [hs], out=f"{name}/hs_T", perm=[0, 2, 1])
    ssm = _matmul_w(g, hs_t, w[f"{key}.x_proj.weight"], f"{name}.x_proj")
    dtr = g.const(np.array([dt_rank], dtype=np.int64), f"mb_dtr{dt_rank}")
    dbs = g.const(np.array([dt_rank + d_state], dtype=np.int64),
                  f"mb_dbs{dt_rank + d_state}")
    dbc = g.const(np.array([dt_rank + 2 * d_state], dtype=np.int64),
                  f"mb_dbc{dt_rank + 2 * d_state}")
    return ssm, dtr, dbs, dbc


def _mamba_mixer(g: GraphBuilder, w: dict, x: str, key: str, dims: tuple,
                 seq_len: int, name: str) -> str:
    """MambaMixer.slow_forward: in_proj -> (states | gate), causal
    depthwise conv + SiLU, x_proj -> (dt | B | C), softplus(dt_proj),
    L-step unrolled selective scan, D skip, SiLU gate, out_proj."""
    d_inner, d_state, dt_rank, k = dims
    proj, z0, di, di2, ax1 = _in_proj(g, w, x, key, d_inner, name)
    hs = g.node("Slice", [proj, z0, di, ax1], out=f"{name}/states")
    gate = g.node("Slice", [proj, di, di2, ax1], out=f"{name}/gate")

    # causal depthwise conv: left-pad k-1 (== HF pad-both + [:L] slice)
    cw = g.init(f"{name}.conv1d.weight", _f32(w[f"{key}.conv1d.weight"]))
    cb = g.init(f"{name}.conv1d.bias", _f32(w[f"{key}.conv1d.bias"]))
    conv = g.node("Conv", [hs, cw, cb], out=f"{name}/conv",
                  pads=[k - 1, 0], strides=[1], dilations=[1], group=d_inner)
    hs = _silu(g, conv, f"{name}/conv_act")             # [B, di, L]

    ssm, dtr, dbs, dbc = _x_proj(g, w, hs, key, dims, name)
    ax2 = g.const(np.array([2], dtype=np.int64), "mb_ax2")
    dt_in = g.node("Slice", [ssm, z0, dtr, ax2], out=f"{name}/dt_in")
    Bm = g.node("Slice", [ssm, dtr, dbs, ax2], out=f"{name}/B")   # [B,L,S]
    Cm = g.node("Slice", [ssm, dbs, dbc, ax2], out=f"{name}/C")   # [B,L,S]
    dt = _dt(g, w, dt_in, key, name)                     # [B, di, L]

    # discrete_A = exp(A * dt): A = -exp(A_log) [di, S]
    A = -np.exp(_f32(w[f"{key}.A_log"]))
    Ac = g.init(f"{name}.A", A[None, :, None, :])        # [1, di, 1, S]
    sh4 = g.const(np.array([0, d_inner, seq_len, 1], dtype=np.int64),
                  f"mb_dt4{d_inner}x{seq_len}")
    dt4 = g.node("Reshape", [dt, sh4], out=f"{name}/dt4")  # [B,di,L,1]
    dA = g.node("Mul", [dt4, Ac], out=f"{name}/dtA")
    dA = g.node("Exp", [dA], out=f"{name}/discrete_A")   # [B,di,L,S]
    # discrete_B * u = dt * B * x
    shB = g.const(np.array([0, 1, seq_len, d_state], dtype=np.int64),
                  f"mb_B4{seq_len}x{d_state}")
    B4 = g.node("Reshape", [Bm, shB], out=f"{name}/B4")  # [B,1,L,S]
    dB = g.node("Mul", [dt4, B4], out=f"{name}/discrete_B")
    shu = g.const(np.array([0, d_inner, seq_len, 1], dtype=np.int64),
                  f"mb_u4{d_inner}x{seq_len}")
    u4 = g.node("Reshape", [hs, shu], out=f"{name}/u4")  # [B,di,L,1]
    dBu = g.node("Mul", [dB, u4], out=f"{name}/deltaB_u")  # [B,di,L,S]

    # the selective recurrence, unrolled over the static L
    outs = []
    h = None
    for t in range(seq_len):
        t0 = g.const(np.array([t], dtype=np.int64), f"mb_t{t}")
        t1 = g.const(np.array([t + 1], dtype=np.int64), f"mb_t{t + 1}")
        dA_t = g.node("Slice", [dA, t0, t1, ax2], out=f"{name}/dA_{t}")
        dBu_t = g.node("Slice", [dBu, t0, t1, ax2], out=f"{name}/dBu_{t}")
        if h is None:
            h = dBu_t                                    # h_0 = dBu_0
        else:
            decayed = g.node("Mul", [dA_t, h], out=f"{name}/decay_{t}")
            h = g.node("Add", [decayed, dBu_t], out=f"{name}/h_{t}")
        # y_t = h_t . C_t : [B,di,S] @ [B,S,1]
        sh3 = g.const(np.array([0, d_inner, d_state], dtype=np.int64),
                      f"mb_h3{d_inner}x{d_state}")
        h3 = g.node("Reshape", [h, sh3], out=f"{name}/h3_{t}")
        C_t = g.node("Slice", [Cm, t0, t1, ax1], out=f"{name}/C_{t}")
        shc = g.const(np.array([0, d_state, 1], dtype=np.int64),
                      f"mb_c3{d_state}")
        C3 = g.node("Reshape", [C_t, shc], out=f"{name}/C3_{t}")
        outs.append(g.node("MatMul", [h3, C3], out=f"{name}/y_{t}"))
    scan = outs[0] if len(outs) == 1 else g.node(
        "Concat", outs, out=f"{name}/scan", axis=-1)     # [B,di,L]

    # D skip + gate + out_proj
    D = g.init(f"{name}.D", _f32(w[f"{key}.D"])[None, :, None])  # [1,di,1]
    skip = g.node("Mul", [hs, D], out=f"{name}/D_skip")
    scan = g.node("Add", [scan, skip], out=f"{name}/scan_skip")
    zact = _silu(g, gate, f"{name}/gate_act")
    gated = g.node("Mul", [scan, zact], out=f"{name}/gated")
    gated = g.node("Transpose", [gated], out=f"{name}/gated_T",
                   perm=[0, 2, 1])                        # [B,L,di]
    return _matmul_w(g, gated, w[f"{key}.out_proj.weight"],
                     f"{name}.out_proj")


def _dt(g: GraphBuilder, w: dict, dt_in: str, key: str, name: str) -> str:
    """dt_proj + its bias, softplus, transposed to [B, d_inner, L]."""
    dt = _matmul_w(g, dt_in, w[f"{key}.dt_proj.weight"], f"{name}.dt_proj")
    dtb = g.init(f"{name}.dt_proj.bias", _f32(w[f"{key}.dt_proj.bias"]))
    dt = g.node("Add", [dt, dtb], out=f"{name}/dt_bias")
    dt = g.node("Softplus", [dt], out=f"{name}/dt")
    return g.node("Transpose", [dt], out=f"{name}/dt_T", perm=[0, 2, 1])


def _head(g: GraphBuilder, w: dict, h: str, cfg: dict) -> None:
    """norm_f and the LM head (tied: the embedding's transpose unless the
    state dict holds its own lm_head.weight), into ``logits``."""
    h = _rms_norm(g, h, w["backbone.norm_f.weight"],
                  float(cfg["layer_norm_epsilon"]), "norm_f")
    head = w.get("lm_head.weight", w["backbone.embeddings.weight"])
    head = g.init("lm_head.weight_t", np.ascontiguousarray(_f32(head).T))
    g.node("MatMul", [h, head], out="logits", name="lm_head")


def _finish(g: GraphBuilder, w: dict) -> O.ModelProto:
    model = g.model()
    model._wte = _f32(w["backbone.embeddings.weight"])
    return model


def mamba_causal_lm(weights: dict, config: dict, batch_size: int = 2,
                    seq_len: int = 8) -> O.ModelProto:
    """MambaForCausalLM over float ``inputs_embeds`` [B, L, H] -> ``logits``
    [B, L, V]. No positions of any kind (the conv and the scan carry the
    order); ``_wte`` rides on the proto. ``config``: HF MambaConfig's
    field names (``MAMBA_130M``)."""
    cfg = dict(MAMBA_130M, **config)
    dims = _dims(cfg)
    eps = float(cfg["layer_norm_epsilon"])
    g = GraphBuilder("mamba_causal_lm")
    h = g.input("inputs_embeds", [batch_size, seq_len,
                                  int(cfg["hidden_size"])])
    for i in range(int(cfg["num_hidden_layers"])):
        key, name = f"backbone.layers.{i}", f"layers.{i}"
        ln = _rms_norm(g, h, weights[f"{key}.norm.weight"], eps,
                       f"{name}.norm")
        mix = _mamba_mixer(g, weights, ln, f"{key}.mixer", dims, seq_len,
                           f"{name}.mixer")
        h = g.node("Add", [h, mix], out=f"{name}/residual")
    _head(g, weights, h, cfg)
    g.output("logits", [batch_size, seq_len, int(cfg["vocab_size"])])
    return _finish(g, weights)


def _mamba_mixer_step(g: GraphBuilder, w: dict, x: str, key: str,
                      dims: tuple, layer: int,
                      name: str) -> tuple[str, str, str]:
    """One-token MambaMixer against the carried (conv window, SSM state).
    Returns (mixed, new_conv_state, new_ssm_state)."""
    d_inner, d_state, dt_rank, k = dims
    proj, z0, di, di2, ax1 = _in_proj(g, w, x, key, d_inner, name)
    ax2 = g.const(np.array([2], dtype=np.int64), "mb_ax2")
    hs = g.node("Slice", [proj, z0, di, ax1], out=f"{name}/states")
    gate = g.node("Slice", [proj, di, di2, ax1], out=f"{name}/gate")

    # slide the conv window: [prev k-1 | current] -> conv over k taps
    window = g.node("Concat", [f"conv_state.{layer}", hs],
                    out=f"{name}/window", axis=-1)       # [B, di, k]
    one = g.const(np.array([1], dtype=np.int64), "mb_one")
    kk = g.const(np.array([k], dtype=np.int64), f"mb_k{k}")
    new_conv = g.node("Slice", [window, one, kk, ax2],
                      out=f"{name}/new_conv_state")      # [B, di, k-1]
    cw = g.init(f"{name}.conv1d.weight", _f32(w[f"{key}.conv1d.weight"]))
    cb = g.init(f"{name}.conv1d.bias", _f32(w[f"{key}.conv1d.bias"]))
    conv = g.node("Conv", [window, cw, cb], out=f"{name}/conv",
                  pads=[0, 0], strides=[1], dilations=[1],
                  group=d_inner)                         # [B, di, 1]
    hs = _silu(g, conv, f"{name}/conv_act")

    ssm, dtr, dbs, dbc = _x_proj(g, w, hs, key, dims, name)
    dt_in = g.node("Slice", [ssm, z0, dtr, ax2], out=f"{name}/dt_in")
    Bm = g.node("Slice", [ssm, dtr, dbs, ax2], out=f"{name}/B")  # [B,1,S]
    Cm = g.node("Slice", [ssm, dbs, dbc, ax2], out=f"{name}/C")  # [B,1,S]
    dt = _dt(g, w, dt_in, key, name)                      # [B, di, 1]

    A = -np.exp(_f32(w[f"{key}.A_log"]))
    Ac = g.init(f"{name}.A", A[None])                     # [1, di, S]
    dA = g.node("Mul", [dt, Ac], out=f"{name}/dtA")       # [B, di, S]
    dA = g.node("Exp", [dA], out=f"{name}/discrete_A")
    dB = g.node("Mul", [dt, Bm], out=f"{name}/discrete_B")  # [B, di, S]
    dBu = g.node("Mul", [dB, hs], out=f"{name}/deltaB_u")   # hs [B,di,1]

    decayed = g.node("Mul", [dA, f"ssm_state.{layer}"],
                     out=f"{name}/decayed")
    new_ssm = g.node("Add", [decayed, dBu], out=f"{name}/new_ssm_state")

    shc = g.const(np.array([0, d_state, 1], dtype=np.int64),
                  f"mb_c3{d_state}")
    C3 = g.node("Reshape", [Cm, shc], out=f"{name}/C3")   # [B, S, 1]
    y = g.node("MatMul", [new_ssm, C3], out=f"{name}/y")  # [B, di, 1]
    D = g.init(f"{name}.D", _f32(w[f"{key}.D"])[None, :, None])
    skip = g.node("Mul", [hs, D], out=f"{name}/D_skip")
    y = g.node("Add", [y, skip], out=f"{name}/y_skip")
    zact = _silu(g, gate, f"{name}/gate_act")
    gated = g.node("Mul", [y, zact], out=f"{name}/gated")
    gated = g.node("Transpose", [gated], out=f"{name}/gated_T",
                   perm=[0, 2, 1])                         # [B, 1, di]
    return (_matmul_w(g, gated, w[f"{key}.out_proj.weight"],
                      f"{name}.out_proj"), new_conv, new_ssm)


def mamba_decode_step(weights: dict, config: dict,
                      batch_size: int = 2) -> O.ModelProto:
    """The O(1)/token decode form of :func:`mamba_causal_lm`. Inputs, in
    order: ``x_step`` [B, 1, H], then ``conv_state.i`` [B, d_inner, k-1]
    and ``ssm_state.i`` [B, d_inner, state] per layer. Outputs: ``logits``
    [B, 1, V], then ``conv_state_out.i``/``ssm_state_out.i``, which the
    caller swaps in wholesale (no positions, no masks). The same weights
    give the full form's function."""
    cfg = dict(MAMBA_130M, **config)
    dims = _dims(cfg)
    d_inner, d_state, _, k = dims
    eps = float(cfg["layer_norm_epsilon"])
    layers = int(cfg["num_hidden_layers"])
    conv_shape = [batch_size, d_inner, k - 1]
    ssm_shape = [batch_size, d_inner, d_state]
    g = GraphBuilder("mamba_decode_step")
    h = g.input("x_step", [batch_size, 1, int(cfg["hidden_size"])])
    for i in range(layers):
        g.input(f"conv_state.{i}", conv_shape)
        g.input(f"ssm_state.{i}", ssm_shape)

    states = []
    for i in range(layers):
        key, name = f"backbone.layers.{i}", f"layers.{i}"
        ln = _rms_norm(g, h, weights[f"{key}.norm.weight"], eps,
                       f"{name}.norm")
        mix, cs, ss = _mamba_mixer_step(g, weights, ln, f"{key}.mixer", dims,
                                        i, f"{name}.mixer")
        states.append((cs, ss))
        h = g.node("Add", [h, mix], out=f"{name}/residual")
    _head(g, weights, h, cfg)
    g.output("logits", [batch_size, 1, int(cfg["vocab_size"])])
    for i, (cs, ss) in enumerate(states):
        g.node("Identity", [cs], out=f"conv_state_out.{i}",
               name=f"conv_out_id.{i}")
        g.node("Identity", [ss], out=f"ssm_state_out.{i}",
               name=f"ssm_out_id.{i}")
        g.output(f"conv_state_out.{i}", conv_shape)
        g.output(f"ssm_state_out.{i}", ssm_shape)
    return _finish(g, weights)


def random_mamba_weights(config: dict, seed: int = 0) -> dict[str, np.ndarray]:
    """A MambaForCausalLM state dict drawn like HF's init: normal(0,
    ``initializer_range``) embedding and projections (out_proj scaled by
    1/sqrt(layers)), A_log = log(1..state) per channel, D = 1, dt_proj
    weights uniform in +-dt_rank^-0.5 and its bias the inverse softplus of
    a log-uniform dt in [time_step_min, time_step_max], the conv's weights
    and bias uniform in +-1/sqrt(k), RMSNorm weights 1. The head is tied:
    no lm_head.weight."""
    cfg = dict(MAMBA_130M, **config)
    d_inner, d_state, dt_rank, k = _dims(cfg)
    hid = int(cfg["hidden_size"])
    layers = int(cfg["num_hidden_layers"])
    rng = np.random.default_rng(seed)
    std = np.float32(cfg["initializer_range"])

    def normal(*shape):
        return rng.standard_normal(shape, dtype=np.float32) * std

    def uniform(bound, *shape):
        return rng.uniform(-bound, bound, shape).astype(np.float32)

    w = {"backbone.embeddings.weight": normal(int(cfg["vocab_size"]), hid)}
    a_log = np.log(np.tile(np.arange(1, d_state + 1, dtype=np.float32),
                           (d_inner, 1)))
    for i in range(layers):
        key = f"backbone.layers.{i}.mixer"
        w[f"backbone.layers.{i}.norm.weight"] = np.ones(hid, np.float32)
        w[f"{key}.A_log"] = a_log.copy()
        w[f"{key}.D"] = np.ones(d_inner, np.float32)
        w[f"{key}.conv1d.weight"] = uniform(k ** -0.5, d_inner, 1, k)
        w[f"{key}.conv1d.bias"] = uniform(k ** -0.5, d_inner)
        w[f"{key}.in_proj.weight"] = normal(2 * d_inner, hid)
        w[f"{key}.x_proj.weight"] = normal(dt_rank + 2 * d_state, d_inner)
        w[f"{key}.dt_proj.weight"] = uniform(dt_rank ** -0.5, d_inner,
                                             dt_rank)
        lo, hi = np.log(cfg["time_step_min"]), np.log(cfg["time_step_max"])
        dt = np.exp(rng.uniform(lo, hi, d_inner))
        dt = np.maximum(dt, cfg["time_step_floor"])
        w[f"{key}.dt_proj.bias"] = (dt + np.log(-np.expm1(-dt))) \
            .astype(np.float32)
        w[f"{key}.out_proj.weight"] = normal(hid, d_inner) \
            / np.float32(np.sqrt(layers))
    w["backbone.norm_f.weight"] = np.ones(hid, np.float32)
    return w
