"""GPT-2 small with weight-only W4 g=128 products (gpt2_small_w4.json),
served greedily by the program's continuous-batching engine: built and
quantized through the program's entry points, the work of its products,
and the comparison with the plain reference."""
from __future__ import annotations

import contextlib
from types import SimpleNamespace

import numpy as np
import torch

from benchmark.common import traffic
from benchmark.reference.gpt2_w4 import GPT2W4


def weights(spec: dict, seed: int, device) -> dict:
    """A seeded GPT2LMHeadModel state dict (HF keys), drawn on ``device``
    in one call and handed over as host float32 arrays."""
    d, layers = spec["n_embd"], spec["n_layer"]
    std = float(spec["initializer_range"])
    proj_std = std / np.sqrt(2 * layers)
    drawn = {"transformer.wte.weight": ((spec["vocab_size"], d), std),
             "transformer.wpe.weight": ((spec["n_positions"], d), std)}
    zeros, ones = {}, {}
    for i in range(layers):
        k = f"transformer.h.{i}"
        for part, shape, s in (("attn.c_attn", (d, 3 * d), std),
                               ("attn.c_proj", (d, d), proj_std),
                               ("mlp.c_fc", (d, 4 * d), std),
                               ("mlp.c_proj", (4 * d, d), proj_std)):
            drawn[f"{k}.{part}.weight"] = (shape, s)
            zeros[f"{k}.{part}.bias"] = (shape[1],)
        for ln in ("ln_1", "ln_2"):
            ones[f"{k}.{ln}.weight"] = (d,)
            zeros[f"{k}.{ln}.bias"] = (d,)
    ones["transformer.ln_f.weight"] = (d,)
    zeros["transformer.ln_f.bias"] = (d,)
    gen = torch.Generator(device=device)
    gen.manual_seed(traffic.stream_seed(seed, "weights"))
    sizes = [int(np.prod(s)) for s, _ in drawn.values()]
    flat = torch.empty(sum(sizes), dtype=torch.float32, device=device)
    flat.normal_(0.0, 1.0, generator=gen)
    at = 0
    for (shape, s), size in zip(drawn.values(), sizes):
        flat[at:at + size] *= s
        at += size
    flat = flat.cpu().numpy()
    out, at = {}, 0
    for (key, (shape, _)), size in zip(drawn.items(), sizes):
        out[key] = flat[at:at + size].reshape(shape)
        at += size
    out.update({k: np.zeros(s, np.float32) for k, s in zeros.items()})
    out.update({k: np.ones(s, np.float32) for k, s in ones.items()})
    out["lm_head.weight"] = out["transformer.wte.weight"]
    return out


class Work:
    """Operations of the model's products over live context, 2 per
    multiply-add: the blocks' Linear products, the tied head and the two
    attention products of each token against the keys it attends to."""

    def __init__(self, spec: dict):
        d, layers = spec["n_embd"], spec["n_layer"]
        self.linear = 2.0 * layers * (d * 3 * d + d * d + 2 * d * 4 * d)
        self.head = 2.0 * d * spec["vocab_size"]
        self.attn = 4.0 * layers * d    # per key attended

    def decode_flops(self, keys: int) -> float:
        """One decoded token attending to ``keys`` keys (itself too)."""
        return self.linear + self.head + self.attn * keys

    def prefill_flops(self, plen: int) -> float:
        """A prompt of ``plen`` tokens: every token through the blocks,
        token i attending to i keys, the head on the last row alone (the
        first token comes from it)."""
        return plen * self.linear + self.head \
            + self.attn * plen * (plen + 1) / 2


def wo_products(spec: dict, rows: int) -> list:
    """The weight-only products of one call of ``rows`` rows as the
    program launches them (49 on GPT-2: four a block and the head): f32 x,
    4-bit weight, its float32 group scales, f32 y; float32 products."""
    d, layers = spec["n_embd"], spec["n_layer"]
    q = spec["quantize_weights"]
    g = q["group_size"]

    def prod(k, n, count):
        return dict(m=rows, k=k, n=n, count=count, x_bytes=4,
                    w_bits=q["bit_width"], out_bytes=4,
                    scale_bytes=4.0 * n * (k // g), precision="f32")

    return [prod(d, 3 * d, layers), prod(d, d, layers),
            prod(d, 4 * d, layers), prod(4 * d, d, layers),
            prod(d, spec["vocab_size"], 1)]


def build(spec: dict, mix: dict, seed: int, device):
    from numpy_quant_tpu_torch import Model, config
    from numpy_quant_tpu_torch.models.gpt import gpt_decode_step, gpt_prefill
    from numpy_quant_tpu_torch.utils.serving import ContinuousBatcher
    w = weights(spec, seed, device)
    sv, q = spec["serving"], spec["quantize_weights"]
    # the published keys, with what the configuration's ``assumed`` says
    # the program runs in their place
    cfg = dict(spec, **spec.get("substituted", {}))
    step_proto = gpt_decode_step(w, cfg, batch_size=sv["slots"],
                                 max_len=sv["cache_len"])
    step = Model.from_onnx(step_proto, device=device)
    step.quantize_weights(**q)
    prefill = Model.from_onnx(gpt_prefill(w, cfg, sv["prefill_len"]),
                              device=device)
    prefill.quantize_weights(**q)
    config.packed_execution = spec["packed_execution"]
    engine = ContinuousBatcher(step, step_proto._wte, step_proto._wpe,
                               prefill_model=prefill)
    return SimpleNamespace(engine=engine, device=device, weights=w,
                           vocab=spec["vocab_size"], work=Work(spec),
                           mode=contextlib.nullcontext)


def free(system) -> dict:
    """Drops the program; returns what the check keeps: the benchmark's
    own weights."""
    kept = {"weights": system.weights}
    system.engine = None
    return kept


def served_gaps(ref: GPT2W4, requests: list, control: bool = False) -> float:
    """The widest gap by which a served token's reference logit lies below
    the reference's best, over ``requests`` [(prompt, prompt + served)].
    ``control``: the tokens are those the TF32 reference puts first at
    each served position instead. No request to judge reads infinite."""
    if not requests:
        return float("inf")
    worst = 0.0
    for prompt, tokens in requests:
        p = prompt.size
        rows = slice(p - 1, tokens.size - 1)
        want = ref.logits(tokens[:-1], rows=rows)
        if control:
            got = ref.logits(tokens[:-1], tf32_products=True,
                             rows=rows).argmax(-1)
        else:
            got = torch.as_tensor(tokens[p:].astype(np.int64),
                                  device=want.device)
        gap = want.max(-1).values - want.gather(1, got[:, None])[:, 0]
        worst = max(worst, float(gap.max()))
    return worst


def check(spec: dict, mix: dict, kept: dict, record, seed: int,
          device) -> list:
    ref = GPT2W4(kept["weights"], spec, device,
                 bits=spec["quantize_weights"]["bit_width"],
                 group=spec["quantize_weights"]["group_size"])
    gap = served_gaps(ref, record.sample["requests"])
    return [(spec["check"]["name"], gap, spec["check"]["limit"])]
