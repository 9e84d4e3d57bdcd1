"""Autoregressive decode through the KV-cache step graph.

Port of ``numpy_quant_tpu/utils/generate.py::generate_kv``,
``decode_calibration`` and ``_next_token`` over
``models/gpt.py::gpt_decode_step`` and ``models/llama.py::
llama_decode_step``. The JAX package compiles the whole loop into one XLA
program; here it is an eager Python loop over positions t. The caches are
device tensors [B, heads, L, head] (float32, or int8 under
``kv_cache_dtype="int8"``) written in place at slot t, the ids stay on the
device, and only the finished ids come back to the host.

Sampling draws its randomness from an explicit ``torch.Generator``:
``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel)``, so
the port adds Gumbel noise drawn from the generator and takes the argmax.
``jax.random`` streams cannot be matched, so the port takes no ``key``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quantization import quantize

_LATER = {
    "score_bias": "the T5 score-bias decode form is a later slice",
    "memory": "the seq2seq (Whisper) decode form is a later slice",
}

_NEG = -1e30  # the filters' masked logit, as in the JAX package


def _kv_layout(step_model, cache_start: int = 2):
    """(n_layer, batch, heads, max_len, head_dim) from the decode-step
    graph's input hints (gpt_decode_step input order; ``cache_start=4``
    for the RoPE form, models/llama.py::llama_decode_step, whose inputs
    insert cos_step/sin_step before the caches)."""
    n_layer = (len(step_model.inputs) - cache_start) // 2
    b, nh, length, hd = step_model.inputs[cache_start].shape_hint
    return n_layer, b, nh, length, hd


def _step_mask(t: int, length: int) -> np.ndarray:
    """[1, 1, 1, L+1] additive mask of step t: cache slots < t live, the
    rest -1e9; the last lane (the current token) always live."""
    mask = np.where(np.arange(length) < t, np.float32(0), np.float32(-1e9))
    mask = np.concatenate([mask, np.zeros((1,), np.float32)])
    return mask.astype(np.float32).reshape(1, 1, 1, length + 1)


def _placed_table(model, name: str, arr) -> torch.Tensor | None:
    """A device copy of an embedding or RoPE table, cached on the model by
    the source array's identity (the 154 MB GPT-2 wte is not re-uploaded
    per call); None stays None."""
    if arr is None:
        return None
    cache = model.__dict__.setdefault("_table_cache", {})
    hit = cache.get(name)
    if hit is not None and hit[0] is arr:
        return hit[1]
    dev = torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr, np.float32))).to(model.device)
    cache[name] = (arr, dev)
    return dev


def _refuse_unported(key, score_bias, memory) -> None:
    if key is not None:
        raise NotImplementedError(
            "jax.random keys are not taken: pass generator= (a seeded "
            "torch.Generator) for sampling")
    for name, value in (("score_bias", score_bias), ("memory", memory)):
        if value is not None:
            raise NotImplementedError(_LATER[name])


def _cache_start(rope) -> int:
    return 2 if rope is None else 4


def _divide(x: torch.Tensor, divisor) -> torch.Tensor:
    """x / divisor with the float32 divisor as a 0-d tensor: the IEEE
    quotient (CUDA's ``tensor / python_scalar`` multiplies by the
    reciprocal)."""
    return x / torch.full((), float(np.float32(divisor)), dtype=x.dtype,
                          device=x.device)


def _softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.softmax's composition: exp(x - max) / sum."""
    e = torch.exp(x - x.amax(dim=-1, keepdim=True))
    return e / e.sum(dim=-1, keepdim=True)


def _gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel noise -log(-log(u)) from ``generator``, with u
    uniform in [tiny, 1) as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    u = u.clamp_min(torch.finfo(torch.float32).tiny)
    return -torch.log(-torch.log(u))


def _sort_descending(x: torch.Tensor) -> torch.Tensor:
    """Indices sorting float32 rows in descending order as lax.top_k does:
    by IEEE total order (+0.0 above -0.0), equal values in index order (a
    stable sort of the order-preserving integer image of the bits)."""
    bits = x.to(torch.float32).contiguous().view(torch.int32)
    key = bits ^ ((bits >> 31) & 0x7FFFFFFF)
    return torch.sort(key, dim=-1, descending=True, stable=True).indices


def _filtered_logits(row: torch.Tensor, temperature, top_k, top_p,
                     min_p) -> torch.Tensor:
    """The [B, V] logits the categorical draw sees: divided by the
    temperature, then the top-k, min-p and top-p (nucleus) filters, each
    setting the tokens it drops to -1e30 (JAX ``_next_token``)."""
    logits = _divide(row, 1.0 if temperature is None else temperature)
    neg = torch.full((), _NEG, dtype=logits.dtype, device=logits.device)
    if top_k is not None:
        # ties at the k-th value all survive
        kth = torch.topk(logits, int(top_k), dim=-1).values[..., -1:]
        logits = torch.where(logits < kth, neg, logits)
    if min_p is not None:
        # keep tokens whose probability is >= min_p * the mode's
        # (arXiv:2407.01082); the mode always survives
        probs = _softmax(logits)
        cap = probs.amax(dim=-1, keepdim=True) * np.float32(min_p)
        logits = torch.where(probs < cap, neg, logits)
    if top_p is not None:
        # nucleus: keep the smallest prefix of the sorted distribution
        # whose mass reaches top_p (the first token always survives)
        sorted_idx = _sort_descending(logits)
        sorted_logits = torch.gather(logits, -1, sorted_idx)
        probs = _softmax(sorted_logits)
        cum = torch.cumsum(probs, dim=-1)
        drop = cum - probs > np.float32(top_p)
        masked = torch.where(drop, neg, sorted_logits)
        logits = torch.full_like(logits, _NEG).scatter(-1, sorted_idx,
                                                       masked)
    return logits


def _next_token(row: torch.Tensor, temperature=None, top_k=None,
                top_p=None, generator: torch.Generator = None, min_p=None,
                presence: torch.Tensor = None,
                repetition_penalty=None) -> torch.Tensor:
    """The next ids [B] of a [B, V] logit row: greedy argmax (the first
    maximum, as jnp.argmax) when no sampling knob is set, else the
    temperature/top-k/top-p/min-p filtered categorical draw, taken as
    argmax(logits + Gumbel noise from ``generator``).
    ``repetition_penalty`` (HF CTRL semantics: positive logits divide,
    negative multiply) applies first, to the tokens marked in the [B, V]
    ``presence`` mask; it composes with greedy decoding too."""
    if repetition_penalty is not None and presence is not None:
        penalized = torch.where(row > 0, _divide(row, repetition_penalty),
                                row * np.float32(repetition_penalty))
        row = torch.where(presence > 0, penalized, row)
    if temperature is None and top_k is None and top_p is None \
            and min_p is None:
        return torch.argmax(row, dim=-1)
    logits = _filtered_logits(row, temperature, top_k, top_p, min_p)
    noise = _gumbel(tuple(logits.shape), generator).to(logits.device)
    return torch.argmax(logits + noise, dim=-1)


def _cache_quantizer(step_model, kv_cache_dtype, cache_start: int):
    """(quantize-or-identity per cache, cache dtype) of ``kv_cache_dtype``:
    an int8 cache stores each present quantized with ITS cache input's
    calibrated params (quantization.quantize: the hand kernel on the
    card)."""
    if kv_cache_dtype is None:
        return [lambda x: x] * (len(step_model.inputs) - cache_start), \
            torch.float32
    if kv_cache_dtype != "int8":
        raise ValueError(f"kv_cache_dtype {kv_cache_dtype!r} not in "
                         "(None, 'int8')")
    qp_map = getattr(step_model, "quant_params", None)
    if qp_map is None:
        raise ValueError("kv_cache_dtype='int8' needs a quantized step "
                         "model (its calibrated cache params set the "
                         "storage scale)")
    if step_model.bit_width > 8:
        raise ValueError(f"an int8 cache holds at most 8 bits, not "
                         f"{step_model.bit_width}")

    def quantizer(qp):
        return lambda x: quantize(x, step_model.bit_width, qp.scale,
                                  qp.zero_point, container=torch.int8)
    return [quantizer(qp_map[v.name])
            for v in step_model.inputs[cache_start:]], torch.int8


@torch.inference_mode()
def generate_kv(step_model, prompt_ids: np.ndarray, wte: np.ndarray,
                wpe: np.ndarray, max_new_tokens: int,
                temperature: float = None, top_k: int = None,
                top_p: float = None, key=None,
                kv_cache_dtype: str = None, rope=None,
                score_bias: np.ndarray = None,
                memory: np.ndarray = None, min_p: float = None,
                repetition_penalty: float = None,
                generator: torch.Generator = None,
                step_logits: list = None) -> np.ndarray:
    """Autoregressive decode through the KV-cache step graph (float,
    weight-only or quantized model): one token per step at O(L) cost.
    Steps inside the prompt are teacher forced (their caches fill, their
    pick is dropped). Returns the ids [B, t0 + max_new_tokens], prompt
    included, as int32. When ``step_logits`` is a list, each step's logits
    [B, V] (a float32 device tensor) are appended to it.

    Greedy argmax by default; ``temperature``/``top_k``/``top_p``/
    ``min_p`` switch to filtered categorical sampling with noise from
    ``generator`` (a torch.Generator; a fresh one seeded 0 on the model's
    device when None). ``repetition_penalty`` down-weights tokens already
    in the row's sequence and composes with greedy decoding too.

    ``kv_cache_dtype="int8"`` (quantized step models only) stores the
    caches as int8, 4x fewer bytes than float32: each present is quantized
    with its cache input's calibrated params, and the executor takes the
    int8 input as pre-quantized. Quantization is idempotent, so the tokens
    equal the float-cache run's.

    ``rope=(cos, sin)`` (each [1, 1, L, head_dim], a llama step model's
    ``_rope_tables``) switches to the RoPE input layout: the position-t
    rows feed the graph's ``cos_step``/``sin_step`` inputs, and ``wpe``
    may be None.

    ``score_bias=`` and ``memory=`` (the T5 and Whisper step forms) raise
    ``NotImplementedError``, and so does a JAX PRNG ``key``."""
    _refuse_unported(key, score_bias, memory)
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    cache_start = _cache_start(rope)
    n_layer, b, nh, length, hd = _kv_layout(step_model, cache_start)
    if b != batch:
        raise ValueError(f"graph batch {b} != prompt batch {batch}")
    if t0 + max_new_tokens - 1 > length:
        raise ValueError(f"prompt {t0} + {max_new_tokens} new tokens "
                         f"exceeds the cache length {length}")
    q_cache, cache_dtype = _cache_quantizer(step_model, kv_cache_dtype,
                                            cache_start)
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    wpe_d = _placed_table(step_model, "wpe", wpe)
    rope_d = None if rope is None else (
        _placed_table(step_model, "rope_cos", rope[0]),
        _placed_table(step_model, "rope_sin", rope[1]))
    sampling = not (temperature is None and top_k is None and top_p is None
                    and min_p is None)
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    total = t0 + max_new_tokens
    ids = torch.zeros((batch, total), dtype=torch.int64, device=dev)
    ids[:, :t0] = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    # int8 caches start at quantize(0.0), the zero point: what the
    # executor's on-entry quantize makes of a float zero cache
    caches = [q(torch.zeros((batch, nh, length, hd), dtype=torch.float32,
                            device=dev)).to(cache_dtype) for q in q_cache]
    masks = torch.from_numpy(np.stack(
        [_step_mask(t, length) for t in range(max(total - 1, 1))])).to(dev)
    presence = None
    if repetition_penalty is not None:
        presence = torch.zeros((batch, wte_d.shape[0]), dtype=torch.float32,
                               device=dev)
        presence.scatter_(1, ids[:, :1], 1.0)
    for t in range(total - 1):
        x = wte_d[ids[:, t]]
        if wpe_d is not None:
            x = x + wpe_d[t]
        extra = [] if rope_d is None else [r[:, :, t:t + 1, :] for r in rope_d]
        outs = step_model([x[:, None, :], masks[t]] + extra + caches,
                          as_numpy=False)
        row = outs[0][:, 0, :]
        if step_logits is not None:
            step_logits.append(row)
        for cache, present, q in zip(caches, outs[1:], q_cache):
            cache[:, :, t:t + 1, :] = q(present)
        nxt = _next_token(row, temperature, top_k, top_p, generator, min_p,
                          presence, repetition_penalty)
        # teacher forcing: inside the prompt the next token is given
        if t + 1 >= t0:
            ids[:, t + 1] = nxt
        if presence is not None:
            presence.scatter_(1, ids[:, t + 1:t + 2], 1.0)
    return ids.cpu().numpy().astype(np.int32)


@torch.inference_mode()
def decode_calibration(step_model, prompt_ids: np.ndarray, wte: np.ndarray,
                       wpe: np.ndarray, rope=None) -> list:
    """Replay ``prompt_ids`` (teacher-forced) through the float decode step
    and return one input list per step, as device tensors: per-step
    calibration batches for quantizing the step graph. Compose with
    ``Model.calibration_stats`` and ``utils.merge_calibration_stats``,
    then ``quantize(stats=...)``. ``wpe`` and ``rope`` as in
    :func:`generate_kv`."""
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    n_layer, b, nh, length, hd = _kv_layout(step_model, _cache_start(rope))
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    wpe_d = _placed_table(step_model, "wpe", wpe)
    ids = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    caches = [torch.zeros((batch, nh, length, hd), dtype=torch.float32,
                          device=dev) for _ in range(2 * n_layer)]
    out = []
    for t in range(t0):
        x = wte_d[ids[:, t]]
        if wpe_d is not None:
            x = x + wpe_d[t]
        mask = torch.from_numpy(_step_mask(t, length)).to(dev)
        extra = [] if rope is None else [
            torch.from_numpy(np.ascontiguousarray(
                r[:, :, t:t + 1, :], np.float32)).to(dev) for r in rope]
        inputs = [x[:, None, :], mask] + extra + [c.clone() for c in caches]
        out.append(inputs)
        res = step_model(inputs, as_numpy=False)
        for cache, present in zip(caches, res[1:]):
            cache[:, :, t:t + 1, :] = present
    return out
