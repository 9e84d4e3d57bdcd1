"""Autoregressive decode through the KV-cache step graph, over the
full-sequence causal graph and over an encoder-decoder pair.

Port of ``numpy_quant_tpu/utils/generate.py::generate_kv``,
``decode_calibration``, ``_next_token``, ``generate``, ``beam_search``,
``generate_speculative``, ``generate_seq2seq``, ``generate_mamba`` and
``mamba_decode_calibration`` over ``models/gpt.py``, ``models/llama.py``,
``models/moe.py``, ``models/t5.py``, ``models/seq2seq.py``,
``models/whisper.py`` and ``models/mamba.py``.
The JAX package compiles each loop into one XLA program; here each is an
eager Python loop. ``generate_kv``'s caches are device tensors
[B, heads, L, head] (float32, or int8 under ``kv_cache_dtype="int8"``)
written in place at slot t; the full-sequence loops run the graph at its
fixed length every step. The ids stay on the device, and only the finished
ids come back to the host.

Sampling draws its randomness from an explicit ``torch.Generator``:
``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel)``, so
the port adds Gumbel noise drawn from the generator and takes the argmax.
``jax.random`` streams cannot be matched, so the port takes no ``key``.
"""
from __future__ import annotations

import numpy as np
import torch

from ..quantization import quantize

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


def _kv_buffers(step_model, q_cache: list, shape: tuple,
                cache_dtype) -> list:
    """The decode's KV caches, kept on the model from one decode to the
    next: the captured step graph reads them in place (``inplace=``), so
    it is captured once, not once per decode. Each starts at its cache
    input's quantize(0.0): the zero point for int8 caches, what the
    executor's on-entry quantize makes of a float zero cache."""
    cache = step_model.__dict__.setdefault("_kv_buffers", {})
    key = (shape, cache_dtype, len(q_cache))
    bufs = cache.get(key)
    if bufs is None:
        bufs = [torch.empty(shape, dtype=cache_dtype,
                            device=step_model.device) for _ in q_cache]
        cache[key] = bufs
    zeros = torch.zeros(shape, dtype=torch.float32, device=step_model.device)
    for buf, q in zip(bufs, q_cache):
        buf.copy_(q(zeros))
    return bufs


def _refuse_key(key) -> None:
    if key is not None:
        raise NotImplementedError(
            "jax.random keys are not taken: pass generator= (a seeded "
            "torch.Generator) for sampling")


def _cache_start(step_model, rope=None, score_bias=False,
                 memory=False) -> int:
    """Index of the first cache input of the step graph's layout: x_step,
    attn_mask, then cos_step/sin_step (RoPE), score_bias (T5) and
    encoder_memory (seq2seq) where given. Raises ValueError where the
    graph's inputs are not that layout."""
    layout = ((["cos_step", "sin_step"] if rope is not None else [])
              + (["score_bias"] if score_bias else [])
              + (["encoder_memory"] if memory else []))
    start = 2 + len(layout)
    names = [v.name for v in step_model.inputs]
    if names[2:start] != layout or not names[start].startswith("past_"):
        raise ValueError(f"the step graph's inputs {names[2:start + 1]} "
                         f"after x_step and attn_mask are not the layout "
                         f"{layout} + caches the arguments give")
    return start


def _memory_buffer(model, name: str, shape: tuple) -> torch.Tensor:
    """A float32 device buffer kept on ``model`` for an input the captured
    forward reads in place (an encoder memory, a decoder's embeddings): one
    address from call to call, so the forward is captured once."""
    cache = model.__dict__.setdefault("_input_buffers", {})
    buf = cache.get((name, shape))
    if buf is None:
        buf = torch.zeros(shape, dtype=torch.float32, device=model.device)
        cache[(name, shape)] = buf
    return buf


def _placed_memory(step_model, memory, cache_start: int) -> torch.Tensor:
    """The step model's ``encoder_memory`` buffer holding ``memory``."""
    hint = tuple(int(d) for d in step_model.inputs[cache_start - 1].shape_hint)
    buf = _memory_buffer(step_model, "encoder_memory", hint)
    buf.copy_(_as_device(memory, step_model.device).reshape(hint))
    return buf


def _as_device(arr, device) -> torch.Tensor:
    """A float32 tensor on ``device`` of a numpy array or tensor."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.float32)
    return torch.from_numpy(np.ascontiguousarray(arr, np.float32)).to(device)


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
                repetition_penalty=None, noise=None) -> torch.Tensor:
    """The next ids [B] of a [B, V] logit row: greedy argmax (the first
    maximum, as jnp.argmax) when no sampling knob is set, else the
    temperature/top-k/top-p/min-p filtered categorical draw, taken as
    argmax(logits + Gumbel noise from ``generator``, or the [B, V]
    ``noise`` given, drawn so before). ``repetition_penalty`` (HF CTRL
    semantics: positive logits divide, negative multiply) applies first,
    to the tokens marked in the [B, V] ``presence`` mask; it composes with
    greedy decoding too."""
    if repetition_penalty is not None and presence is not None:
        penalized = torch.where(row > 0, _divide(row, repetition_penalty),
                                row * np.float32(repetition_penalty))
        row = torch.where(presence > 0, penalized, row)
    if temperature is None and top_k is None and top_p is None \
            and min_p is None:
        return torch.argmax(row, dim=-1)
    logits = _filtered_logits(row, temperature, top_k, top_p, min_p)
    if noise is None:
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


def _step_masks(steps: int, length: int, device) -> torch.Tensor:
    """[steps, 1, 1, 1, L+1]: :func:`_step_mask` of each step, on
    ``device``."""
    return torch.from_numpy(np.stack(
        [_step_mask(t, length) for t in range(max(steps, 1))])).to(device)


def _kv_step(forward, tables: dict, ids: torch.Tensor, caches: list,
             presence, pos: torch.Tensor, t0: int, q_cache: list,
             knobs: dict, noise=None, generator=None, functional=False):
    """One step of :func:`generate_kv` at position t, held in ``pos`` (an
    int64 [1] device tensor, so that a traced loop reads every row by it:
    utils/aot.py): the embedding and position rows of the token at t, the
    step mask, RoPE and score-bias rows, ``forward`` over them and the
    caches, the presents written into the caches at t, the next token
    (teacher forced inside the prompt of ``t0`` tokens) written into
    ``ids`` at t + 1, and the presence mask updated. ``tables``: wte, wpe,
    masks, rope, bias (None where not used) and memory (a list). Returns
    (logit row [B, V], ids, caches, presence): new tensors when
    ``functional``, else the ones given, written in place."""
    x = tables["wte"].index_select(0, ids.index_select(1, pos).reshape(-1))
    if tables["wpe"] is not None:
        x = x + tables["wpe"].index_select(0, pos)
    extra = [] if tables["rope"] is None \
        else [r.index_select(2, pos) for r in tables["rope"]]
    if tables["bias"] is not None:
        extra.append(tables["bias"].index_select(0, pos)[0][None, :, None, :])
    outs = forward([x[:, None, :], tables["masks"].index_select(0, pos)[0]]
                   + extra + tables["memory"] + caches)
    row = outs[0][:, 0, :]
    written = [q(present) for present, q in zip(outs[1:], q_cache)]
    if functional:
        caches = [c.index_copy(2, pos, w) for c, w in zip(caches, written)]
    else:
        for c, w in zip(caches, written):
            c.index_copy_(2, pos, w)
    nxt = _next_token(row, knobs["temperature"], knobs["top_k"],
                      knobs["top_p"], generator, knobs["min_p"], presence,
                      knobs["repetition_penalty"], noise=noise)
    # teacher forcing: inside the prompt the next token is given
    at = pos + 1
    nxt = torch.where(at >= t0, nxt, ids.index_select(1, at).reshape(-1))
    if functional:
        ids = ids.index_copy(1, at, nxt[:, None])
    else:
        ids.index_copy_(1, at, nxt[:, None])
    if presence is not None:
        presence = presence.scatter(1, nxt[:, None], 1.0) if functional \
            else presence.scatter_(1, nxt[:, None], 1.0)
    return row, ids, caches, presence


def _sampling(knobs: dict) -> bool:
    return any(knobs[k] is not None
               for k in ("temperature", "top_k", "top_p", "min_p"))


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

    ``score_bias=`` ([L, H, L+1], a T5 step model's ``_decode_bias``) feeds
    row t of the table, placed on the device once, as the graph's
    ``score_bias`` input [1, H, 1, L+1] at step t. ``memory=`` ([B, S, d],
    an encoder output) feeds the graph's ``encoder_memory`` input, copied
    once per call into a buffer the captured step reads in place (the
    seq2seq step forms: models/t5.py, models/seq2seq.py,
    models/whisper.py). A JAX PRNG ``key`` raises
    ``NotImplementedError``."""
    _refuse_key(key)
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    cache_start = _cache_start(step_model, rope, score_bias is not None,
                               memory is not None)
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
    bias_d = _placed_table(step_model, "score_bias", score_bias)
    memory_in = [] if memory is None else [
        _placed_memory(step_model, memory, cache_start)]
    knobs = dict(temperature=temperature, top_k=top_k, top_p=top_p,
                 min_p=min_p, repetition_penalty=repetition_penalty)
    if _sampling(knobs) and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    total = t0 + max_new_tokens
    ids = torch.zeros((batch, total), dtype=torch.int64, device=dev)
    ids[:, :t0] = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    # a sharded step model keeps its caches per rank: the batch rows of its
    # data shard and the heads of its model shard (parallel/sharding.py)
    from ..parallel.sharding import kv_cache_layout, local_shape
    cache_lay = kv_cache_layout(step_model, batch, nh)
    caches = _kv_buffers(step_model, q_cache, local_shape(
        (batch, nh, length, hd), cache_lay, getattr(step_model, "mesh", None)),
        cache_dtype)
    if cache_lay:
        step_model._local_io = {v.name: cache_lay for v in
                                step_model.inputs[cache_start:]
                                + step_model.outputs[1:]}
    # the captured step graph reads the caches and the memory where they lie
    inplace = tuple(range(cache_start - len(memory_in),
                          cache_start + len(caches)))
    tables = dict(wte=wte_d, wpe=wpe_d, rope=rope_d, bias=bias_d,
                  memory=memory_in, masks=_step_masks(total - 1, length, dev))
    presence = None
    if repetition_penalty is not None:
        presence = torch.zeros((batch, wte_d.shape[0]), dtype=torch.float32,
                               device=dev)
        presence.scatter_(1, ids[:, :1], 1.0)
    positions = torch.arange(total, device=dev)

    def forward(inputs):
        return step_model(inputs, as_numpy=False, inplace=inplace)

    for t in range(total - 1):
        row, ids, caches, presence = _kv_step(
            forward, tables, ids, caches, presence, positions[t:t + 1], t0,
            q_cache, knobs, generator=generator)
        if step_logits is not None:
            step_logits.append(row)
    if cache_lay:
        step_model._local_io = {}
    return ids.cpu().numpy().astype(np.int32)


@torch.inference_mode()
def decode_calibration(step_model, prompt_ids: np.ndarray, wte: np.ndarray,
                       wpe: np.ndarray, rope=None,
                       score_bias: np.ndarray = None,
                       memory: np.ndarray = None) -> list:
    """Replay ``prompt_ids`` (teacher-forced) through the float decode step
    and return one input list per step, as device tensors: per-step
    calibration batches for quantizing the step graph. Compose with
    ``Model.calibration_stats`` and ``utils.merge_calibration_stats``,
    then ``quantize(stats=...)``. ``wpe``, ``rope``, ``score_bias`` and
    ``memory`` as in :func:`generate_kv`."""
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    cache_start = _cache_start(step_model, rope, score_bias is not None,
                               memory is not None)
    n_layer, b, nh, length, hd = _kv_layout(step_model, cache_start)
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    wpe_d = _placed_table(step_model, "wpe", wpe)
    bias_d = _placed_table(step_model, "score_bias", score_bias)
    mem_d = None if memory is None else _as_device(memory, dev)
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
        if bias_d is not None:
            extra.append(bias_d[t][None, :, None, :].clone())
        if mem_d is not None:
            extra.append(mem_d)
        inputs = [x[:, None, :], mask] + extra + [c.clone() for c in caches]
        out.append(inputs)
        res = step_model(inputs, as_numpy=False)
        for cache, present in zip(caches, res[1:]):
            cache[:, :, t:t + 1, :] = present
    return out


def _graph_length(model, index: int = 1):
    """Dim ``index`` of the first input's shape hint, or None."""
    hint = model.inputs[0].shape_hint
    return None if hint is None else int(hint[index])


@torch.inference_mode()
def generate(model, prompt_ids: np.ndarray, wte: np.ndarray,
             max_new_tokens: int, temperature: float = None,
             top_k: int = None, top_p: float = None, key=None,
             min_p: float = None, repetition_penalty: float = None,
             generator: torch.Generator = None) -> np.ndarray:
    """Generate ``max_new_tokens`` continuations of ``prompt_ids`` [B, T0]
    with ``model`` (any Model/QModel over an ``inputs_embeds`` causal graph:
    models/gpt.py::gpt_causal_lm, models/llama.py::llama_causal_lm) and the
    token-embedding table ``wte`` [V, H]. Every step runs the graph at its
    fixed length L over the embeddings so far (the causal mask keeps the
    zero tail out of the live positions) and picks from the logits at the
    last filled position.

    Greedy argmax by default; ``temperature``/``top_k``/``top_p``/``min_p``
    switch to filtered sampling with Gumbel noise from ``generator`` (a
    torch.Generator; one seeded 0 on the model's device when None).
    ``repetition_penalty`` (HF CTRL semantics) composes with greedy
    decoding too. Returns [B, T0 + max_new_tokens] int32 ids. A JAX PRNG
    ``key`` raises ``NotImplementedError``."""
    _refuse_key(key)
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    length = _graph_length(model)
    if length is not None and t0 + max_new_tokens > length:
        raise ValueError(
            f"prompt {t0} + {max_new_tokens} new tokens exceeds the "
            f"graph's fixed length {length}")
    length = length if length is not None else t0 + max_new_tokens
    dev = model.device
    wte_d = _placed_table(model, "wte", wte)
    sampling = not (temperature is None and top_k is None and top_p is None
                    and min_p is None)
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    prompt = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    embeds = torch.zeros((batch, length, wte_d.shape[1]),
                         dtype=torch.float32, device=dev)
    embeds[:, :t0] = wte_d[prompt]
    ids = torch.zeros((batch, length), dtype=torch.int64, device=dev)
    ids[:, :t0] = prompt
    presence = None
    if repetition_penalty is not None:
        presence = torch.zeros((batch, wte_d.shape[0]), dtype=torch.float32,
                               device=dev)
        presence.scatter_(1, prompt, 1.0)
    for i in range(max_new_tokens):
        t = t0 - 1 + i  # the position whose logits predict token t+1
        row = model([embeds], as_numpy=False)[0][:, t, :]
        nxt = _next_token(row, temperature, top_k, top_p, generator, min_p,
                          presence, repetition_penalty)
        embeds[:, t + 1] = wte_d[nxt]
        ids[:, t + 1] = nxt
        if presence is not None:
            presence.scatter_(1, nxt[:, None], 1.0)
    return ids[:, :t0 + max_new_tokens].cpu().numpy().astype(np.int32)


def _log_softmax(x: torch.Tensor) -> torch.Tensor:
    """jax.nn.log_softmax's composition: (x - max) - log(sum(exp(x - max)))."""
    shifted = x - x.amax(dim=-1, keepdim=True)
    return shifted - torch.log(torch.exp(shifted).sum(dim=-1, keepdim=True))


@torch.inference_mode()
def beam_search(model, prompt_ids: np.ndarray, wte: np.ndarray,
                max_new_tokens: int, num_beams: int, eos_id: int = None):
    """Beam-search decode over a full-sequence causal graph (the
    :func:`generate` graph form) built with batch ``B * num_beams``: every
    step forwards all hypotheses as one batch, expands the candidates to
    [B, W * V] summed token log-probabilities and keeps the W best, ordered
    as ``lax.top_k`` orders them (descending by IEEE total order, equal
    scores lower index first).

    With ``eos_id`` set, a beam that emits EOS freezes: its score stops
    accumulating and its only continuation is EOS itself. Returns
    ``(ids, scores)``: ids [B, num_beams, T0 + max_new_tokens] int32 and
    scores [B, num_beams] float32, both best first."""
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    w = int(num_beams)
    hint = model.inputs[0].shape_hint
    if hint is not None and int(hint[0]) != batch * w:
        raise ValueError(
            f"beam search over {batch} prompts x {w} beams needs a "
            f"graph with batch {batch * w}, got {int(hint[0])}")
    length = int(hint[1]) if hint is not None else t0 + max_new_tokens
    if t0 + max_new_tokens > length:
        raise ValueError(
            f"prompt {t0} + {max_new_tokens} new tokens exceeds the "
            f"graph's fixed length {length}")
    dev = model.device
    wte_d = _placed_table(model, "wte", wte)
    vocab, hidden = wte_d.shape
    neg = torch.full((), _NEG, dtype=torch.float32, device=dev)
    prompt = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    embeds = torch.zeros((batch, w, length, hidden), dtype=torch.float32,
                         device=dev)
    embeds[:, :, :t0] = wte_d[prompt][:, None]
    ids = torch.zeros((batch, w, length), dtype=torch.int64, device=dev)
    ids[:, :, :t0] = prompt[:, None, :]
    # only beam 0 is live at step 0, else the W beams would all pick the
    # same top token
    scores = torch.full((batch, w), _NEG, dtype=torch.float32, device=dev)
    scores[:, 0] = 0.0
    done = torch.zeros((batch, w), dtype=torch.bool, device=dev)
    b_idx = torch.arange(batch, device=dev)[:, None]
    for i in range(max_new_tokens):
        t = t0 - 1 + i
        logits = model([embeds.reshape(batch * w, length, hidden)],
                       as_numpy=False)[0]
        logp = _log_softmax(logits[:, t, :].reshape(batch, w, vocab)
                            .to(torch.float32))
        cand = scores[:, :, None] + logp                  # [B, W, V]
        if eos_id is not None:
            # finished beams: score frozen, sole continuation is EOS
            frozen = neg.expand(batch, w, vocab).clone()
            frozen[:, :, eos_id] = scores
            cand = torch.where(done[:, :, None], frozen, cand)
        flat_scores = cand.reshape(batch, w * vocab)
        flat = _sort_descending(flat_scores)[:, :w]
        scores = torch.gather(flat_scores, 1, flat)
        beam_idx = flat // vocab                          # source beam
        tok = flat % vocab                                # next token
        ids = ids[b_idx, beam_idx]                        # reorder beams
        ids[:, :, t + 1] = tok
        embeds = embeds[b_idx, beam_idx]
        embeds[:, :, t + 1] = wte_d[tok]
        if eos_id is not None:
            done = done[b_idx, beam_idx] | (tok == eos_id)
    return (ids[:, :, :t0 + max_new_tokens].cpu().numpy().astype(np.int32),
            scores.cpu().numpy())


def _write_col(buf: torch.Tensor, col: torch.Tensor,
               val: torch.Tensor) -> torch.Tensor:
    """buf[b, col[b]] = val[b] for each row b; a column past the buffer
    writes nothing."""
    pos = torch.arange(buf.shape[1], device=buf.device)[None, :]
    hit = pos == col[:, None]
    if buf.ndim == 3:
        return torch.where(hit[:, :, None], val[:, None, :], buf)
    return torch.where(hit, val[:, None], buf)


def _read_col(arr: torch.Tensor, col: torch.Tensor) -> torch.Tensor:
    """arr[b, col[b]], the column clamped into the array."""
    c = col.clamp(0, arr.shape[1] - 1)
    return arr[torch.arange(arr.shape[0], device=arr.device), c]


@torch.inference_mode()
def generate_speculative(target_model, draft_model, prompt_ids: np.ndarray,
                         wte_target: np.ndarray, wte_draft: np.ndarray,
                         max_new_tokens: int, k: int = 4):
    """Greedy speculative decoding: ``draft_model`` proposes ``k`` tokens
    per round by greedy steps, ``target_model`` verifies them in one
    forward, and each row accepts its longest matching prefix plus the
    target's own token after it, so a round costs one target forward and
    advances a row 1 to k+1 tokens. The output equals target-only greedy
    decoding (argmax keeps the first maximum on both sides).

    Both models are full-sequence causal graphs (the :func:`generate` form)
    over one vocabulary and batch, each embedding with its own table. Rows
    advance independently. Graph lengths must cover ``T0 + max_new_tokens
    + k - 1``. Returns ``(ids [B, T0 + max_new_tokens] int32,
    target_forwards)``: the verify rounds run (plain greedy takes
    ``max_new_tokens`` forwards)."""
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    total = t0 + max_new_tokens
    for m, which in ((target_model, "target"), (draft_model, "draft")):
        lm = _graph_length(m)
        if lm is not None and lm < total + k - 1:
            raise ValueError(
                f"{which} graph length {lm} < T0 + max_new_tokens + k - 1 "
                f"= {total + k - 1}")
    lt, ld = _graph_length(target_model), _graph_length(draft_model)
    dev = target_model.device
    wte_t = _placed_table(target_model, "wte", wte_target)
    wte_d = _placed_table(draft_model, "wte", wte_draft)
    prompt = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    ids = torch.zeros((batch, total), dtype=torch.int64, device=dev)
    ids[:, :t0] = prompt
    emb_t = torch.zeros((batch, lt, wte_t.shape[1]), dtype=torch.float32,
                        device=dev)
    emb_t[:, :t0] = wte_t[prompt]
    emb_d = torch.zeros((batch, ld, wte_d.shape[1]), dtype=torch.float32,
                        device=dev)
    emb_d[:, :t0] = wte_d[prompt]
    t = torch.full((batch,), t0, dtype=torch.int64, device=dev)
    rounds = 0
    while int(t.min()) < total:
        # draft k greedy proposals (k cheap forwards)
        d_toks = []
        for i in range(k):
            logits = draft_model([emb_d], as_numpy=False)[0]
            tok = torch.argmax(_read_col(logits, t + i - 1), dim=-1)
            d_toks.append(tok)
            emb_d = _write_col(emb_d, t + i, wte_d[tok])
            emb_t = _write_col(emb_t, t + i, wte_t[tok])
        d_toks = torch.stack(d_toks, dim=1)
        # one target forward verifies all k proposals
        logits = target_model([emb_t], as_numpy=False)[0]
        y = torch.stack([torch.argmax(_read_col(logits, t + i - 1), dim=-1)
                         for i in range(k + 1)], dim=1)
        # longest matching prefix: n in [0, k]
        n = torch.cumprod((d_toks == y[:, :k]).to(torch.int64),
                          dim=1).sum(dim=1)
        for i in range(k):
            live = (i < n) & (t + i < total)
            ids = torch.where(live[:, None],
                              _write_col(ids, t + i, d_toks[:, i]), ids)
        corr = torch.gather(y, 1, n[:, None])[:, 0]
        at = t + n
        live = at < total
        ids = torch.where(live[:, None], _write_col(ids, at, corr), ids)
        emb_t = torch.where(live[:, None, None],
                            _write_col(emb_t, at, wte_t[corr]), emb_t)
        emb_d = torch.where(live[:, None, None],
                            _write_col(emb_d, at, wte_d[corr]), emb_d)
        t = torch.clamp(t + n + 1, max=total)
        rounds += 1
    return ids.cpu().numpy().astype(np.int32), rounds


@torch.inference_mode()
def generate_seq2seq(enc_model, dec_model, src_ids: np.ndarray,
                     wte: np.ndarray, max_new_tokens: int,
                     decoder_start_id: int, temperature: float = None,
                     top_k: int = None, top_p: float = None, key=None,
                     generator: torch.Generator = None) -> np.ndarray:
    """Encoder-decoder generation over the encoder and decoder graph forms
    (models/seq2seq.py, models/whisper.py): the encoder runs once over
    ``src_ids`` [B, S], then the decoder graph runs at its fixed target
    length once per new token against that memory, picking from the logits
    at the last filled position (its causal self-attention keeps the zero
    tail out of the live positions). ``enc_model``/``dec_model`` are any
    Model/QModel over the two graphs, quantized independently or not. Only
    the token embedding (``wte`` [V, d]) happens outside the graphs.

    A float ``src_ids`` feeds the encoder directly (Whisper's
    ``input_features``); ``wte`` then embeds the decoder's tokens only.
    Greedy argmax by default; ``temperature``/``top_k``/``top_p`` switch
    to filtered sampling with Gumbel noise from ``generator`` (one seeded 0
    on the model's device when None). The memory, the embeddings and the
    ids stay on the device; only the finished ids come back. Returns
    [B, 1 + max_new_tokens] int32 ids starting with ``decoder_start_id``.
    A JAX PRNG ``key`` raises ``NotImplementedError``."""
    _refuse_key(key)
    src = src_ids if isinstance(src_ids, torch.Tensor) \
        else torch.from_numpy(np.ascontiguousarray(src_ids))
    batch = int(src.shape[0])
    length = _graph_length(dec_model)
    if 1 + max_new_tokens > length:
        raise ValueError(f"start token + {max_new_tokens} new tokens "
                         f"exceeds the decoder graph's fixed length {length}")
    dev = dec_model.device
    wte_d = _placed_table(dec_model, "wte", wte)
    if src.is_floating_point():
        enc_in = _as_device(src, enc_model.device)
    else:
        enc_in = _placed_table(enc_model, "wte", wte)[
            src.to(device=enc_model.device, dtype=torch.int64)]
    memory = enc_model([enc_in], as_numpy=False)[0]
    hint = tuple(int(d) for d in dec_model.inputs[1].shape_hint)
    mem_d = _memory_buffer(dec_model, "encoder_memory", hint)
    mem_d.copy_(memory.to(device=dev, dtype=torch.float32))
    embeds = _memory_buffer(dec_model, "decoder_embeds",
                            (batch, length, int(wte_d.shape[1])))
    embeds.zero_()
    sampling = not (temperature is None and top_k is None and top_p is None)
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    ids = torch.zeros((batch, length), dtype=torch.int64, device=dev)
    ids[:, 0] = int(decoder_start_id)
    embeds[:, 0] = wte_d[int(decoder_start_id)]
    for i in range(max_new_tokens):
        # the decoder reads the embeddings and the memory where they lie
        row = dec_model([embeds, mem_d], as_numpy=False, inplace=(0, 1))[0][:, i]
        nxt = _next_token(row, temperature, top_k, top_p, generator)
        embeds[:, i + 1] = wte_d[nxt]
        ids[:, i + 1] = nxt
    return ids[:, :1 + max_new_tokens].cpu().numpy().astype(np.int32)


def _mamba_state_shapes(step_model) -> list:
    """[(conv shape, ssm shape), ...] per layer, from the SSM step graph's
    input hints (models/mamba.py::mamba_decode_step input order)."""
    hints = [tuple(int(d) for d in v.shape_hint)
             for v in step_model.inputs[1:]]
    return list(zip(hints[0::2], hints[1::2]))


def _state_buffers(step_model, shapes: list) -> list:
    """The SSM carries, one zeroed float32 buffer per conv window and per
    state, kept on the model from one decode to the next: the captured
    step reads them in place (``inplace=``) and each step's new states are
    copied into them."""
    cache = step_model.__dict__.setdefault("_state_buffers", {})
    flat = tuple(s for pair in shapes for s in pair)
    bufs = cache.get(flat)
    if bufs is None:
        bufs = [torch.zeros(s, dtype=torch.float32, device=step_model.device)
                for s in flat]
        cache[flat] = bufs
    for buf in bufs:
        buf.zero_()
    return bufs


@torch.inference_mode()
def generate_mamba(step_model, prompt_ids: np.ndarray, wte: np.ndarray,
                   max_new_tokens: int, temperature: float = None,
                   top_k: int = None, top_p: float = None, key=None,
                   min_p: float = None, repetition_penalty: float = None,
                   generator: torch.Generator = None,
                   step_logits: list = None) -> np.ndarray:
    """Autoregressive decode through an SSM decode-step graph
    (models/mamba.py::mamba_decode_step): O(1) per token. The carry is a
    constant-size (conv window, SSM state) pair per layer, swapped in
    wholesale each step (no positions, no masks): each step's outputs are
    copied into the carry buffers the captured step reads in place. Steps
    inside the prompt are teacher forced. The ids and carries stay on the
    device; only the finished ids come back. Sampling knobs,
    ``generator`` and ``step_logits`` as in :func:`generate_kv`; a JAX PRNG
    ``key`` raises ``NotImplementedError``. Returns [B, t0 +
    max_new_tokens] int32."""
    _refuse_key(key)
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    shapes = _mamba_state_shapes(step_model)
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    sampling = not (temperature is None and top_k is None and top_p is None
                    and min_p is None)
    if sampling and generator is None:
        generator = torch.Generator(device=dev).manual_seed(0)
    total = t0 + max_new_tokens
    ids = torch.zeros((batch, total), dtype=torch.int64, device=dev)
    ids[:, :t0] = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    states = _state_buffers(step_model, shapes)
    inplace = tuple(range(1, 1 + len(states)))
    presence = None
    if repetition_penalty is not None:
        presence = torch.zeros((batch, wte_d.shape[0]), dtype=torch.float32,
                               device=dev)
        presence.scatter_(1, ids[:, :1], 1.0)
    for t in range(total - 1):
        x = wte_d[ids[:, t]][:, None, :]
        outs = step_model([x] + states, as_numpy=False, inplace=inplace)
        for buf, new in zip(states, outs[1:]):
            buf.copy_(new)
        row = outs[0][:, 0, :]
        if step_logits is not None:
            step_logits.append(row)
        nxt = _next_token(row, temperature, top_k, top_p, generator, min_p,
                          presence, repetition_penalty)
        # teacher forcing: inside the prompt the next token is given
        if t + 1 >= t0:
            ids[:, t + 1] = nxt
        if presence is not None:
            presence.scatter_(1, ids[:, t + 1:t + 2], 1.0)
    return ids.cpu().numpy().astype(np.int32)


@torch.inference_mode()
def mamba_decode_calibration(step_model, prompt_ids: np.ndarray,
                             wte: np.ndarray) -> list:
    """Teacher-forced replay of ``prompt_ids`` through the float SSM decode
    step; returns one input list per step, as device tensors (the
    state-carry counterpart of :func:`decode_calibration`)."""
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    shapes = _mamba_state_shapes(step_model)
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    ids = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    states = [torch.zeros(s, dtype=torch.float32, device=dev)
              for pair in shapes for s in pair]
    out = []
    for t in range(t0):
        inputs = [wte_d[ids[:, t]][:, None, :]] + [s.clone() for s in states]
        out.append(inputs)
        states = step_model(inputs, as_numpy=False)[1:]
    return out
