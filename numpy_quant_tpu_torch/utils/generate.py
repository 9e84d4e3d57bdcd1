"""Greedy autoregressive decode through the KV-cache step graph.

Port of ``numpy_quant_tpu/utils/generate.py::generate_kv`` (greedy
branch) over ``models/gpt.py::gpt_decode_step``. The JAX package compiles
the whole loop into one XLA program; here it is an eager Python loop over
positions t. The caches are device tensors [B, heads, L, head] written in
place at slot t, the ids stay on the device, and only the finished ids
come back to the host.
"""
from __future__ import annotations

import numpy as np
import torch

_LATER = {
    "kv_cache_dtype": "an int8 KV cache needs a quantized step model; it "
                      "comes with the decoder-attention slice (the "
                      "full-int8 GPT step)",
    "rope": "RoPE decode (the LLaMA step form) is a later slice",
    "score_bias": "the T5 score-bias decode form is a later slice",
    "memory": "the seq2seq (Whisper) decode form is a later slice",
    "sampling": "sampling (temperature/top_k/top_p/min_p, key) needs an "
                "explicit torch.Generator; it is a later slice (jax.random "
                "streams cannot be matched)",
    "repetition_penalty": "repetition_penalty comes with the sampling "
                          "slice",
}


def _kv_layout(step_model, cache_start: int = 2):
    """(n_layer, batch, heads, max_len, head_dim) from the decode-step
    graph's input hints (gpt_decode_step input order)."""
    n_layer = (len(step_model.inputs) - cache_start) // 2
    b, nh, length, hd = step_model.inputs[cache_start].shape_hint
    return n_layer, b, nh, length, hd


def _step_mask(t: int, length: int) -> np.ndarray:
    """[1, 1, 1, L+1] additive mask of step t: cache slots < t live, the
    rest -1e9; the last lane (the current token) always live."""
    mask = np.where(np.arange(length) < t, np.float32(0), np.float32(-1e9))
    mask = np.concatenate([mask, np.zeros((1,), np.float32)])
    return mask.astype(np.float32).reshape(1, 1, 1, length + 1)


def _placed_table(model, name: str, arr) -> torch.Tensor:
    """A device copy of an embedding table, cached on the model by the
    source array's identity (the 154 MB GPT-2 wte is not re-uploaded per
    call)."""
    cache = model.__dict__.setdefault("_table_cache", {})
    hit = cache.get(name)
    if hit is not None and hit[0] is arr:
        return hit[1]
    dev = torch.from_numpy(np.ascontiguousarray(
        np.asarray(arr, np.float32))).to(model.device)
    cache[name] = (arr, dev)
    return dev


def _refuse_unported(**options) -> None:
    sampling = ("temperature", "top_k", "top_p", "min_p", "key")
    for name, value in options.items():
        if value is not None:
            raise NotImplementedError(
                _LATER["sampling" if name in sampling else name])


@torch.inference_mode()
def generate_kv(step_model, prompt_ids: np.ndarray, wte: np.ndarray,
                wpe: np.ndarray, max_new_tokens: int,
                temperature: float = None, top_k: int = None,
                top_p: float = None, key=None,
                kv_cache_dtype: str = None, rope=None,
                score_bias: np.ndarray = None,
                memory: np.ndarray = None, min_p: float = None,
                repetition_penalty: float = None,
                step_logits: list = None) -> np.ndarray:
    """Greedy autoregressive decode through the KV-cache step graph
    (models/gpt.py::gpt_decode_step, float or weight-only model): one
    token per step at O(L) cost. Steps inside the prompt are teacher
    forced (their caches fill, their argmax is dropped). Returns the ids
    [B, t0 + max_new_tokens], prompt included, as int32. When
    ``step_logits`` is a list, each step's logits [B, V] (a float32
    device tensor) are appended to it.

    The JAX package's other options (``kv_cache_dtype="int8"``, ``rope=``,
    ``score_bias=``, ``memory=``, sampling and ``repetition_penalty``)
    raise ``NotImplementedError`` naming the later slice."""
    _refuse_unported(temperature=temperature, top_k=top_k, top_p=top_p,
                     min_p=min_p, key=key, kv_cache_dtype=kv_cache_dtype,
                     rope=rope, score_bias=score_bias, memory=memory,
                     repetition_penalty=repetition_penalty)
    prompt_ids = np.asarray(prompt_ids)
    batch, t0 = prompt_ids.shape
    n_layer, b, nh, length, hd = _kv_layout(step_model)
    if b != batch:
        raise ValueError(f"graph batch {b} != prompt batch {batch}")
    if t0 + max_new_tokens - 1 > length:
        raise ValueError(f"prompt {t0} + {max_new_tokens} new tokens "
                         f"exceeds the cache length {length}")
    dev = step_model.device
    wte_d = _placed_table(step_model, "wte", wte)
    wpe_d = _placed_table(step_model, "wpe", wpe)
    total = t0 + max_new_tokens
    ids = torch.zeros((batch, total), dtype=torch.int64, device=dev)
    ids[:, :t0] = torch.from_numpy(prompt_ids.astype(np.int64)).to(dev)
    caches = [torch.zeros((batch, nh, length, hd), dtype=torch.float32,
                          device=dev) for _ in range(2 * n_layer)]
    masks = torch.from_numpy(np.stack(
        [_step_mask(t, length) for t in range(max(total - 1, 1))])).to(dev)
    for t in range(total - 1):
        x = (wte_d[ids[:, t]] + wpe_d[t])[:, None, :]
        outs = step_model([x, masks[t]] + caches, as_numpy=False)
        row = outs[0][:, 0, :]
        if step_logits is not None:
            step_logits.append(row)
        for cache, present in zip(caches, outs[1:]):
            cache[:, :, t:t + 1, :] = present
        # teacher forcing: inside the prompt the next token is given;
        # argmax keeps the first maximum, as jnp.argmax does
        if t + 1 >= t0:
            ids[:, t + 1] = torch.argmax(row, dim=-1)
    return ids.cpu().numpy().astype(np.int32)


