"""The port's token pick (``utils/generate.py::_next_token``) held against
the JAX package's, in TPU-mode numerics (x64 off).

``jax.random.categorical(key, logits)`` is ``argmax(logits + gumbel(key))``
(checked below), so both sides are given the same Gumbel noise: the port's
``_gumbel`` is patched to hand out JAX's draws. Tolerance: the picked ids
are equal for greedy, temperature, top-k, top-p, min-p and
repetition-penalty picks and their combinations, on rows with ties
(top-k keeps every tie at the k-th value; top-p sorts ties in index order,
as ``lax.top_k`` does; argmax keeps the first maximum). Through the whole
decode loop, the port's sampled GPT-2 tokens equal JAX's when the port
draws JAX's per-step noise, and a seeded ``torch.Generator`` makes a
decode reproducible.
"""
import importlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from transformers import GPT2Config
from transformers.models.gpt2.modeling_gpt2 import GPT2LMHeadModel

import numpy_quant_tpu as nq
from numpy_quant_tpu.models import gpt as JG
from numpy_quant_tpu_torch import Model
from numpy_quant_tpu_torch.models import gpt as TG

# the modules: each package's ``generate`` name is the function
TGEN = importlib.import_module("numpy_quant_tpu_torch.utils.generate")
JGEN = importlib.import_module("numpy_quant_tpu.utils.generate")

B, V = 6, 40
CFG = dict(vocab_size=96, n_positions=16, n_embd=64, n_layer=2, n_head=4)
MAX_LEN, PROMPT, NEW = 16, 4, 8

FILTERS = {
    "greedy": {},
    "temperature": dict(temperature=0.7),
    "top_k": dict(top_k=5),
    "top_k_1": dict(top_k=1),
    "top_p": dict(top_p=0.8),
    "min_p": dict(min_p=0.1),
    "temp_top_k_top_p": dict(temperature=1.3, top_k=12, top_p=0.9),
    "all": dict(temperature=0.9, top_k=20, top_p=0.7, min_p=0.05),
}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


def _rows(seed: int) -> np.ndarray:
    """[B, V] logits with ties: rows 0-1 draw from a few levels (many ties
    at every rank), row 2 has a tied maximum, the rest are continuous."""
    rng = np.random.default_rng(seed)
    rows = rng.normal(size=(B, V)).astype(np.float32) * 2.0
    rows[0] = rng.integers(-3, 4, size=V).astype(np.float32)
    rows[1] = np.round(rows[1])
    rows[2, [7, 19, 31]] = rows[2].max() + 1.0
    return rows


def _presence(seed: int) -> np.ndarray:
    rng = np.random.default_rng(seed + 1)
    return (rng.random((B, V)) < 0.3).astype(np.float32)


def test_categorical_is_gumbel_argmax():
    key = jax.random.PRNGKey(5)
    logits = jnp.asarray(_rows(0))
    np.testing.assert_array_equal(
        np.asarray(jax.random.categorical(key, logits, axis=-1)),
        np.asarray(jnp.argmax(logits + jax.random.gumbel(key, logits.shape),
                              axis=-1)))


@pytest.mark.parametrize("penalty", [None, 1.3], ids=["plain", "penalty"])
@pytest.mark.parametrize("name", list(FILTERS))
def test_next_token_matches_jax(name, penalty, monkeypatch):
    """20 draws per filter: the same ids as JAX's _next_token under the
    same noise."""
    kw = FILTERS[name]
    for seed in range(20):
        row = _rows(seed)
        presence = _presence(seed) if penalty is not None else None
        key = jax.random.PRNGKey(seed)
        want = np.asarray(JGEN._next_token(
            jnp.asarray(row), kw.get("temperature"), kw.get("top_k"),
            kw.get("top_p"), key, kw.get("min_p"),
            None if presence is None else jnp.asarray(presence), penalty))
        noise = torch.from_numpy(np.array(jax.random.gumbel(key, row.shape)))
        monkeypatch.setattr(TGEN, "_gumbel", lambda shape, gen: noise)
        got = TGEN._next_token(
            torch.from_numpy(row), kw.get("temperature"), kw.get("top_k"),
            kw.get("top_p"), None, kw.get("min_p"),
            None if presence is None else torch.from_numpy(presence), penalty)
        np.testing.assert_array_equal(got.numpy(), want,
                                      err_msg=f"{name} seed {seed}")


def test_filters_keep_ties_as_jax():
    """top-k keeps every tie at the k-th value; top-p keeps tied tokens
    in index order; greedy takes the first maximum."""
    row = np.array([[1, 3, 3, 0, 3, 2, 2, -1]], np.float32)
    t = torch.from_numpy(row)
    kept = TGEN._filtered_logits(t, None, 2, None, None)[0] > -1e29
    assert kept.tolist() == [False, True, True, False, True, False, False,
                             False]
    # equal probabilities 1/3 each among the three 3s: the nucleus at 0.5
    # keeps the first two of them in index order
    row = np.array([[3, 0, 3, 3]], np.float32)
    got = TGEN._filtered_logits(torch.from_numpy(row), None, None, 0.5,
                                None)[0] > -1e29
    assert got.tolist() == [True, False, True, False]
    # lax.top_k orders +0.0 above -0.0 (IEEE total order), equal values
    # by index
    row0 = np.array([[0.0, -0.0, 1.0, 0.0, -0.0, -2.0]], np.float32)
    want = np.asarray(jax.lax.top_k(jnp.asarray(row0), 6)[1])
    np.testing.assert_array_equal(
        TGEN._sort_descending(torch.from_numpy(row0)).numpy(), want)
    assert want.tolist() == [[2, 0, 3, 1, 4, 5]]
    first = int(np.asarray(jnp.argmax(jnp.asarray(row), -1))[0])
    assert int(TGEN._next_token(torch.from_numpy(row))[0]) == first == 0


@pytest.fixture(scope="module")
def gpt():
    weights = TG.random_gpt2_weights(CFG, seed=0)
    hf = GPT2LMHeadModel(GPT2Config(**CFG, activation_function="gelu",
                                    attn_implementation="eager")).eval()
    hf.load_state_dict({k: torch.from_numpy(v) for k, v in weights.items()})
    with jax.enable_x64(False):
        j_step = JG.gpt_decode_step(module=hf, batch_size=2, max_len=MAX_LEN)
    return dict(j_step=j_step,
                t_step=TG.gpt_decode_step(weights, CFG, batch_size=2,
                                          max_len=MAX_LEN),
                prompt=np.random.default_rng(4).integers(
                    0, CFG["vocab_size"], size=(2, PROMPT)).astype(np.int32))


class _JaxNoise:
    """The per-step Gumbel draws of JAX's generate_kv loop (one key split
    per step, sampling or not), handed out in order."""

    def __init__(self, key):
        self.key = key

    def __call__(self, shape, generator):
        self.key, sub = jax.random.split(self.key)
        return torch.from_numpy(np.array(jax.random.gumbel(sub, shape)))


@pytest.mark.parametrize("name", [n for n in FILTERS if n != "greedy"])
def test_sampled_decode_matches_jax_under_shared_noise(gpt, name,
                                                       monkeypatch):
    kw = FILTERS[name]
    key = jax.random.PRNGKey(11)
    jp, tp = gpt["j_step"], gpt["t_step"]
    want = JGEN.generate_kv(nq.Model.from_onnx(jp), gpt["prompt"], jp._wte,
                            jp._wpe, NEW, key=key, repetition_penalty=1.2,
                            **kw)
    monkeypatch.setattr(TGEN, "_gumbel", _JaxNoise(key))
    got = TGEN.generate_kv(Model.from_onnx(tp, device="cpu"), gpt["prompt"],
                           tp._wte, tp._wpe, NEW, repetition_penalty=1.2,
                           **kw)
    np.testing.assert_array_equal(got, np.asarray(want))


def test_seeded_generator_reproduces_a_decode(gpt):
    """The same seed gives the same ids, ids stay in the vocabulary,
    top_k=1 equals greedy, and no generator means a fresh one seeded 0."""
    tp = gpt["t_step"]
    tm = Model.from_onnx(tp, device="cpu")

    def run(**kw):
        return TGEN.generate_kv(tm, gpt["prompt"], tp._wte, tp._wpe, NEW,
                                **kw)
    kw = dict(temperature=1.5, top_p=0.95)
    a = run(generator=torch.Generator().manual_seed(7), **kw)
    b = run(generator=torch.Generator().manual_seed(7), **kw)
    np.testing.assert_array_equal(a, b)
    assert a.min() >= 0 and a.max() < CFG["vocab_size"]
    seeds = [run(generator=torch.Generator().manual_seed(s), **kw)
             for s in range(4)]
    assert any(not np.array_equal(s, a) for s in seeds)
    np.testing.assert_array_equal(run(top_k=1, temperature=2.0,
                                      generator=torch.Generator()), run())
    np.testing.assert_array_equal(
        run(**kw), run(generator=torch.Generator().manual_seed(0), **kw))
