"""The fixture trainers (``models/fixtures.py::train_fixture``,
``text_fixture.py`` and ``modsum_fixture.py``'s ``train_fixture``, all on
``train.py``) held against the JAX package's, which train
``transformers`` modules, on the CPU at a few steps:

* the small ViT: JAX's own ``train_fixture(steps=3, batch=16)`` and the
  port's from JAX's initial state dict take the same Adam steps on the
  same ``make_batch`` stream: every weight within 1e-4 of JAX's and 99.9%
  of them within 1e-6 (measured: 1.87e-5 at most, 99.96% within 1e-6;
  Adam's first steps move a weight by about ``lr`` whatever its gradient's
  size, so a gradient near 0 that rounds apart parts the two most), the
  held-out accuracies within one image in 64;
* the GPT trainers: one step's loss and every gradient, dropout off on
  both sides, against the HF module of JAX's ``_build_module`` (loss within
  1e-6 relative, each gradient within 1e-4 of its tensor's largest);
* the dropout sites (``GPT2Config``'s: embeddings, attention
  probabilities, both residual branches) and their rate, masks from the
  trainer's generator; none outside training;
* ``param_views`` maps every initializer to its state-dict entry (the
  tied head to the token embedding, transposed);
* each trainer runs end to end and writes only the ``path`` it is given
  (none by default).
"""
import inspect

import jax
import numpy as np
import pytest
import torch

from numpy_quant_tpu.models import fixtures as JF
from numpy_quant_tpu.models import modsum_fixture as JM
from numpy_quant_tpu.models import text_fixture as JT
from numpy_quant_tpu_torch.models import fixtures as TF
from numpy_quant_tpu_torch.models import modsum_fixture as TM
from numpy_quant_tpu_torch.models import text_fixture as TT
from numpy_quant_tpu_torch.models.gpt import gpt_causal_lm
from numpy_quant_tpu_torch.models.vit import (random_vit_weights,
                                              vit_image_classifier)
from numpy_quant_tpu_torch.train import (GPT2_DROPOUT, GraphTrainer,
                                         gpt_dropout_sites, lm_loss,
                                         param_views)

GPT = {"copy": (JT, TT, TT.FIXTURE_CONFIG), "modsum": (JM, TM,
                                                       TM.MODSUM_CONFIG)}


@pytest.fixture(autouse=True)
def tpu_mode():
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True)
def one_thread():
    """One intra-op thread: a training walk is thousands of small ops, which
    a thread pool shared with the test run's other workers only slows."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _state(module) -> dict:
    return {k: v.detach().numpy().copy() for k, v in
            module.state_dict().items()}


def test_vit_train_fixture_matches_jax(tmp_path):
    steps, lr, batch = 3, 3e-4, 16
    init = _state(JF._build_module())
    jpath, tpath = tmp_path / "jax.npz", tmp_path / "port.npz"
    jacc = JF.train_fixture(steps=steps, batch=batch, lr=lr,
                            path=str(jpath))
    tacc = TF.train_fixture(steps=steps, batch=batch, lr=lr,
                            path=str(tpath), init=init, device="cpu")
    with np.load(jpath) as j, np.load(tpath) as t:
        assert set(j.files) == set(t.files) == set(init)
        worst, close, total = 0.0, 0, 0
        for k in j.files:
            d = np.abs(j[k].astype(np.float64) - t[k])
            worst = max(worst, float(d.max()))
            close += int((d <= 1e-6).sum())
            total += d.size
            assert not np.array_equal(t[k], init[k]) or \
                np.array_equal(j[k], init[k]), k
    print(f"after {steps} steps: max |w - w_jax| {worst:.3g}; "
          f"{close} of {total} within 1e-6; held out {tacc} / {jacc}")
    assert worst <= 1e-4
    assert close >= 0.999 * total
    assert abs(tacc - jacc) <= 4 / 256


@pytest.mark.parametrize("which", ["copy", "modsum"])
def test_gpt_step_matches_hf(which):
    jmod, tmod, cfg = GPT[which]
    hf = jmod._build_module()
    hf.eval()                                   # dropout off
    init = _state(hf)
    rng = np.random.default_rng(3)
    if which == "copy":
        seqs = tmod.make_copy_batch(rng, 8)
        labels = seqs.copy()
    else:
        seqs = tmod.make_modsum_batch(rng, 8)
        labels = seqs.copy()
        labels[:, 0::2] = -100
    out = hf(input_ids=torch.from_numpy(seqs),
             labels=torch.from_numpy(labels))
    out.loss.backward()
    trainer = GraphTrainer(
        lambda w: gpt_causal_lm(w, cfg, batch_size=8,
                                seq_len=seqs.shape[1]),
        init, "cpu", embed="transformer.wte.weight")
    loss = lm_loss(trainer.forward([seqs])[0], torch.from_numpy(labels))
    loss.backward()
    np.testing.assert_allclose(float(loss), float(out.loss), rtol=1e-6)
    grads = dict(hf.named_parameters())
    assert set(trainer.params) == set(grads)
    for k, p in grads.items():
        want = p.grad.numpy()
        got = trainer.params[k].grad.numpy()
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-4 * float(np.abs(want).max()),
                                   err_msg=k)


def test_dropout_sites_and_rate():
    cfg, rate = TT.FIXTURE_CONFIG, GPT2_DROPOUT
    assert rate == 0.1           # GPT2Config's default
    init = TT.random_gpt2_weights(cfg, seed=0)
    sites = gpt_dropout_sites(cfg["n_layer"])
    assert len(sites) == 1 + 3 * cfg["n_layer"]

    def build(w):
        return gpt_causal_lm(w, cfg, batch_size=16, seq_len=TT.SEQ_LEN)

    names = {o for n in build(init).graph.node for o in n.output}
    assert set(sites) <= names
    seqs = TT.make_copy_batch(np.random.default_rng(0), 16)
    t = GraphTrainer(build, init, "cpu", embed="transformer.wte.weight",
                     dropout=sites, seed=5)
    plain, seen = t.walk._post_node, {}

    def post(node, outputs):
        before = outputs[0].data
        after = plain(node, outputs)
        if node.outputs[0].name in sites:
            seen[node.outputs[0].name] = (before, after[0].data)
        return after

    t.walk._post_node = post
    with torch.no_grad():
        a = t.forward([seqs])[0]
        dropped = dict(seen)
        t.walk.generator.manual_seed(5)
        b = t.forward([seqs])[0]
        t.walk.generator.manual_seed(6)
        c = t.forward([seqs])[0]
        t.walk.training = False
        d = t.forward([seqs])[0]
        t.walk.training, t.walk.dropout = True, {}
        e = t.forward([seqs])[0]
    assert set(dropped) == set(sites)
    for name, (before, after) in dropped.items():
        # among the entries that were not 0 already (masked probabilities)
        kept = (after != 0) & (before != 0)
        share = 1 - float(kept.sum()) / float((before != 0).sum())
        assert abs(share - rate) < 0.02, (name, share)
        torch.testing.assert_close(after[kept], before[kept] / (1 - rate),
                                   rtol=1e-6, atol=0)
    assert torch.equal(a, b) and not torch.equal(a, c)
    assert torch.equal(d, e)


def test_param_views_map_every_weight():
    cfg = dict(TF.FIXTURE_CONFIG)
    w = random_vit_weights(cfg, seed=1)
    views = param_views(lambda s: vit_image_classifier(s, cfg), w)
    assert {k for k, _ in views.values()} == set(w)
    key, index = views["encoder.layer.0.attention.query.weight_t"]
    assert key == "vit.encoder.layer.0.attention.attention.query.weight"
    np.testing.assert_array_equal(w[key].reshape(-1)[index], w[key].T)
    g = TT.random_gpt2_weights(TT.FIXTURE_CONFIG, seed=1)
    views = param_views(lambda s: gpt_causal_lm(s, TT.FIXTURE_CONFIG,
                                                batch_size=2, seq_len=25), g)
    assert {k for k, _ in views.values()} == set(g) - {"lm_head.weight"}
    key, index = views["lm_head.weight_t"]
    assert key == "transformer.wte.weight"
    np.testing.assert_array_equal(g[key].reshape(-1)[index], g[key].T)
    assert views["wpe.slice"][1].shape == (25, TT.FIXTURE_CONFIG["n_embd"])


@pytest.mark.parametrize("which", ["vit", "copy", "modsum"])
def test_trainer_runs_and_writes_only_where_told(which, tmp_path):
    mod = {"vit": TF, "copy": TT, "modsum": TM}[which]
    assert inspect.signature(mod.train_fixture).parameters["path"] \
        .default is None
    history = []
    path = tmp_path / "sub" / "w.npz"
    acc = mod.train_fixture(steps=2, batch=8, device="cpu", path=str(path),
                            history=history)
    assert 0.0 <= acc <= 1.0 and len(history) == 2
    assert np.isfinite(history).all()
    assert [p.name for p in tmp_path.rglob("*") if p.is_file()] == ["w.npz"]
    with np.load(path) as f:
        dtypes = {f[k].dtype for k in f.files}
    assert dtypes == {np.dtype(np.float32 if which == "vit"
                               else np.float16)}
