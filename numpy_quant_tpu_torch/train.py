"""Training a graph's weights on the port's own float walk (the fixture
trainers of ``models/fixtures.py``, ``text_fixture.py`` and
``modsum_fixture.py``).

The JAX package trains its fixtures as ``transformers`` modules; the port
trains the ONNX graph its own builders emit, under torch autograd through
``qat.py``'s walk with fake quantization off, so the trained weights are by
construction what the port's builders serve. The trainable tensors are the
HF-keyed state dict itself: :func:`param_views` finds, for each initializer
of the graph, the state-dict entry it was built from and the elements it
takes (the builders transpose, slice and tie weights), and the walk reads
each initializer as that gather of its entry, so every gradient lands on
the entry, tied uses summed.

Train-only dropout: ``dropout`` ({value name: rate}) drops entries of those
node outputs during training, with masks drawn from an explicit
``torch.Generator`` (the GPT fixtures' ``GPT2Config`` defaults: 0.1 at the
embeddings, the attention probabilities and both residual branches).
"""
from __future__ import annotations

from typing import Callable

import numpy as np
import torch
import torch.nn.functional as F

from . import onnx as onnx_lib
from .model import Model
from .qat import _FakeQuantModel
from .tensor import FTensor

# the probe build's tag of state-dict entry i is _TAG + i: far from the
# values a builder writes itself (0, 1, -1e9, small shape constants)
_TAG = 1000.0
# float32 holds every integer position below this exactly
_EXACT = 1 << 24


def _initializers(proto) -> dict[str, np.ndarray]:
    return {t.name: onnx_lib.to_array(t) for t in proto.graph.initializer}


def param_views(build: Callable, state: dict) -> dict[str, tuple]:
    """{initializer name: (state key, int64 index array)} for each
    initializer of ``build(state)`` that is a gather of one state-dict
    entry: ``state[key].reshape(-1)[index]`` equals it bit for bit. Found by
    building the graph twice more, once from entries filled with their
    key's tag and once with each element's position; initializers the
    builder makes itself (masks, shape constants) are left out."""
    keys = sorted(state)
    shapes = {k: np.shape(state[k]) for k in keys}
    for k in keys:
        if int(np.prod(shapes[k])) >= _EXACT:
            raise ValueError(f"{k}: {shapes[k]} has too many elements to "
                             "tag in float32")
    real = _initializers(build(state))
    tagged = _initializers(build({k: np.full(shapes[k], _TAG + i, np.float32)
                                  for i, k in enumerate(keys)}))
    placed = _initializers(build({
        k: np.arange(int(np.prod(shapes[k])), dtype=np.float32)
        .reshape(shapes[k]) for k in keys}))
    views = {}
    for name, tag in tagged.items():
        flat = tag.reshape(-1)
        if flat.size == 0 or not (flat == flat[0]).all():
            continue
        i = float(flat[0]) - _TAG
        if i != int(i) or not 0 <= i < len(keys):
            continue
        key = keys[int(i)]
        index = placed[name].astype(np.int64)
        src = np.asarray(state[key], np.float32).reshape(-1)
        if index.min(initial=0) < 0 or index.max(initial=0) >= src.size:
            continue
        if np.array_equal(src[index], real[name]):
            views[name] = (key, index)
    return views


def lm_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """HF's causal-LM loss: logits[:, t] against labels[:, t + 1], mean
    cross-entropy over the labels that are not -100."""
    v = logits.shape[-1]
    return F.cross_entropy(logits[:, :-1].reshape(-1, v).float(),
                           labels[:, 1:].reshape(-1), ignore_index=-100)


class _TrainWalk(_FakeQuantModel):
    """The float walk of a graph whose sourced initializers read the
    trainer's state tensors, with train-only dropout at named values."""

    def __init__(self, model: Model, views: dict, state: dict,
                 dropout: dict, generator: torch.Generator):
        super().__init__(model, None)
        self.views = {n: (k, torch.from_numpy(i).to(model.device))
                      for n, (k, i) in views.items()}
        self.state = state
        self.dropout = dropout
        self.generator = generator
        self.training = True

    def _wrap_constant(self, value):
        view = self.views.get(value.name)
        if view is None:
            return super()._wrap_constant(value)
        key, index = view
        return FTensor(self.state[key].reshape(-1)[index])

    def _post_node(self, node, outputs):
        rate = self.dropout.get(node.outputs[0].name) if self.training \
            else None
        if not rate:
            return outputs
        out = []
        for t in outputs:
            d = t.data
            keep = torch.rand(d.shape, generator=self.generator,
                              device=d.device) >= rate
            out.append(FTensor(d * keep * (1.0 / (1.0 - rate))))
        return out


class GraphTrainer:
    """A graph's weights as trainable tensors: the HF-keyed state dict
    ``init`` (numpy arrays) on ``device``, the graph ``build(weights)``
    walked over them. ``embed``: the state key whose rows embed the first
    input's int64 ids outside the graph (the GPT graphs take
    ``inputs_embeds``). ``dropout``: {value name: rate}, masks drawn from a
    generator seeded ``seed`` on ``device``."""

    def __init__(self, build: Callable, init: dict, device, *,
                 embed: str | None = None, dropout: dict | None = None,
                 seed: int = 0):
        init = {k: np.asarray(v, np.float32) for k, v in init.items()}
        views = param_views(build, init)
        used = {k for k, _ in views.values()} | ({embed} - {None})
        self.device = torch.device(device)
        self.embed = embed
        # copies: the optimizer updates them in place
        self.params = {k: torch.tensor(init[k], device=self.device,
                                       requires_grad=True)
                       for k in sorted(used)}
        self._init = init
        model = Model.from_onnx(build(init), device=self.device)
        generator = torch.Generator(device=self.device).manual_seed(seed)
        self.walk = _TrainWalk(model, views, self.params, dropout or {},
                               generator)

    def forward(self, arrays: list) -> list[torch.Tensor]:
        """The graph's outputs over ``arrays`` (host numpy), with
        autograd."""
        feeds = [a if a.dtype == np.int64 else
                 torch.from_numpy(np.ascontiguousarray(a)).to(self.device)
                 for a in arrays]
        if self.embed is not None:
            ids = torch.from_numpy(arrays[0]).to(self.device)
            feeds[0] = self.params[self.embed][ids]
        return self.walk.walk(feeds)

    def state_dict(self) -> dict[str, np.ndarray]:
        """The trained state dict, float32, keyed as ``init`` (entries the
        graph does not read keep their initial values)."""
        out = dict(self._init)
        out.update({k: t.detach().cpu().numpy()
                    for k, t in self.params.items()})
        return out


def train(trainer: GraphTrainer, steps: int, batch: Callable,
          loss_fn: Callable, optimizer, scheduler=None,
          history: list | None = None) -> dict[str, np.ndarray]:
    """``steps`` steps of ``optimizer`` (over ``trainer.params``) on
    ``loss_fn(outputs, target)``, ``batch(step) -> (arrays, target)`` host
    data; the scheduler steps after each update. Appends each step's loss
    to ``history`` (read once, after the last step). Returns the trained
    state dict."""
    losses = []
    trainer.walk.training = True
    for step in range(int(steps)):
        arrays, target = batch(step)
        target = torch.from_numpy(np.asarray(target)).to(trainer.device)
        loss = loss_fn(trainer.forward(arrays), target)
        optimizer.zero_grad(set_to_none=True)
        loss.backward()
        optimizer.step()
        if scheduler is not None:
            scheduler.step()
        losses.append(loss.detach())
    trainer.walk.training = False
    if history is not None and losses:
        history.extend(torch.stack(losses).cpu().tolist())
    return trainer.state_dict()


# GPT2Config's embd_pdrop, attn_pdrop and resid_pdrop
GPT2_DROPOUT = 0.1


def gpt_dropout_sites(n_layer: int) -> dict[str, float]:
    """GPT2Config's dropout sites in ``models/gpt.py``'s graphs, at its
    rate: the embeddings (token + position), each layer's attention
    probabilities and its two residual branches (attention and MLP
    projections)."""
    sites = {"/pos_add": GPT2_DROPOUT}
    for i in range(n_layer):
        for value in (f"h.{i}.attn/probs", f"h.{i}.attn.c_proj/Add_out",
                      f"h.{i}.mlp.c_proj/Add_out"):
            sites[value] = GPT2_DROPOUT
    return sites
