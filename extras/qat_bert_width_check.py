"""QAT of BERT at base widths, in both packages, on the CPU.

Builds one BertForSequenceClassification at bert-base widths cut to one
layer (hidden 768, 12 heads, intermediate 3072, vocabulary 30522, 2
labels; HF's init, seed 0), then runs the self-distilled W4A8
``qat_quantize`` of tests/test_qat.py's BERT case for a few steps in the
JAX package and in the PyTorch port on the same graph and ids, and prints
both loss histories per learning rate.

    JAX_PLATFORMS=cpu python extras/qat_bert_width_check.py [--steps 4]

About a minute on one CPU host.
"""
from __future__ import annotations

import argparse
import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=4)
    ap.add_argument("--lrs", type=float, nargs="+", default=[1e-3, 2e-5])
    args = ap.parse_args()

    import jax
    jax.config.update("jax_platforms", "cpu")
    from transformers import BertConfig

    import numpy_quant_tpu as nq
    from numpy_quant_tpu.models.text import bert_text_classifier as j_bert
    from numpy_quant_tpu_torch import Model
    from numpy_quant_tpu_torch.models import text as TT

    config = BertConfig(vocab_size=30522, hidden_size=768,
                        num_hidden_layers=1, num_attention_heads=12,
                        intermediate_size=3072, max_position_embeddings=512,
                        num_labels=2, hidden_act="gelu")
    proto = j_bert(config=config, batch_size=2, seq_len=16, seed=0)
    ids = np.random.default_rng(22).integers(0, 30522, (2, 16)) \
        .astype(np.int64)
    weights = {k: v.detach().numpy().copy()
               for k, v in proto._torch_module.state_dict().items()
               if not k.endswith(("position_ids", "token_type_ids"))}
    cfg = {k: getattr(config, k) for k in TT.BERT_BASE
           if k != "initializer_range"}
    port = Model.from_onnx(TT.bert_text_classifier(weights, cfg, batch_size=2,
                                                   seq_len=16), device="cpu")
    with jax.enable_x64(False):
        jm = nq.Model.from_onnx(proto)
        for lr in args.lrs:
            kw = dict(bit_width=8, weight_bit_width=4, steps=args.steps,
                      lr=lr)
            print(f"lr {lr:g} jax  ", jm.qat_quantize([ids], **kw)
                  .qat_loss_history)
            print(f"lr {lr:g} torch", port.qat_quantize([ids], **kw)
                  .qat_loss_history)


if __name__ == "__main__":
    main()
