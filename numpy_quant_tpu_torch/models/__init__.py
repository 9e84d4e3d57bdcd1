"""ONNX graph builders over numpy weights."""
from .llama import (
    TINYLLAMA_1_1B,
    llama_causal_lm,
    random_llama_weights,
    rope_tables,
)

__all__ = ["TINYLLAMA_1_1B", "llama_causal_lm", "random_llama_weights",
           "rope_tables"]
