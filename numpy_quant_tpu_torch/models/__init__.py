"""ONNX graph builders over numpy weights."""
from .llama import (
    TINYLLAMA_1_1B,
    llama_causal_lm,
    llama_decode_step,
    llama_prefill,
    random_llama_weights,
    rope_tables,
)
from .t5 import (
    T5_SMALL,
    random_t5_weights,
    relative_position_bias,
    t5_conditional_generation,
    t5_encoder,
)

__all__ = ["TINYLLAMA_1_1B", "llama_causal_lm", "llama_decode_step",
           "llama_prefill", "random_llama_weights",
           "rope_tables", "T5_SMALL", "random_t5_weights",
           "relative_position_bias", "t5_conditional_generation",
           "t5_encoder"]
