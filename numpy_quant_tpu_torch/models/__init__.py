"""ONNX graph builders over numpy weights."""
from .llama import (
    TINYLLAMA_1_1B,
    llama_causal_lm,
    llama_decode_step,
    llama_prefill,
    mistral_causal_lm,
    mistral_default_config,
    random_llama_weights,
    rope_tables,
)
from .seq2seq import (
    BART_BASE,
    bart_decode_step,
    bart_decoder,
    bart_encoder,
    bart_seq2seq,
    random_bart_weights,
)
from .t5 import (
    T5_SMALL,
    decode_bias_table,
    random_t5_weights,
    relative_position_bias,
    t5_conditional_generation,
    t5_decode_step,
    t5_encoder,
)
from .whisper import (
    WHISPER_TINY,
    random_whisper_weights,
    whisper_decode_step,
    whisper_decoder,
    whisper_encoder,
    whisper_seq2seq,
)

__all__ = ["TINYLLAMA_1_1B", "llama_causal_lm", "llama_decode_step",
           "llama_prefill", "random_llama_weights",
           "rope_tables", "T5_SMALL", "decode_bias_table",
           "random_t5_weights", "relative_position_bias",
           "t5_conditional_generation", "t5_decode_step", "t5_encoder",
           "mistral_causal_lm", "mistral_default_config", "BART_BASE",
           "bart_decode_step", "bart_decoder", "bart_encoder",
           "bart_seq2seq", "random_bart_weights", "WHISPER_TINY",
           "random_whisper_weights", "whisper_decode_step",
           "whisper_decoder", "whisper_encoder", "whisper_seq2seq"]
