"""Graph optimization passes for QModel. Each pass is a module function
taking the QModel; ``QModel`` exposes them as methods. They preserve the
executor's numerics and share one matching toolkit (:mod:`.toolkit`)."""
from .attention import fuse_attention
from .decode_attention import fuse_decode_attention
from .gelu import fuse_gelu
from .int8_dataflow import int8_dataflow
from .narrow import narrow_gather
from .toolkit import PASSTHROUGH_OPS
from .weights import pack_weights, shift_q_bias

__all__ = ["PASSTHROUGH_OPS", "fuse_attention", "fuse_decode_attention",
           "fuse_gelu",
           "int8_dataflow", "narrow_gather", "pack_weights", "shift_q_bias"]
