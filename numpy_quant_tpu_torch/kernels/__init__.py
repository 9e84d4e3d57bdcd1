"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (taken for CPU tensors) and a count of its launches."""
from .attention import (
    fused_attention,
    fused_attention_hs,
    fused_attention_hs_blockq,
    fused_attention_hs_blockq_reference,
    fused_attention_hs_reference,
    fused_attention_reference,
)
from .elementwise import (
    dequantize,
    dequantize_reference,
    quantize,
    quantize_reference,
)
from .qmatmul import (
    packed_qmatmul,
    packed_qmatmul_reference,
    splitk_qmatmul,
    splitk_qmatmul_reference,
    splitk_wo_matmul,
    splitk_wo_matmul_reference,
)

__all__ = ["dequantize", "dequantize_reference", "fused_attention",
           "fused_attention_hs",
           "fused_attention_hs_blockq",
           "fused_attention_hs_blockq_reference",
           "fused_attention_hs_reference", "fused_attention_reference",
           "packed_qmatmul",
           "packed_qmatmul_reference", "quantize", "quantize_reference",
           "splitk_qmatmul",
           "splitk_qmatmul_reference", "splitk_wo_matmul",
           "splitk_wo_matmul_reference"]
