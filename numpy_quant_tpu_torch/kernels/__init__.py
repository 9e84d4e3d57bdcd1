"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (taken for CPU tensors) and a count of its launches."""
from .attention import fused_attention_hs, fused_attention_hs_reference
from .qmatmul import (
    packed_qmatmul,
    packed_qmatmul_reference,
    splitk_qmatmul,
    splitk_qmatmul_reference,
    splitk_wo_matmul,
    splitk_wo_matmul_reference,
)

__all__ = ["fused_attention_hs", "fused_attention_hs_reference",
           "packed_qmatmul", "packed_qmatmul_reference", "splitk_qmatmul",
           "splitk_qmatmul_reference", "splitk_wo_matmul",
           "splitk_wo_matmul_reference"]
