"""Hand-written CUDA kernels of the port, each beside its plain PyTorch
version (taken for CPU tensors) and a count of its launches.

Each wrapper counts in ``launches`` (and, where it has several forms, in
``launches_by_form``) the launches it makes. A replayed CUDA graph
(model.py) runs no wrapper: :func:`launch_counts` reads every counter,
and the replay adds the launches its capture recorded
(:func:`add_launch_counts`)."""
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
    fake_quantize,
    fake_quantize_reference,
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

# every wrapper that counts its launches
COUNTED = (quantize, dequantize, fake_quantize, fused_attention_hs,
           fused_attention_hs_blockq, fused_attention, splitk_qmatmul,
           packed_qmatmul, splitk_wo_matmul)


def launch_counts() -> dict:
    """Every counter: {(wrapper name, None): launches} and {(wrapper name,
    form): launches of that form}."""
    counts = {}
    for fn in COUNTED:
        counts[(fn.__name__, None)] = fn.launches
        for form, n in getattr(fn, "launches_by_form", {}).items():
            counts[(fn.__name__, form)] = n
    return counts


def set_launch_counts(counts: dict) -> None:
    """Set every counter to its value in ``counts`` (launch_counts's
    form)."""
    for fn in COUNTED:
        fn.launches = counts[(fn.__name__, None)]
        by_form = getattr(fn, "launches_by_form", None)
        if by_form is not None:
            for form in by_form:
                by_form[form] = counts.get((fn.__name__, form), 0)


def launch_delta(after: dict, before: dict) -> tuple:
    """The launches between two launch_counts readings, as (wrapper, form,
    n) entries for add_launch_counts; counters that did not move are left
    out."""
    by_name = {fn.__name__: fn for fn in COUNTED}
    return tuple((by_name[name], form, n - before.get((name, form), 0))
                 for (name, form), n in after.items()
                 if n != before.get((name, form), 0))


def add_launch_counts(delta: tuple) -> None:
    """Add a launch_delta to the counters (a replay's launches)."""
    for fn, form, n in delta:
        if form is None:
            fn.launches += n
        else:
            fn.launches_by_form[form] += n


__all__ = ["COUNTED", "add_launch_counts", "dequantize",
           "fake_quantize", "fake_quantize_reference",
           "dequantize_reference", "fused_attention", "fused_attention_hs",
           "fused_attention_hs_blockq",
           "fused_attention_hs_blockq_reference",
           "fused_attention_hs_reference", "fused_attention_reference",
           "launch_counts", "launch_delta", "packed_qmatmul",
           "packed_qmatmul_reference", "quantize", "quantize_reference",
           "set_launch_counts", "splitk_qmatmul",
           "splitk_qmatmul_reference", "splitk_wo_matmul",
           "splitk_wo_matmul_reference"]
