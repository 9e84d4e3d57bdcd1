"""The weight-only products' kernel (kernels/qmatmul.py splitk_wo_matmul,
csrc/qmatmul_wo.cu wo_kernel) against its roofline over the traced steps
and prefills: the configuration's wo_products at the slots and at the
prefill length."""
from benchmark.common.readers import roofline


def read(run):
    cfg, spec = run.cell.config, run.cell.spec
    sv = spec["serving"]
    return roofline(run, "wo_kernel", {
        "decode_step": cfg.wo_products(spec, sv["slots"]),
        "prefill": cfg.wo_products(spec, sv["prefill_len"])})
