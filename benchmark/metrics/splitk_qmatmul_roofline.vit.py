"""The packed int8 products' kernel (kernels/qmatmul.py splitk_qmatmul,
csrc/qmatmul.cu qmatmul_kernel) against its roofline over the traced
forwards: the configuration's qmatmul_products at the mix's batch."""
from benchmark.common.readers import roofline


def read(run):
    cfg, spec, mix = run.cell.config, run.cell.spec, run.cell.mix
    return roofline(run, "qmatmul_kernel",
                    {"forward": cfg.qmatmul_products(spec, mix["batch"])})
