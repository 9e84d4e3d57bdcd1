"""The fused head-split attention kernel (kernels/attention.py
fused_attention_hs, csrc/attention_hs.cu attention_hs_kernel) against its
roofline over the traced forwards: the configuration's
attention_products at the mix's batch."""
from benchmark.common.readers import roofline


def read(run):
    cfg, spec, mix = run.cell.config, run.cell.spec, run.cell.mix
    return roofline(run, "attention_hs_kernel",
                    {"forward": cfg.attention_products(spec, mix["batch"])})
