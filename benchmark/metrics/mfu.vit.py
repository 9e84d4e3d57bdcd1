"""The ViT step's share of the card's int8 peak: the operations of one
image's products at the published shapes (the configuration's
ops_per_image) times the untraced stretch's images/s. Every product on
the path is int8."""
from benchmark.common.readers import peak_share


def read(run):
    ops = run.cell.config.ops_per_image(run.cell.spec)
    return peak_share(ops * run.record.stretch.get("images_per_s", 0.0),
                      run, "int8")
