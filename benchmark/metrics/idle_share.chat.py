"""The share of the traced stretch in which no operation ran on the
device (1 - the union of the device records over the traced wall)."""
from benchmark.common.readers import idle_share


def read(run):
    return idle_share(run)
