"""% of the traced window in which the card ran no kernel, copy or memset."""

from benchmark.core import layers


def read(run):
    return layers.idle_pct(run, "train")
