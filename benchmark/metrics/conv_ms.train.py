"""Device ms per request in the conv kernel class (cuDNN's convolutions,
forward and backward) of the traced window."""

from benchmark.core import layers


def read(run):
    return layers.class_ms(run, "train", "conv")
