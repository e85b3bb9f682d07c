"""% of the card's float32 peak (67 TFLOP/s): the model's FLOPs of the
requests completed in the traced window over its seconds."""

from benchmark.core import layers


def read(run):
    return layers.mfu(run, "train")
