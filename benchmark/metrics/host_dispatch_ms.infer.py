"""Host ms per chunk in the harness's span around the dispatch call."""

from benchmark.core import layers


def read(run):
    return layers.dispatch_ms(run, "infer")
