"""Host ms per served chunk in the program's ``wait`` spans: the convert's
device-to-host copies, which wait for the chunks queued before them."""

from benchmark.core import program_spans


def read(run):
    return program_spans.host_ms(run, "infer", "wait")
