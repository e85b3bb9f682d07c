"""Host ms per training step in the program's ``wait`` spans: where the
host blocks on the card (the convert's wait for its host copies, and any
synchronising call inside the dispatch)."""

from benchmark.core import program_spans


def read(run):
    return program_spans.host_ms(run, "train", "wait")
