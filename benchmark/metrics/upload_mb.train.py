"""MB (1e6 bytes) uploaded per training step: the program's
``upload.bytes`` counter (every ``host_to_device`` call, the step's small
constants included)."""

from benchmark.core import program_spans


def read(run):
    mb = program_spans.counter(run, "train", "upload.bytes")
    return None if mb is None else mb / 1e6
