"""Device ms per served chunk in the event pair of the program's ``refine``
span: the one-stage refinement (batch top-k, decode, K1, merge)."""

from benchmark.core import program_spans


def read(run):
    return program_spans.device_ms(run, "infer", "refine")
