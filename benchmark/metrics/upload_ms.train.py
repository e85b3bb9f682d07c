"""Host ms per training step in the program's ``upload`` span: the batch's
copies to the card (``models/base.py::host_to_device`` through the
detector's ``_prep``: pinning, the host-side casts and the GT masks)."""

from benchmark.core import program_spans


def read(run):
    return program_spans.host_ms(run, "train", "upload")
