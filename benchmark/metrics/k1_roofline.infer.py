"""% of its least time that K1, the NMS kernel, takes over the chunks of
the traced window (the refinement's lanes; Mask R-CNN's proposals too)."""

from benchmark.core import layers


def read(run):
    return layers.roofline(run, "infer", ("nms_kernel",), run.family.k1_bound_s(run.ref_cf), "request")
