"""% of its least time that K3, the stem conv's forward kernel, takes in the
traced window, over all its launches (the forward and remat's recompute)."""

from benchmark.core import layers, work


def read(run):
    return layers.roofline(run, "train", ("stem_fwd_kernel",), work.k3_bound_s(run.ref_cf), "launch")
