"""% of its least time that K4, the stem conv's weight gradient (its
partial pass and its reduction), takes in the traced window."""

from benchmark.core import layers, work


def read(run):
    return layers.roofline(run, "train", ("stem_wgrad_partial_kernel", "stem_wgrad_reduce_kernel"),
                           work.k4_bound_s(run.ref_cf), "launch")
