"""% of its least time that K6, the weight gradient of the stride-1 1x1x1
3D convs (its partial pass and its reduction), takes in the traced window:
the bound of the step's admitted convs (``core/pointwise_wgrad.py``) per
step, over the two kernels' device time. None where the program launches
no K6."""

from benchmark.core import layers, pointwise_wgrad


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    bound = pointwise_wgrad.k6_bound_s(run.ref_cf, run.cell.config["model"], run.cell.config["precision"])
    if bound is None:
        return None
    return layers.roofline(run, "train", ("pointwise_wgrad_partial_kernel", "pointwise_wgrad_reduce_kernel"), bound,
                           "request")
