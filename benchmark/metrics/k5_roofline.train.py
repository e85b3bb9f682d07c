"""% of its least time that K5, the weight gradient of the 3D convs with a
kernel larger than 1 voxel (its partial pass and its reduction), takes in
the traced window: the bound of the step's admitted convs
(``core/wgrad.py``) per step, over the two kernels' device time. None where
the program launches no K5."""

from benchmark.core import layers, wgrad


def read(run):
    if run.kind != "train" or run.trace is None:
        return None
    bound = wgrad.k5_bound_s(run.ref_cf, run.cell.config["model"], run.cell.config["precision"])
    if bound is None:
        return None
    return layers.roofline(run, "train", ("conv3d_wgrad_partial_kernel", "conv3d_wgrad_reduce_kernel"), bound,
                           "request")
