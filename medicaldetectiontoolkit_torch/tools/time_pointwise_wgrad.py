"""Hold the pointwise weight-gradient kernel K6 against float64 on one CUDA
card, and time it at the main path's shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_pointwise_wgrad.py [--quick]

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it.

First the registers and spills ``ptxas`` reports for each K6 instance of the
build. Then for each case (float32, TF32 off): K6's dw against the plain
version computed in float64, within ``TOL`` of its max |dw| (exit 1 if not),
two launches bit-identical, and beside it the float64 errors of the plain
version in float32 and of cuDNN's ``conv3d_weight`` (in norm and in max).
The timed cases are the 25 stride-1 1x1x1 weight gradients of the
benchmark's two LIDC training cells (3D Retina U-Net and Mask R-CNN, batch 8
of 128 x 128 x 64); for each it prints the CUDA-event time of the launch
alone (arguments prepared once; the same operands each launch, so a shape
under the 50 MB L2 reads them warm), of the whole wrapper, the host's time
per wrapper call, the plain version's time, cuDNN's ``conv3d_weight`` (a
yardstick only: the port never calls it for these convs) and the bound;
after all of them K6's device time per call (both passes) from
``torch.profiler``. ``--quick`` skips the plain version's and cuDNN's
times. The last line is a JSON object of them.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from pathlib import Path

# max |K6 - float64| over max |dw|: float32 products summed in float32, each
# accumulator at most 4,096 of them (the plan's MAX_RUN), then the 32 lanes
# and the slices; cuDNN's own float32 wgrad reads up to 1.6e-5 at the same
# shapes on an H100 (PERF.md); a wrong channel or voxel moves dw by O(1)
TOL = 1e-5


def wgrad_cases():
    """(name, x shape, cout, timed): the stride-1 1x1x1 weight gradients of
    the LIDC training cells, then shapes that take the kernel's other paths
    (V not a multiple of 4, so 4-byte copies; a misaligned x; tiles along
    both channel axes with one slice)."""
    t = True
    return [
        ("lateral0_18to36", (8, 18, 128, 128, 64), 36, t), ("seg_head_36to2", (8, 36, 128, 128, 64), 2, t),
        ("lateral1_18to36", (8, 18, 64, 64, 64), 36, t), ("c2_conv3_18to72", (8, 18, 32, 32, 64), 72, t),
        ("c2_conv1_72to18", (8, 72, 32, 32, 64), 18, t), ("lateral2_72to36", (8, 72, 32, 32, 64), 36, t),
        ("c2_conv1_18to18", (8, 18, 32, 32, 64), 18, t), ("rpn_128to18_p2", (8, 128, 32, 32, 64), 18, t),
        ("rpn_128to6_p2", (8, 128, 32, 32, 64), 6, t), ("mask_final_36to3", (48, 36, 28, 28, 10), 3, t),
        ("c3_conv1_144to36", (8, 144, 16, 16, 32), 36, t), ("c3_conv3_36to144", (8, 36, 16, 16, 32), 144, t),
        ("rpn_128to18_p3", (8, 128, 16, 16, 32), 18, t), ("rpn_128to6_p3", (8, 128, 16, 16, 32), 6, t),
        ("c4_conv1_288to72", (8, 288, 8, 8, 16), 72, t), ("c4_conv3_72to288", (8, 72, 8, 8, 16), 288, t),
        ("lateral4_288to36", (8, 288, 8, 8, 16), 36, t), ("rpn_128to18_p4", (8, 128, 8, 8, 16), 18, t),
        ("rpn_128to6_p4", (8, 128, 8, 8, 16), 6, t), ("c5_conv1_576to144", (8, 576, 4, 4, 8), 144, t),
        ("c5_conv3_144to576", (8, 144, 4, 4, 8), 576, t), ("lateral5_576to36", (8, 576, 4, 4, 8), 36, t),
        ("rpn_128to18_p5", (8, 128, 4, 4, 8), 18, t), ("rpn_128to6_p5", (8, 128, 4, 4, 8), 6, t),
        ("classifier_144to144", (48, 144, 1, 1, 1), 144, t),
        ("v105_20to7", (3, 20, 5, 7, 3), 7, False), ("misaligned_9to13", (2, 9, 8, 8, 8), 13, False),
        ("tiles_200to150", (2, 200, 4, 4, 4), 150, False),
    ]


def case_inputs(torch, name, xs, cout, seed=3):
    """x uniform on [0, 1) (as after a ReLU), dy normal; the misaligned case
    starts x one float into its buffer."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    n = math.prod(xs)
    if name.startswith("misaligned"):
        x = torch.rand(n + 1, generator=g, device="cuda")[1:].view(xs)
    else:
        x = torch.rand(xs, generator=g, device="cuda")
    dy = torch.randn((xs[0], cout, *xs[2:]), generator=g, device="cuda")
    return x, dy


def ptxas_lines(log_text):
    """{K6 instance: "N registers, spills S bytes"} from the build's
    ``-Xptxas -v`` output, by copy width."""
    found, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"pointwise_wgrad_(partial|reduce)_kernel(?:ILi(\d+)EE)?", line)
        if "Compiling entry function" in line:
            name = None
            if m:
                name = "reduce" if m.group(1) == "reduce" else f"q{m.group(2)}"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)
            found[name] = f"spills {spill.group(1) if spill else '?'} bytes"
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found[name] = f"{regs.group(1)} registers, {found.get(name, 'spills ? bytes')}"
            name = None
    return found


def launcher(torch, pointwise_wgrad_cuda, x, dy):
    """K6's launch alone on arguments prepared once (the plan, scratch and
    dw allocated once)."""
    p, shape_arr, plan_arr = pointwise_wgrad_cuda.launch_plan(x, dy)
    dw = torch.empty((dy.shape[1], x.shape[1]), dtype=torch.float32, device=x.device)
    partial = torch.empty(p["scratch"], dtype=torch.float32, device=x.device) if p["scratch"] else dw
    lib = pointwise_wgrad_cuda._load()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr())

    def launch():
        if lib.mdt_pointwise_wgrad_launch(*ptrs, shape_arr, plan_arr, stream) != 0:
            raise RuntimeError("K6 launch failed")
    launch.keep = (partial, dw)
    return launch


def bound(common, x, dy):
    """K6's least time (ms, what bounds it): x, dy and dw once at the memory
    rate; 2 x the multiply-adds at the float32 rate."""
    n_dw = dy.shape[1] * x.shape[1]
    return common.bound((x.numel() + dy.numel() + n_dw) * 4, 2.0 * dy.numel() * x.shape[1])


def k6_device_ms(torch, fn, iters=10):
    """Device ms per call of K6's kernels, from ``torch.profiler``; None if
    the trace holds no launch of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "pointwise_wgrad_" in e.name]
    return sum(us) / iters / 1e3 if us else None


def _errors(torch, t, ref64):
    d = t.double() - ref64
    return float(d.norm() / ref64.norm()), float(d.abs().max() / ref64.abs().max())


def check_cases(torch, common, pointwise_wgrad, pointwise_wgrad_cuda, cases, quick=False, iters=10):
    """Every case through K6 (twice), its plain version in float32 and
    float64 and cuDNN's ``conv3d_weight`` on the card (AssertionError where
    K6 is beyond ``TOL`` of float64 or two launches differ). For the timed
    cases returns {name: times, bound and errors} (after every case; the
    AssertionError names each case that failed): ``ms`` (the launch alone,
    CUDA events), ``wrapper_ms``, ``host_ms`` (per wrapper call),
    ``plain_ms``, ``cudnn_ms`` (``conv3d_weight``), ``bound_ms`` /
    ``bound_by``, ``pct_bound`` (bound over ``ms``), ``err_f64`` /
    ``norm_f64`` (K6), ``plain_*`` and ``cudnn_*`` (the same for the plain
    version and cuDNN)."""
    timings, failed = {}, []
    for name, xs, cout, timed in cases:
        x, dy = case_inputs(torch, name, xs, cout)
        dw = pointwise_wgrad_cuda.pointwise_wgrad(x, dy)
        again = pointwise_wgrad_cuda.pointwise_wgrad(x, dy)
        ref64 = pointwise_wgrad.pointwise_wgrad_reference(x.double(), dy.double())
        plain = pointwise_wgrad.pointwise_wgrad_reference(x, dy)
        cudnn = torch.nn.grad.conv3d_weight(x, (cout, xs[1], 1, 1, 1), dy).view(cout, xs[1])
        torch.cuda.synchronize()
        t = {}
        for key, val in (("", dw), ("plain_", plain), ("cudnn_", cudnn)):
            t[key + "norm_f64"], t[key + "err_f64"] = _errors(torch, val, ref64)
        same = bool(torch.equal(dw, again))
        p = pointwise_wgrad_cuda.launch_plan(x, dy)[0]
        print(f"  {name}: x {xs} cout {cout}: max|K6 - f64| / max|dw| {t['err_f64']:.3e} (tol {TOL:.0e}; norm "
              f"{t['norm_f64']:.3e}), plain {t['plain_err_f64']:.3e} / {t['plain_norm_f64']:.3e}, cuDNN "
              f"{t['cudnn_err_f64']:.3e} / {t['cudnn_norm_f64']:.3e} (max / norm); twice bit-identical {same}; plan "
              f"{json.dumps({k: p[k] for k in (*pointwise_wgrad_cuda.PLAN_KEYS, 'ntm', 'ntc', 'threads')})}")
        if not (t["err_f64"] <= TOL and same and dw.shape == (cout, xs[1])):
            failed.append(name)
        if timed:
            ms = common.cuda_ms
            call = lambda: pointwise_wgrad_cuda.pointwise_wgrad(x, dy)  # noqa: E731
            t["ms"] = ms(launcher(torch, pointwise_wgrad_cuda, x, dy), iters)
            t["wrapper_ms"], t["host_ms"] = ms(call, iters), common.host_ms(call, iters)
            t["bound_ms"], t["bound_by"] = bound(common, x, dy)
            t["pct_bound"] = 100.0 * t["bound_ms"] / t["ms"]
            if not quick:
                t["plain_ms"] = ms(lambda: pointwise_wgrad.pointwise_wgrad_reference(x, dy), 3, 1)
                t["cudnn_ms"] = ms(lambda: torch.nn.grad.conv3d_weight(x, (cout, xs[1], 1, 1, 1), dy), 3, 1)
            print(f"  {name}: launch alone {t['ms']:.4f} ms ({t['pct_bound']:.1f}% of a {t['bound_ms']:.4f} ms "
                  f"bound, {t['bound_by']}), wrapper {t['wrapper_ms']:.4f} ms (host {t['host_ms']:.4f} ms per call)"
                  + ("" if quick else f", plain {t['plain_ms']:.4f} ms, conv3d_weight {t['cudnn_ms']:.4f} ms")
                  + " (CUDA events)")
            timings[name] = t
        del x, dy, dw, again, ref64, plain, cudnn
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K6 disagrees with float64 or with itself on {', '.join(failed)}")
    return timings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="skip the plain version's and cuDNN's times")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import torch

    from medicaldetectiontoolkit_torch.ops import pointwise_wgrad, pointwise_wgrad_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(pointwise_wgrad_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {pointwise_wgrad_cuda.__file__}, not the package under {root}: run this "
                         f"script by its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = pointwise_wgrad_cuda.build()
    log = lib.with_suffix(".log")
    regs = ptxas_lines(log.read_text()) if log.exists() else {}
    for inst, line in regs.items():
        print(f"  ptxas K6 {inst}: {line}")
    cases = wgrad_cases()
    try:
        timings = check_cases(torch, common, pointwise_wgrad, pointwise_wgrad_cuda, cases, args.quick)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    # the profiler last, so that no CUDA-event or host time is taken in a
    # process whose launches it has traced
    for name, xs, cout, timed in cases:
        if name in timings:
            x, dy = case_inputs(torch, name, xs, cout)
            ms = k6_device_ms(torch, lambda: pointwise_wgrad_cuda.pointwise_wgrad(x, dy))
            timings[name]["profiled_ms"] = ms
            print(f"  {name}: K6 in the profiler {'not measured' if ms is None else f'{ms:.4f} ms'} a call")
            del x, dy
    print(json.dumps({"card": card, "package": str(root), "ptxas": regs, "cases": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
