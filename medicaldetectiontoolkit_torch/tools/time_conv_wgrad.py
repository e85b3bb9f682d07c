"""Hold the conv weight-gradient kernel K5 against its plain PyTorch version
on one CUDA card, and time it at the main path's shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_conv_wgrad.py [--quick]

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it.

First the registers and spills ``ptxas`` reports for each K5 instance of the
build. Then for each case (float32, TF32 off): K5's dw against the plain
version within ``TOL`` of the plain version's max |dw| (exit 1 if not), and
two launches bit-identical. The timed cases are the six largest weight
gradients K5 takes in the benchmark's two LIDC training cells (3D Retina
U-Net and Mask R-CNN, batch 8 of 128 x 128 x 64); for each it prints the CUDA-event
time of the launch alone (arguments prepared once), of the whole wrapper,
the host's time per wrapper call, the plain version's time, cuDNN's
``conv3d_weight`` with benchmark mode off and on (a yardstick only: the
port never calls it for these convs) and the bound; after all of them K5's
device time per call (both passes) from ``torch.profiler``. ``--quick``
skips the plain version's and cuDNN's times. The last line is a JSON object
of them.
"""

from __future__ import annotations

import argparse
import json
import math
import re
import sys
from pathlib import Path

# max |K5 - plain| over max |dw|: both sum the same float32 products, in
# other orders (K5 one accumulator per slice, up to 190 K products at the
# out0 shape, then the slices; the plain version per tap through a float32
# matrix product). Measured on an H100: at most 1.13e-5 (out0, 8.4 M
# products; K5 1.12e-5 and the plain version 3.5e-6 from float64); a wrong
# tap, channel or voxel moves dw by its own size, O(1)
TOL = 3e-5


def wgrad_cases():
    """(name, x shape, w shape, stride, padding, timed): the six largest
    weight gradients K5 takes in the LIDC training cells, then shapes that
    take the kernel's other paths (the strided 7x7x7 stem, which the gate
    leaves to cuDNN; kz 3 in 4-byte copies, nb > 1, a slab's padding, an odd
    cout, deep levels, a cin-1 stem)."""
    one, same = (1, 1, 1), (1, 1, 1)
    return [
        ("out0_36to36", (8, 36, 128, 128, 64), (36, 36, 3, 3, 3), one, same, True),
        ("stem0_18to18", (8, 18, 128, 128, 64), (18, 18, 3, 3, 3), one, same, True),
        ("head_64to64_p2", (8, 64, 32, 32, 64), (64, 64, 3, 3, 3), one, same, True),
        ("box_final_64to54_p2", (8, 64, 32, 32, 64), (54, 64, 3, 3, 3), one, same, True),
        ("head_36to64_p2", (8, 36, 32, 32, 64), (64, 36, 3, 3, 3), one, same, True),
        ("rpn_36to128_p2", (8, 36, 32, 32, 64), (128, 36, 3, 3, 3), one, same, True),
        ("stem1_k7", (8, 18, 128, 128, 64), (18, 18, 7, 7, 7), (2, 2, 1), (3, 3, 3), False),
        ("c5_144to144", (8, 144, 4, 4, 8), (144, 144, 3, 3, 3), one, same, False),
        ("mask_head_36to36", (48, 36, 14, 14, 5), (36, 36, 3, 3, 3), one, same, False),
        ("classifier_7x7x3", (48, 36, 7, 7, 3), (144, 36, 7, 7, 3), one, (0, 0, 0), False),
        ("slab_pad011", (2, 36, 18, 32, 64), (36, 36, 3, 3, 3), one, (0, 1, 1), False),
        ("cin1_k7", (2, 1, 64, 64, 32), (18, 1, 7, 7, 7), (2, 2, 1), (3, 3, 3), False),
    ]


def case_inputs(torch, xs, ws, stride, padding, seed=3):
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.rand(xs, generator=g, device="cuda")
    out = [(n + 2 * p - k) // s + 1 for n, k, s, p in zip(xs[2:], ws[2:], stride, padding)]
    dy = torch.randn((xs[0], ws[0], *out), generator=g, device="cuda")
    return x, dy


def ptxas_lines(log_text):
    """{K5 instance: "N registers, spills S bytes"} from the build's
    ``-Xptxas -v`` output, by TM, KZT and copy width."""
    found, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"conv3d_wgrad_(partial|reduce)_kernel(?:ILi(\d+)ELi(\d+)ELi(\d+)E)?", line)
        if "Compiling entry function" in line:
            name = None
            if m:
                name = "reduce" if m.group(1) == "reduce" else f"tm{m.group(2)} kzt{m.group(3)} q{m.group(4)}"
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)
            found[name] = f"spills {spill.group(1) if spill else '?'} bytes"
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found[name] = f"{regs.group(1)} registers, {found.get(name, 'spills ? bytes')}"
            name = None
    return found


def launcher(torch, conv_wgrad_cuda, x, dy, ks, stride, padding):
    """K5's launch alone on arguments prepared once (the plan, scratch and
    dw allocated once)."""
    p, shape_arr, plan_arr = conv_wgrad_cuda.launch_plan(x, dy, ks, stride, padding)
    partial = torch.empty(p["scratch"], dtype=torch.float32, device=x.device)
    dw = torch.empty((dy.shape[1], x.shape[1], *ks), dtype=torch.float32, device=x.device)
    lib = conv_wgrad_cuda._load()
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), dy.data_ptr(), partial.data_ptr(), dw.data_ptr())

    def launch():
        if lib.mdt_conv_wgrad_launch(*ptrs, shape_arr, plan_arr, stream) != 0:
            raise RuntimeError("K5 launch failed")
    launch.keep = (partial, dw)
    return launch


def bound(common, x, dy, ks):
    """K5's least time (ms, what bounds it): x, dy and dw once at the
    memory rate; 2 x the multiply-adds at the float32 rate."""
    macs = dy.numel() * x.shape[1] * math.prod(ks)
    n_dw = dy.shape[1] * x.shape[1] * math.prod(ks)
    return common.bound((x.numel() + dy.numel() + n_dw) * 4, 2.0 * macs)


def k5_device_ms(torch, fn, iters=10):
    """Device ms per call of K5's two kernels, from ``torch.profiler``; None
    if the trace holds no launch of them."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    us = [e.time_range.elapsed_us() for e in prof.events()
          if e.device_type == torch.autograd.DeviceType.CUDA and "conv3d_wgrad_" in e.name]
    return sum(us) / iters / 1e3 if us else None


def check_cases(torch, common, conv_wgrad, conv_wgrad_cuda, cases, quick=False, iters=10):
    """Every case through K5 (twice) and its plain version on the card
    (AssertionError beyond ``TOL`` or where two launches differ). For the
    timed cases returns {name: times and bound} (after every case; the
    AssertionError names each case that failed): ``ms`` (the launch alone,
    CUDA events), ``wrapper_ms``, ``host_ms`` (per wrapper call),
    ``plain_ms``, ``cudnn_ms`` / ``cudnn_benchmark_ms`` (``conv3d_weight``,
    benchmark mode off / on), ``bound_ms`` / ``bound_by``, ``tflops`` (2 x
    MACs over ``ms``) and ``rel_err``."""
    timings, failed = {}, []
    for name, xs, ws, stride, padding, timed in cases:
        ks = ws[2:]
        x, dy = case_inputs(torch, xs, ws, stride, padding)
        dw = conv_wgrad_cuda.conv3d_wgrad(x, dy, ks, stride, padding)
        again = conv_wgrad_cuda.conv3d_wgrad(x, dy, ks, stride, padding)
        ref = conv_wgrad.conv3d_wgrad_reference(x, dy, ks, stride, padding)
        ref64 = conv_wgrad.conv3d_wgrad_reference(x.double(), dy.double(), ks, stride, padding)
        torch.cuda.synchronize()
        scale = float(ref64.abs().max())
        err = float((dw - ref).abs().max()) / scale
        err64, plain64 = (float((t.double() - ref64).abs().max()) / scale for t in (dw, ref))
        same = bool(torch.equal(dw, again))
        p = conv_wgrad_cuda.launch_plan(x, dy, ks, stride, padding)[0]
        print(f"  {name}: x {xs} w {ws} stride {stride} pad {padding}: max|K5 - plain| / max|dw| {err:.3e} (tol "
              f"{TOL:.0e}; K5 {err64:.3e} and plain {plain64:.3e} from float64), twice bit-identical {same}; plan "
              f"{json.dumps({k: p[k] for k in conv_wgrad_cuda.PLAN_KEYS})}")
        if not (err <= TOL and same and dw.shape == ref.shape):
            failed.append(name)
        if timed:
            ms, t = common.cuda_ms, {"rel_err": err, "err_f64": err64, "plain_err_f64": plain64}
            call = lambda: conv_wgrad_cuda.conv3d_wgrad(x, dy, ks, stride, padding)  # noqa: E731
            t["ms"] = ms(launcher(torch, conv_wgrad_cuda, x, dy, ks, stride, padding), iters)
            t["wrapper_ms"], t["host_ms"] = ms(call, iters), common.host_ms(call, iters)
            t["bound_ms"], t["bound_by"] = bound(common, x, dy, ks)
            t["tflops"] = 2.0 * dy.numel() * x.shape[1] * math.prod(ks) / t["ms"] / 1e9
            if not quick:
                t["plain_ms"] = ms(lambda: conv_wgrad.conv3d_wgrad_reference(x, dy, ks, stride, padding), 2, 1)
                for key, bench in (("cudnn_ms", False), ("cudnn_benchmark_ms", True)):
                    torch.backends.cudnn.benchmark = bench
                    t[key] = ms(lambda: torch.nn.grad.conv3d_weight(x, ws, dy, stride=stride, padding=padding),
                                iters, 3)
                torch.backends.cudnn.benchmark = False
            print(f"  {name}: launch alone {t['ms']:.4f} ms ({t['tflops']:.2f} TFLOP/s), wrapper "
                  f"{t['wrapper_ms']:.4f} ms (host {t['host_ms']:.4f} ms per call), bound {t['bound_ms']:.4f} ms "
                  f"({t['bound_by']})" + ("" if quick else f", plain {t['plain_ms']:.2f} ms, conv3d_weight "
                                                            f"{t['cudnn_ms']:.4f} ms (benchmark mode "
                                                            f"{t['cudnn_benchmark_ms']:.4f} ms)") + " (CUDA events)")
            timings[name] = t
        del x, dy, dw, again, ref, ref64
        torch.cuda.empty_cache()
    if failed:
        raise AssertionError(f"K5 disagrees with its plain version on {', '.join(failed)}")
    return timings


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--quick", action="store_true", help="skip the plain version's and cuDNN's times")
    args = ap.parse_args()
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import torch

    from medicaldetectiontoolkit_torch.ops import conv_wgrad, conv_wgrad_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(conv_wgrad_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {conv_wgrad_cuda.__file__}, not the package under {root}: run this script by "
                         f"its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = conv_wgrad_cuda.build()
    log = lib.with_suffix(".log")
    regs = ptxas_lines(log.read_text()) if log.exists() else {}
    for inst, line in regs.items():
        print(f"  ptxas K5 {inst}: {line}")
    cases = wgrad_cases()
    try:
        timings = check_cases(torch, common, conv_wgrad, conv_wgrad_cuda, cases, args.quick)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    # the profiler last, so that no CUDA-event or host time is taken in a
    # process whose launches it has traced
    for name, xs, ws, stride, padding, timed in cases:
        if name in timings:
            x, dy = case_inputs(torch, xs, ws, stride, padding)
            ms = k5_device_ms(torch, lambda: conv_wgrad_cuda.conv3d_wgrad(x, dy, ws[2:], stride, padding))
            timings[name]["profiled_ms"] = ms
            print(f"  {name}: K5 in the profiler {'not measured' if ms is None else f'{ms:.4f} ms'} a call")
            del x, dy
    print(json.dumps({"card": card, "package": str(root), "ptxas": regs, "cases": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
