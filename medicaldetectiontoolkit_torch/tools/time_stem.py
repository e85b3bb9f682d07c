"""Hold the stem conv forward kernel K3 against its plain PyTorch version on
one CUDA card, and time it at the main path's shapes.

    python3 medicaldetectiontoolkit_torch/tools/time_stem.py

Run it by its path: it imports the ``medicaldetectiontoolkit_torch`` of the
tree that holds it. To compare two commits on one card, unpack the other one
into a directory, copy this script and ``tools/common.py`` into its
``medicaldetectiontoolkit_torch/tools/``, and run the two copies in turns.

First the registers and spills ``ptxas`` reports for each K3 instance of the
build. Then for each case: the kernel's output against the plain version,
float32 within 1e-5 and bfloat16 within 1e-2 of the plain version's max
|value| (``chip_smoke.py`` phase 3c's tolerances; exit 1 if not). The timed
cases are Retina U-Net's conv0 (2x1x128x128x64, k 3, cout 18), Retina
Net's C1 stem (8x1x128x128x64, k 7, stride (2, 2, 1)) and PET-CT's conv0
at two input channels (8x2x192x192x32, k 3, cout 18), each in float32 and
bfloat16; for each it prints the CUDA-event time of the launch alone
(arguments prepared once), of the whole wrapper, the host's time per wrapper
call, the plain version's and ``F.conv3d``'s times and the bound; after all
of them the kernel's device time per launch from ``torch.profiler``. The last
line is a JSON object of them.
"""

from __future__ import annotations

import json
import re
import sys
from pathlib import Path


def stem_cases(torch):
    """(name, (B, cin, Y, X, Z), k, sy, sx, cout, dtype, timed)."""
    f32, bf16 = torch.float32, torch.bfloat16
    lidc, petct = (128, 128, 64), (192, 192, 32)
    return [
        ("conv0_f32", (2, 1, *lidc), 3, 1, 1, 18, f32, True),
        ("conv0_bf16", (2, 1, *lidc), 3, 1, 1, 18, bf16, True),
        # PET-CT's conv0: CT and PET as two channels, batch 8 as exec's training runs it
        ("conv0_cin2_f32", (8, 2, *petct), 3, 1, 1, 18, f32, True),
        ("conv0_cin2_bf16", (8, 2, *petct), 3, 1, 1, 18, bf16, True),
        ("c1_f32", (8, 1, *lidc), 7, 2, 2, 18, f32, True),
        ("c1_bf16", (8, 1, *lidc), 7, 2, 2, 18, bf16, True),
        ("cout32_z61_bf16", (2, 1, 33, 47, 61), 3, 1, 1, 32, bf16, False),
    ]


def case_inputs(torch, np, shape, k, cout, dtype, seed=2):
    rng = np.random.RandomState(seed)
    cin = shape[1]
    x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda().to(dtype)
    w = torch.from_numpy((rng.randn(cout, cin, k, k, k) * 0.2).astype(np.float32)).cuda().to(dtype)
    b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda().to(dtype)
    return x, w, b


def launcher(torch, stem_conv_cuda, x, w, b, sy, sx):
    """The launch alone on arguments prepared once: ``fwd_prepare`` /
    ``fwd_launch`` where the tree has them, else (a tree from before the
    split) the library's entry point called with that tree's arguments."""
    if hasattr(stem_conv_cuda, "fwd_prepare"):
        _, args = stem_conv_cuda.fwd_prepare(x, w, b, sy, sx)
        return lambda: stem_conv_cuda.fwd_launch(args)
    lib = stem_conv_cuda._load()
    cout, k = w.shape[0], w.shape[-1]
    B, cin, Y, X, Z = x.shape
    out = torch.empty((B, cout, -(-Y // sy), -(-X // sx), Z), dtype=x.dtype, device=x.device)
    stream = torch.cuda.current_stream().cuda_stream
    ptrs = (x.data_ptr(), w.data_ptr(), b.data_ptr(), out.data_ptr())
    dt = 0 if x.dtype == torch.float32 else 1

    def launch():
        if lib.mdt_stem_fwd_launch(*ptrs, dt, B, cin, Y, X, Z, cout, k, sy, sx, stream) != 0:
            raise RuntimeError("K3 launch failed")
    launch.keep = (out,)
    return launch


def ptxas_lines(log_text):
    """{K3 instance: "N registers, spills S bytes"} from the build's
    ``-Xptxas -v`` output, by dtype, k and channels summed."""
    found, name = {}, None
    for line in log_text.splitlines():
        m = re.search(r"stem_fwd_kernelI(f|13__nv_bfloat16)Li(\d)ELi(\d+)E", line)
        if "Compiling entry function" in line:
            name = f"{'f32' if m.group(1) == 'f' else 'bf16'} k{m.group(2)} co{m.group(3)}" if m else None
        elif name and "spill stores" in line:
            spill = re.search(r"(\d+) bytes spill stores", line)
            found[name] = f"spills {spill.group(1) if spill else '?'} bytes"
        elif name and "Used" in line and "registers" in line:
            regs = re.search(r"Used (\d+) registers", line)
            found[name] = f"{regs.group(1)} registers, {found.get(name, 'spills ? bytes')}"
            name = None
    return found


def k3_times(torch, common, stem_conv, stem_conv_cuda, x, w, b, sy, sx, iters=20):
    """K3's times on x, w, b (ms): ``ms`` the launch alone and
    ``wrapper_ms`` the whole call (CUDA events), ``host_ms`` the host's time
    per wrapper call, ``plain_ms``, ``library_ms`` (``F.conv3d``), and
    ``bound_ms`` / ``bound_by`` for reading x, w and b and writing the
    output once and the float32 or bf16 FMAs of the sums."""
    ms, k = common.cuda_ms, w.shape[-1]
    call = lambda: stem_conv_cuda.stem_conv3d(x, w, b, sy, sx)  # noqa: E731
    t = {"ms": ms(launcher(torch, stem_conv_cuda, x, w, b, sy, sx), iters), "wrapper_ms": ms(call, iters),
         "host_ms": common.host_ms(call, iters),
         "plain_ms": ms(lambda: stem_conv.stem_conv3d_reference(x, w, b, sy, sx), 3, 1),
         "library_ms": ms(lambda: torch.nn.functional.conv3d(x, w, b, (sy, sx, 1), k // 2), iters)}
    n_out = x.shape[0] * w.shape[0] * -(-x.shape[2] // sy) * -(-x.shape[3] // sx) * x.shape[4]
    t["bound_ms"], t["bound_by"] = common.bound(
        (x.numel() + w.numel() + b.numel() + n_out) * x.element_size(), 2 * n_out * x.shape[1] * k**3,
        "float32" if x.dtype == torch.float32 else "bfloat16")
    return t


def check_cases(torch, np, common, stem_conv, stem_conv_cuda, cases, iters=20):
    """Every case through K3 and its plain version on the card (AssertionError
    beyond the tolerance). For the timed cases returns {name: times and
    bound}: ``ms`` (the launch alone, CUDA events), ``wrapper_ms`` (the whole
    call), ``host_ms`` (the host's time per wrapper call), ``plain_ms``,
    ``library_ms`` (``F.conv3d``), ``bound_ms`` / ``bound_by`` and
    ``max_abs_err``."""
    timings = {}
    for name, shape, k, sy, sx, cout, dtype, timed in cases:
        x, w, b = case_inputs(torch, np, shape, k, cout, dtype)
        out = stem_conv_cuda.stem_conv3d(x, w, b, sy, sx)
        ref = stem_conv.stem_conv3d_reference(x, w, b, sy, sx)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        tol = (1e-5 if dtype == torch.float32 else 1e-2) * float(ref.float().abs().max())
        print(f"  {name}: {str(dtype)[6:]} x {tuple(shape)} k {k} stride ({sy},{sx},1) cout {cout}: max|err| "
              f"{err:.3e} (tol {tol:.3e})")
        if out.dtype != dtype or out.shape != ref.shape or not err <= tol:
            raise AssertionError(f"K3 disagrees with its plain version on {name}")
        if timed:
            t = dict(k3_times(torch, common, stem_conv, stem_conv_cuda, x, w, b, sy, sx, iters), max_abs_err=err)
            print(f"  {name}: launch alone {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms (host "
                  f"{t['host_ms']:.4f} ms per call), plain {t['plain_ms']:.4f} ms, F.conv3d {t['library_ms']:.4f} "
                  f"ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']}) (CUDA events)")
            timings[name] = t
        del x, w, b, out, ref
        torch.cuda.empty_cache()
    return timings


def main() -> int:
    root = Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(root))
    import numpy as np
    import torch

    from medicaldetectiontoolkit_torch.ops import stem_conv, stem_conv_cuda
    from medicaldetectiontoolkit_torch.tools import common

    if not Path(stem_conv_cuda.__file__).resolve().is_relative_to(root):
        raise SystemExit(f"imported {stem_conv_cuda.__file__}, not the package under {root}: run this script by "
                         f"its path")
    card = common.setup_card()
    print(f"card: {card}; package {root}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    lib = stem_conv_cuda.build()
    log = lib.with_suffix(".log")
    regs = ptxas_lines(log.read_text()) if log.exists() else {}
    for inst, line in regs.items():
        print(f"  ptxas K3 {inst}: {line}")
    cases = stem_cases(torch)
    try:
        timings = check_cases(torch, np, common, stem_conv, stem_conv_cuda, cases)
    except AssertionError as e:
        print(f"FAILED: {e}")
        return 1
    # the profiler last, so that no CUDA-event or host time is taken in a
    # process whose launches it has traced
    for name, shape, k, sy, sx, cout, dtype, timed in cases:
        if name in timings:
            x, w, b = case_inputs(torch, np, shape, k, cout, dtype)
            ms = common.profiled_kernel_ms(lambda: stem_conv_cuda.stem_conv3d(x, w, b, sy, sx), "stem_fwd_kernel")
            timings[name]["profiled_ms"] = ms
            print(f"  {name}: kernel in the profiler {'not measured' if ms is None else f'{ms:.4f} ms'}")
            del x, w, b
    print(json.dumps({"card": card, "package": str(root), "ptxas": regs, "cases": timings}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
