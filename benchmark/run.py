"""Run one cell of the benchmark once and print its result.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout. The cell's files are found by name
(``core/cell.py``); its traffic driver makes the inputs and weights from the
seed, builds the program, warms up the cell's own shapes, runs the measured
window for ``--seconds``, and then holds what the window produced against
the plain reference (``reference/``). With ``--trace 0`` the result carries
the cell's end-to-end metrics, with ``--trace 1`` its per-layer metrics,
read from a ``torch.profiler`` trace of the window and the harness's own
spans. The last line of standard output is one JSON object; the numbers
that decide ``correct`` are printed beside their limits as the last lines of
standard error and under the result's last key, ``checks``.

Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result. It exits with code 3 if JAX or the JAX
package has been loaded by the end of the window.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
# top-level module names that no run may load
BANNED = ("jax", "jaxlib", "flax", "medicaldetectiontoolkit_tpu")


def process_age_s() -> float:
    """Seconds since this process started (the kernel's start time)."""
    with open("/proc/self/stat") as f:
        start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
    return time.clock_gettime(time.CLOCK_BOOTTIME) - start_ticks / os.sysconf("SC_CLK_TCK")


def fixed_cache_dirs(root: Path):
    """Point the kernel caches that PyTorch and Triton keep at fixed
    directories inside the checkout, so that only a checkout's first run
    builds; the program's own nvcc builds already live in its ``_build/``."""
    cache = root / "benchmark" / ".cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def banned_modules():
    return sorted({name.split(".", 1)[0] for name in list(sys.modules)} & set(BANNED))


class Context:
    """What a traffic driver is given, and what the per-layer metrics read
    back: the cell, its model family, the seed, the window's length, the
    device, the spans and, in a traced run, the reduced trace. The driver sets ``kind``
    ("train" or "infer"), ``requests`` (steps or chunks completed in the
    window), ``flops_per_request`` and ``readings`` (the compared numbers
    and the others it prints)."""

    def __init__(self, cell, seed: int, seconds: float, trace: bool, device: str, program: str):
        from benchmark.core import cell as cell_mod
        from benchmark.core.trace import Spans

        self.cell = cell
        self.seed = seed
        self.seconds = seconds
        self.traced = trace
        self.device = device
        self.program = program
        self.cf = cell_mod.program_config(cell.config)
        self.ref_cf = cell_mod.reference_config(cell.config)
        self.family = cell.family()
        self.spans = Spans()
        self.spans.traced = trace
        self.trace = None
        self._prof = None
        self.setup_s = None
        self.window_s = None
        self.t0 = None
        self.setup_marks = [("process start to the driver", process_age_s())]

    def mark(self, what: str):
        """Note how far set-up has come (seconds since the process started)."""
        self.setup_marks.append((what, process_age_s()))

    def seed_for(self, stream: int) -> int:
        """A seed of its own for each stream of draws (inputs, weights,
        the program's random draws, the sample of answers judged)."""
        import numpy as np

        return int(np.random.default_rng([self.seed % 2 ** 64, stream]).integers(2 ** 62))

    def synchronize(self):
        import torch

        if self.device == "cuda":
            torch.cuda.synchronize()

    def start_window(self):
        """End of set-up: every shape is warm. Drops the warm-up's spans,
        resets the memory peak, starts
        the profiler in a traced run, and starts the window's clock."""
        import torch

        self.synchronize()
        self.spans.records.clear()
        if self.device == "cuda":
            torch.cuda.reset_peak_memory_stats()
        if self.traced:
            from torch.profiler import ProfilerActivity, profile

            acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if self.device == "cuda" else [])
            self._prof = profile(activities=acts)
            self._prof.__enter__()
        self.setup_s = process_age_s()
        self.setup_marks.append(("warm-up done", self.setup_s))
        self.t0 = time.perf_counter()

    def end_window(self):
        """The window closes when its last request has completed."""
        self.synchronize()
        self.window_s = time.perf_counter() - self.t0
        if self._prof is not None:
            from benchmark.core.trace import reduce_trace

            self._prof.__exit__(None, None, None)
            self.trace = reduce_trace(self._prof, self.window_s)
            self._prof = None

    def peak_bytes(self) -> int:
        import torch

        return int(torch.cuda.max_memory_allocated()) if self.device == "cuda" else 0


def parse(argv):
    ap = argparse.ArgumentParser(prog="python3 -m benchmark.run", description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True, help="a cell named in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True, help="length of the measured window")
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv=None, device: str | None = None, root: Path = ROOT, program: str = "port") -> int:
    """Run a cell. ``device`` None requires the CUDA cards the cell asks
    for; the tests pass ``"cpu"`` to drive a run on the CPU. ``program``
    ``"control"`` puts the reference, one precision lower, in the program's
    place (``core/program.py``)."""
    args = parse(argv)
    fixed_cache_dirs(root)
    from benchmark.core.cell import Cell

    cell = Cell(root, args.workload)
    os.environ.update(cell.config.get("env", {}))
    import torch

    if device is None:
        if not torch.cuda.is_available() or torch.cuda.device_count() < cell.entry["chips"]:
            n = torch.cuda.device_count() if torch.cuda.is_available() else 0
            print(f"benchmark: needs {cell.entry['chips']} CUDA card(s), found {n}", file=sys.stderr)
            return 2
        device = "cuda"
    precision = cell.config["precision"]
    torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = bool(precision["tf32"])

    ctx = Context(cell, args.seed, args.seconds, bool(args.trace), device, program)
    out = cell.traffic().run(ctx)

    found = banned_modules()
    if found:
        print(f"benchmark: loaded {', '.join(found)}, which no run may load", file=sys.stderr)
        return 3
    if args.trace:
        metrics = {}
        for m in cell.per_layer():
            value = cell.reader(m["name"])(ctx)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    else:
        metrics = {m["name"]: {"value": out["metrics"][m["name"]], "unit": m["unit"]} for m in cell.end_to_end()}
    device_info = {"platform": "gpu" if device == "cuda" else device,
                   "kind": torch.cuda.get_device_name(0) if device == "cuda" else "cpu",
                   "count": cell.entry["chips"], "memory_peak_bytes": out["memory_peak_bytes"]}
    result = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
              "metrics": metrics, "device": device_info}
    if args.trace:
        device_info["busy_s"] = ctx.trace["busy_s"] if ctx.trace else 0.0
        device_info["window_s"] = ctx.window_s
        if ctx.trace:
            result["breakdown"] = ctx.trace["breakdown"]
    result["checks"] = out["checks"]
    print("readings " + json.dumps(getattr(ctx, "readings", {})), file=sys.stderr)
    print("setup " + json.dumps(ctx.setup_marks), file=sys.stderr)
    if ctx.trace:
        print("trace " + json.dumps({k: ctx.trace[k] for k in ("by_class", "idle_by_span", "host_runtime")}),
              file=sys.stderr)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
