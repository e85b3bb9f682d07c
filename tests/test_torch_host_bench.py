"""The port's host-path bench (``medicaldetectiontoolkit_torch/tools/host_bench.py``)
at tiny sizes on the CPU, in a process where jax cannot be imported: one
JSON line per bench and native mode, with the root tool's keys, the mode
and the CPU count; the native and NumPy paths keep the same clusters and
boxes; the LIDC preprocessing bench prints one line, with no native mode."""

import json
import os
import subprocess
import sys

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TINY = ["--reps", "1", "--wbc-boxes", "120", "--nms-boxes", "150", "--patients", "4", "--boxes-per-patient", "5",
        "--aug-shape", "24", "24", "12", "--aug-patch", "16", "16", "8", "--lidc-ct", "12", "32", "32"]
RUN = ("import json, sys; sys.modules['jax'] = None; "
       "from medicaldetectiontoolkit_torch.tools import host_bench; host_bench.main(sys.argv[1:]); "
       "bad = [m for m in sys.modules if m.startswith(('jax', 'medicaldetectiontoolkit_tpu')) and sys.modules[m]]; "
       "assert not bad, bad")
METRICS = ["wbc_3d_120boxes", "nms_2to3d_150boxes", "evaluator_4pat_5box", "augment_3d_patch"]


@pytest.fixture(scope="module")
def lines():
    env = dict(os.environ, OMP_NUM_THREADS="2", PYTHONPATH=os.pathsep.join([REPO, os.environ.get("PYTHONPATH", "")]))
    proc = subprocess.run([sys.executable, "-c", RUN, *TINY], cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return [json.loads(line) for line in proc.stdout.splitlines() if line.startswith("{")]


def test_one_line_per_bench_and_mode(lines):
    assert [(d["metric"], d["native"]) for d in lines] == \
        [(m, mode) for mode in ("on", "off") for m in METRICS] + [("lidc_pp_12x32x32", "n/a")]
    for d in lines:
        assert {"metric", "value", "unit", "native", "cpus"} <= set(d)
        assert d["value"] > 0 and d["cpus"] == os.cpu_count()
        assert d["unit"] == ("s" if d["metric"].startswith(("evaluator", "lidc_pp")) else "ms")


def test_lidc_pp_line(lines):
    """The CT of 12 slices at 2.5 mm resampled to 1.25 mm, both stages
    timed, the two raters' nodule kept."""
    d = lines[-1]
    assert d["shape"] == [24, 32, 32] and d["fused_voxels"] > 0
    assert d["ct_s"] > 0 and d["fuse_s"] > 0 and d["value"] == pytest.approx(d["ct_s"] + d["fuse_s"])


@pytest.mark.parametrize("key", ["clusters", "kept"])
def test_native_and_numpy_paths_agree(lines, key):
    on, off = ([d[key] for d in lines if key in d and d["native"] == mode] for mode in ("on", "off"))
    assert len(on) == len(off) == 1 and on == off and on[0] > 0
