"""No run loads JAX, flax or the JAX package, and the reference loads
nothing of the measured package either: each is imported in a fresh
process and ``sys.modules``' top-level names are compared whole."""

from __future__ import annotations

import json
import os
import subprocess
import sys

from conftest import REPO

JAX = {"jax", "jaxlib", "flax", "medicaldetectiontoolkit_tpu"}

LOAD_HARNESS = """
import json, sys
from pathlib import Path
from benchmark import run
from benchmark.core import cell, compare, data, layers, program, trace, work
bench = json.loads(Path("BENCHMARK.json").read_text())
for w in bench["workloads"]:
    c = cell.Cell(Path("."), w["name"])
    c.traffic()
    c.family()
    for m in c.per_layer():
        c.reader(m["name"])
    cell.program_config(c.config)
import medicaldetectiontoolkit_torch.models
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""

LOAD_REFERENCE = """
import json, sys
from benchmark.reference import models, mrcnn, ops, retina_unet
print(json.dumps(sorted({m.split(".", 1)[0] for m in sys.modules})))
"""


def _top_level(code):
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True, text=True, timeout=300,
                         check=True,
                         env=dict(os.environ, PYTHONPATH=os.pathsep.join([str(REPO), os.environ.get("PYTHONPATH", "")])))
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_harness_and_program_load_no_jax():
    loaded = _top_level(LOAD_HARNESS)
    assert "medicaldetectiontoolkit_torch" in loaded
    assert not loaded & JAX


def test_reference_loads_neither_jax_nor_the_program():
    loaded = _top_level(LOAD_REFERENCE)
    assert not loaded & (JAX | {"medicaldetectiontoolkit_torch"})
