"""The port and ``chip_smoke.py`` import without jax, flax, optax, pandas,
sklearn or matplotlib and without any module of the JAX package, and
``chip_smoke.py`` refuses to run without a GPU."""

import os
import shutil
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")
pytest.importorskip("jax")

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BANNED = ("jax", "jaxlib", "flax", "optax", "pandas", "sklearn", "matplotlib")
PORT_MODULES = [
    "medicaldetectiontoolkit_torch",
    "medicaldetectiontoolkit_torch.testing",
    "medicaldetectiontoolkit_torch.ops",
    "medicaldetectiontoolkit_torch.ops.anchors",
    "medicaldetectiontoolkit_torch.ops.boxes",
    "medicaldetectiontoolkit_torch.ops.nms",
    "medicaldetectiontoolkit_torch.ops.nms_cuda",
    "medicaldetectiontoolkit_torch.models",
    "medicaldetectiontoolkit_torch.models.backbone",
    "medicaldetectiontoolkit_torch.models.base",
    "medicaldetectiontoolkit_torch.models.retina_net",
    "medicaldetectiontoolkit_torch.utils",
    "medicaldetectiontoolkit_torch.utils.convert",
    "medicaldetectiontoolkit_torch.tools",
    "medicaldetectiontoolkit_torch.tools.common",
    "medicaldetectiontoolkit_torch.tools.profile_slice",
    "medicaldetectiontoolkit_torch.tools.ab_nms",
    "chip_smoke",
]


def _run(code, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_port_imports_no_jax_or_host_heavy_packages():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "from medicaldetectiontoolkit_torch.models import build_model\n"
        "from medicaldetectiontoolkit_torch.testing import make_batch, make_config\n"
        "cf = make_config(model='retina_unet', dim=2)\n"
        "net = build_model(cf, None, device='cpu')\n"
        "net.initialize(seed=0)\n"
        "net.test_forward(make_batch(cf, seed=0))\n"
        f"bad = sorted(m for m in sys.modules if m.split('.')[0] in {BANNED!r})\n"
        "print('BANNED', bad)\n"
        "print('JAX_PACKAGE', sorted(m for m in sys.modules if m.startswith('medicaldetectiontoolkit_tpu')))\n"
        "print('JAX_FILES', sorted(m.__name__ for m in list(sys.modules.values())\n"
        "                          if 'medicaldetectiontoolkit_tpu' in (getattr(m, '__file__', None) or '')))\n"
    )
    res = _run(code, REPO, {"PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")})
    assert res.returncode == 0, res.stderr[-3000:]
    assert "BANNED []" in res.stdout, res.stdout
    assert "JAX_PACKAGE []" in res.stdout, res.stdout
    assert "JAX_FILES []" in res.stdout, res.stdout


def test_chip_smoke_fails_without_gpu_or_repo(tmp_path):
    # any card of the host is hidden, so this holds on a GPU machine too
    hidden = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=REPO, capture_output=True, text=True, timeout=300,
                         env=hidden)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    # alone in a directory, without the repository beside it
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in hidden.items() if k != "PYTHONPATH"}
    res = subprocess.run([sys.executable, "chip_smoke.py"], cwd=tmp_path, capture_output=True, text=True,
                         timeout=300, env=env)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
