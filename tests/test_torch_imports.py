"""The port and ``chip_smoke.py`` import without jax, flax, optax, pandas,
sklearn or matplotlib and without any module of the JAX package (and
without building the native host library), running
every detector (a training step of the one-stage ones with the opt-in stem
path included, one of them data-parallel at world size 1 over gloo, and of
Detection U-Net), the port's test mode (``exec
--mode test``, then ``--mode analysis``, figures off: they import
matplotlib where it is installed) on a tiny synthetic LIDC set and
the toy and PET-CT generators and loaders load none of them either, and
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
    "medicaldetectiontoolkit_torch.ops.cuda_build",
    "medicaldetectiontoolkit_torch.ops.losses",
    "medicaldetectiontoolkit_torch.ops.matching",
    "medicaldetectiontoolkit_torch.ops.stem_conv",
    "medicaldetectiontoolkit_torch.ops.stem_conv_cuda",
    "medicaldetectiontoolkit_torch.ops.conv_wgrad",
    "medicaldetectiontoolkit_torch.ops.conv_wgrad_cuda",
    "medicaldetectiontoolkit_torch.ops.pointwise_wgrad",
    "medicaldetectiontoolkit_torch.ops.pointwise_wgrad_cuda",
    "medicaldetectiontoolkit_torch.ops.topk",
    "medicaldetectiontoolkit_torch.ops.roi_align",
    "medicaldetectiontoolkit_torch.ops.roi_align_cuda",
    "medicaldetectiontoolkit_torch.models",
    "medicaldetectiontoolkit_torch.models.backbone",
    "medicaldetectiontoolkit_torch.models.base",
    "medicaldetectiontoolkit_torch.models.retina_net",
    "medicaldetectiontoolkit_torch.models.mrcnn",
    "medicaldetectiontoolkit_torch.models.detection_unet",
    "medicaldetectiontoolkit_torch.utils",
    "medicaldetectiontoolkit_torch.utils.convert",
    "medicaldetectiontoolkit_torch.utils.trace",
    "medicaldetectiontoolkit_torch.tools",
    "medicaldetectiontoolkit_torch.tools.common",
    "medicaldetectiontoolkit_torch.tools.profile_slice",
    "medicaldetectiontoolkit_torch.tools.ab_nms",
    "medicaldetectiontoolkit_torch.tools.time_nms",
    "medicaldetectiontoolkit_torch.tools.time_paths",
    "medicaldetectiontoolkit_torch.tools.time_patient",
    "medicaldetectiontoolkit_torch.config",
    "medicaldetectiontoolkit_torch.data",
    "medicaldetectiontoolkit_torch.data.dataloader_utils",
    "medicaldetectiontoolkit_torch.data.seg_to_boxes",
    "medicaldetectiontoolkit_torch.experiments",
    "medicaldetectiontoolkit_torch.experiments.lidc_exp",
    "medicaldetectiontoolkit_torch.experiments.lidc_exp.configs",
    "medicaldetectiontoolkit_torch.experiments.lidc_exp.data_loader",
    "medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing",
    "medicaldetectiontoolkit_torch.experiments.lidc_exp.pack_dataset",
    "medicaldetectiontoolkit_torch.experiments.toy_exp",
    "medicaldetectiontoolkit_torch.experiments.toy_exp.configs",
    "medicaldetectiontoolkit_torch.experiments.toy_exp.data_loader",
    "medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys",
    "medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification",
    "medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.configs",
    "medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.data_loader",
    "medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing",
    "medicaldetectiontoolkit_torch.tools.convergence",
    "medicaldetectiontoolkit_torch.utils.exp_utils",
    "medicaldetectiontoolkit_torch.predictor",
    "medicaldetectiontoolkit_torch.evaluator",
    "medicaldetectiontoolkit_torch.exec",
    "medicaldetectiontoolkit_torch.native",
    "medicaldetectiontoolkit_torch.data.augmentation",
    "medicaldetectiontoolkit_torch.data.loader",
    "medicaldetectiontoolkit_torch.plotting",
    "medicaldetectiontoolkit_torch.tools.time_train",
    "medicaldetectiontoolkit_torch.tools.time_roi_align_bwd",
    "medicaldetectiontoolkit_torch.tools.time_stem",
    "medicaldetectiontoolkit_torch.tools.time_conv_wgrad",
    "medicaldetectiontoolkit_torch.tools.time_pointwise_wgrad",
    "medicaldetectiontoolkit_torch.tools.time_roi_align",
    "medicaldetectiontoolkit_torch.parallel",
    "medicaldetectiontoolkit_torch.parallel.mesh",
    "chip_smoke",
]


def _run(code, cwd, env_extra=None):
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=cwd, capture_output=True, text=True, timeout=300, env=env)


def test_port_imports_no_jax_or_host_heavy_packages():
    code = (
        "import importlib, sys\n"
        f"for m in {PORT_MODULES!r}: importlib.import_module(m)\n"
        "from medicaldetectiontoolkit_torch import native\n"
        "print('NATIVE_AT_IMPORT', native._lib, native.lib_info())\n"
        "from medicaldetectiontoolkit_torch.models import build_model\n"
        "from medicaldetectiontoolkit_torch.testing import make_batch, make_config\n"
        "for model in ('retina_unet', 'mrcnn', 'ufrcnn', 'detection_unet'):\n"
        "    cf = make_config(model=model, dim=2)\n"
        "    net = build_model(cf, None, device='cpu')\n"
        "    net.initialize(seed=0)\n"
        "    net.test_forward(make_batch(cf, seed=0), return_masks=True)\n"
        "net.train_forward(make_batch(cf, seed=0))\n"
        "import os\n"
        "os.environ['MDT_STEM_PALLAS'] = '1'\n"
        "cf = make_config(model='retina_unet', dim=3, batch_size=2)\n"
        "net = build_model(cf, None, device='cpu')\n"
        "net.initialize(seed=0)\n"
        "net.train_forward(make_batch(cf, seed=0))\n"
        "assert net.module.fpn.stem0[0].stem_kernel\n"
        "from medicaldetectiontoolkit_torch.parallel import mesh\n"
        "os.environ.update(MDT_DIST_COORD=f'127.0.0.1:{mesh.free_port()}', MDT_DIST_NPROCS='1', MDT_DIST_RANK='0')\n"
        "assert mesh.maybe_initialize_distributed(device='cpu')\n"
        "net.enable_data_parallel()\n"
        "net.train_forward(make_batch(cf, seed=0))\n"
        "mesh.dist.destroy_process_group()\n"
        "for k in ('MDT_DIST_COORD', 'MDT_DIST_NPROCS', 'MDT_DIST_RANK'): os.environ.pop(k)\n"
        "import tempfile\n"
        "from medicaldetectiontoolkit_torch import exec as port_exec\n"
        "from medicaldetectiontoolkit_torch.testing import make_lidc_experiment, run_lidc_test\n"
        "with tempfile.TemporaryDirectory() as root:\n"
        "    cf = make_lidc_experiment(root, {'MDT_DIM': '3', 'MDT_MODEL': 'retina_unet', 'MDT_LIDC_PATCH': '32,32,8',\n"
        "                                     'MDT_LIDC_BS': '4'},\n"
        "                              {'start_filts': 4, 'end_filts': 8, 'n_rpn_features': 8, 'pre_nms_limit': 500,\n"
        "                               'n_cv_splits': 4, 'plot_prediction_histograms': False})\n"
        "    out = run_lidc_test(cf, device='cpu')\n"
        "    assert any(b['box_type'] == 'det' for r in out['results'] for bl in r[0] for b in bl)\n"
        "    port_exec.main(['--mode', 'analysis', '--exp_source', os.path.join('medicaldetectiontoolkit_torch',\n"
        "                   'experiments', 'lidc_exp'), '--exp_dir', cf.exp_dir, '--folds', '0'])\n"
        "    from medicaldetectiontoolkit_torch.experiments.toy_exp import configs as toy_configs, data_loader\n"
        "    from medicaldetectiontoolkit_torch.experiments.toy_exp.generate_toys import generate_experiment\n"
        "    generate_experiment(root, 'donuts_shape', 3, 1, 'donuts_shape')\n"
        "    os.environ['MDT_TOY_ROOT'] = root\n"
        "    tcf = toy_configs.configs()\n"
        "    batch = next(data_loader.PatientBatchIterator(data_loader.load_dataset(tcf, None), tcf))\n"
        "    assert batch['data'].shape == (1, 1, 320, 320)\n"
        "    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import configs as petct_configs\n"
        "    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification import data_loader as petct_dl\n"
        "    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing import (\n"
        "        generate_synthetic_petct)\n"
        "    generate_synthetic_petct(os.path.join(root, 'petct'), n_patients=2, shape=(8, 40, 40))\n"
        "    os.environ.update(MDT_PETCT_PP=os.path.join(root, 'petct'), MDT_PETCT_PATCH='32,32,8')\n"
        "    pcf = petct_configs.configs()\n"
        "    batch = next(petct_dl.PatientBatchIterator(petct_dl.load_dataset(pcf, None), pcf))\n"
        "    assert batch['data'].shape[1:] == (2, 32, 32, 8)\n"
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
    assert "NATIVE_AT_IMPORT None {}" in res.stdout, res.stdout


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
