"""The benchmark of ``medicaldetectiontoolkit_torch`` on NVIDIA GPUs: one
cell (a model configuration under one traffic mix) per run, driven by the
files under this folder. ``python3 -m benchmark.run --help``."""
