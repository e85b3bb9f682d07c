"""Measurement scripts of the port, run on one CUDA card from the repository
root, e.g. ``python3 -m medicaldetectiontoolkit_torch.tools.profile_slice``."""
