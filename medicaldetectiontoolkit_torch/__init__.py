"""Medical Detection Toolkit — PyTorch / CUDA port for NVIDIA Hopper.

A second package beside ``medicaldetectiontoolkit_tpu`` (the JAX/Pallas
reference it is held against). Module names mirror the JAX package so each
counterpart is easy to find; inside, the code is plain PyTorch: ``nn.Module``s,
channel-first tensors, an explicit ``device``. Every Pallas kernel on a ported
path is a hand-written Hopper kernel under ``csrc/`` with a plain PyTorch
version beside it; a CPU tensor takes the plain version, a CUDA tensor the
kernel.

Ported so far: the inference paths of RetinaNet / Retina U-Net and of
Mask R-CNN / U-Faster R-CNN+ (2D + 3D), with the NMS kernel
(``ops/nms_cuda.py`` + ``csrc/nms.cu``) and the pyramid RoIAlign kernel
(``ops/roi_align_cuda.py`` + ``csrc/roi_align.cu``); the training of all
four, with the stem conv kernels (``csrc/stem_conv.cu``) and the pyramid
RoIAlign's backward kernel (in ``csrc/roi_align.cu``), through ``exec.py
--mode train | train_test``; and whole-patient test inference through
``exec.py --mode test``
(``predictor.py``, ``evaluator.py``, ``config.py``, ``experiments/lidc_exp/``,
``utils/exp_utils.py``). The package loads nothing of the JAX package: its
anchors, configs, loaders and test batches are its own, held equal to the
JAX package's by the CPU tests. Measurement scripts for the card are in
``tools/``.

Importing this package never needs a compiler: kernels build at first use.
"""

__version__ = "0.1.0"
