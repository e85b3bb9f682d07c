#!/usr/bin/env python3
"""Drive the PyTorch port's inference and training paths once on one CUDA card and check them.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; no phase is caught and skipped):
  1. device: require CUDA, print the card (``nvidia-smi`` name and power
     limit), the float32 precision switches (TF32 off for convs and
     matmuls) and which of pandas, sklearn and matplotlib import there;
  2. build the three kernel sources in parallel, one nvcc each: NMS
     (``csrc/nms.cu``), pyramid RoIAlign (``csrc/roi_align.cu``) and the stem
     conv's forward and weight gradient (``csrc/stem_conv.cu``); beside them
     the native host library (``native/``, g++) that phases 8 and 9 use;
  3. NMS kernel vs plain PyTorch NMS on the card (the cases of
     ``tools/time_nms.py``): bit-identical keep lists on random, tied,
     all-invalid, ragged, sorted (ties across the walk's tiles) and
     over-capacity lanes (the global scratch, sorted and unsorted), and at
     the three main-path shapes, timed beside their bounds: Retina U-Net's
     refinement (16 broadcast lanes x 50,000), Mask R-CNN's proposals
     (8 x 6,000, 500 kept) and its refinement (16 broadcast lanes x 8,000,
     unsorted); the launch alone (the kernels line's ``ms``) and the whole
     wrapper (``wrapper_ms``);
  3b. RoIAlign kernel vs plain PyTorch pyramid RoIAlign on the card (the
     cases of ``tools/time_roi_align.py``): first a probe that the card
     computes ``t / crop`` as the kernel's ``scale`` does (a product with the
     reciprocal); then bit-identical float32 crops in 2D and 3D, every level,
     crop 1, clamped and zero-size boxes, bf16 and f16 maps, ragged RoI
     counts, boxes on which division and the reciprocal differ and boxes on
     the integer lattice (ending on S - 1), level indices -1 and n_levels,
     strided maps (channels-last, sliced), 20,000 RoIs (past one wave of
     blocks), and the Mask R-CNN slice's shapes on the LIDC pyramid (600 RoIs,
     the classify-all pass's launch shape; 4,000 in f32 and bf16; the mask
     pass's 240), with times and bounds;
  3c. stem conv kernels K3 (forward) and K4 (weight gradient) vs their plain
     PyTorch versions on the card: Retina U-Net's conv0 and Retina Net's C1
     stem at LIDC width in float32 and bfloat16 (timed), PET-CT's conv0 at
     cin 2 (8x2x192x192x32, float32 and bfloat16, timed) and its Retina Net
     C1 stem, odd Y/X and cin 2
     in both dtypes, cout 32 with Z 61 (K3's widest instance and its store
     tails), and K4's
     grid with fewer chunks than blocks and with chunks no multiple of it;
     each case prints K4's grid G and its partials' bytes and K3's plan, whose
     shared-memory bytes must equal the library's; K4 run twice must be
     bit-identical; K3's launch alone, wrapper and host time per call, K4's
     wrapper and host time, beside F.conv3d and conv3d_weight;
  3d. the backward of the RoIAlign kernel (K2's gradient to the maps, a
     float32 scatter with atomic adds) vs the plain PyTorch backward on the
     card (the cases of ``tools/time_roi_align_bwd.py``): 2D and 3D, every
     level, crop 1, clamped and zero-size boxes, level indices -1 and
     n_levels, strided maps, bf16 and f16 maps, and the two-stage training
     step's launches at LIDC width (48 sampled RoIs to (7,7,3) and to
     (14,14,5) on the 36-channel pyramid, float32 and bfloat16); each case
     twice, the runs within the atomics' tolerance; the launch alone, the
     wrapper, its host time per call and the bound;
  4. 3D Retina U-Net at LIDC width (patch 128x128x64, start_filts 18,
     end_filts 36, batch 8) through ``build_model`` ->
     ``test_forward_dispatch``/``convert``, three chunks dispatched before
     any is converted, in float32 and bfloat16; the NMS launch counter rises
     once per chunk; refine_detections with the kernel equals it with the
     plain NMS; a small 3D input agrees with the CPU run of the same weights;
  5. 3D Mask R-CNN at LIDC width (the same geometry, 3 anchors per
     position, 500 proposals per patch, RoIs classified in chunks of 600),
     three chunks with masks, float32 and bfloat16: the NMS counter rises by
     2 per chunk and the RoIAlign counter by the classify launches plus one
     mask launch per chunk; on chunk 0 the kernels give the same detections
     and masks as the plain versions on the same heads and maps;
  6. small 3D Mask R-CNN, U-Faster R-CNN+ and Detection U-Net: the card
     against the CPU run of the same weights (Detection U-Net: the softmax
     within 1e-4, the argmax and the boxes of its components equal);
  7. 3D Retina U-Net training at LIDC width (``make_train_slice_config``:
     batch 2 x 4 accumulated, remat, 300 training anchors per image) with
     ``MDT_STEM_PALLAS=1``, float32 and bfloat16, through
     ``train_forward_dispatch``/``convert``: one warm-up step, three timed
     steps; the K3, K4 and NMS counters rise by the counts derived per step;
     from the same weights and draws the cuDNN stem (the opt-in unset) gives
     the same loss and gradients within the stated tolerance, and both
     step times are printed; small 3D retina_unet, retina_net, mrcnn, ufrcnn
     and detection_unet train steps on the card agree with the CPU run of
     the same weights and draws (7b);
  8. whole-patient test inference through ``medicaldetectiontoolkit_torch.exec``
     (``--mode test``) on synthetic LIDC patients, each experiment directory
     prepared as a training run leaves one (config snapshot, hold-out split,
     ``epoch_ranking.npy``, two ranked checkpoints of random weights written by
     ``save_checkpoint``; random weights already score detections above
     ``min_det_thresh``): 3D Retina U-Net at LIDC width on a patient of z 64 x
     y 256 x x 256 (9 patches x 4 mirrors x 2 checkpoints) in float32 and
     bfloat16, K1 counted once per chunk, and every chunk's NMS inputs run
     through the plain NMS on the same card after the timed run, giving the
     same keep lists (so the same consolidated boxes); 3D Mask R-CNN at LIDC width in
     float32 with K1 (2 per chunk) and K2 (the classify-all chunks) counted; 2D
     LIDC Retina U-Net (patch 288, start_filts 48, batch 20, one slice of 3D
     context, 2D->3D merging) on z 16 x 288 x 288; and two small 3D
     patients on the card against the CPU: raw detections of each patch
     forward as phase 4b holds them (as a set), a forward that differs only as a proven
     near tie in the NMS order (one flipped pair of overlapping boxes of one
     class, their scores within 1e-5; at most 1% of the forwards), the
     consolidated ones within 1e-5 in score and 1e-3 voxels, the same AP.
     ms per patient, its split and patches/s are printed; no module of
     pandas, sklearn, matplotlib or jax is loaded;
  9. training through ``medicaldetectiontoolkit_torch.exec`` (``--mode
     train_test``) on ten synthetic LIDC patients of z 96 x 160 x 160: the
     LIDC config's 3D Retina U-Net at full width (patch 128x128x64, pre-crop
     156x156x96, batch 8, the config's 8 loader threads, the native
     resample), ``MDT_STEM_PALLAS=1``, float32, 2 epochs x 3 train batches
     and 2 ``val_sampling`` batches, then the test of fold 0's test patients
     with the ranked checkpoints; then ``--resume_to_checkpoint`` of
     ``last_checkpoint`` to a third epoch. Each train dispatch must launch
     K3 twice, K4 once and K1 once, each validation dispatch K3 and K1 once,
     each test chunk K3 and K1 once; every monitored loss is finite; the
     ranked best checkpoints, ``epoch_ranking.npy`` and ``last_checkpoint``
     are written and the best ones load back into the port; the test's WBC
     ran in the native host library; the resumed run trains epoch 3 only;
     no module of pandas, sklearn, matplotlib or jax is loaded. ms per step
     as the loop logs it, the loader's patches/s, each epoch's wall time
     and the phase's time are printed;
 10. two-stage training through ``exec --mode train_test`` on phase 9's
     patients: the LIDC config's 3D Mask R-CNN at full width (batch 8,
     float32, ``MDT_STEM_PALLAS=1``), 2 epochs x 3 train batches and 2
     ``val_sampling`` batches, then the test. Each train dispatch must
     launch K1 twice (proposals, refinement), K2 three times (classify-all,
     the sampled RoIs' classifier and mask heads), K2's backward twice, K3
     twice and K4 once; each validation dispatch K1 twice, K2 four times
     (with the mask pass on the detections) and K3 once; each test chunk K1
     twice, K2 for its classify-all chunks and K3 once; every monitored loss
     is finite; ms per step as logged. Then one warm-up and two timed
     bfloat16 train steps of ``make_mrcnn_slice_config`` with the same
     counts;
 11. Detection U-Net training through ``exec --mode train_test`` on phase
     9's patients: the LIDC config's 3D Detection U-Net at full width (patch
     128x128x64, sf 18, ef 36, batch 8, float32, ``MDT_STEM_PALLAS=1``), one
     epoch of 3 train batches and 2 ``val_sampling`` batches, then the test.
     Each train dispatch must launch K3 twice and K4 once, each validation
     dispatch and test chunk K3 once, and none K1; the first two train and
     validation converts, made from the softmax copies queued at dispatch,
     equal converts of synchronous ``.cpu()`` reads; every monitored loss is
     finite; ms per step as logged. Then steps of
     ``make_det_unet_slice_config`` in float32 and bfloat16 (one warm-up, two
     timed): dispatch to synchronise (the device) and the convert (the
     softmax's host copy waited for, argmax, connected components, boxes);
 12. the toy experiment through ``exec --mode train_test`` at its full
     width (2D, 320x320, start_filts 48, resnet50, batch 20) on 48 generated
     train and val images and 4 test images, 2 epochs x 4 train batches, 4
     validation images, for Retina U-Net (K1 counted: once per train and
     validation dispatch and per test forward) and Detection U-Net (no
     kernel of the table: the stem kernels are 3D only); the results files
     are written and each test's mean foreground roi-AP printed;
 13. the PET-CT experiment through ``exec --mode train_test`` at its
     published width (3D Retina U-Net, CT and PET as two channels, patch
     192x192x32 from a 280x280x48 pre-crop, start_filts 18, end_filts 36,
     resnet50, batch 8, float32, ``MDT_STEM_PALLAS=1``) on four synthetic
     patients of z 48 x 288 x 288: one epoch of 3 train batches with no
     validation (model selection on the train metrics), the hold-out test of
     every patient, then ``--mode analysis`` (fold ensembling). Each train
     dispatch must launch K1 once, K3 twice and K4 once, every K3/K4 call on
     an input of 2 channels; each test chunk K1 and K3 once; losses finite,
     ``results.txt`` written. Then, after a warm-up, two timed train steps
     each of the PET-CT Retina U-Net and Retina Net at the same geometry
     (K3/K4 on conv0 and on Retina Net's k-7 C1 stem, stride (2, 2, 1), at
     cin 2; launches asserted) and a small two-channel Retina U-Net train
     step on the card against the CPU (phase 7b's tolerances). ms per logged
     step, the peak device memory and the phase's time are printed;
 14. data parallelism (``parallel/mesh.py``). 14a: two ranks on the one card
     over gloo (NCCL puts no two ranks of a group on one device), started by
     ``mesh.spawn_ranks``, each taking its 4 rows of a global batch of 8 (one
     microbatch) for a step of the LIDC config's 3D Retina U-Net and of its 3D
     Mask R-CNN at full width (float32, remat, ``MDT_STEM_PALLAS=1``): loss
     within 1e-5 relative and gradients within 1e-3 of each tensor's max of
     the single-process step on the whole batch (phase 7b's tolerances), the
     two ranks' summed gradients bit-identical, and per rank and step the
     launches Retina U-Net K1 1, K3 2, K4 1 and Mask R-CNN K1 2, K2 3, K2's
     backward 2, K3 2, K4 1; ms per step per rank (two ranks sharing one
     card: not a scaling figure), the gradient buffer's MB and its
     all-reduce's ms. 14b: ``exec --mode train_test`` through the
     data-parallel path at world size 1 over NCCL (the ``MDT_DIST_*`` triple
     with ``NPROCS=1``) on phase 9's patients at LIDC width, one epoch of 3
     train and 2 ``val_sampling`` batches and the test, with phase 9's
     launches per dispatch and chunk; the data-parallel log line,
     ``results.txt`` and ``last_checkpoint`` written; ms per logged step
     beside phase 9's; then the gradient all-reduce over NCCL at world size 1;
 15. spatial partitioning for inference (``parallel/mesh.py``). 15a/b: two
     ranks share the one card over gloo as a space group (S = 2, each holding
     a Y slab of every split level; TF32 off, ``MDT_STEM_PALLAS=1``) and run
     a test forward of the LIDC-width 3D Retina U-Net and 3D Mask R-CNN (with
     masks) on a chunk of 8 at 128x128x64, float32: the gathered heads (and
     Mask R-CNN's pyramid levels) within atol 1e-5 of the one-process forward
     on the card, the seg argmax equal where the top two logits differ by
     more than 1e-5, detections equal as sets within 1e-5 in score and 1e-3
     voxels, Mask R-CNN's mask union within 1e-4 of its voxels; per rank and
     forward the launches K3 1 (on the haloed slab), K1 1 (Retina U-Net) or
     K1 2 and K2 for the classify-all chunks plus the mask pass (Mask R-CNN,
     on the gathered levels); the halo and gather collectives' calls, bytes
     and ms (fenced by synchronises), the forward's ms (two ranks sharing one
     card: not a scaling figure) and the peak device memory per rank against
     one process. 15c: ``exec --mode test`` of one small patient over two
     ranks that exec starts itself (``n_space_parallel`` 2, ``exec.main(...,
     backend="gloo")``; enabling spatial inference turns TF32 off) against
     a one-process test of the same checkpoints (TF32 off, as in the whole
     script): raw detections equal as sets, ``results.txt`` scores equal;
 16. spatial partitioning for training (``parallel/mesh.py``: the halo,
     sum and gather collectives' backward, ``enable_spatial_parallel``).
     16a: two ranks share the card over gloo as a space group (S = 2) and
     take a train step of the LIDC-width 3D Retina U-Net and 3D Mask R-CNN
     (patch 128x128x64, the global batch of 8 as one microbatch, remat,
     float32, TF32 off, ``MDT_STEM_PALLAS=1``), held against the one-process
     step on the card (loss 1e-5 relative, gradients 1e-3 of each tensor's
     max: phase 7b's tolerances; the two ranks' gradients bit-identical);
     per rank and step the launches K1 1, K3 2, K4 1 (Retina U-Net) and K1
     2, K2 3, K2 bwd 2, K3 2, K4 1 (Mask R-CNN), K3 and K4 on the haloed
     slab (phase 3c holds them at those shapes), K1, K2 and K2's backward on
     the gathered tensors; the forward and backward collectives' calls, MB
     and ms (fenced), ms per step (two ranks sharing one card: not a
     scaling figure) and the peak device memory per rank against one
     process. 16b: ``exec --mode train_test`` over two ranks that exec
     starts itself (``n_space_parallel`` 2, backend gloo) on phase 15c's
     small patients, one epoch and the test: every train and validation
     loss within 1e-5 relative of a one-process run of the same seed,
     ``last_checkpoint`` and ``results.txt`` written. Mask R-CNN's GT masks
     go up as each rank's Y slab (its bytes printed against one process's)
     and its mask targets' rows meet in one ``mask_rows`` sum (calls and
     bytes asserted); the step's target layer outputs on each rank equal,
     bit for bit, one process's on the rank's inputs and the whole masks;
 17. the host-path bench (``tools/host_bench.py``: WBC, the 2D->3D merge,
     the evaluator, spatial augmentation) at its default sizes on the
     machine's CPUs, the native host library on and off, one JSON line
     each.

Each phase's start is printed with the seconds since the script began.
The last lines are a JSON object with one entry per kernel of the paths and
``{"ok": true, "device": {...}}``.

The script imports the PyTorch package only (configs and batches come from
``medicaldetectiontoolkit_torch.testing``): neither jax nor any module of the
JAX package.
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import pickle
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor


def _check_nms(torch, np, common, nms_ops, nms_cuda, time_nms):
    """Phase 3: every case of ``tools/time_nms.py`` bit-identical to the
    plain version; the timed cases (the three main-path shapes) with their
    bounds. Returns the kernels-line entry (Retina U-Net's shape; ``ms`` the
    launch alone, ``wrapper_ms`` the whole call) and the timings of every
    timed case."""
    print("== phase 3: NMS kernel vs plain PyTorch (bit-identical idx and mask)")
    timings = time_nms.check_cases(torch, np, common, nms_ops, nms_cuda, time_nms.nms_cases(np))
    t = timings["slice_16x50000_3d"]
    entry = {k: t[k] for k in ("max_abs_err", "ms", "wrapper_ms", "plain_ms", "bound_ms", "bound_by")}
    return dict(entry, library_ms=None), timings


def _check_roi_align(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align):
    """Phase 3b: how the card divides by a Python number (the kernel copies
    that form of ``scale``), then every case of ``tools/time_roi_align.py``
    bit-identical to the plain version; the timed cases (600 and 4,000 RoIs
    to (7,7,3), f32 and bf16; the mask pass's 240 to (14,14,5)) with their
    bounds. Returns the kernels-line entry (the 600-RoI launch shape; ``ms``
    the launch alone, ``wrapper_ms`` the whole call) and the timings."""
    print("== phase 3b: RoIAlign kernel vs plain PyTorch pyramid RoIAlign (bit-identical float32 crops)")
    form = time_roi_align.division_probe(torch, np, roi_ops, roi_align_cuda)
    if form != ("reciprocal" if roi_align_cuda.SCALE_BY_RECIPROCAL else "division"):
        raise AssertionError(f"the card computes t / crop as {form}; the kernel's scale assumes "
                             f"SCALE_BY_RECIPROCAL={roi_align_cuda.SCALE_BY_RECIPROCAL}")
    timings = time_roi_align.check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels,
                                         time_roi_align.roi_cases(torch))
    t = timings["lidc_classify_600_f32"]
    entry = {k: t[k] for k in ("max_abs_err", "ms", "wrapper_ms", "host_ms", "plain_ms", "bound_ms", "bound_by")}
    return dict(entry, library_ms=None), timings


def _check_roi_align_bwd(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align,
                         time_roi_align_bwd):
    """Phase 3d: every case of ``tools/time_roi_align_bwd.py``, the kernel
    (twice) against the plain backward within that module's tolerances; the
    timed cases with their bounds. Returns the kernels-line entry (the mask
    head's launch at LIDC width, float32) and the timings."""
    print("== phase 3d: RoIAlign backward kernel vs the plain PyTorch backward (float32 atomics)")
    timings = time_roi_align_bwd.check_cases(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align,
                                             time_roi_align_bwd.bwd_cases(torch))
    t = timings["lidc_mask_48_f32"]
    entry = {k: t[k] for k in ("max_abs_err", "ms", "wrapper_ms", "host_ms", "plain_ms", "bound_ms", "bound_by")}
    return dict(entry, library_ms=None), timings


def _stem_cases(torch):
    """(name, (B, cin, Y, X, Z), k, sy, sx, cout, dtype, timed, chunks): with
    ``chunks`` "ragged", K4's chunks must outnumber its grid G and not be a
    multiple of it (2,039 chunks, a prime); with "fewer", every block of the
    grid takes one chunk (14 chunks)."""
    f32, bf16 = torch.float32, torch.bfloat16
    lidc, petct = (128, 128, 64), (192, 192, 32)
    return [
        ("conv0_2x1x128x128x64_k3", (2, 1, *lidc), 3, 1, 1, 18, f32, True, None),
        # PET-CT (CT and PET as two channels) as exec's training runs it: conv0 of Retina U-Net, and Retina
        # Net's C1 stem
        ("conv0_cin2_8x2x192x192x32_k3", (8, 2, *petct), 3, 1, 1, 18, f32, True, None),
        ("conv0_cin2_8x2x192x192x32_k3_bf16", (8, 2, *petct), 3, 1, 1, 18, bf16, True, None),
        ("c1_cin2_8x2x192x192x32_k7_s2", (8, 2, *petct), 7, 2, 2, 18, f32, False, None),
        # conv0 as exec's LIDC training runs it: batch 8 as one microbatch
        ("conv0_8x1x128x128x64_k3", (8, 1, *lidc), 3, 1, 1, 18, f32, True, None),
        ("c1_8x1x128x128x64_k7_s2", (8, 1, *lidc), 7, 2, 2, 18, f32, True, None),
        ("odd_13x11x6_k7_s2", (2, 1, 13, 11, 6), 7, 2, 2, 6, f32, False, "fewer"),
        ("cin2_64x64x32_k5_s2", (2, 2, 64, 64, 32), 5, 2, 2, 18, f32, False, None),
        ("ragged_cin2_4077x13x16_k5_s2", (1, 2, 4077, 13, 16), 5, 2, 2, 18, f32, False, "ragged"),
        ("conv0_bf16", (2, 1, *lidc), 3, 1, 1, 18, bf16, True, None),
        ("c1_bf16", (8, 1, *lidc), 7, 2, 2, 18, bf16, True, None),
        # K3's widest instance and its scalar store tails (Z % 4 != 0)
        ("cout32_z61_bf16", (2, 1, 33, 47, 61), 3, 1, 1, 32, bf16, False, None),
        # bf16 at a small odd Z (one z tile of 2 blocks) and at cin 2
        ("odd_13x11x6_k7_s2_bf16", (2, 1, 13, 11, 6), 7, 2, 2, 6, bf16, False, None),
        ("cin2_64x64x32_k5_s2_bf16", (2, 2, 64, 64, 32), 5, 2, 2, 18, bf16, False, None),
        # phase 15's haloed Y slabs (S = 2): conv0 takes 1 row on each side of its 64; Mask R-CNN's C1 stem 4
        # before (its halo of 3 rounded up to the stride) and 2 after, 35 output rows of which 32 are kept
        ("slab_conv0_8x1x66x128x64_k3", (8, 1, 66, 128, 64), 3, 1, 1, 18, f32, False, None),
        ("slab_conv0_8x1x66x128x64_k3_bf16", (8, 1, 66, 128, 64), 3, 1, 1, 18, bf16, False, None),
        ("slab_c1_8x1x70x128x64_k7_s2", (8, 1, 70, 128, 64), 7, 2, 2, 18, f32, False, None),
        ("slab_c1_8x1x70x128x64_k7_s2_bf16", (8, 1, 70, 128, 64), 7, 2, 2, 18, bf16, False, None),
    ]


def _check_stem(torch, np, common, stem_conv, stem_conv_cuda, time_stem, cases):
    """K3 and K4 against their plain versions. Tolerances, relative to the
    plain version's max |value|: K3 float32 1e-5 and K4 1e-5 (float32 sums of
    the same products in another order; K4's over up to 2 M positions);
    K3 bfloat16 1e-2 (both round the float32 sum, then the bias add, to
    bf16: a sum near a rounding boundary lands one bf16 ulp, 2^-8, apart)."""
    print("== phase 3c: stem conv kernels K3 / K4 vs plain PyTorch; K4 twice bit-identical")
    rng = np.random.RandomState(2)
    entries, timings = {}, {}
    for name, shape, k, sy, sx, cout, dtype, timed, chunks in cases:
        cin = shape[1]
        x = torch.from_numpy(rng.rand(*shape).astype(np.float32)).cuda().to(dtype)
        w = torch.from_numpy((rng.randn(cout, cin, k, k, k) * 0.2).astype(np.float32)).cuda().to(dtype)
        b = torch.from_numpy((rng.randn(cout) * 0.1).astype(np.float32)).cuda().to(dtype)
        out = stem_conv_cuda.stem_conv3d(x, w, b, sy, sx)
        ref = stem_conv.stem_conv3d_reference(x, w, b, sy, sx)
        g = torch.from_numpy(rng.randn(*out.shape).astype(np.float32)).cuda().to(dtype)
        dw, dw2 = stem_conv_cuda.stem_wgrad(x, g, k, sy, sx), stem_conv_cuda.stem_wgrad(x, g, k, sy, sx)
        dw_ref = stem_conv.stem_wgrad_reference(x, g, k, sy, sx)
        torch.cuda.synchronize()
        xt, n_chunks, grid = stem_conv_cuda.wgrad_plan(x, cout, k, sy, sx)
        print(f"  {name}: K4 plan: {n_chunks} chunks of {xt} xo columns, grid G {grid}, partials "
              f"{grid * dw.numel() * 4} bytes")
        plan = stem_conv_cuda.fwd_launch_plan(x, cout, k, sy, sx)
        lib_smem = stem_conv_cuda._load().mdt_stem_fwd_smem(cin, cout, k, sy, sx, plan["zt"], plan["tx"], plan["ty"],
                                                            x.element_size(), plan["nbuf"])
        print(f"  {name}: K3 plan: {plan['n_tiles']} tiles of {plan['zt']} z blocks x {plan['tx']} xo x "
              f"{plan['ty']} yo, grid G {plan['grid']}, {plan['threads']} threads, {plan['co']} channels summed, "
              f"{plan['nbuf']} tile buffers, shared memory {plan['smem']} bytes (library: {lib_smem})")
        if lib_smem != plan["smem"]:
            raise AssertionError(f"{name}: K3's shared memory in the library ({lib_smem}) is not the plan's")
        if (chunks == "ragged" and not (n_chunks > grid and n_chunks % grid)) or \
                (chunks == "fewer" and grid != n_chunks):
            raise AssertionError(f"{name}: K4's grid {grid} for {n_chunks} chunks is not the {chunks} case")
        err3 = float((out.float() - ref.float()).abs().max())
        err4 = float((dw - dw_ref).abs().max())
        tol3 = (1e-5 if dtype == torch.float32 else 1e-2) * float(ref.float().abs().max())
        tol4 = 1e-5 * float(dw_ref.abs().max())
        repro = torch.equal(dw, dw2)
        print(f"  {name}: {str(dtype)[6:]} x {tuple(shape)} k {k} stride ({sy},{sx},1) cout {cout}: "
              f"K3 max|err| {err3:.3e} (tol {tol3:.3e}), K4 max|err| {err4:.3e} (tol {tol4:.3e}), "
              f"K4 twice identical {repro}")
        if out.dtype != dtype or out.shape != ref.shape or not err3 <= tol3 or not err4 <= tol4 or not repro:
            raise AssertionError(f"stem kernels disagree with their plain versions on {name}")
        if timed:
            item = x.element_size()
            ops = 2 * out.numel() * cin * k**3
            ms = common.cuda_ms
            k3 = time_stem.k3_times(torch, common, stem_conv, stem_conv_cuda, x, w, b, sy, sx)
            k4 = {"ms": ms(lambda: stem_conv_cuda.stem_wgrad(x, g, k, sy, sx)),
                  "plain_ms": ms(lambda: stem_conv.stem_wgrad_reference(x, g, k, sy, sx), 3, 1),
                  "library_ms": ms(lambda: torch.nn.grad.conv3d_weight(
                      x, w.shape, g, (sy, sx, 1), k // 2), 3, 1)}
            host4 = common.host_ms(lambda: stem_conv_cuda.stem_wgrad(x, g, k, sy, sx))
            dt = "float32" if dtype == torch.float32 else "bfloat16"
            k4["bound_ms"], k4["bound_by"] = common.bound((x.numel() + g.numel()) * item + dw.numel() * 4, ops, dt)
            print(f"  {name} K3: launch alone {k3['ms']:.4f} ms, wrapper {k3['wrapper_ms']:.4f} ms (host "
                  f"{k3['host_ms']:.4f} ms per call), plain {k3['plain_ms']:.4f} ms, library "
                  f"{k3['library_ms']:.4f} ms (F.conv3d), bound {k3['bound_ms']:.4f} ms ({k3['bound_by']}) "
                  f"(CUDA events)")
            print(f"  {name} K4: kernel {k4['ms']:.4f} ms, plain {k4['plain_ms']:.4f} ms, library "
                  f"{k4['library_ms']:.4f} ms (conv3d_weight), bound {k4['bound_ms']:.4f} ms ({k4['bound_by']}) "
                  f"(CUDA events); host {host4:.4f} ms per wrapper call")
            timings[name] = (k3, k4)
            if name == "conv0_2x1x128x128x64_k3":  # the training slice's shape
                entries = {"stem_fwd": dict(k3, max_abs_err=err3), "stem_wgrad": dict(k4, max_abs_err=err4)}
        del x, w, b, out, ref, g, dw, dw2, dw_ref
        torch.cuda.empty_cache()
    return entries, timings


def _check_results(np, results, cf, seg_dtype):
    ps = tuple(cf.patch_size)
    for r in results:
        if r["seg_preds"].shape != (cf.batch_size, 1) + ps or r["seg_preds"].dtype != seg_dtype:
            raise AssertionError(f"seg_preds {r['seg_preds'].shape} {r['seg_preds'].dtype}")
        if len(r["boxes"]) != cf.batch_size:
            raise AssertionError(f"boxes list of length {len(r['boxes'])}")
        for boxes in r["boxes"]:
            for box in boxes:
                if box["box_type"] != "det" or not np.all(np.isfinite(box["box_coords"])) \
                        or not np.isfinite(box["box_score"]):
                    raise AssertionError(f"bad box {box}")
    return [sum(len(b) for b in r["boxes"]) for r in results]


def _drive_slice(torch, np, dtype, batches, common, nms_cuda, refine_detections, nms_ops, card):
    print(f"== phase 4: retina_unet 3D 128x128x64 sf18 ef36 batch 8, {dtype}")
    net = common.slice_net(dtype, seed=0)
    cf = net.cf
    n_params = sum(p.numel() for p in net.module.parameters())
    print(f"  params {n_params}, anchors {net.anchors.shape[0]}")

    # warm-up chunk (cuDNN plans, kernel library load); not counted
    net.test_forward_convert(net.test_forward_dispatch(batches[0]), batches[0])
    torch.cuda.synchronize()

    nms_cuda.batched_nms.launches = 0
    handles, results, t_dispatch, wall = common.run_window(net, batches)
    launches = nms_cuda.batched_nms.launches
    print(f"  NMS kernel launches in the main-path run: {launches} (chunks: {len(batches)})")
    if launches != len(batches):
        raise AssertionError(f"expected {len(batches)} NMS kernel launches, counted {launches}")
    for _, (det, mask, _, seg) in handles:
        if not (det.is_cuda and mask.is_cuda and seg.is_cuda):
            raise AssertionError("a main-path output is not on the CUDA card")
    n_det = _check_results(np, results, cf, np.uint8)
    per_chunk = wall / len(batches)
    print(f"  {len(batches)} chunks: dispatch {t_dispatch * 1e3:.1f} ms, dispatch+convert {wall * 1e3:.1f} ms; "
          f"{per_chunk * 1e3:.1f} ms/chunk, {8 * len(batches) / wall:.2f} patches/s ({card}); "
          f"detections per chunk {n_det}")

    # head outputs of chunk 0: finite; kernel NMS == plain NMS on them
    with torch.inference_mode():
        from medicaldetectiontoolkit_torch.models.base import host_to_device

        heads = net._predict(host_to_device(batches[0]["data"], net.device))
        for name, t in zip(("class_logits", "bb_deltas", "seg_logits"), heads):
            if not t.is_cuda or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} not finite or not on the card")
        det_k, mask_k = refine_detections(net.anchors, heads[0], heads[1], cf)
        det_p, mask_p = refine_detections(net.anchors, heads[0], heads[1], cf, nms_fn=nms_ops.batched_nms)
        torch.cuda.synchronize()
    if not (torch.equal(det_k, det_p) and torch.equal(mask_k, mask_p)):
        raise AssertionError("refine_detections: kernel NMS and plain NMS give different detections")
    print(f"  refine_detections kernel == plain on chunk 0: {int(mask_k.sum())} detections identical")
    return {"launches": launches, "per_chunk_ms": per_chunk * 1e3, "heads": [h.float().cpu() for h in heads[:2]]}


def _small_reference(torch, np, make_config, make_batch, build_model, log):
    """A small 3D retina_unet: the card (kernel NMS, TF32 off) against the CPU
    run of the same weights (plain PyTorch everywhere)."""
    print("== phase 4b: small 3D retina_unet, card vs CPU plain path")
    cf = make_config(model="retina_unet", dim=3, batch_size=2)
    batch = make_batch(cf, seed=5)
    gpu = build_model(cf, log, device="cuda")
    cpu = build_model(cf, log, device="cpu")
    gpu.initialize(seed=1)
    cpu.load_state_dict(gpu.state_dict())
    with torch.inference_mode():
        hg = [h.cpu() for h in gpu._predict(torch.from_numpy(batch["data"]).cuda())]
        hc = cpu._predict(torch.from_numpy(batch["data"]))
    for name, a, b in zip(("class_logits", "bb_deltas", "seg_logits"), hg, hc):
        _close(name, a, b)
    rg, rc = gpu.test_forward(batch), cpu.test_forward(batch)
    _same_seg(rg["seg_preds"], rc["seg_preds"])
    _same_boxes(np, rg["boxes"], rc["boxes"])


def _close(name, a, b, rel=1e-4):
    err, ref = float((a - b).abs().max()), float(b.abs().max())
    print(f"  {name}: max|gpu-cpu| {err:.3e} (max|cpu| {ref:.3e})")
    # float32 convs summed in another order: relative 1e-4
    if not err <= rel * ref:
        raise AssertionError(f"{name} differs from the CPU reference beyond {rel} relative")


def _same_seg(a, b):
    n_diff = int((a != b).sum())
    print(f"  seg_preds: {n_diff} of {b.size} voxels differ (argmax near-ties)")
    if n_diff > 1e-4 * b.size:
        raise AssertionError("small input: seg_preds differ from the CPU reference")


def _same_boxes(np, ga, ca):
    for bg, bc in zip(ga, ca):
        same = len(bg) == len(bc) and all(
            np.array_equal(g["box_coords"], c["box_coords"]) and g["box_pred_class_id"] == c["box_pred_class_id"]
            and abs(g["box_score"] - c["box_score"]) < 1e-5
            for g, c in zip(bg, bc)
        )
        if not same:
            raise AssertionError("small input: detections differ from the CPU reference")
    print(f"  detections equal: {sum(len(b) for b in ca)} boxes")


def _drive_mrcnn(torch, np, dtype, batches, common, nms_cuda, roi_align_cuda, nms_ops, roi_ops, card):
    print(f"== phase 5: mrcnn 3D 128x128x64 sf18 ef36 batch 8, {dtype}, with masks")
    net = common.slice_net(dtype, seed=0, model="mrcnn")
    cf = net.cf
    bsz, max_inst = cf.batch_size, cf.model_max_instances_per_batch_element
    n_classify = math.ceil(bsz * cf.post_nms_rois_inference / cf.roi_chunk_size)
    n_params = sum(p.numel() for p in net.module.parameters())
    print(f"  params {n_params}, anchors {net.anchors.shape[0]}, classify launches per chunk {n_classify}")

    net.test_forward_convert(net.test_forward_dispatch(batches[0]), batches[0])  # warm-up, not counted
    torch.cuda.synchronize()

    nms_cuda.batched_nms.launches = 0
    roi_align_cuda.pyramid_roi_align.launches = 0
    handles, results, t_dispatch, wall = common.run_window(net, batches)
    launches = {"nms": nms_cuda.batched_nms.launches, "roi_align": roi_align_cuda.pyramid_roi_align.launches}
    expect = {"nms": 2 * len(batches), "roi_align": (n_classify + 1) * len(batches)}
    print(f"  kernel launches in the main-path run: {launches} (expected {expect}; chunks: {len(batches)})")
    if launches != expect:
        raise AssertionError(f"expected kernel launches {expect}, counted {launches}")
    for with_masks, (det, mask, masks_raw, seg) in handles:
        if not with_masks or seg is not None:
            raise AssertionError("mrcnn handles: masks were asked for and there is no seg head")
        if not (det.is_cuda and mask.is_cuda and masks_raw.is_cuda):
            raise AssertionError("a main-path output is not on the CUDA card")
        if det.shape != (bsz, max_inst, 8) or masks_raw.shape != (bsz, max_inst, cf.head_classes, *cf.mask_shape):
            raise AssertionError(f"det {tuple(det.shape)}, masks {tuple(masks_raw.shape)}")
        if not (bool(torch.isfinite(det).all()) and bool(torch.isfinite(masks_raw).all())):
            raise AssertionError("detections or masks not finite")
    n_det = _check_results(np, results, cf, np.uint8)
    n_fg = [int(r["seg_preds"].sum()) for r in results]
    per_chunk = wall / len(batches)
    print(f"  {len(batches)} chunks: dispatch {t_dispatch * 1e3:.1f} ms, dispatch+convert {wall * 1e3:.1f} ms; "
          f"{per_chunk * 1e3:.1f} ms/chunk, {bsz * len(batches) / wall:.2f} patches/s ({card}); "
          f"detections per chunk {n_det}; mask-union voxels per chunk {n_fg}")

    # chunk 0: the kernels against the plain versions on the same heads and maps
    from medicaldetectiontoolkit_torch.models.base import host_to_device

    with torch.inference_mode():
        img = host_to_device(batches[0]["data"], net.device)
        heads = net.module.extract(img)
        for name, t in zip(("rpn_logits", "rpn_deltas"), heads[1:3]):
            if not t.is_cuda or not bool(torch.isfinite(t).all()):
                raise AssertionError(f"{name} not finite or not on the card")
        out_k = net._from_heads(heads, bsz, True)
        net.nms_fn, net.align_fn = nms_ops.batched_nms, roi_ops.pyramid_roi_align
        try:
            out_p = net._from_heads(heads, bsz, True)
        finally:
            del net.nms_fn, net.align_fn  # back to the class's dispatchers
        torch.cuda.synchronize()
    for name, k, p in zip(("det", "det_mask", "det_masks_raw"), out_k[:3], out_p[:3]):
        if not torch.equal(k, p):
            err = float((k.float() - p.float()).abs().max())
            raise AssertionError(f"{name}: kernels and plain versions differ on chunk 0 (max|err| {err:.3e})")
    print(f"  chunk 0, K1 + K2 == plain NMS + plain RoIAlign: {int(out_k[1].sum())} detections and their "
          f"masks identical")
    return {"launches": launches, "per_chunk_ms": per_chunk * 1e3,
            "heads": [h.float().cpu() for h in heads[1:3]]}


def _small_two_stage(torch, np, make_config, make_batch, build_model, log, model):
    """Small 3D two-stage detector: the card (kernels, TF32 off) against the
    CPU run of the same weights (plain PyTorch everywhere)."""
    print(f"== phase 6: small 3D {model}, card vs CPU plain path")
    cf = make_config(model=model, dim=3, batch_size=2, retina_scales=False)
    batch = make_batch(cf, seed=5)
    gpu = build_model(cf, log, device="cuda")
    cpu = build_model(cf, log, device="cpu")
    gpu.initialize(seed=1)
    cpu.load_state_dict(gpu.state_dict())
    x = torch.from_numpy(batch["data"])
    with torch.inference_mode():
        hg = gpu.module.extract(x.cuda())
        hc = cpu.module.extract(x)
        _close("rpn_logits", hg[1].cpu(), hc[1])
        _close("rpn_deltas", hg[2].cpu(), hc[2])
        # the same heads and maps on both sides: the CPU's, copied to the card
        hm = ([m.cuda() for m in hc[0]], hc[1].cuda(), hc[2].cuda(), None if hc[3] is None else hc[3].cuda())
        pg, pc = gpu._proposals(hm[1], hm[2]), cpu._proposals(hc[1], hc[2])
        if not torch.equal(pg[2].cpu(), pc[2]):
            raise AssertionError("proposals: valid slots differ")
        err = float((pg[1].cpu() - pc[1]).abs().max())
        print(f"  proposals (pixel boxes, scores): max|gpu-cpu| {err:.3e}, {int(pc[2].sum())} valid")
        # unrounded decoded boxes: exp on another device may differ in the last bit
        if err > 1e-4:
            raise AssertionError("proposals differ from the CPU reference")
        og = gpu._from_heads(hm, cf.batch_size, True)
        oc = cpu._from_heads(hc, cf.batch_size, True)
    from medicaldetectiontoolkit_torch.models.base import detections_to_box_results

    boxes = [detections_to_box_results(cf, o[0].cpu().numpy(), o[1].cpu().numpy()) for o in (og, oc)]
    _same_boxes(np, *boxes)
    if og[2] is not None:
        # random weights put mask probabilities near 0.5, where the rounded
        # union of the unmolded masks flips on any difference: compare the
        # raw masks instead
        _close("det_masks_raw", og[2].cpu(), oc[2])
    else:
        shape = batch["data"].shape
        _same_seg(gpu._make_seg_preds(*og, shape, True), cpu._make_seg_preds(*oc, shape, True))


def _small_det_unet(torch, np, make_config, make_batch, build_model, log):
    """Small 3D Detection U-Net: the card (stem kernels, TF32 off) against
    the CPU run of the same weights. The softmax within 1e-4 of its max; the
    argmax equal but for near-ties (at most 1e-4 of the voxels, each within
    1e-4 between its top two classes on the CPU); where the argmax is equal
    everywhere, the boxes of its components equal (scores within 1e-5)."""
    from medicaldetectiontoolkit_torch.models.detection_unet import channel_softmax

    print("== phase 6: small 3D detection_unet, card vs CPU plain path")
    os.environ["MDT_STEM_PALLAS"] = "1"
    cf = make_config(model="detection_unet", dim=3, batch_size=2)
    batch = make_batch(cf, seed=5)
    gpu = build_model(cf, log, device="cuda")
    cpu = build_model(cf, log, device="cpu")
    gpu.initialize(seed=1)
    cpu.load_state_dict(gpu.state_dict())
    x = torch.from_numpy(batch["data"])
    with torch.inference_mode():
        sg = channel_softmax(gpu.module(x.cuda())).cpu()
        sc = channel_softmax(cpu.module(x))
    if not gpu.module.fpn.stem0[0].stem_kernel:
        raise AssertionError("the small Detection U-Net's conv0 did not take the stem kernel")
    _close("softmax", sg, sc)
    rg, rc = gpu.test_forward(batch), cpu.test_forward(batch)
    differ = rg["seg_preds"] != rc["seg_preds"]
    top2 = np.sort(sc.numpy(), axis=1)[:, -2:]
    margin = (top2[:, 1] - top2[:, 0])[:, None]
    print(f"  argmax: {int(differ.sum())} of {differ.size} voxels differ, CPU margins there "
          f"{margin[differ].tolist()[:8]}")
    if differ.sum() > 1e-4 * differ.size or (differ.any() and margin[differ].max() > 1e-4):
        raise AssertionError("small Detection U-Net: the argmax differs from the CPU reference beyond near-ties")
    if not differ.any():
        _same_boxes(np, rg["boxes"], rc["boxes"])


def _grad_errors(torch, a, b):
    """Worst per-tensor max|a - b| / max|b| over two {name: grad} dicts."""
    errs = {n: float((a[n] - b[n]).abs().max()) / max(float(b[n].abs().max()), 1e-30) for n in b}
    name = max(errs, key=errs.get)
    return errs[name], name


def _drive_train(torch, np, dtype, batches, common, kernels, card):
    """Phase 7 in one dtype. ``kernels`` maps counter names to the wrappers
    whose ``.launches`` count the main path's kernel launches.

    A/B tolerances, the kernel stem against cuDNN's from the same weights
    and draws: float32 (TF32 off) loss 1e-4 relative, gradients 1e-2 of each
    tensor's max |g|: the stem output differs in summation order only, but
    ReLU boundaries and the sums that cancel in the early layers' gradients
    amplify that (the CPU tests measure up to 2e-3 against JAX); bfloat16
    loss 2e-2 relative and gradients 0.25 of the max: a one-ulp (2^-8)
    difference of the bf16 stem output is carried through some 60 bf16
    layers."""
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum

    print(f"== phase 7: retina_unet 3D training 128x128x64 sf18 ef36, batch 2 x 4, remat, MDT_STEM_PALLAS=1, {dtype}")
    os.environ["MDT_STEM_PALLAS"] = "1"
    net = common.slice_net(dtype, seed=0, model="retina_unet_train")
    cf = net.cf
    n_micro = resolve_grad_accum(cf, cf.batch_size)
    m = cf.batch_size // n_micro
    common.train_steps(net, batches[:1])  # warm-up: cuDNN plans, kernel load
    torch.cuda.reset_peak_memory_stats()

    for wrapper in kernels.values():
        wrapper.launches = 0
    results, times = common.train_steps(net, batches)
    launches = {name: wrapper.launches for name, wrapper in kernels.items()}
    n = len(batches)
    expect = {"stem_fwd": 2 * n_micro * n, "stem_wgrad": n_micro * n, "nms": n}
    print(f"  expected launches over {n} steps of {n_micro} microbatches: K3 2 per microbatch (its forward and "
          f"the remat recompute in the backward) = {expect['stem_fwd']}, K4 1 per microbatch = "
          f"{expect['stem_wgrad']}, K1 1 per step (refinement of the merged heads) = {expect['nms']}")
    print(f"  counted: {launches}")
    if launches != expect:
        raise AssertionError(f"expected kernel launches {expect}, counted {launches}")
    if not net.module.fpn.stem0[0].stem_kernel or net.module.fpn.stem0[1].stem_kernel:
        raise AssertionError("only stem0's first conv (cin 1) should take the stem kernels")
    for r in results:
        values = [r["loss"], *r["monitor_values"].values()]
        if not all(math.isfinite(v) for v in values) or len(r["boxes"]) != cf.batch_size:
            raise AssertionError(f"a training step gave non-finite losses or a malformed result: {r['logger_string']}")
        print(f"  {r['logger_string']}; boxes per element {[len(b) for b in r['boxes']]}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    ms = [t * 1e3 for t in times]
    print(f"  {n} steps: {', '.join(f'{t:.1f}' for t in ms)} ms per step, {cf.batch_size * n / sum(times):.2f} "
          f"patches/s, peak device memory {peak:.2f} GiB ({card})")

    # the same weights and draws through the kernel stem and cuDNN's
    inputs = net._prep(batches[0])
    draws = net.draws(n_micro, m)
    ab = {}
    for stem in ("1", "0"):
        os.environ["MDT_STEM_PALLAS"] = stem
        loss, _ = net._accumulate(inputs, draws)
        ab[stem] = (float(loss), {n_: p.grad.float().clone() for n_, p in net.module.named_parameters()})
        if net.module.fpn.stem0[0].stem_kernel != (stem == "1"):
            raise AssertionError("MDT_STEM_PALLAS did not select the stem path")
    loss_err = abs(ab["1"][0] - ab["0"][0]) / abs(ab["0"][0])
    grad_err, worst = _grad_errors(torch, ab["1"][1], ab["0"][1])
    loss_tol, grad_tol = (1e-4, 1e-2) if dtype == "float32" else (2e-2, 0.25)
    print(f"  kernel stem vs cuDNN stem, same weights and draws: loss {ab['1'][0]:.6f} vs {ab['0'][0]:.6f} "
          f"(relative {loss_err:.2e}, tol {loss_tol}); worst gradient {grad_err:.2e} of its tensor's max "
          f"({worst}; tol {grad_tol})")
    if not (loss_err <= loss_tol and grad_err <= grad_tol):
        raise AssertionError("the kernel stem and cuDNN's stem give different losses or gradients")
    del ab, inputs

    # end-to-end A/B of K3/K4 against cuDNN's stem: steps in turns
    ab_ms = {"1": [], "0": []}
    for i, stem in enumerate(("1", "0", "0", "1", "1", "0")):
        os.environ["MDT_STEM_PALLAS"] = stem
        ab_ms[stem] += [t * 1e3 for t in common.train_steps(net, [batches[i % n]])[1]]
    os.environ["MDT_STEM_PALLAS"] = "1"
    print(f"  step ms with K3/K4 {[round(t, 1) for t in ab_ms['1']]}, with cuDNN's stem "
          f"{[round(t, 1) for t in ab_ms['0']]} (turns 1 0 0 1 1 0)")
    return {"launches": launches, "ms": ms, "patches_per_s": cf.batch_size * n / sum(times), "peak_gib": peak,
            "ab_ms": ab_ms}


def _small_train(torch, np, make_config, make_batch, build_model, log, model, n_channels=1):
    """A small 3D train step (2 microbatches of 2, remat, the stem kernels)
    on the card against the CPU run of the same weights and draws. Float32
    with TF32 off: loss within 1e-5 relative, gradients within 1e-3 of each
    tensor's max, updated params within 1e-6 where the gradient is clear of
    zero and of one sign on both (Adam's first step is lr * sign(g)), else
    2 lr. The two-stage detectors take the weights and batch of
    ``tests/test_torch_mrcnn_train.py``'s 3D mrcnn case (positive RoIs are
    sampled), and their sampled RoIs must be the same slots and classes on
    both, the boxes within 1e-5."""
    print(f"== phase {'7b' if n_channels == 1 else 13}: small 3D {model} train step at {n_channels} input "
          f"channel(s), card vs CPU plain path")
    os.environ["MDT_STEM_PALLAS"] = "1"
    two_stage = model in ("mrcnn", "ufrcnn")
    seg_only = model == "detection_unet"  # no draws: a loss of the seg head alone
    cf = make_config(model=model, dim=3, batch_size=4, retina_scales=not two_stage)
    cf.grad_accum_steps, cf.n_channels = 2, n_channels
    if two_stage:
        cf.pre_nms_limit, cf.post_nms_rois_training = 2000, 300
    batch = make_batch(cf, seed=1 if two_stage else 5)
    gpu = build_model(cf, log, device="cuda")
    cpu = build_model(cf, log, device="cpu")
    gpu.initialize(seed=4 if two_stage else 1)
    cpu.load_state_dict(gpu.state_dict())
    draws = None if seg_only else cpu.draws(2, 2)
    out, sampled = {}, {}
    for net, d in ((gpu, None if seg_only else [t.cuda() for t in draws]), (cpu, draws)):
        net.current_lr = 1e-3
        loss, aux = net._accumulate(*net._prep(batch)) if seg_only else net._accumulate(net._prep(batch), d)
        grads = {n: p.grad.float().cpu().clone() for n, p in net.module.named_parameters()}
        net._update()
        out[net.device.type] = (float(loss), grads, {n: p.detach().cpu() for n, p in net.module.named_parameters()})
        if two_stage:
            sampled[net.device.type] = [[a[k].cpu() for k in ("sampled_valid", "sampled_class", "sampled_rois")] +
                                        [float(a["monitor"]["mrcnn_bbox_loss"])] for a in aux]
    if two_stage:
        for g, c in zip(sampled["cuda"], sampled["cpu"]):
            same = torch.equal(g[0], c[0]) and torch.equal(g[1], c[1]) and float((g[2] - c[2]).abs().max()) <= 1e-5
            print(f"  microbatch: {int(c[0].sum())} sampled RoIs, {int((c[1] > 0).sum())} positive (box loss "
                  f"{c[3]:.4f}); the same on the card: {same}")
            if not same:
                raise AssertionError(f"small {model} train step: the card sampled other RoIs than the CPU")
    stem = gpu.module.fpn.stem0[0] if cf.operate_stride1 else gpu.module.fpn.stem1
    if not stem.stem_kernel or stem.conv.weight.shape[1] != n_channels:
        raise AssertionError(f"the small net's stem (cin {n_channels}) did not take the stem kernels")
    loss_err = abs(out["cuda"][0] - out["cpu"][0]) / abs(out["cpu"][0])
    grad_err, worst = _grad_errors(torch, out["cuda"][1], out["cpu"][1])
    p_err = 0.0
    for n, g in out["cpu"][1].items():
        clear = (torch.sign(g) == torch.sign(out["cuda"][1][n])) & (g.abs() > 1e-3 * g.abs().max())
        diff = (out["cuda"][2][n] - out["cpu"][2][n]).abs()
        p_err = max(p_err, float(torch.where(clear, diff, 0.0).max()))
        if float(diff.max()) > 2e-3 + 1e-6:
            raise AssertionError(f"{n}: updated params differ by more than 2 lr")
    print(f"  loss {out['cuda'][0]:.6f} vs {out['cpu'][0]:.6f} (relative {loss_err:.2e}); worst gradient "
          f"{grad_err:.2e} of its tensor's max ({worst}); updated params where the gradient is clear of zero: "
          f"max|gpu-cpu| {p_err:.2e}")
    if not (loss_err <= 1e-5 and grad_err <= 1e-3 and p_err <= 1e-6):
        raise AssertionError(f"small {model} train step: the card differs from the CPU reference")


PATIENT_3D = (64, 256, 256)  # z, y, x: 9 patches of 128 x 128 x 64
PATIENT_2D = (16, 288, 288)  # one patch of 288 x 288 per slice
BANNED = ("pandas", "sklearn", "matplotlib", "jax", "jaxlib", "flax", "optax")


def _host_packages():
    """Which of pandas, sklearn and matplotlib import on this machine (in a
    child process: this one must not load them)."""
    code = ("import importlib\nfor m in ('pandas', 'sklearn', 'matplotlib'):\n    try:\n        "
            "importlib.import_module(m); print(m, 'imports')\n    except ImportError as e:\n        "
            "print(m, 'does not import:', e)")
    return subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, timeout=120).stdout.strip()


def _quietly(log_path, fn, *args, **kwargs):
    """``fn`` with the experiment loggers' console lines sent to ``log_path``
    (each fold's ``exec.log`` keeps them too)."""
    with open(log_path, "a") as handle, contextlib.redirect_stdout(handle):
        return fn(*args, **kwargs)


def _timed_test(torch, run_lidc_test, cf, log_path, device="cuda"):
    """``exec --mode test`` of ``cf``'s experiment; (result, host seconds
    ending in a synchronise)."""
    t0 = time.perf_counter()
    out = _quietly(log_path, run_lidc_test, cf, device=device)
    if device == "cuda":
        torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def _patient_line(name, out, wall, forwards, card):
    t = out["predictor"].times
    stitch = t["patient"] - t["forward"]
    n_det = sum(b["box_type"] == "det" for r in out["results"] for bl in r[0] for b in bl)
    print(f"  {name}: {wall * 1e3:.1f} ms per patient (forward {t['forward'] * 1e3:.1f}, stitching "
          f"{stitch * 1e3:.1f}, consolidation {t['consolidation'] * 1e3:.1f}, evaluation "
          f"{out['evaluation_s'] * 1e3:.1f} ms); {forwards} patch forwards, {forwards / wall:.2f} patches/s "
          f"({forwards / t['forward']:.2f} over the forward); {n_det} consolidated detections ({card})")
    if not n_det:
        raise AssertionError(f"{name}: no detection survived consolidation")
    return {"ms": wall * 1e3, "forward_ms": t["forward"] * 1e3, "stitching_ms": stitch * 1e3,
            "consolidation_ms": t["consolidation"] * 1e3, "evaluation_ms": out["evaluation_s"] * 1e3,
            "patches_per_s": forwards / wall}


def _same_consolidated(np, a, b, score_tol=0.0, coord_tol=0.0):
    """Two consolidated results lists: the same patients, boxes, classes and
    labels in the same order; scores and (score-weighted mean) coords within
    the tolerances. Returns the largest differences (score, coords)."""
    worst = [0.0, 0.0]
    if [r[1] for r in a] != [r[1] for r in b]:
        raise AssertionError("consolidated results: the patients differ")
    for (ba, _), (bb, _) in zip(a, b):
        for la, lb in zip(ba, bb):
            if len(la) != len(lb):
                raise AssertionError(f"consolidated results: {len(la)} boxes against {len(lb)}")
            for x, y in zip(la, lb):
                if x["box_type"] != y["box_type"] or x.get("box_pred_class_id") != y.get("box_pred_class_id") \
                        or x.get("box_label") != y.get("box_label"):
                    raise AssertionError(f"consolidated results: {x} against {y}")
                worst[1] = max(worst[1], float(np.abs(np.asarray(x["box_coords"], float)
                                                      - np.asarray(y["box_coords"], float)).max()))
                if x["box_type"] == "det":
                    worst[0] = max(worst[0], abs(float(x["box_score"]) - float(y["box_score"])))
    if worst[0] > score_tol or worst[1] > coord_tol:
        raise AssertionError(f"consolidated results differ: max|score| {worst[0]:.3e} (tol {score_tol}), "
                             f"max|coords| {worst[1]:.3e} (tol {coord_tol})")
    return worst


def _box_iou(np, a, b):
    """IoU of two boxes (y1, x1, y2, x2[, z1, z2]) as the NMS computes it
    (``ops/nms.py::_iou_rows``, pixel offset 1)."""
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    inter, area_a, area_b = 1.0, 1.0, 1.0
    for lo, hi in ((0, 2), (1, 3), (4, 5))[: len(a) // 2]:
        inter *= max(min(a[hi], b[hi]) - max(a[lo], b[lo]) + 1.0, 0.0)
        area_a *= a[hi] - a[lo] + 1.0
        area_b *= b[hi] - b[lo] + 1.0
    return inter / (area_a + area_b - inter)


def _near_tie_forwards(np, raw_a, raw_b, iou_threshold, score_tol=1e-5):
    """Raw detections of two runs, per patient and patch forward (rank,
    mirror, patch): equal as phase 4b holds them (coords and classes equal,
    scores within ``score_tol``), matched as a set, since two boxes whose
    scores lie within the error may leave the top-k in either order (seen on
    the card: one forward in 432). A forward that differs passes only as a
    proven near tie in the NMS order: every box matched but one on each side,
    the two of one class, overlapping (IoU above the NMS threshold, so the
    NMS keeps one of them) and within ``score_tol`` in score (the card-vs-CPU
    error bounds the gap between the two kept scores of a flipped pair). At
    most 1% of a patient's forwards may be such near ties. Returns {pid:
    number of near-tie forwards}."""
    out = {}
    for (ba, pid), (bb, pid_b) in zip(raw_a, raw_b):
        if pid != pid_b:
            raise AssertionError("raw predictions: the patients differ")
        forwards = {}
        for side, boxes in ((0, ba[0]), (1, bb[0])):
            for b in boxes:
                if b["box_type"] == "det":
                    forwards.setdefault(b["patch_id"], ([], []))[side].append(b)
        ties = 0
        for patch_id, (da, db) in forwards.items():
            rest_b = list(db)
            rest_a = []
            for x in da:
                hit = next((j for j, y in enumerate(rest_b)
                            if np.array_equal(x["box_coords"], y["box_coords"])
                            and x["box_pred_class_id"] == y["box_pred_class_id"]
                            and abs(x["box_score"] - y["box_score"]) < score_tol), None)
                if hit is None:
                    rest_a.append(x)
                else:
                    rest_b.pop(hit)
            if not rest_a and not rest_b:
                continue
            desc = [[([round(float(v), 3) for v in x["box_coords"]], x["box_pred_class_id"],
                      float(x["box_score"])) for x in r] for r in (rest_a, rest_b)]
            if len(rest_a) != 1 or len(rest_b) != 1:
                raise AssertionError(f"{pid} forward {patch_id}: unmatched boxes card {desc[0]}, CPU {desc[1]}: "
                                     f"not one flipped pair")
            x, y = rest_a[0], rest_b[0]
            iou = _box_iou(np, x["box_coords"], y["box_coords"])
            gap = abs(float(x["box_score"]) - float(y["box_score"]))
            print(f"  {pid} forward {patch_id}: near tie, card keeps {desc[0][0]}, CPU keeps {desc[1][0]}; IoU "
                  f"{iou:.3f} (NMS threshold {iou_threshold}), score gap {gap:.3e} (tol {score_tol})")
            if x["box_pred_class_id"] != y["box_pred_class_id"] or not iou > iou_threshold or not gap < score_tol:
                raise AssertionError(f"{pid} forward {patch_id}: the card and the CPU keep different boxes that "
                                     f"are not a near tie in the NMS order")
            ties += 1
        print(f"  {pid}: raw detections {sum(len(f[0]) for f in forwards.values())} / "
              f"{sum(len(f[1]) for f in forwards.values())}; {ties} of {len(forwards)} patch forwards keep other "
              f"boxes, each a proven near tie in the NMS order")
        if ties > 0.01 * len(forwards):
            raise AssertionError(f"{pid}: {ties} of {len(forwards)} patch forwards differ from the CPU reference")
        out[pid] = ties
    return out


class _RecordedNMS:
    """An NMS entry point that keeps every call's inputs and outputs (device
    tensors, no copies) for a check after the timed run."""

    def __init__(self, fn):
        self.fn, self.calls = fn, []

    def __call__(self, *args, **kwargs):
        out = self.fn(*args, **kwargs)
        self.calls.append((args, kwargs, out))
        return out

    def check_plain(self, torch, plain):
        """Every recorded call through ``plain``: keep indices and mask equal.
        Returns the number of boxes kept."""
        kept = 0
        for args, kwargs, (idx, mask) in self.calls:
            p_idx, p_mask = plain(*args, **kwargs)
            if not (torch.equal(idx, p_idx) and torch.equal(mask, p_mask)):
                raise AssertionError("the kernel NMS and the plain NMS differ on a chunk of the whole patient")
            kept += int(mask.sum())
        self.calls = []
        return kept


@contextlib.contextmanager
def _class_attr(cls, name, value):
    saved = vars(cls)[name]
    setattr(cls, name, value)
    try:
        yield
    finally:
        setattr(cls, name, saved)


def _raw_boxes(cf):
    """The raw (pre-consolidation) predictions the last test run pickled."""
    import pickle

    name = "raw_pred_boxes_hold_out_list" if cf.hold_out_test_set else "raw_pred_boxes_list"
    with open(os.path.join(cf.exp_dir, "fold_0", f"{name}.pickle"), "rb") as handle:
        return pickle.load(handle)


def _drive_patients(torch, np, common, nms_cuda, roi_align_cuda, nms_ops, card, root):
    """Phase 8: whole patients through the port's test mode. Returns the
    main-path launch counts and the per-patient times."""
    from medicaldetectiontoolkit_torch.data.dataloader_utils import get_patch_crop_coords
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc
    from medicaldetectiontoolkit_torch.models.retina_net import RetinaNetDetector
    from medicaldetectiontoolkit_torch.testing import make_lidc_experiment, run_lidc_test

    log_path = os.path.join(root, "exec_console.log")
    data3d, data2d = os.path.join(root, "data3d"), os.path.join(root, "data2d")
    t0 = time.perf_counter()
    generate_synthetic_lidc(data3d, n_patients=1, shape=PATIENT_3D)
    generate_synthetic_lidc(data2d, n_patients=1, shape=PATIENT_2D)
    print(f"== phase 8: whole patients through exec --mode test (synthetic patients {PATIENT_3D} and {PATIENT_2D}, "
          f"z y x, made in {time.perf_counter() - t0:.1f} s)")

    def experiment(name, env, data_dir, overrides=None, device="cuda", n_patients=1):
        """Two ranked checkpoints of random weights, every patient tested."""
        t0 = time.perf_counter()
        cf = _quietly(log_path, make_lidc_experiment, root, env, dict(overrides or {}, test_n_epochs=2),
                      n_patients=n_patients, seeds=(0, 1), epochs=(3, 1), device=device, hold_out=True,
                      data_dir=data_dir, exp_name=name)
        print(f"  experiment directory (config snapshot, 2 checkpoints) in {time.perf_counter() - t0:.1f} s")
        return cf

    def chunks_of(cf, shape_zyx):
        z, y, x = shape_zyx
        ps = list(cf.patch_size) + ([1] if cf.dim == 2 else [])
        n = len(get_patch_crop_coords(np.broadcast_to(np.uint8(0), (y, x, z)), ps))
        return n, math.ceil(n / cf.batch_size) * 4 * 2  # x 4 mirror variants x 2 checkpoints

    launches = {"nms": 0, "roi_align": 0}
    times = {}
    for dtype in ("float32", "bfloat16"):
        name = f"retina_unet 3D {dtype}"
        print(f"== phase 8: {name} at LIDC width (patch 128x128x64, sf 18, ef 36, batch 8), {PATIENT_3D}, "
              f"4 mirrors x 2 checkpoints, WBC")
        cf = experiment(f"exp_retina_{dtype}", {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_DTYPE": dtype},
                        data3d)
        n_patches, n_chunks = chunks_of(cf, PATIENT_3D)
        recorder = _RecordedNMS(nms_ops.batched_nms_auto)
        nms_cuda.batched_nms.launches = 0
        with _class_attr(RetinaNetDetector, "nms_fn", recorder):
            out, wall = _timed_test(torch, run_lidc_test, cf, log_path)
        counted = nms_cuda.batched_nms.launches
        print(f"  {n_patches} patches, {n_chunks} chunks of {cf.batch_size}: K1 launches {counted} (1 per chunk)")
        if counted != n_chunks or len(recorder.calls) != n_chunks:
            raise AssertionError(f"{name}: expected {n_chunks} NMS kernel launches, counted {counted}")
        launches["nms"] += counted
        times[name] = _patient_line(name, out, wall, n_patches * 8, card)

        # every chunk's NMS again through the plain version, on the same
        # inputs (the same heads, as phase 4): equal keep lists everywhere
        # give the same raw boxes, so the same consolidated boxes
        n_kept = recorder.check_plain(torch, nms_ops.batched_nms)
        print(f"  kernel NMS == plain NMS on all {n_chunks} chunks of the patient ({n_kept} boxes kept), so the "
              f"{sum(len(bl) for r in out['results'] for bl in r[0])} consolidated boxes are the plain path's")
        del out, recorder
        torch.cuda.empty_cache()

    name = "mrcnn 3D float32"
    print(f"== phase 8: {name} at LIDC width, {PATIENT_3D}, 4 mirrors x 2 checkpoints, WBC")
    cf = experiment("exp_mrcnn", {"MDT_DIM": "3", "MDT_MODEL": "mrcnn"}, data3d)
    n_patches, n_chunks = chunks_of(cf, PATIENT_3D)
    n_classify = math.ceil(cf.batch_size * cf.post_nms_rois_inference / cf.roi_chunk_size)
    nms_cuda.batched_nms.launches = roi_align_cuda.pyramid_roi_align.launches = 0
    out, wall = _timed_test(torch, run_lidc_test, cf, log_path)
    counted = {"nms": nms_cuda.batched_nms.launches, "roi_align": roi_align_cuda.pyramid_roi_align.launches}
    expect = {"nms": 2 * n_chunks, "roi_align": n_classify * n_chunks}
    print(f"  {n_patches} patches, {n_chunks} chunks: launches {counted} (expected {expect}: K1 2 per chunk, K2 "
          f"{n_classify} classify-all launches per chunk, no mask pass as return_masks_in_test is "
          f"{cf.return_masks_in_test})")
    if counted != expect:
        raise AssertionError(f"{name}: expected kernel launches {expect}, counted {counted}")
    for k in launches:
        launches[k] += counted[k]
    times[name] = _patient_line(name, out, wall, n_patches * 8, card)
    del out
    torch.cuda.empty_cache()

    name = "retina_unet 2D float32"
    print(f"== phase 8: {name}, LIDC 2D (patch 288x288, sf 48, batch 20, 1 slice of 3D context, 2D->3D merge), "
          f"{PATIENT_2D}")
    cf = experiment("exp_2d", {"MDT_DIM": "2", "MDT_MODEL": "retina_unet"}, data2d,
                    {"n_3D_context": 1, "n_channels": 3})
    n_patches, n_chunks = chunks_of(cf, PATIENT_2D)
    nms_cuda.batched_nms.launches = 0
    out, wall = _timed_test(torch, run_lidc_test, cf, log_path)
    counted = nms_cuda.batched_nms.launches
    print(f"  {n_patches} slice patches, {n_chunks} chunks of {cf.batch_size}: K1 launches {counted} (1 per chunk)")
    if counted != n_chunks:
        raise AssertionError(f"{name}: expected {n_chunks} NMS kernel launches, counted {counted}")
    launches["nms"] += counted
    if not all(len(b["box_coords"]) == 6 for r in out["results"] for bl in r[0] for b in bl):
        raise AssertionError("2D->3D merging left boxes without z extents")
    times[name] = _patient_line(name, out, wall, n_patches * 8, card)
    del out
    torch.cuda.empty_cache()

    print("== phase 8b: small 3D patients (2 of 16x48x48, patch 32x32x8, sf 8), exec --mode test on the card and "
          "the CPU")
    small = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "32,32,8", "MDT_LIDC_BS": "4"}
    cf = experiment("exp_small", small, os.path.join(root, "data_small"),
                    {"start_filts": 8, "end_filts": 16, "n_rpn_features": 16, "pre_nms_limit": 2000}, device="cpu",
                    n_patients=2)
    runs = {}
    for device in ("cuda", "cpu"):
        out, wall = _timed_test(torch, run_lidc_test, cf, log_path, device=device)
        runs[device] = (out, _raw_boxes(cf))
        print(f"  exec --mode test on the {device}: {wall:.1f} s")
    (og, rg), (oc, rc) = runs["cuda"], runs["cpu"]
    _near_tie_forwards(np, rg, rc, cf.detection_nms_threshold)
    for (bg, pid), (bc, _) in zip(og["results"], oc["results"]):
        worst = _same_consolidated(np, [[bg, pid]], [[bc, pid]], score_tol=1e-5, coord_tol=1e-3)
        print(f"  {pid}: {sum(b['box_type'] == 'det' for b in bg[0])} consolidated detections, max|score| "
              f"{worst[0]:.3e} (tol 1e-05), max|coords| {worst[1]:.3e} voxels (tol 0.001)")
    ap = [[float(s["ap"]) for s in o["evaluator"].return_metrics()[0]] for o in (og, oc)]
    print(f"  AP per class and level: card {ap[0]}, CPU {ap[1]}")
    if not np.array_equal(ap[0], ap[1], equal_nan=True):
        raise AssertionError("small patient: the evaluator's AP differs between the card and the CPU")

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    print(f"  modules of {', '.join(BANNED)} loaded: {loaded}")
    if loaded:
        raise AssertionError(f"the port's test mode loaded {loaded}")
    return {"launches": launches, "times": times}


TRAIN_PATIENT = (96, 160, 160)  # z, y, x: covers the 3D pre-crop of 156 x 156 x 96
TRAIN_ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_EPOCHS": "2", "MDT_LIDC_NTB": "3",
             "MDT_LIDC_NVB": "2"}


def _recorded_dispatches(counters, steps, detector):
    """``detector.train_forward_dispatch`` that records, per call, whether
    it validated and how far each launch counter rose during it."""
    real = detector.train_forward_dispatch

    def dispatch(self, batch, is_validation=False, do_update=True):
        before = {k: w.launches for k, w in counters.items()}
        out = real(self, batch, is_validation, do_update)
        steps.append(("val" if is_validation else "train", {k: w.launches - before[k] for k, w in counters.items()}))
        return out

    return _class_attr(detector, "train_forward_dispatch", dispatch)


def _same_tree(torch, np, a, b):
    """Exact equality of nested dicts, lists, arrays, tensors and scalars."""
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(_same_tree(torch, np, a[k], b[k]) for k in a)
    if isinstance(a, (list, tuple)):
        return type(a) is type(b) and len(a) == len(b) and all(_same_tree(torch, np, x, y) for x, y in zip(a, b))
    if isinstance(a, torch.Tensor):
        return isinstance(b, torch.Tensor) and torch.equal(a, b)
    if isinstance(a, np.ndarray):
        return isinstance(b, np.ndarray) and a.dtype == b.dtype and np.array_equal(a, b)
    return type(a) is type(b) and a == b


@contextlib.contextmanager
def _checked_converts(torch, np, checked, detector, n_each=2):
    """For the first ``n_each`` train and validation dispatches of
    ``detector`` (``RetinaNetDetector`` or ``DetectionUNetDetector``), holds
    what ``train_forward_convert`` returns (from the pinned copies that
    ``start_host_copies`` queued, waited for on its event) against the same
    convert of synchronous ``.cpu()`` reads of the same device tensors, with
    no event. Appends (kind, equal) to ``checked``."""
    from medicaldetectiontoolkit_torch.models import base

    real_copies = base.start_host_copies
    real_dispatch = detector.train_forward_dispatch
    real_convert = detector.train_forward_convert
    queued, pending, counts = [], [], {"train": 0, "val": 0}

    def copies(tensors):
        queued[:] = [list(tensors)]
        return real_copies(tensors)

    def dispatch(self, batch, is_validation=False, do_update=True):
        handles = real_dispatch(self, batch, is_validation, do_update)
        kind = "val" if is_validation else "train"
        if counts[kind] < n_each:
            counts[kind] += 1
            pending.append((handles, kind, queued[0]))
        return handles

    def convert(self, handles, batch, need_seg_preds=True):
        out = real_convert(self, handles, batch, need_seg_preds)
        for i, (held, kind, device_tensors) in enumerate(pending):
            if held is handles:
                del pending[i]
                read = [None if t is None else t.cpu() for t in device_tensors]
                if len(handles) == 3:  # Detection U-Net: (loss, softmax, event)
                    sync = (*read, None)
                else:
                    img_shape, monitor, _, _, _, seg_preds, _ = handles
                    n = len(monitor)
                    sync = (img_shape, dict(zip(monitor, read[:n])), read[n:-2], read[-2], read[-1], seg_preds, None)
                checked.append((kind, _same_tree(torch, np, out, real_convert(self, sync, batch, need_seg_preds))))
                break
        return out

    with contextlib.ExitStack() as stack:
        stack.enter_context(_class_attr(base, "start_host_copies", copies))
        stack.enter_context(_class_attr(detector, "train_forward_dispatch", dispatch))
        stack.enter_context(_class_attr(detector, "train_forward_convert", convert))
        yield


def _train_run(torch, np, cf, counters, log_path, mode, resume=None, checked=None, detector=None, exp="lidc_exp"):
    """One ``exec --mode {mode}`` run of the experiment ``exp`` on the card
    with the launch counters from 0: (result, per-dispatch launches, total
    launches, wall seconds). ``detector`` is the class whose dispatches are
    recorded (default ``RetinaNetDetector``). With a list ``checked``, the
    first converts are held against synchronous reads
    (``_checked_converts``)."""
    from medicaldetectiontoolkit_torch.models.retina_net import RetinaNetDetector
    from medicaldetectiontoolkit_torch.testing import run_lidc_train

    steps = []
    detector = detector or RetinaNetDetector
    for wrapper in counters.values():
        wrapper.launches = 0
    t0 = time.perf_counter()
    with contextlib.ExitStack() as stack:
        stack.enter_context(_recorded_dispatches(counters, steps, detector))
        if checked is not None:
            stack.enter_context(_checked_converts(torch, np, checked, detector))
        out = _quietly(log_path, run_lidc_train, cf, mode, device="cuda", resume=resume, exp=exp)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return out, steps, {k: w.launches for k, w in counters.items()}, wall


def _check_steps(cf, steps, n_epochs, expect=None, n_val=None):
    """Each dispatch launched the kernels ``expect`` gives per kind ("train",
    "val"); by default Retina U-Net's: each train dispatch K3 twice per
    microbatch (forward and remat recompute), K4 once per microbatch, K1
    once (refinement of the merged heads); each validation dispatch K3 once
    and K1 once. ``n_val`` validation batches per epoch (default
    ``cf.num_val_batches``), besides the plotted one."""
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum

    n_micro = resolve_grad_accum(cf, cf.batch_size)
    expect = expect or {"train": {"stem_fwd": 2 * n_micro, "stem_wgrad": n_micro, "nms": 1},
                        "val": {"stem_fwd": 1, "stem_wgrad": 0, "nms": 1}}
    # per epoch: the train batches, the val_sampling batches and the plotted prediction
    n_val = cf.num_val_batches if n_val is None else n_val
    n_expect = {"train": n_epochs * cf.num_train_batches, "val": n_epochs * (n_val + 1)}
    for kind in ("train", "val"):
        got = [d for k, d in steps if k == kind]
        print(f"  {len(got)} {kind} dispatches, launches each {got[0] if got else None} (expected {n_expect[kind]} "
              f"of {expect[kind]})")
        if len(got) != n_expect[kind] or any(d != expect[kind] for d in got):
            raise AssertionError(f"{kind} dispatches: expected {n_expect[kind]} of {expect[kind]}, got {got}")
    return {k: sum(d[k] for _, d in steps) for k in expect["train"]}


def _test_chunks(np, cf):
    """(test patients of fold 0, patches per patient, ranked checkpoints
    tested, test chunks) of ``exec --mode test`` on phase 9's patients: each
    patient's patch grid in chunks of ``cf.batch_size``, 4 mirrors, each
    ranked checkpoint."""
    import pickle

    from medicaldetectiontoolkit_torch.data.dataloader_utils import get_patch_crop_coords

    ranking = np.load(os.path.join(cf.exp_dir, "fold_0", "epoch_ranking.npy"))
    n_ckpt = min(len(ranking), cf.test_n_epochs)
    with open(os.path.join(cf.exp_dir, "fold_ids.pickle"), "rb") as handle:
        n_patients = len(pickle.load(handle)[0][2])
    z, y, x = TRAIN_PATIENT
    n_patches = len(get_patch_crop_coords(np.broadcast_to(np.uint8(0), (y, x, z)), cf.patch_size))
    return n_patients, n_patches, n_ckpt, math.ceil(n_patches / cf.batch_size) * 4 * n_ckpt * n_patients


def _finite_losses(cf, out, n_val):
    """The monitored values of every train and validation step, each
    finite."""
    metrics = out["train"]["monitor_metrics"]
    steps = [m for split in ("train", "val") for ep in metrics[split]["monitor_values"] for m in ep]
    losses = [v for m in steps for v in m.values()]
    if len(steps) != cf.num_epochs * (cf.num_train_batches + n_val) or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"non-finite or missing losses: {losses}")
    return losses


def _print_train_times(out, card):
    t, loader = out["times"], out["loader"]
    for epoch in sorted(t["epoch_s"]):
        print(f"  epoch {epoch}: {t['epoch_s'][epoch]:.2f} s ({t['train_s'][epoch]:.2f} s train); steps "
              f"{', '.join(f'{s * 1e3:.1f}' for s in t['step_s'][epoch])} ms as the loop logs them; waited for "
              f"the loader {', '.join(f'{s * 1e3:.1f}' for s in t['load_s'][epoch])} ms ({card})")
    per_batch = loader["batch_seconds"]
    capacity = loader["n_workers"] * loader["batch_size"] / (sum(per_batch) / len(per_batch))
    print(f"  loader: {loader['n_workers']} workers, {len(per_batch)} train batches of {loader['batch_size']} made, "
          f"{sum(per_batch) / len(per_batch) * 1e3:.1f} ms per batch per worker: {capacity:.2f} patches/s")
    return capacity


def _drive_training(torch, np, common, counters, card, root):
    """Phase 9: 3D Retina U-Net training at LIDC width through
    ``exec --mode train_test``, then a resume. Returns the launch counts."""
    from medicaldetectiontoolkit_torch import native
    from medicaldetectiontoolkit_torch.experiments.lidc_exp.preprocessing import generate_synthetic_lidc
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.testing import make_lidc_experiment
    from medicaldetectiontoolkit_torch.utils.exp_utils import load_checkpoint_state

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    log_path = os.path.join(root, "exec_console.log")
    data_dir = os.path.join(root, "data_train")
    generate_synthetic_lidc(data_dir, n_patients=10, shape=TRAIN_PATIENT)
    cf = _quietly(log_path, make_lidc_experiment, root, TRAIN_ENV, {}, seeds=(), epochs=(), device="cuda",
                  data_dir=data_dir, exp_name="exp_train")
    print(f"== phase 9: exec --mode train_test, 3D retina_unet at LIDC width (patch {cf.patch_size}, pre-crop "
          f"{cf.pre_crop_size}, sf {cf.start_filts}, ef {cf.end_filts}, batch {cf.batch_size}, {cf.compute_dtype}, "
          f"MDT_STEM_PALLAS=1), {cf.n_workers} loader workers; 10 synthetic patients {TRAIN_PATIENT} (z y x); "
          f"{cf.num_epochs} epochs x {cf.num_train_batches} batches, {cf.num_val_batches} val_sampling batches")
    native.reset_calls()
    checked = []
    out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test", checked=checked)
    per_step = _check_steps(cf, steps, cf.num_epochs)
    print(f"  convert from the queued pinned copies vs synchronous .cpu() reads of the same device tensors "
          f"(results dict: boxes, loss, monitor values): {checked}")
    if sorted(k for k, _ in checked) != ["train", "train", "val", "val"] or not all(same for _, same in checked):
        raise AssertionError(f"train_forward_convert's results differ from synchronous reads: {checked}")

    # the test on fold 0's test patients with the ranked checkpoints
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    ranking = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
    test = out["test"]
    n_patients, n_patches, n_ckpt, n_chunks = _test_chunks(np, cf)
    if len(test["results"]) != n_patients:
        raise AssertionError(f"the test mode gave {len(test['results'])} patients, fold 0 tests {n_patients}")
    rest = {k: totals[k] - per_step[k] for k in totals}
    print(f"  test: {n_patients} patients of {n_patches} patches x {n_ckpt} checkpoints x 4 mirrors, {n_chunks} "
          f"chunks; launches outside "
          f"the train and val dispatches {rest} (expected K1 and K3 1 per chunk)")
    if rest != {"stem_fwd": n_chunks, "stem_wgrad": 0, "nms": n_chunks}:
        raise AssertionError(f"test mode: expected {n_chunks} K1 and K3 launches, counted {rest}")
    calls = native.calls()
    info = native.lib_info()
    print(f"  native host library {os.path.basename(info['path'])} ({info['compiler']}, {info['omp_threads']} "
          f"OpenMP threads); calls in the run {calls}")
    if not calls["wbc_greedy"] or not os.path.isfile(info["path"]):
        raise AssertionError("the test's WBC did not run in the native host library")

    losses = _finite_losses(cf, out, cf.num_val_batches)
    files = sorted(os.listdir(fold_dir))
    best = [f"{e}_best_checkpoint" for e in ranking]
    print(f"  fold_0: {files}; epoch_ranking {ranking.tolist()}; {len(losses)} finite monitored losses")
    if not (set(best) <= set(files) and os.path.isfile(os.path.join(fold_dir, "last_checkpoint", "params.pkl"))):
        raise AssertionError("the best checkpoints or last_checkpoint were not written")
    net = build_model(cf, common.QuietLog(), device="cuda")
    for b in best:  # the best checkpoints load back into the port
        net.load_params(load_checkpoint_state(os.path.join(fold_dir, b))["params"])
    del net
    capacity = _print_train_times(out["train"], card)
    print(f"  train_test: {wall:.1f} s; test {test['predictor'].times['forward'] * 1e3:.1f} ms forward, "
          f"{test['predictor'].times['consolidation'] * 1e3:.1f} ms consolidation")

    # resume to a third epoch from last_checkpoint
    cf = _quietly(log_path, make_lidc_experiment, root, dict(TRAIN_ENV, MDT_LIDC_EPOCHS="3"), {}, seeds=(),
                  epochs=(), device="cuda", data_dir=data_dir, exp_name="exp_train")
    resumed, steps, totals_r, wall_r = _train_run(torch, np, cf, counters, log_path, "train",
                                                  resume=os.path.join(fold_dir, "last_checkpoint"))
    epochs = sorted(resumed["times"]["epoch_s"])
    print(f"  resume from last_checkpoint with num_epochs {cf.num_epochs}: epochs {epochs}, {wall_r:.1f} s")
    if epochs != [3]:
        raise AssertionError(f"the resumed run trained epochs {epochs}, not [3]")
    _check_steps(cf, steps, 1)
    _print_train_times(resumed, card)

    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    print(f"  modules of {', '.join(BANNED)} loaded: {loaded}")
    if loaded:
        raise AssertionError(f"the port's training loaded {loaded}")
    print(f"  phase 9: {time.perf_counter() - t_phase:.1f} s ({card})")
    step_ms = [s * 1e3 for t in (out["train"]["times"], resumed["times"]) for ep in t["step_s"].values() for s in ep]
    return {"launches": {k: totals[k] + totals_r[k] for k in totals}, "step_ms": step_ms,
            "loader_patches_per_s": capacity}


def two_stage_launches(cf, m, kind, with_mask_head=True):
    """Kernel launches of one two-stage dispatch of ``m`` elements per
    microbatch: ``kind`` "train" (per microbatch: K1 for the proposals and
    the refinement, K2 for the classify-all chunks and the sampled RoIs'
    heads, K2's backward for those heads, K3 forward and remat recompute,
    K4), "val" (one pass, no gradient, the mask pass on the detections when
    ``cf.return_masks_in_val``) or "test" (a chunk of ``exec --mode test``:
    the inference proposals, classify-all, refinement)."""
    from medicaldetectiontoolkit_torch.models.base import resolve_grad_accum

    heads = 2 if with_mask_head else 1
    if kind == "test":
        return {"nms": 2, "roi_align": math.ceil(m * cf.post_nms_rois_inference / cf.roi_chunk_size),
                "roi_align_bwd": 0, "stem_fwd": 1, "stem_wgrad": 0}
    classify = math.ceil(m * cf.post_nms_rois_training / cf.roi_chunk_size)
    if kind == "val":
        masks = 1 if with_mask_head and cf.return_masks_in_val else 0
        return {"nms": 2, "roi_align": classify + heads + masks, "roi_align_bwd": 0, "stem_fwd": 1, "stem_wgrad": 0}
    n = resolve_grad_accum(cf, m)
    classify = math.ceil(m // n * cf.post_nms_rois_training / cf.roi_chunk_size)
    return {"nms": 2 * n, "roi_align": (classify + heads) * n, "roi_align_bwd": heads * n, "stem_fwd": 2 * n,
            "stem_wgrad": n}


def _drive_two_stage_training(torch, np, common, counters, card, root):
    """Phase 10: 3D Mask R-CNN training at LIDC width through ``exec --mode
    train_test`` on phase 9's patients, then bfloat16 steps of the Mask
    R-CNN slice. Returns the launch counts and step times."""
    from medicaldetectiontoolkit_torch.models.mrcnn import MaskRCNNDetector
    from medicaldetectiontoolkit_torch.testing import make_lidc_experiment

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    log_path = os.path.join(root, "exec_console.log")
    cf = _quietly(log_path, make_lidc_experiment, root, dict(TRAIN_ENV, MDT_MODEL="mrcnn"), {}, seeds=(), epochs=(),
                  device="cuda", data_dir=os.path.join(root, "data_train"), exp_name="exp_train_mrcnn")
    print(f"== phase 10: exec --mode train_test, 3D mrcnn at LIDC width (patch {cf.patch_size}, sf {cf.start_filts}, "
          f"ef {cf.end_filts}, batch {cf.batch_size}, {cf.compute_dtype}, MDT_STEM_PALLAS=1, "
          f"{cf.post_nms_rois_training} proposals and {cf.train_rois_per_image} sampled RoIs per element); phase 9's "
          f"patients; {cf.num_epochs} epochs x {cf.num_train_batches} batches, {cf.num_val_batches} val_sampling batches")
    out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test", detector=MaskRCNNDetector)
    expect = {kind: two_stage_launches(cf, cf.batch_size, kind) for kind in ("train", "val")}
    print(f"  derived launches per dispatch: {expect}")
    per_step = _check_steps(cf, steps, cf.num_epochs, expect)

    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    ranking = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
    n_patients, _, n_ckpt, n_chunks = _test_chunks(np, cf)
    per_chunk = two_stage_launches(cf, cf.batch_size, "test")
    rest = {k: totals[k] - per_step[k] for k in totals}
    want = {k: v * n_chunks for k, v in per_chunk.items()}
    print(f"  test: {n_patients} patients x {n_ckpt} checkpoints x 4 mirrors, {n_chunks} chunks; launches outside the "
          f"train and val dispatches {rest} (expected {want})")
    if len(out["test"]["results"]) != n_patients or rest != want:
        raise AssertionError(f"mrcnn test mode: expected {want} launches for {n_patients} patients, counted {rest}")
    losses = _finite_losses(cf, out, cf.num_val_batches)
    files = sorted(os.listdir(fold_dir))
    print(f"  fold_0: {files}; epoch_ranking {ranking.tolist()}; {len(losses)} finite monitored losses")
    if not ({f"{e}_best_checkpoint" for e in ranking} <= set(files) and
            os.path.isfile(os.path.join(fold_dir, "last_checkpoint", "params.pkl"))):
        raise AssertionError("the best checkpoints or last_checkpoint were not written")
    with open(os.path.join(fold_dir, "exec.log")) as handle:
        logged = [line.split("|| ")[-1].strip() for line in handle if "tr. batch" in line]
    print(f"  train steps as logged: {logged[:2]} ...")
    _print_train_times(out["train"], card)
    step_ms = [s * 1e3 for ep in out["train"]["times"]["step_s"].values() for s in ep]
    print(f"  train_test: {wall:.1f} s")

    print("== phase 10: 3D mrcnn slice (make_mrcnn_slice_config), bfloat16: one warm-up and two timed train steps")
    net = common.slice_net("bfloat16", seed=0, model="mrcnn")
    batches = common.slice_batches(3, "mrcnn")
    common.train_steps(net, batches[:1])
    for wrapper in counters.values():
        wrapper.launches = 0
    results, times = common.train_steps(net, batches[1:])
    counted = {k: w.launches for k, w in counters.items()}
    want = {k: v * len(times) for k, v in two_stage_launches(net.cf, net.cf.batch_size, "train").items()}
    print(f"  launches {counted} (expected {want}); {', '.join(f'{t * 1e3:.1f}' for t in times)} ms per step; "
          f"{results[-1]['logger_string']} ({card})")
    if counted != want or not all(math.isfinite(r["loss"]) for r in results):
        raise AssertionError(f"mrcnn bfloat16 train steps: launches {counted} (expected {want}) or a non-finite loss")
    del net
    torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    if loaded:
        raise AssertionError(f"the port's two-stage training loaded {loaded}")
    print(f"  phase 10: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": {k: totals[k] + counted[k] for k in totals}, "step_ms": step_ms,
            "bf16_step_ms": [t * 1e3 for t in times]}


def _drive_det_unet_training(torch, np, common, counters, card, root):
    """Phase 11: 3D Detection U-Net at LIDC width through ``exec --mode
    train_test`` on phase 9's patients, then steps of the Detection U-Net
    slice in float32 and bfloat16. Returns the launch counts and times."""
    from medicaldetectiontoolkit_torch.models.detection_unet import DetectionUNetDetector
    from medicaldetectiontoolkit_torch.testing import make_lidc_experiment

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    log_path = os.path.join(root, "exec_console.log")
    env = dict(TRAIN_ENV, MDT_MODEL="detection_unet", MDT_LIDC_EPOCHS="1")
    cf = _quietly(log_path, make_lidc_experiment, root, env, {}, seeds=(), epochs=(), device="cuda",
                  data_dir=os.path.join(root, "data_train"), exp_name="exp_train_det_unet")
    print(f"== phase 11: exec --mode train_test, 3D detection_unet at LIDC width (patch {cf.patch_size}, sf "
          f"{cf.start_filts}, ef {cf.end_filts}, batch {cf.batch_size}, {cf.compute_dtype}, MDT_STEM_PALLAS=1, "
          f"{cf.n_roi_candidates} RoI candidates, {cf.seg_loss_mode}); phase 9's patients; {cf.num_epochs} epochs x "
          f"{cf.num_train_batches} batches, {cf.num_val_batches} val_sampling batches")
    checked = []
    out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test", checked=checked,
                                          detector=DetectionUNetDetector)
    expect = {"train": {"stem_fwd": 2, "stem_wgrad": 1, "nms": 0}, "val": {"stem_fwd": 1, "stem_wgrad": 0, "nms": 0}}
    per_step = _check_steps(cf, steps, cf.num_epochs, expect)
    print(f"  convert from the queued pinned copies vs synchronous .cpu() reads of the same device tensors "
          f"(results dict: boxes, seg_preds, loss): {checked}")
    if sorted(k for k, _ in checked) != ["train", "train", "val", "val"] or not all(same for _, same in checked):
        raise AssertionError(f"Detection U-Net's train_forward_convert differs from synchronous reads: {checked}")
    n_patients, _, _, n_chunks = _test_chunks(np, cf)
    rest = {k: totals[k] - per_step[k] for k in totals}
    want = {"stem_fwd": n_chunks, "stem_wgrad": 0, "nms": 0}
    print(f"  test: {n_patients} patients, {n_chunks} chunks; launches outside the train and val dispatches {rest} "
          f"(expected {want})")
    if len(out["test"]["results"]) != n_patients or rest != want:
        raise AssertionError(f"detection_unet test mode: expected {want} launches for {n_patients} patients, "
                             f"counted {rest}")
    losses = _finite_losses(cf, out, cf.num_val_batches)
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    files = sorted(os.listdir(fold_dir))
    print(f"  fold_0: {files}; {len(losses)} finite monitored losses; results.txt "
          f"{os.path.isfile(os.path.join(cf.exp_dir, 'results.txt'))}")
    if not (os.path.isfile(os.path.join(fold_dir, "last_checkpoint", "params.pkl")) and
            os.path.isfile(os.path.join(cf.exp_dir, "results.txt"))):
        raise AssertionError("detection_unet: last_checkpoint or results.txt was not written")
    with open(os.path.join(fold_dir, "exec.log")) as handle:
        logged = [line.split("|| ")[-1].strip() for line in handle if "tr. batch" in line]
    print(f"  train steps as logged: {logged[:2]} ...")
    _print_train_times(out["train"], card)
    step_ms = [s * 1e3 for ep in out["train"]["times"]["step_s"].values() for s in ep]
    print(f"  train_test: {wall:.1f} s; test {out['test']['predictor'].times['forward'] * 1e3:.1f} ms forward "
          f"(dispatch and convert, with the components)")

    # the device and the host per step at LIDC width
    slice_steps = {}
    for dtype in ("float32", "bfloat16"):
        net = common.slice_net(dtype, seed=0, model="detection_unet")
        batches = common.slice_batches(3, "detection_unet")
        net.train_forward(batches[0], need_seg_preds=False)  # warm-up: cuDNN plans
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        before = {k: w.launches for k, w in counters.items()}
        device_ms, host_ms, n_boxes = [], [], []
        for b in batches[1:]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            handles = net.train_forward_dispatch(b)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            r = net.train_forward_convert(handles, b, need_seg_preds=False)
            host_ms.append((time.perf_counter() - t1) * 1e3)
            device_ms.append((t1 - t0) * 1e3)
            n_boxes.append(sum(bx["box_type"] == "det" for el in r["boxes"] for bx in el))
            if not math.isfinite(r["loss"]):
                raise AssertionError(f"detection_unet slice {dtype}: non-finite loss")
        counted = {k: w.launches - before[k] for k, w in counters.items()}
        n = len(batches) - 1
        if counted != {"stem_fwd": 2 * n, "stem_wgrad": n, "nms": 0}:
            raise AssertionError(f"detection_unet slice {dtype}: launches {counted} for {n} steps")
        for k in totals:
            totals[k] += counted[k]
        peak = torch.cuda.max_memory_allocated() / 2**30
        print(f"  slice {dtype}: dispatch to synchronise {', '.join(f'{t:.1f}' for t in device_ms)} ms per step of 8; "
              f"convert (softmax copy waited for, argmax, components, boxes) {', '.join(f'{t:.1f}' for t in host_ms)} "
              f"ms; det boxes {n_boxes}; launches {counted}; peak {peak:.2f} GiB ({card})")
        slice_steps[dtype] = {"device_ms": device_ms, "host_ms": host_ms}
        del net
        torch.cuda.empty_cache()
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    if loaded:
        raise AssertionError(f"the port's Detection U-Net training loaded {loaded}")
    print(f"  phase 11: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": totals, "step_ms": step_ms, "slice": slice_steps}


TOY_ENV = {"MDT_TOY_NTRAINVAL": "48", "MDT_TOY_EPOCHS": "2", "MDT_TOY_NTB": "4", "MDT_TOY_MAXVAL": "4",
           "MDT_TOY_MAXTEST": "4", "MDT_TOY_TEST_N": "2"}


def _drive_toy(torch, np, common, counters, card, root):
    """Phase 12: the toy experiment at full width through ``exec --mode
    train_test`` for Retina U-Net and Detection U-Net. Returns K1's
    launches and the logged step times."""
    from medicaldetectiontoolkit_torch.models.detection_unet import DetectionUNetDetector
    from medicaldetectiontoolkit_torch.models.retina_net import RetinaNetDetector
    from medicaldetectiontoolkit_torch.testing import make_toy_experiment

    t_phase = time.perf_counter()
    log_path = os.path.join(root, "exec_console.log")
    launches, step_ms = 0, {}
    for model, detector in (("retina_unet", RetinaNetDetector), ("detection_unet", DetectionUNetDetector)):
        cf = _quietly(log_path, make_toy_experiment, root, dict(TOY_ENV, MDT_MODEL=model), {}, n_train=48, n_test=4,
                      exp_name=f"exp_toy_{model}")
        n_val = min(cf.max_val_patients, cf.n_train_val_data - 2 * cf.n_train_val_data // 3)
        print(f"== phase 12: toy experiment, 2D {model} (patch {cf.patch_size}, sf {cf.start_filts}, ef "
              f"{cf.end_filts}, batch {cf.batch_size}, {cf.compute_dtype}) through exec --mode train_test: "
              f"{cf.num_epochs} epochs x {cf.num_train_batches} batches, {n_val} val images, {cf.max_test_patients} "
              f"test images")
        out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test", detector=detector,
                                              exp="toy_exp")
        k1 = 1 if model == "retina_unet" else 0
        # per epoch the train batches; the val images and the plotted val_sampling batch
        n_expect = {"train": cf.num_epochs * cf.num_train_batches, "val": cf.num_epochs * (n_val + 1)}
        for kind in ("train", "val"):
            got = [d["nms"] for k, d in steps if k == kind]
            print(f"  {len(got)} {kind} dispatches, K1 launches each {got[0] if got else None} (expected "
                  f"{n_expect[kind]} of {k1})")
            if len(got) != n_expect[kind] or any(g != k1 for g in got):
                raise AssertionError(f"toy {model} {kind} dispatches: expected {n_expect[kind]} of K1 {k1}, got {got}")
        ranking = np.load(os.path.join(cf.exp_dir, "fold_0", "epoch_ranking.npy"))
        n_forwards = cf.max_test_patients * min(len(ranking), cf.test_n_epochs) * 4
        rest = totals["nms"] - sum(d["nms"] for _, d in steps)
        print(f"  test: {cf.max_test_patients} images x {min(len(ranking), cf.test_n_epochs)} checkpoints x 4 mirrors; "
              f"K1 launches outside the dispatches {rest} (expected {n_forwards * k1})")
        if rest != n_forwards * k1 or totals["stem_fwd"] or totals["stem_wgrad"]:
            raise AssertionError(f"toy {model} test: K1 {rest} (expected {n_forwards * k1}), launches {totals}")
        _finite_losses(cf, out, n_val)
        results = os.path.join(cf.exp_dir, "results.txt")
        raw = [f for f in os.listdir(os.path.join(cf.exp_dir, "fold_0")) if f.startswith("raw_pred_boxes")]
        if not (os.path.isfile(results) and raw and len(out["test"]["results"]) == cf.max_test_patients):
            raise AssertionError(f"toy {model}: the results files were not written")
        with open(results) as handle:
            ap = [line.strip() for line in handle if "average_foreground_roi" in line]
        step_ms[model] = [s * 1e3 for ep in out["train"]["times"]["step_s"].values() for s in ep]
        print(f"  results.txt {ap}; {raw}; steps {', '.join(f'{t:.1f}' for t in step_ms[model])} ms as logged; "
              f"train_test {wall:.1f} s ({card})")
        launches += totals["nms"]
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    if loaded:
        raise AssertionError(f"the port's toy experiment loaded {loaded}")
    print(f"  phase 12: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"nms": launches, "step_ms": step_ms}


PETCT_PATIENT = (48, 288, 288)  # z, y, x: holds the pre-crop 280 x 280 x 48 without padding
PETCT_ENV = {"MDT_MODEL": "retina_unet", "MDT_PETCT_EPOCHS": "1", "MDT_PETCT_NTB": "3"}


def _petct_config(model):
    """The port's PET-CT config for ``model`` at its published geometry."""
    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.configs import configs

    saved = os.environ.get("MDT_MODEL")
    os.environ["MDT_MODEL"] = model
    try:
        return configs()
    finally:
        os.environ.pop("MDT_MODEL") if saved is None else os.environ.__setitem__("MDT_MODEL", saved)


@contextlib.contextmanager
def _stem_inputs(shapes):
    """Record the input shape of every stem kernel call (K3 and K4) of the
    port's stem path in ``shapes``, as ("K3" | "K4", shape)."""
    from medicaldetectiontoolkit_torch.ops import stem_conv

    def recorded(name, real):
        def call(x, *args):
            shapes.append((name, tuple(x.shape)))
            return real(x, *args)
        return call

    with _class_attr(stem_conv, "stem_conv3d", recorded("K3", stem_conv.stem_conv3d)), \
            _class_attr(stem_conv, "stem_wgrad", recorded("K4", stem_conv.stem_wgrad)):
        yield


def _drive_petct(torch, np, common, counters, card, root):
    """Phase 13: the PET-CT experiment's 3D Retina U-Net at its published
    width through ``exec --mode train_test`` (no validation, hold-out test)
    and ``--mode analysis``, then timed train steps of its Retina U-Net and
    Retina Net (the C1 stem at cin 2) and a small cin-2 step against the
    CPU. Returns the launch counts and times."""
    from medicaldetectiontoolkit_torch import exec as port_exec
    from medicaldetectiontoolkit_torch.data.dataloader_utils import get_patch_crop_coords
    from medicaldetectiontoolkit_torch.experiments.pet_ct_tnm_classification.preprocessing import (
        generate_synthetic_petct,
    )
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.testing import make_batch, make_config, make_petct_experiment

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    log_path = os.path.join(root, "exec_console.log")
    data_dir = os.path.join(root, "petct_data")
    _quietly(log_path, generate_synthetic_petct, data_dir, n_patients=4, shape=PETCT_PATIENT)
    cf = _quietly(log_path, make_petct_experiment, root, PETCT_ENV, {}, data_dir=data_dir, exp_name="exp_petct")
    print(f"== phase 13: PET-CT through exec --mode train_test, 3D retina_unet (patch {cf.patch_size}, pre-crop "
          f"{cf.pre_crop_size}, {cf.n_channels} channels, sf {cf.start_filts}, ef {cf.end_filts}, batch "
          f"{cf.batch_size}, {cf.compute_dtype}, MDT_STEM_PALLAS=1), {cf.n_workers} loader workers; 4 synthetic "
          f"patients {PETCT_PATIENT} (z y x); {cf.num_epochs} epoch x {cf.num_train_batches} batches, no "
          f"validation, hold-out test of every patient")
    shapes = []
    torch.cuda.reset_peak_memory_stats()
    with _stem_inputs(shapes):
        out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test",
                                              exp="pet_ct_tnm_classification")
    peak = torch.cuda.max_memory_allocated() / 2**30
    per_step = _check_steps(cf, steps, cf.num_epochs, n_val=0)
    cins = sorted({(name, shape[1]) for name, shape in shapes})
    print(f"  stem kernel calls {len(shapes)}, (kernel, cin): {cins}; K3 inputs "
          f"{sorted({s for n, s in shapes if n == 'K3'})}")
    if cins != [("K3", 2), ("K4", 2)] or len(shapes) != totals["stem_fwd"] + totals["stem_wgrad"]:
        raise AssertionError(f"PET-CT: the stem kernels ran at {cins}, {len(shapes)} calls for {totals}")

    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    ranking = np.load(os.path.join(fold_dir, "epoch_ranking.npy"))
    n_patches = len(get_patch_crop_coords(np.broadcast_to(np.uint8(0), PETCT_PATIENT[1:] + PETCT_PATIENT[:1]),
                                          cf.patch_size))
    n_ckpt = min(len(ranking), cf.test_n_epochs)
    n_chunks = math.ceil(n_patches / cf.batch_size) * 4 * n_ckpt * 4
    rest = {k: totals[k] - per_step[k] for k in totals}
    print(f"  test: 4 patients of {n_patches} patches x {n_ckpt} checkpoints (ranked {ranking.tolist()} on the train "
          f"metrics) x 4 mirrors, {n_chunks} chunks; launches outside the dispatches {rest} (expected K1 and K3 1 "
          f"per chunk)")
    if len(out["test"]["results"]) != 4 or rest != {"stem_fwd": n_chunks, "stem_wgrad": 0, "nms": n_chunks}:
        raise AssertionError(f"PET-CT test mode: expected {n_chunks} K1 and K3 launches for 4 patients, counted "
                             f"{rest} for {len(out['test']['results'])}")
    losses = _finite_losses(cf, out, 0)
    results = os.path.join(cf.exp_dir, "results.txt")
    with open(results) as handle:
        ap = [line.strip() for line in handle if "average_foreground_roi" in line]
    _quietly(log_path, port_exec.main, ["--mode", "analysis", "--exp_source", os.path.join(
        os.path.dirname(os.path.abspath(__file__)), "medicaldetectiontoolkit_torch", "experiments",
        "pet_ct_tnm_classification"), "--exp_dir", cf.exp_dir, "--folds", "0"], device="cuda")
    csv_path = os.path.join(cf.exp_dir, "results_hold_out.csv")
    with open(csv_path) as handle:
        n_rows = len(handle.read().splitlines()) - 1
    print(f"  {len(losses)} finite monitored losses; results.txt {ap}; analysis (fold ensembling, WBC): "
          f"{n_rows} boxes in results_hold_out.csv")
    if not ap or not os.path.isfile(os.path.join(fold_dir, "last_checkpoint", "params.pkl")):
        raise AssertionError("PET-CT: results.txt or last_checkpoint was not written")
    _print_train_times(out["train"], card)
    step_ms = [s * 1e3 for ep in out["train"]["times"]["step_s"].values() for s in ep]
    print(f"  train_test: {wall:.1f} s; peak device memory {peak:.2f} GiB; test "
          f"{out['test']['predictor'].times['forward'] * 1e3:.1f} ms forward ({card})")

    # train steps at the same geometry, after a warm-up: Retina U-Net's conv0 and Retina Net's C1 stem (k 7,
    # stride (2, 2, 1)) at cin 2
    slice_ms = {}
    for model in ("retina_unet", "retina_net"):
        mcf = _petct_config(model)
        net = build_model(mcf, common.QuietLog(), device="cuda")
        net.initialize(seed=0)
        batches = [make_batch(mcf, seed=i) for i in range(3)]
        common.train_steps(net, batches[:1])  # warm-up: cuDNN plans
        torch.cuda.reset_peak_memory_stats()
        before = {k: w.launches for k, w in counters.items()}
        shapes = []
        with _stem_inputs(shapes):
            results, times = common.train_steps(net, batches[1:])
        counted = {k: w.launches - before[k] for k, w in counters.items()}
        n = len(batches) - 1
        stem = net.module.fpn.stem0[0] if mcf.operate_stride1 else net.module.fpn.stem1
        slice_ms[model] = [t * 1e3 for t in times]
        print(f"  {model} steps (stem k {stem.conv.kernel_size[0]}, stride {stem.conv.stride}, cin "
              f"{stem.conv.in_channels}): {n} steps of {mcf.batch_size}, "
              f"{', '.join(f'{t:.1f}' for t in slice_ms[model])} ms; launches {counted}; stem inputs "
              f"{sorted(set(shapes))}; peak {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB ({card})")
        if counted != {"stem_fwd": 2 * n, "stem_wgrad": n, "nms": n} or not stem.stem_kernel or \
                {s[1] for _, s in shapes} != {2}:
            raise AssertionError(f"PET-CT {model}: launches {counted} for {n} steps, stem inputs {shapes}")
        for r in results:
            if not all(math.isfinite(v) for v in (r["loss"], *r["monitor_values"].values())):
                raise AssertionError(f"PET-CT {model}: non-finite losses {r['logger_string']}")
        for k in totals:
            totals[k] += counted[k]
        del net, batches
        torch.cuda.empty_cache()

    _small_train(torch, np, make_config, make_batch, build_model, common.QuietLog(), "retina_unet", n_channels=2)
    loaded = sorted(m for m in sys.modules if m.split(".")[0] in BANNED)
    if loaded:
        raise AssertionError(f"the port's PET-CT experiment loaded {loaded}")
    print(f"  phase 13: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": totals, "step_ms": step_ms, "peak_gib": peak, "slice_ms": slice_ms}


DP_MODELS = ("retina_unet", "mrcnn")


def _dp_config(model):
    """Phase 14a's configurations: the LIDC width of phases 7 and 10 (patch
    128x128x64, sf 18, ef 36, remat), float32, a global batch of 8 as one
    microbatch (4 rows per rank); phase 16a's Detection U-Net that of phase
    11 (``make_det_unet_slice_config``)."""
    from medicaldetectiontoolkit_torch.testing import (make_det_unet_slice_config, make_mrcnn_slice_config,
                                                       make_train_slice_config)

    make = {"retina_unet": make_train_slice_config, "mrcnn": make_mrcnn_slice_config,
            "detection_unet": make_det_unet_slice_config}[model]
    cf = make("float32")
    cf.grad_accum_steps, cf.use_remat = 1, True
    return cf


def _dp_counters():
    from medicaldetectiontoolkit_torch.ops import nms_cuda, roi_align_cuda, stem_conv_cuda

    return {"stem_fwd": stem_conv_cuda.stem_conv3d, "stem_wgrad": stem_conv_cuda.stem_wgrad,
            "nms": nms_cuda.batched_nms, "roi_align": roi_align_cuda.pyramid_roi_align,
            "roi_align_bwd": roi_align_cuda.pyramid_roi_align_backward}


def _reduce_ms(torch, net, params, iters=5):
    """Wall ms of one gradient all-reduce (``DataParallel.reduce_gradients``)
    over ``iters`` calls after a warm-up, ending in a synchronise; every rank
    calls it."""
    sync = torch.cuda.synchronize if params[0].is_cuda else (lambda: None)
    net.dp.reduce_gradients(params)
    sync()
    t0 = time.perf_counter()
    for _ in range(iters):
        net.dp.reduce_gradients(params)
    sync()
    return (time.perf_counter() - t0) * 1e3 / iters


def _dp_rank(out_dir, configs, device):
    """A rank of phase 14a (started by ``mesh.spawn_ranks``): joins the two
    ranks' gloo group on the one card and, per model of ``configs``, takes
    one checked step (launches counted from 0; the summed gradients and the
    loss saved) and two timed steps of its rows of the global batch, then
    times the gradient all-reduce alone."""
    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch
    from medicaldetectiontoolkit_torch.tools import common

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    os.environ["MDT_STEM_PALLAS"] = "1"
    mesh.maybe_initialize_distributed(device=device, backend="gloo")
    rank, world = mesh.rank_and_world()
    counters = _dp_counters()
    try:
        for model, cf in configs.items():
            net = build_model(cf, common.QuietLog(), device=device)
            net.initialize(seed=0)
            net.enable_data_parallel()
            local = mesh.shard_batch(make_batch(cf, seed=0), rank, world)
            for wrapper in counters.values():
                wrapper.launches = 0
            loss = net.train_forward_convert(net.train_forward_dispatch(local), local, need_seg_preds=False)["loss"]
            launches = {k: w.launches for k, w in counters.items()}
            grads = {n: p.grad.detach().float().cpu() for n, p in net.module.named_parameters()}
            _, times = common.train_steps(net, [local, local])
            params = [p for p in net.module.parameters()]
            n_bytes = sum(p.grad.numel() * p.grad.element_size() for p in params)
            reduce_ms = _reduce_ms(torch, net, params)
            torch.save({"loss": loss, "grads": grads, "launches": launches, "step_ms": [t * 1e3 for t in times],
                        "grad_mb": n_bytes / 1e6, "reduce_ms": reduce_ms},
                       os.path.join(out_dir, f"{model}_rank{rank}.pt"))
            del net, grads
    finally:
        mesh.dist.destroy_process_group()


def _drive_data_parallel(torch, np, common, counters, card, root):
    """Phase 14: data-parallel training (``parallel/mesh.py``). 14a: two
    ranks share the one card over gloo and take a step of 3D Retina U-Net
    and of 3D Mask R-CNN at LIDC width on their rows of a global batch of
    8, held against the single-process step on the whole batch (loss 1e-5
    relative, gradients 1e-3 of each tensor's max: phase 7b's tolerances;
    the two ranks' summed gradients bit-identical), with each rank's kernel
    launches counted. 14b: ``exec --mode train_test`` through the
    data-parallel path at world size 1 over NCCL (the ``MDT_DIST_*`` triple)
    on phase 9's patients. Returns the launch counts and times."""
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch, make_lidc_experiment

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    print("== phase 14a: two data-parallel ranks on the one card over gloo (NCCL puts no two ranks of a group on "
          "one device; gloo's all-reduce and broadcast take CUDA tensors), LIDC width, float32, TF32 off, "
          "MDT_STEM_PALLAS=1, global batch 8 = 4 rows per rank, one microbatch, remat")
    ref, configs = {}, {model: _dp_config(model) for model in DP_MODELS}
    for model, cf in configs.items():
        net = build_model(cf, common.QuietLog(), device="cuda")
        net.initialize(seed=0)
        batch = make_batch(cf, seed=0)
        loss = net.train_forward_convert(net.train_forward_dispatch(batch), batch, need_seg_preds=False)["loss"]
        ref[model] = (loss, {n: p.grad.detach().float().cpu() for n, p in net.module.named_parameters()})
        del net
        torch.cuda.empty_cache()
    out_dir = os.path.join(root, "dp_ranks")
    os.makedirs(out_dir)
    os.environ.setdefault("MDT_DIST_INIT_TIMEOUT", "300")
    t0 = time.perf_counter()
    mesh.spawn_ranks(_dp_rank, 2, (out_dir, configs, "cuda"))
    print(f"  two ranks started, stepped and stopped in {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in _dp_counters()}
    dp_times = {}
    for model, cf in configs.items():
        if model == "retina_unet":
            expect = {"stem_fwd": 2, "stem_wgrad": 1, "nms": 1, "roi_align": 0, "roi_align_bwd": 0}
        else:
            expect = two_stage_launches(cf, cf.batch_size // 2, "train")
        loss, grads = ref[model]
        ranks = [torch.load(os.path.join(out_dir, f"{model}_rank{r}.pt"), weights_only=False) for r in range(2)]
        for r, res in enumerate(ranks):
            loss_err = abs(res["loss"] - loss) / abs(loss)
            grad_err, worst = _grad_errors(torch, res["grads"], grads)
            print(f"  {model} rank {r}: loss {res['loss']:.6f} vs one process {loss:.6f} (relative {loss_err:.2e}); "
                  f"worst gradient {grad_err:.2e} of its tensor's max ({worst}); launches {res['launches']} "
                  f"(expected {expect}); {', '.join(f'{t:.1f}' for t in res['step_ms'])} ms per step of 4 rows "
                  f"(two ranks sharing one card: not a scaling figure); gradient buffer {res['grad_mb']:.2f} MB, "
                  f"its all-reduce over gloo {res['reduce_ms']:.2f} ms ({card})")
            if not (loss_err <= 1e-5 and grad_err <= 1e-3):
                raise AssertionError(f"{model} rank {r}: the data-parallel step differs from the single-process step")
            if {k: res["launches"][k] for k in expect} != expect:
                raise AssertionError(f"{model} rank {r}: launches {res['launches']}, expected {expect}")
            for k in launches:
                launches[k] += res["launches"].get(k, 0)
        if any(not torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in grads):
            raise AssertionError(f"{model}: the two ranks hold different summed gradients")
        dp_times[model] = ranks
    del ref

    print("== phase 14b: exec --mode train_test through the data-parallel path at world size 1 over NCCL "
          "(MDT_DIST_COORD / _NPROCS=1 / _RANK=0), phase 9's patients and width")
    log_path = os.path.join(root, "exec_console.log")
    cf = _quietly(log_path, make_lidc_experiment, root, dict(TRAIN_ENV, MDT_LIDC_EPOCHS="1"), {}, seeds=(),
                  epochs=(), device="cuda", data_dir=os.path.join(root, "data_train"), exp_name="exp_dp")
    os.environ.update(MDT_DIST_COORD=f"127.0.0.1:{mesh.free_port()}", MDT_DIST_NPROCS="1", MDT_DIST_RANK="0")
    try:
        out, steps, totals, wall = _train_run(torch, np, cf, counters, log_path, "train_test")
    finally:
        for key in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
            os.environ.pop(key)
    if mesh.dist.is_initialized():
        raise AssertionError("exec left its process group up")
    per_step = _check_steps(cf, steps, cf.num_epochs)
    fold_dir = os.path.join(cf.exp_dir, "fold_0")
    with open(os.path.join(fold_dir, "exec.log")) as handle:
        log = handle.read()
    results = os.path.join(cf.exp_dir, "results.txt")
    if "data-parallel training: rank 0 of 1" not in log or not os.path.isfile(results) or \
            not os.path.isfile(os.path.join(fold_dir, "last_checkpoint", "params.pkl")):
        raise AssertionError("exec over NCCL: no data-parallel log line, results.txt or last_checkpoint")
    n_patients, _, _, n_chunks = _test_chunks(np, cf)
    rest = {k: totals[k] - per_step[k] for k in totals}
    if len(out["test"]["results"]) != n_patients or rest != {"stem_fwd": n_chunks, "stem_wgrad": 0, "nms": n_chunks}:
        raise AssertionError(f"exec over NCCL test: {len(out['test']['results'])} patients, launches {rest}")
    _finite_losses(cf, out, cf.num_val_batches)
    step_ms = [s * 1e3 for ep in out["train"]["times"]["step_s"].values() for s in ep]
    print(f"  {cf.num_epochs} epoch x {cf.num_train_batches} batches of {cf.batch_size}, {cf.num_val_batches} "
          f"val_sampling batches, the test of {n_patients} patients: {wall:.1f} s; steps "
          f"{', '.join(f'{t:.1f}' for t in step_ms)} ms as the loop logs them; results.txt written ({card})")
    for k in totals:
        launches[k] = launches.get(k, 0) + totals[k]

    # the gradient all-reduce of phase 14a's Retina U-Net over NCCL at world size 1
    os.environ.update(MDT_DIST_COORD=f"127.0.0.1:{mesh.free_port()}", MDT_DIST_NPROCS="1", MDT_DIST_RANK="0")
    try:
        mesh.maybe_initialize_distributed(device="cuda")
        net = build_model(_dp_config("retina_unet"), common.QuietLog(), device="cuda")
        net.enable_data_parallel()
        params = list(net.module.parameters())
        for p in params:
            p.grad = torch.zeros_like(p)
        nccl_ms = _reduce_ms(torch, net, params)
        mb = sum(p.numel() * p.element_size() for p in params) / 1e6
        gloo_ms = ", ".join(f"{r['reduce_ms']:.2f}" for r in dp_times["retina_unet"])
        print(f"  gradient all-reduce of the Retina U-Net ({mb:.2f} MB) over NCCL at world size 1: {nccl_ms:.3f} ms; "
              f"over gloo between the two ranks of 14a: {gloo_ms} ms ({card})")
        del net, params
    finally:
        if mesh.dist.is_initialized():
            mesh.dist.destroy_process_group()
        for key in ("MDT_DIST_COORD", "MDT_DIST_NPROCS", "MDT_DIST_RANK"):
            os.environ.pop(key)
    torch.cuda.empty_cache()
    print(f"  phase 14: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "step_ms": step_ms, "ranks": dp_times, "nccl_ms": nccl_ms}


SP_MODELS = ("retina_unet", "mrcnn")
SP_TRAIN_MODELS = (*SP_MODELS, "detection_unet")
SP_PATIENT = (16, 64, 64)  # z, y, x of phase 15c's small patient
SP_ENV = {"MDT_DIM": "3", "MDT_MODEL": "retina_unet", "MDT_LIDC_PATCH": "64,64,8", "MDT_LIDC_BS": "4"}


def _sp_config(model):
    """Phase 15's configurations: the inference slices of phases 4 and 5
    (LIDC width, patch 128x128x64, a chunk of 8), float32."""
    from medicaldetectiontoolkit_torch.testing import make_mrcnn_slice_config, make_slice_config

    return make_slice_config("float32") if model == "retina_unet" else make_mrcnn_slice_config("float32")


def _sp_expected(cf, model):
    """Launches of one spatial test forward per rank (masks asked for): the
    refinement's K1 and K3 on conv0 (Retina U-Net) or on the C1 stem, K1
    twice and K2 for the classify-all chunks and the mask pass (Mask R-CNN)."""
    if model == "retina_unet":
        return {"stem_fwd": 1, "stem_wgrad": 0, "nms": 1, "roi_align": 0, "roi_align_bwd": 0}
    expect = two_stage_launches(cf, cf.batch_size, "test")
    return dict(expect, roi_align=expect["roi_align"] + 1)


def _sp_forward(torch, net, batch):
    """One test forward through the user's entry points, synchronised;
    returns its results and wall seconds."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    res = net.test_forward_convert(net.test_forward_dispatch(batch), batch)
    torch.cuda.synchronize()
    return res, time.perf_counter() - t0


def _sp_rank(out_dir, configs, device):
    """A rank of phase 15a/b (started by ``mesh.spawn_ranks``): joins the two
    ranks' gloo group on the one card and, per model, makes the detector
    spatial over them (S = 2), then runs: one test forward with the launches
    counted from 0, the peak device memory and the collectives of its
    dispatch and of its convert (which joins the uint8 seg_preds slabs), the
    gathered heads, one forward with the collectives fenced by synchronises
    (their seconds) and one plain timed forward."""
    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch, sp_heads_fn
    from medicaldetectiontoolkit_torch.tools import common

    os.environ["MDT_STEM_PALLAS"] = "1"  # TF32 left on: enabling spatial inference turns it off
    mesh.maybe_initialize_distributed(device=device, backend="gloo")
    rank, world = mesh.rank_and_world()
    counters = _dp_counters()
    try:
        for model, cf in configs.items():
            net = build_model(cf, common.QuietLog(), device=device)
            net.initialize(seed=0)
            net.enable_spatial_parallel_inference(n_space=world)
            batch = make_batch(cf, seed=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for wrapper in counters.values():
                wrapper.launches = 0
            net.space.reset_stats()
            handles = net.test_forward_dispatch(batch)
            dispatched = dict(net.space.stats["gather"])
            res = net.test_forward_convert(handles, batch)
            torch.cuda.synchronize()
            launches = {k: w.launches for k, w in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            comm = {k: dict(v) for k, v in net.space.stats.items()}
            seg_gather = {k: comm["gather"][k] - dispatched[k] for k in ("calls", "bytes")}
            with torch.inference_mode():
                heads = net._spatial(sp_heads_fn(net), torch.from_numpy(batch["data"]).cuda())
            heads = [t.cpu() for t in mesh.tensor_leaves(heads)]
            net.space.reset_stats()
            net.space.timing = True
            _, fenced_s = _sp_forward(torch, net, batch)
            net.space.timing = False
            timed = {k: v["s"] for k, v in net.space.stats.items()}
            _, wall_s = _sp_forward(torch, net, batch)
            torch.save({"results": res, "heads": heads, "launches": launches, "peak": peak, "comm": comm,
                        "seg_gather": seg_gather, "comm_s": timed, "fenced_ms": fenced_s * 1e3,
                        "ms": wall_s * 1e3}, os.path.join(out_dir, f"{model}_rank{rank}.pt"))
            del net, heads
            torch.cuda.empty_cache()
    finally:
        mesh.dist.destroy_process_group()


@contextlib.contextmanager
def _quiet_fd(log_path):
    """File descriptor 1 sent to ``log_path`` inside: the console lines of
    the processes started there too."""
    sys.stdout.flush()
    saved = os.dup(1)
    with open(log_path, "a") as handle:
        os.dup2(handle.fileno(), 1)
    try:
        yield
    finally:
        sys.stdout.flush()
        os.dup2(saved, 1)
        os.close(saved)


def _drive_spatial(torch, np, common, card, root):
    """Phase 15: spatial partitioning for inference (``parallel/mesh.py``).
    15a/b: two ranks share the one card over gloo as a space group (S = 2),
    each holding a Y slab of every split level, and run a test forward of
    the LIDC-width 3D Retina U-Net and 3D Mask R-CNN (masks) on a chunk of
    8, held against the one-process forward on the card: the gathered heads
    (and Mask R-CNN's pyramid levels) within atol 1e-5, the seg argmax equal
    where the top two logits differ by more than 1e-5, the detections equal
    as sets within 1e-5 in score and 1e-3 voxels, Mask R-CNN's mask union
    differing in at most 1e-4 of its voxels; the launches per rank and
    forward (K3 on the haloed slab, K1 on the gathered heads, K2 on the
    gathered levels). 15c: ``exec --mode test`` of a small patient over the
    two ranks against a one-process test of the same checkpoints. Returns
    the launch counts and the figures."""
    import shutil

    from medicaldetectiontoolkit_torch import exec as port_exec
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch, make_lidc_experiment, same_detections, sp_heads_fn

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    print("== phase 15a/b: two ranks on the one card over gloo as a space group (S = 2, a Y slab each), LIDC width "
          "(patch 128x128x64, sf 18, ef 36, a chunk of 8), float32, TF32 off, MDT_STEM_PALLAS=1")
    configs = {model: _sp_config(model) for model in SP_MODELS}
    ref = {}
    for model, cf in configs.items():
        net = build_model(cf, common.QuietLog(), device="cuda")
        net.initialize(seed=0)
        batch = make_batch(cf, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        res, _ = _sp_forward(torch, net, batch)
        peak = torch.cuda.max_memory_allocated()
        with torch.inference_mode():
            heads = sp_heads_fn(net)(torch.from_numpy(batch["data"]).cuda())
        heads = [t.cpu() for t in mesh.tensor_leaves(heads)]
        _, wall_s = _sp_forward(torch, net, batch)
        ref[model] = {"results": res, "heads": heads, "peak": peak, "ms": wall_s * 1e3}
        del net
        torch.cuda.empty_cache()
    out_dir = os.path.join(root, "sp_ranks")
    os.makedirs(out_dir)
    os.environ.setdefault("MDT_DIST_INIT_TIMEOUT", "300")
    t0 = time.perf_counter()
    mesh.spawn_ranks(_sp_rank, 2, (out_dir, configs, "cuda"))
    print(f"  two ranks started, ran and stopped in {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in _dp_counters()}
    figures = {}
    for model, cf in configs.items():
        one = ref[model]
        expect = _sp_expected(cf, model)
        ranks = [torch.load(os.path.join(out_dir, f"{model}_rank{r}.pt"), weights_only=False) for r in range(2)]
        for r, res in enumerate(ranks):
            if len(res["heads"]) != len(one["heads"]):
                raise AssertionError(f"{model} rank {r}: {len(res['heads'])} head tensors, {len(one['heads'])} on one "
                                     "process")
            head_err = max(float((a - b).abs().max()) for a, b in zip(res["heads"], one["heads"]))
            seg = res["results"]["seg_preds"]
            if model == "retina_unet":
                top2 = np.sort(one["heads"][-1].numpy(), axis=1)[:, -2:]
                clear = (top2[:, 1] - top2[:, 0] > 1e-5)[:, None]
                n_seg = int((np.where(clear, seg, 0) != np.where(clear, one["results"]["seg_preds"], 0)).sum())
                seg_ok = n_seg == 0
            else:
                n_seg = int((seg != one["results"]["seg_preds"]).sum())
                seg_ok = n_seg <= 1e-4 * seg.size
            worst = same_detections(res["results"]["boxes"], one["results"]["boxes"])
            n_det = sum(len(b) for b in res["results"]["boxes"])
            comm, comm_s, seg_gather = res["comm"], res["comm_s"], res["seg_gather"]
            # the convert joins the uint8 argmax of each rank's slab: b x 1 x (Y / 2) x X x Z bytes received
            want_seg = {"calls": 1, "bytes": cf.batch_size * int(np.prod(cf.patch_size)) // 2} \
                if model == "retina_unet" else {"calls": 0, "bytes": 0}
            print(f"  {model} rank {r}: heads max|2 ranks - 1 process| {head_err:.3e}; seg {n_seg} voxels differ; "
                  f"{n_det} detections, max|score| {worst[0]:.2e}, max|coords| {worst[1]:.2e}; launches "
                  f"{res['launches']} (expected {expect}); per forward: halo {comm['halo']['calls']} exchanges, "
                  f"{comm['halo']['bytes'] / 1e6:.1f} MB received, {comm_s['halo'] * 1e3:.1f} ms; GroupNorm sums "
                  f"{comm['sum']['calls']}; gather {comm['gather']['calls']} calls, {comm['gather']['bytes'] / 1e6:.1f}"
                  f" MB received ({seg_gather['calls']} of them in the convert: the seg_preds slabs as uint8, "
                  f"{seg_gather['bytes'] / 1e6:.2f} MB, expected {want_seg['bytes'] / 1e6:.2f}), "
                  f"{comm_s['gather'] * 1e3:.1f} ms (each collective fenced by synchronises, gloo "
                  f"through the host); forward {res['ms']:.1f} ms ({res['fenced_ms']:.1f} ms fenced) against "
                  f"{one['ms']:.1f} ms on one process (two ranks sharing one card: not a scaling figure); peak "
                  f"device memory {res['peak'] / 2**30:.3f} GiB against {one['peak'] / 2**30:.3f} GiB on one "
                  f"process ({card})")
            if not (head_err <= 1e-5 and seg_ok and n_det > 0):
                raise AssertionError(f"{model} rank {r}: the spatial forward differs from the one-process forward")
            if {k: res["launches"][k] for k in expect} != expect:
                raise AssertionError(f"{model} rank {r}: launches {res['launches']}, expected {expect}")
            if seg_gather != want_seg:
                raise AssertionError(f"{model} rank {r}: the convert's seg_preds gather {seg_gather}, expected {want_seg}")
            for k in launches:
                launches[k] += res["launches"][k]
        figures[model] = {"ranks": ranks, "one": {k: one[k] for k in ("peak", "ms")}}
        for res in ranks:
            del res["heads"], res["results"]
    del ref

    print(f"== phase 15c: exec --mode test over two ranks that exec starts itself (n_space_parallel 2, "
          f"backend gloo) on a synthetic patient of {SP_PATIENT} (patch 64x64x8, sf 8), against a one-process "
          "test of the same checkpoints (TF32 off)")
    log_path = os.path.join(root, "exec_console.log")
    cf = _quietly(log_path, make_lidc_experiment, root, SP_ENV,
                  {"start_filts": 8, "end_filts": 16, "n_rpn_features": 16, "n_space_parallel": 2,
                   "plot_prediction_histograms": False}, n_patients=1, shape=SP_PATIENT, device="cuda",
                  hold_out=True)
    source = os.path.join(os.path.dirname(os.path.abspath(__file__)), "medicaldetectiontoolkit_torch", "experiments",
                          "lidc_exp")
    argv = ["--mode", "test", "--exp_source", source, "--exp_dir", cf.exp_dir, "--folds", "0"]
    t0 = time.perf_counter()
    with _quiet_fd(log_path):
        _quietly(log_path, port_exec.main, argv, device="cuda", backend="gloo")
    spatial_s = time.perf_counter() - t0
    single = os.path.join(root, "exp_single")
    shutil.copytree(cf.exp_dir, single)
    configs_py = os.path.join(single, "configs.py")
    with open(configs_py) as handle:
        text = handle.read()
    with open(configs_py, "w") as handle:
        handle.write(text.replace("'n_space_parallel': 2", "'n_space_parallel': None"))
    os.remove(os.path.join(single, "results.txt"))
    t0 = time.perf_counter()
    _quietly(log_path, port_exec.main, argv[:5] + [single] + argv[6:], device="cuda")
    single_s = time.perf_counter() - t0

    def raw(d):
        with open(os.path.join(d, "fold_0", "raw_pred_boxes_hold_out_list.pickle"), "rb") as handle:
            return pickle.load(handle)

    def scores(d):
        with open(os.path.join(d, "results.txt")) as handle:
            return [line for line in handle.read().splitlines() if line.startswith("AUC")]

    a, b = raw(cf.exp_dir), raw(single)
    if [p for _, p in a] != [p for _, p in b] or len(a) != 1:
        raise AssertionError("exec over two ranks: other patients than the one-process test")
    worst = [0.0, 0.0]
    for (boxes_a, _), (boxes_b, _) in zip(a, b):
        worst = [max(w, v) for w, v in zip(worst, same_detections(boxes_a, boxes_b))]
    n_det = sum(x["box_type"] == "det" for boxes, _ in a for el in boxes for x in el)
    if not n_det or not scores(cf.exp_dir) or scores(cf.exp_dir) != scores(single):
        raise AssertionError("exec over two ranks: no detections, or other results.txt scores than one process")
    print(f"  {len(a)} patient, {n_det} raw detections equal as sets (max|score| {worst[0]:.2e}, max|coords| "
          f"{worst[1]:.2e}), results.txt scores equal; {spatial_s:.1f} s over two ranks (their start included), "
          f"{single_s:.1f} s on one process ({card})")
    torch.cuda.empty_cache()
    print(f"  phase 15: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "models": figures}


SP_TRAIN_ENV = dict(SP_ENV, MDT_LIDC_EPOCHS="1", MDT_LIDC_NTB="2", MDT_LIDC_NVB="1", MDT_LIDC_BS="2")
SP_TRAIN_SMALL = {"start_filts": 8, "end_filts": 16, "n_rpn_features": 16, "n_cv_splits": 4, "n_workers": 2,
                  "plot_prediction_histograms": False, "test_n_epochs": 1}


@contextlib.contextmanager
def _recorded_targets():
    """Inside, each call of Mask R-CNN's ``detection_target_layer`` (as the
    detector makes it) is recorded: the GT masks (on the device) with their
    shape and bytes, and on the host the draws, the other inputs, the space
    group and the outputs."""
    from medicaldetectiontoolkit_torch.models import mrcnn

    layer, calls = mrcnn.detection_target_layer, []

    def recorded(draws, *args, **kwargs):
        out = layer(draws, *args, **kwargs)
        masks = args[6]
        calls.append({"masks": masks, "masks_shape": tuple(masks.shape),
                      "masks_bytes": masks.numel() * masks.element_size(), "space": kwargs.get("space"),
                      "draws": [d.cpu() for d in draws], "inputs": [t.cpu() for t in args[:6]],
                      "out": [t.cpu() for t in out]})
        return out

    mrcnn.detection_target_layer = recorded
    try:
        yield calls
    finally:
        mrcnn.detection_target_layer = layer


def _with_gt_proposals(torch, inputs, copies=4):
    """The target layer's inputs with each element's first proposals
    replaced by ``copies`` jitters (0.005) of each valid GT box, so that the
    GTs yield positives whatever random heads propose."""
    proposals, prop_valid, scores, gt_boxes, gt_ids, gt_valid = inputs
    near = torch.cat([gt_boxes] * copies, dim=1)
    near = near + torch.randn(near.shape, generator=torch.Generator().manual_seed(0)) * 0.005
    n = near.shape[1]
    near = torch.where(torch.cat([gt_valid] * copies, dim=1)[..., None], near, proposals[:, :n])
    return [torch.cat([near, proposals[:, n:]], dim=1), prop_valid, scores, gt_boxes, gt_ids, gt_valid]


def _gt_proposal_targets(torch, cf, calls):
    """Per recorded call, the layer again on the card with the GT boxes
    among the proposals (``_with_gt_proposals``) and the same slab of the
    masks and space group: its inputs and outputs on the host (the masks
    dropped)."""
    from medicaldetectiontoolkit_torch.models import mrcnn

    for call in calls:
        inputs = _with_gt_proposals(torch, call["inputs"])
        out = mrcnn.detection_target_layer([d.cuda() for d in call["draws"]], *[t.cuda() for t in inputs],
                                           call.pop("masks"), cf, space=call.pop("space"))
        call["gt_proposals"] = {"inputs": inputs, "out": [t.cpu() for t in out]}
    return calls


def _sp_train_rank(out_dir, configs, device):
    """A rank of phase 16a (started by ``mesh.spawn_ranks``): joins the two
    ranks' gloo group on the one card and, per model of ``configs``, makes
    the detector spatially partitioned for training over them (S = 2), then
    takes one checked step of the global batch (launches counted from 0,
    the collectives' counts and bytes, the peak device memory, Mask R-CNN's
    target layer recorded with its slab of the GT masks; the gradients Adam
    took and the loss saved), one step with the collectives
    fenced by synchronises (their seconds), one plain timed step and one
    with the allocator's history on (``common.peak_allocations``: what is
    alive at the peak)."""
    import torch

    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch
    from medicaldetectiontoolkit_torch.tools import common

    os.environ["MDT_STEM_PALLAS"] = "1"  # TF32 left on: enabling spatial training turns it off
    mesh.maybe_initialize_distributed(device=device, backend="gloo")
    rank, world = mesh.rank_and_world()
    counters = _dp_counters()
    try:
        for model, cf in configs.items():
            net = build_model(cf, common.QuietLog(), device=device)
            net.initialize(seed=0)
            net.enable_spatial_parallel(n_space=world)
            batch = make_batch(cf, seed=0)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            for wrapper in counters.values():
                wrapper.launches = 0
            net.space.reset_stats()
            with _recorded_targets() as targets:
                (res,), (step_s,) = common.train_steps(net, [batch])
            launches = {k: w.launches for k, w in counters.items()}
            peak = torch.cuda.max_memory_allocated()
            comm = {k: dict(v) for k, v in net.space.stats.items()}
            targets = _gt_proposal_targets(torch, cf, targets)
            grads = {n: p.grad.detach().float().cpu() for n, p in net.module.named_parameters()}
            net.space.reset_stats()
            net.space.timing = True
            _, (fenced_s,) = common.train_steps(net, [batch])
            net.space.timing = False
            comm_s = {k: v["s"] for k, v in net.space.stats.items()}
            _, (wall_s,) = common.train_steps(net, [batch])
            at_peak = common.peak_allocations(lambda: common.train_steps(net, [batch]))
            torch.save({"loss": res["loss"], "grads": grads, "launches": launches, "peak": peak, "comm": comm,
                        "comm_s": comm_s, "first_ms": step_s * 1e3, "fenced_ms": fenced_s * 1e3, "ms": wall_s * 1e3,
                        "at_peak": at_peak, "targets": targets}, os.path.join(out_dir, f"{model}_rank{rank}.pt"))
            del net, grads
            torch.cuda.empty_cache()
    finally:
        mesh.dist.destroy_process_group()


def _epoch_losses(np, exp_dir):
    """Per split the losses of every logged train and validation step of
    the exp dir's ``last_checkpoint``, epoch by epoch."""
    with open(os.path.join(exp_dir, "fold_0", "last_checkpoint", "monitor_metrics.pickle"), "rb") as handle:
        metrics = pickle.load(handle)
    return {split: np.asarray([v["loss"] for ep in metrics[split]["monitor_values"] for v in ep], float)
            for split in ("train", "val")}


def _sp_train_expected(np, cf, model):
    """A spatial train step's gathers and sums per rank at S = 2, from the
    shapes (``SpaceGroup.stats``: calls, bytes received): the heads' per
    pyramid level (Retina: class and box heads; Mask R-CNN: the RPN's
    logits and deltas and the level itself), each the other rank's float32
    slab forward and the whole gradient backward; Detection U-Net's softmax,
    joined detached; the seg loss's one float64 ``sum`` of 3 C + 1 values
    (3 C + 2 with class weights) and its ``sum_bwd``; Mask R-CNN's one
    ``mask_rows`` sum of the GT mask rows its mask targets read (two per
    crop row of every positive slot, uint8). No GroupNorm (norm None at
    LIDC)."""
    from medicaldetectiontoolkit_torch.models.mrcnn import roi_slots

    A, b = cf.n_anchors_per_pos, cf.batch_size
    voxels = sum(int(np.prod(shape)) for shape in cf.backbone_shapes)
    if model == "detection_unet":
        smax = b * cf.num_seg_classes * int(np.prod(cf.patch_size)) * 4 // 2
        gathers, whole = (1, smax), (0, 0)
    else:
        per_level, channels = (2, A * (cf.head_classes + 2 * cf.dim)) if model == "retina_unet" else \
            (3, A * (2 + 2 * cf.dim) + cf.end_filts)
        n = per_level * len(cf.pyramid_levels)
        gathers, whole = (n, b * channels * voxels * 4 // 2), (n, b * channels * voxels * 4)
    seg = (0, 0)
    if model in ("retina_unet", "detection_unet"):
        seg = (1, (3 * cf.num_seg_classes + (2 if model == "detection_unet" else 1)) * 8)
    rows = (0, 0)
    if model == "mrcnn":
        rows = (1, 2 * b * roi_slots(cf)[0] * cf.mask_shape[0] * int(np.prod(cf.patch_size[1:])))
    return {"gather": gathers, "gather_bwd": whole, "sum": seg, "sum_bwd": seg, "mask_rows": rows}


def _check_mask_targets(torch, cf, ranks, whole_masks, card):
    """Mask R-CNN's GT masks on the slabs: each rank's target layer was given
    its Y slab of the masks (bytes against the arithmetic and against one
    process's upload), and its outputs, in the step and again with the GT
    boxes among the proposals (so that crops read rows of both slabs),
    equal, bit for bit, the layer's on one process given the rank's inputs
    and draws and the whole masks. Prints the positives with mask targets
    and those whose crops read rows of both slabs."""
    from medicaldetectiontoolkit_torch.models import mrcnn
    from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops

    whole_bytes = whole_masks.numel() * whole_masks.element_size()
    slab_shape = (*whole_masks.shape[:2], whole_masks.shape[2] // 2, *whole_masks.shape[3:])
    n_pos, half = mrcnn.roi_slots(cf)[0], whole_masks.shape[2] // 2

    def held(draws, inputs, got):
        want = mrcnn.detection_target_layer([d.cuda() for d in draws], *[t.cuda() for t in inputs], whole_masks, cf)
        rois, mask_pos = got[0][:, :n_pos], got[6][:, :n_pos]
        y0, y1, _ = roi_ops.roi_axes(rois.reshape(-1, 2 * cf.dim), cf.mask_shape, whole_masks.shape[2:])[0]
        straddle = ((y0.amin(dim=1) < half) & (y1.amax(dim=1) >= half)).reshape(mask_pos.shape) & mask_pos
        same = all(torch.equal(a.cpu(), b) for a, b in zip(want, got))
        return same, f"{same} ({int(mask_pos.sum())} positives with mask targets, {int(straddle.sum())} reading rows " \
            "of both slabs)"

    for r, res in enumerate(ranks):
        (call,) = res["targets"]
        same, line = held(call["draws"], call["inputs"], call["out"])
        same_gt, line_gt = held(call["draws"], call["gt_proposals"]["inputs"], call["gt_proposals"]["out"])
        print(f"  mrcnn rank {r}: GT masks uploaded as {call['masks_shape']} uint8, {call['masks_bytes'] / 1e6:.1f} "
              f"MB (expected {slab_shape}, {whole_bytes / 2e6:.1f} MB; one process {whole_bytes / 1e6:.1f} MB); "
              f"target layer bit-identical to one process's on the whole masks, in the step: {line}; with the GT "
              f"boxes among the proposals: {line_gt} ({card})")
        if call["masks_shape"] != slab_shape or not (same and same_gt):
            raise AssertionError(f"mrcnn rank {r}: GT masks {call['masks_shape']} (expected the slab {slab_shape}) or "
                                 "target layer outputs that differ from one process's")


def _size(n_bytes):
    """Bytes as MB, or as bytes below 0.1 MB (the seg loss's sums)."""
    return f"{n_bytes / 1e6:.1f} MB" if n_bytes >= 1e5 else f"{n_bytes} B"


def _print_peak(label, at_peak, card):
    """The five largest origins of what is alive at a step's peak."""
    parts = "; ".join(f"{origin}: {n_bytes / 2**30:.3f} GiB" + (f" ({count} blocks)" if count else "")
                      for origin, n_bytes, count in at_peak["top"])
    print(f"    {label}: peak {at_peak['peak'] / 2**30:.3f} GiB ({at_peak['before'] / 2**30:.3f} allocated before "
          f"the step); largest alive there: {parts} ({card})")


def _drive_spatial_training(torch, np, common, card, root):
    """Phase 16: spatial partitioning for training (``parallel/mesh.py``:
    the primitives' backward collectives, ``Detector.enable_spatial_parallel``).
    16a: two ranks share the one card over gloo as a space group (S = 2) and
    take a train step of the LIDC-width 3D Retina U-Net, 3D Mask R-CNN and
    3D Detection U-Net on the global batch of 8 (one microbatch, remat,
    float32, TF32 off, ``MDT_STEM_PALLAS=1``), held against the one-process
    step on the card (loss 1e-5 relative, gradients 1e-3 of each tensor's
    max: phase 7b's tolerances), with each rank's kernel launches asserted
    (K3 and K4 on the haloed slabs, K1, K2 and K2's backward on the gathered
    tensors), the gathers and sums asserted against the shapes'
    (``_sp_train_expected``: the seg path stays on the slabs), the forward
    and backward collectives' calls, MB and fenced ms, ms per step, the peak
    device memory and what is alive at the peak (rank 0 and one process)
    printed. 16b: ``exec --mode train_test`` over
    two ranks that exec starts itself (``n_space_parallel`` 2, backend
    gloo) on phase 15c's small patients, its losses against a one-process
    run. Returns the launch counts and the figures."""
    import shutil

    from medicaldetectiontoolkit_torch import exec as port_exec
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.parallel import mesh
    from medicaldetectiontoolkit_torch.testing import make_batch, make_lidc_experiment

    t_phase = time.perf_counter()
    os.environ["MDT_STEM_PALLAS"] = "1"
    print("== phase 16a: two ranks on the one card over gloo as a space group (S = 2), spatially partitioned "
          "training at LIDC width (patch 128x128x64, sf 18, ef 36, global batch 8 as one microbatch, remat), "
          "float32, TF32 off, MDT_STEM_PALLAS=1")
    configs = {model: _dp_config(model) for model in SP_TRAIN_MODELS}
    ref = {}
    for model, cf in configs.items():
        net = build_model(cf, common.QuietLog(), device="cuda")
        net.initialize(seed=0)
        batch = make_batch(cf, seed=0)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        (res,), _ = common.train_steps(net, [batch])
        peak = torch.cuda.max_memory_allocated()
        grads = {n: p.grad.detach().float().cpu() for n, p in net.module.named_parameters()}
        _, (wall_s,) = common.train_steps(net, [batch])
        at_peak = common.peak_allocations(lambda: common.train_steps(net, [batch]))
        ref[model] = {"loss": res["loss"], "grads": grads, "peak": peak, "ms": wall_s * 1e3, "at_peak": at_peak}
        if model == "mrcnn":  # the whole GT masks as one process uploads them
            ref[model]["masks"] = net._prep(batch)[4]
        del net
        torch.cuda.empty_cache()
    out_dir = os.path.join(root, "sp_train_ranks")
    os.makedirs(out_dir)
    os.environ.setdefault("MDT_DIST_INIT_TIMEOUT", "300")
    t0 = time.perf_counter()
    mesh.spawn_ranks(_sp_train_rank, 2, (out_dir, configs, "cuda"))
    print(f"  two ranks started, stepped and stopped in {time.perf_counter() - t0:.1f} s")
    launches = {k: 0 for k in _dp_counters()}
    figures = {}
    for model, cf in configs.items():
        one = ref[model]
        if model == "retina_unet":
            expect = {"stem_fwd": 2, "stem_wgrad": 1, "nms": 1, "roi_align": 0, "roi_align_bwd": 0}
        elif model == "detection_unet":
            expect = {"stem_fwd": 2, "stem_wgrad": 1, "nms": 0, "roi_align": 0, "roi_align_bwd": 0}
        else:
            expect = two_stage_launches(cf, cf.batch_size, "train")
        want = _sp_train_expected(np, cf, model)
        ranks = [torch.load(os.path.join(out_dir, f"{model}_rank{r}.pt"), weights_only=False) for r in range(2)]
        for r, res in enumerate(ranks):
            loss_err = abs(res["loss"] - one["loss"]) / abs(one["loss"])
            grad_err, worst = _grad_errors(torch, res["grads"], one["grads"])
            comm, comm_s = res["comm"], res["comm_s"]
            coll = "; ".join(f"{k} {comm[k]['calls']} calls, {_size(comm[k]['bytes'])} received" + (
                f" (expected {want[k][0]} calls, {_size(want[k][1])})" if k in want else "")
                + f", {comm_s[k] * 1e3:.1f} ms" for k in comm)
            print(f"  {model} rank {r}: loss {res['loss']:.6f} vs one process {one['loss']:.6f} (relative "
                  f"{loss_err:.2e}); worst gradient {grad_err:.2e} of its tensor's max ({worst}); launches "
                  f"{res['launches']} (expected {expect}); per step: {coll} (each collective fenced by "
                  f"synchronises, gloo through the host); step {res['ms']:.1f} ms ({res['fenced_ms']:.1f} fenced, "
                  f"first {res['first_ms']:.1f}) against {one['ms']:.1f} ms on one process (two ranks sharing "
                  f"one card: not a scaling figure); peak device memory {res['peak'] / 2**30:.3f} GiB against "
                  f"{one['peak'] / 2**30:.3f} GiB on one process ({card})")
            if not (loss_err <= 1e-5 and grad_err <= 1e-3):
                raise AssertionError(f"{model} rank {r}: the spatial train step differs from the one-process step")
            if {k: res["launches"][k] for k in expect} != expect:
                raise AssertionError(f"{model} rank {r}: launches {res['launches']}, expected {expect}")
            if not (comm["halo"]["calls"] > 0 and comm["halo_bwd"]["calls"] > 0) or any(
                    (comm[k]["calls"], comm[k]["bytes"]) != want[k] for k in want):
                raise AssertionError(f"{model} rank {r}: the spatial step's collectives {comm}, expected halos and "
                                     f"{want}")
            for k in launches:
                launches[k] += res["launches"][k]
        if any(not torch.equal(ranks[0]["grads"][n], ranks[1]["grads"][n]) for n in one["grads"]):
            raise AssertionError(f"{model}: the two ranks hold different summed gradients")
        if model == "mrcnn":
            _check_mask_targets(torch, cf, ranks, one.pop("masks"), card)
        for res in ranks:
            del res["targets"]
        for res in ranks:
            del res["grads"]
        _print_peak(f"{model}, one process", one["at_peak"], card)
        _print_peak(f"{model}, rank 0", ranks[0]["at_peak"], card)
        figures[model] = {"ranks": ranks, "one": {k: one[k] for k in ("peak", "ms", "at_peak")}}
    del ref

    print(f"== phase 16b: exec --mode train_test over two ranks that exec starts itself (n_space_parallel 2, "
          f"backend gloo) on synthetic patients of {SP_PATIENT} (patch 64x64x8, sf 8, batch 2, one epoch of 2 "
          "train and 1 val_sampling batches from 2 loader workers, then the test), against a one-process run of the "
          "same seed (TF32 off)")
    log_path = os.path.join(root, "exec_console.log")
    data = os.path.join(root, "data_sp_train")
    exps = {tag: _quietly(log_path, make_lidc_experiment, root, SP_TRAIN_ENV, dict(SP_TRAIN_SMALL, n_space_parallel=s),
                          n_patients=4, shape=SP_PATIENT, seeds=(), epochs=(), device="cuda", data_dir=data,
                          exp_name=f"exp_sp_train_{tag}")
            for s, tag in ((2, "spatial"), (None, "single"))}
    source = os.path.join(os.path.dirname(os.path.abspath(__file__)), "medicaldetectiontoolkit_torch", "experiments",
                          "lidc_exp")
    walls = {}
    for tag, cf in exps.items():
        argv = ["--mode", "train_test", "--exp_source", source, "--exp_dir", cf.exp_dir, "--folds", "0",
                "--use_stored_settings"]
        t0 = time.perf_counter()
        with _quiet_fd(log_path):
            _quietly(log_path, port_exec.main, argv, device="cuda", backend="gloo" if tag == "spatial" else None)
        walls[tag] = time.perf_counter() - t0
    a, b = (_epoch_losses(np, exps[tag].exp_dir) for tag in ("spatial", "single"))
    worst = max(float(np.max(np.abs(a[k] - b[k]) / np.abs(b[k]))) for k in b) if all(
        a[k].shape == b[k].shape and a[k].size for k in b) else float("inf")
    spatial = exps["spatial"].exp_dir
    with open(os.path.join(spatial, "fold_0", "exec.log")) as handle:
        log = handle.read()
    written = os.path.isfile(os.path.join(spatial, "results.txt")) and \
        os.path.isfile(os.path.join(spatial, "fold_0", "last_checkpoint", "params.pkl"))
    print(f"  train losses {a['train'].tolist()}, val {a['val'].tolist()} over two ranks; worst relative difference "
          f"from one process {worst:.2e}; last_checkpoint and results.txt written: {written}; {walls['spatial']:.1f} s "
          f"over two ranks (their start included), {walls['single']:.1f} s on one process ({card})")
    if not (worst <= 1e-5 and written and "spatially-partitioned training over 1x2" in log):
        raise AssertionError("exec train_test over two ranks: other losses than one process, or no checkpoint, "
                             "results.txt or spatial training log line")
    shutil.rmtree(data)
    torch.cuda.empty_cache()
    print(f"  phase 16: {time.perf_counter() - t_phase:.1f} s ({card})")
    return {"launches": launches, "models": figures, "exec_s": walls}


def _drive_host_bench(card):
    """Phase 17: the port's host-path bench (``tools/host_bench.py``) at its
    default sizes on this machine's CPUs, the native host library on and
    off: one JSON line per bench and mode; the two modes keep the same WBC
    clusters and 2D->3D boxes."""
    from medicaldetectiontoolkit_torch.tools import host_bench

    print(f"== phase 17: host-path bench (WBC, the 2D->3D merge, the evaluator, spatial augmentation) on "
          f"{os.cpu_count()} CPUs, the native library on and off ({card}'s host)")
    lines = host_bench.main([])
    for key in ("clusters", "kept"):
        counts = {d["native"]: d[key] for d in lines if key in d}
        if len(set(counts.values())) != 1:
            raise AssertionError(f"host bench: {key} {counts} differ between the native and NumPy paths")
    if not all(math.isfinite(d["value"]) and d["value"] > 0 for d in lines):
        raise AssertionError(f"host bench: a non-positive time in {lines}")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device visible (torch.cuda.is_available() is False)", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import numpy as np

    from medicaldetectiontoolkit_torch import native
    from medicaldetectiontoolkit_torch.testing import make_batch, make_config
    from medicaldetectiontoolkit_torch.tools import common
    from medicaldetectiontoolkit_torch.models import build_model
    from medicaldetectiontoolkit_torch.models.mrcnn import roi_levels
    from medicaldetectiontoolkit_torch.models.retina_net import refine_detections
    from medicaldetectiontoolkit_torch.ops import nms as nms_ops
    from medicaldetectiontoolkit_torch.ops import nms_cuda, roi_align_cuda, stem_conv, stem_conv_cuda
    from medicaldetectiontoolkit_torch.ops import roi_align as roi_ops
    from medicaldetectiontoolkit_torch.tools import time_nms, time_roi_align, time_roi_align_bwd, time_stem

    t_start = time.perf_counter()

    def lap(phase):
        print(f"-- phase {phase} starts at {time.perf_counter() - t_start:.1f} s")

    print("== phase 1: device")
    card = common.card_line()
    name = torch.cuda.get_device_name(0)
    print(f"  nvidia-smi: {card}")
    print(f"  torch {torch.__version__}, CUDA {torch.version.cuda}, device 0: {name}, "
          f"count {torch.cuda.device_count()}")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    print(f"  cudnn.allow_tf32={torch.backends.cudnn.allow_tf32} "
          f"cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")
    print("  " + _host_packages().replace("\n", "\n  "))

    print("== phase 2: build (one nvcc per source and the native host library, in parallel)")
    t0 = time.perf_counter()
    with ThreadPoolExecutor(max_workers=4) as pool:
        host_lib = pool.submit(native.get_lib)
        libs = list(pool.map(lambda m: m.build(), (nms_cuda, roi_align_cuda, stem_conv_cuda)))
        host_lib.result()
    info = native.lib_info()
    print(f"  {', '.join(p.name for p in libs)}, {os.path.basename(info['path'])} ({info['compiler']}) in "
          f"{time.perf_counter() - t0:.2f} s")
    for lib_path in libs:
        log = lib_path.with_suffix(".log")
        if log.exists():
            print("  " + log.read_text().strip().replace("\n", "\n  "))

    lap("3: kernel checks")
    nms_entry, nms_times = _check_nms(torch, np, common, nms_ops, nms_cuda, time_nms)
    roi_entry, roi_times = _check_roi_align(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align)
    stem_entries, stem_times = _check_stem(torch, np, common, stem_conv, stem_conv_cuda, time_stem,
                                           _stem_cases(torch))
    bwd_entry, bwd_times = _check_roi_align_bwd(torch, np, common, roi_ops, roi_align_cuda, roi_levels, time_roi_align,
                                                time_roi_align_bwd)

    lap("4: inference slices")
    batches = common.slice_batches(3)
    runs = {}
    for dtype in ("float32", "bfloat16"):
        runs[dtype] = _drive_slice(torch, np, dtype, batches, common, nms_cuda, refine_detections, nms_ops, card)
        torch.cuda.empty_cache()
    h32, h16 = runs["float32"]["heads"], runs["bfloat16"]["heads"]
    for hname, a, b in zip(("class_logits", "bb_deltas"), h32, h16):
        print(f"  bfloat16 vs float32 {hname}: max abs diff {float((a - b).abs().max()):.3e}")
    _small_reference(torch, np, make_config, make_batch, build_model, common.QuietLog())

    mruns = {}
    for dtype in ("float32", "bfloat16"):
        mruns[dtype] = _drive_mrcnn(torch, np, dtype, batches, common, nms_cuda, roi_align_cuda, nms_ops, roi_ops,
                                    card)
        torch.cuda.empty_cache()
    h32, h16 = mruns["float32"]["heads"], mruns["bfloat16"]["heads"]
    for hname, a, b in zip(("rpn_logits", "rpn_deltas"), h32, h16):
        print(f"  bfloat16 vs float32 mrcnn {hname}: max abs diff {float((a - b).abs().max()):.3e}")
    for model in ("mrcnn", "ufrcnn"):
        _small_two_stage(torch, np, make_config, make_batch, build_model, common.QuietLog(), model)
    _small_det_unet(torch, np, make_config, make_batch, build_model, common.QuietLog())
    lap("7: one-stage training")

    counters = {"stem_fwd": stem_conv_cuda.stem_conv3d, "stem_wgrad": stem_conv_cuda.stem_wgrad,
                "nms": nms_cuda.batched_nms}
    train_batches = common.slice_batches(3, "retina_unet_train")
    truns = {}
    for dtype in ("float32", "bfloat16"):
        truns[dtype] = _drive_train(torch, np, dtype, train_batches, common, counters, card)
        torch.cuda.empty_cache()
    for model in ("retina_unet", "retina_net", "mrcnn", "ufrcnn", "detection_unet"):
        _small_train(torch, np, make_config, make_batch, build_model, common.QuietLog(), model)

    lap("8: whole patients")
    with tempfile.TemporaryDirectory() as root:
        patients = _drive_patients(torch, np, common, nms_cuda, roi_align_cuda, nms_ops, card, root)
    with tempfile.TemporaryDirectory() as train_root:  # phase 9's patients, read again by 10, 11 and 14
        lap("9: one-stage training through exec")
        training = _drive_training(torch, np, common, counters, card, train_root)
        lap("10: two-stage training through exec")
        two_stage = _drive_two_stage_training(
            torch, np, common, dict(counters, roi_align=roi_align_cuda.pyramid_roi_align,
                                    roi_align_bwd=roi_align_cuda.pyramid_roi_align_backward), card, train_root)
        lap("11: Detection U-Net through exec")
        det_unet = _drive_det_unet_training(torch, np, common, counters, card, train_root)
        lap("12: the toy experiment through exec")
        with tempfile.TemporaryDirectory() as root:
            toy = _drive_toy(torch, np, common, counters, card, root)
        lap("13: the PET-CT experiment through exec")
        with tempfile.TemporaryDirectory() as root:
            petct = _drive_petct(torch, np, common, counters, card, root)
        lap("14: data parallelism")
        dp = _drive_data_parallel(torch, np, common, counters, card, train_root)
    lap("15: spatial partitioning")
    with tempfile.TemporaryDirectory() as root:
        sp = _drive_spatial(torch, np, common, card, root)
    lap("16: spatial training")
    with tempfile.TemporaryDirectory() as root:
        spt = _drive_spatial_training(torch, np, common, card, root)
    lap("17: the host-path bench")
    _drive_host_bench(card)

    print(f"== summary ({card}; {time.perf_counter() - t_start:.1f} s)")
    for pname, t in patients["times"].items():
        print(f"  whole patient {pname}: {t['ms']:.1f} ms per patient (forward {t['forward_ms']:.1f}, stitching "
              f"{t['stitching_ms']:.1f}, consolidation {t['consolidation_ms']:.1f}, evaluation "
              f"{t['evaluation_ms']:.1f}), {t['patches_per_s']:.2f} patches/s")
    for dtype, r in runs.items():
        print(f"  retina_unet {dtype}: {r['per_chunk_ms']:.1f} ms per chunk of 8 patches")
    for dtype, r in mruns.items():
        print(f"  mrcnn {dtype}: {r['per_chunk_ms']:.1f} ms per chunk of 8 patches")
    for case, t in nms_times.items():
        print(f"  nms {case}: kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms, plain {t['plain_ms']:.4f} "
              f"ms, bound {t['bound_ms']:.6f} ms ({t['bound_by']})")
    for case, t in roi_times.items():
        print(f"  roi_align {case}: kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms (host "
              f"{t['host_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    for case, (k3, k4) in stem_times.items():
        print(f"  stem K3 {case}: launch alone {k3['ms']:.4f} ms, wrapper {k3['wrapper_ms']:.4f} ms (host "
              f"{k3['host_ms']:.4f} ms), plain {k3['plain_ms']:.4f} ms, library {k3['library_ms']:.4f} ms, bound "
              f"{k3['bound_ms']:.4f} ms ({k3['bound_by']})")
        print(f"  stem K4 {case}: kernel {k4['ms']:.4f} ms, plain {k4['plain_ms']:.4f} ms, library "
              f"{k4['library_ms']:.4f} ms, bound {k4['bound_ms']:.4f} ms ({k4['bound_by']})")
    print(f"  exec --mode train_test, retina_unet 3D float32 at LIDC width: "
          f"{sum(training['step_ms']) / len(training['step_ms']):.1f} ms per step of 8 as the loop logs it "
          f"(median {sorted(training['step_ms'])[len(training['step_ms']) // 2]:.1f}), loader "
          f"{training['loader_patches_per_s']:.2f} patches/s")
    for case, t in bwd_times.items():
        print(f"  roi_align backward {case}: kernel {t['ms']:.4f} ms, wrapper {t['wrapper_ms']:.4f} ms (host "
              f"{t['host_ms']:.4f} ms), plain {t['plain_ms']:.4f} ms, bound {t['bound_ms']:.4f} ms ({t['bound_by']})")
    ms = two_stage["step_ms"]
    print(f"  exec --mode train_test, mrcnn 3D float32 at LIDC width: {sum(ms) / len(ms):.1f} ms per step of 8 as the "
          f"loop logs it (median {sorted(ms)[len(ms) // 2]:.1f}); mrcnn slice bfloat16: "
          f"{', '.join(f'{t:.1f}' for t in two_stage['bf16_step_ms'])} ms per step")
    ms = det_unet["step_ms"]
    print(f"  exec --mode train_test, detection_unet 3D float32 at LIDC width: {sum(ms) / len(ms):.1f} ms per step of 8 "
          f"as the loop logs it (median {sorted(ms)[len(ms) // 2]:.1f})")
    for dtype, t in det_unet["slice"].items():
        print(f"  detection_unet slice {dtype}: device {', '.join(f'{v:.1f}' for v in t['device_ms'])} ms, host "
              f"convert {', '.join(f'{v:.1f}' for v in t['host_ms'])} ms per step of 8")
    for model, ms in toy["step_ms"].items():
        print(f"  toy {model} 2D 320x320 batch 20: median {sorted(ms)[len(ms) // 2]:.1f} ms per step as logged")
    ms = petct["step_ms"]
    print(f"  exec --mode train_test, PET-CT retina_unet 3D float32 (192x192x32, 2 channels, batch 8): "
          f"{', '.join(f'{t:.1f}' for t in ms)} ms per step as logged, peak {petct['peak_gib']:.2f} GiB; after a "
          f"warm-up, {'; '.join(f'{m} ' + ', '.join(f'{t:.1f}' for t in v) for m, v in petct['slice_ms'].items())} "
          f"ms per step")
    for model, ranks in dp["ranks"].items():
        print(f"  data-parallel {model}, 2 ranks of 4 rows sharing one card over gloo: "
              f"{'; '.join(', '.join(f'{t:.1f}' for t in r['step_ms']) for r in ranks)} ms per step per rank "
              f"(not a scaling figure); gradient buffer {ranks[0]['grad_mb']:.2f} MB, all-reduce "
              f"{', '.join(str(round(r['reduce_ms'], 2)) for r in ranks)} ms")
    ms = dp["step_ms"]
    print(f"  exec --mode train_test data-parallel at world size 1 over NCCL, retina_unet 3D float32 at LIDC width: "
          f"{', '.join(f'{t:.1f}' for t in ms)} ms per step as logged (phase 9: median "
          f"{sorted(training['step_ms'])[len(training['step_ms']) // 2]:.1f}); gradient all-reduce over NCCL "
          f"{dp['nccl_ms']:.3f} ms")
    for model, fig in sp["models"].items():
        ms = ", ".join(f"{r['ms']:.1f}" for r in fig["ranks"])
        halo = ", ".join(f"{r['comm_s']['halo'] * 1e3:.1f}" for r in fig["ranks"])
        gather = ", ".join(f"{r['comm_s']['gather'] * 1e3:.1f}" for r in fig["ranks"])
        peak = ", ".join(f"{r['peak'] / 2**30:.3f}" for r in fig["ranks"])
        print(f"  spatial {model}, S = 2 over gloo on one card: forward {ms} ms per rank against "
              f"{fig['one']['ms']:.1f} ms on one process (not a scaling figure); halo {halo} ms, gather {gather} ms "
              f"per forward (fenced); peak {peak} GiB per rank against {fig['one']['peak'] / 2**30:.3f} GiB")
    for model, fig in spt["models"].items():
        ms = ", ".join(f"{r['ms']:.1f}" for r in fig["ranks"])
        comm = ", ".join(f"{sum(r['comm_s'].values()) * 1e3:.1f}" for r in fig["ranks"])
        peak = ", ".join(f"{r['peak'] / 2**30:.3f}" for r in fig["ranks"])
        print(f"  spatial training {model}, S = 2 over gloo on one card: step {ms} ms per rank against "
              f"{fig['one']['ms']:.1f} ms on one process (not a scaling figure); collectives {comm} ms per step "
              f"(fenced); peak {peak} GiB per rank against {fig['one']['peak'] / 2**30:.3f} GiB")
    for dtype, r in truns.items():
        print(f"  retina_unet training {dtype}: {sum(r['ms']) / len(r['ms']):.1f} ms per step of 8 "
              f"({r['patches_per_s']:.2f} patches/s, peak {r['peak_gib']:.2f} GiB); A/B K3/K4 vs cuDNN stem: "
              f"{sorted(r['ab_ms']['1'])[1]:.1f} vs {sorted(r['ab_ms']['0'])[1]:.1f} ms per step (medians of 3)")
    kernels = [{
        "name": "nms",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/nms.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/nms_pallas.py:84",
        "launches": sum(r["launches"] for r in runs.values()) + sum(r["launches"]["nms"] for r in mruns.values())
        + sum(r["launches"]["nms"] for r in truns.values()) + patients["launches"]["nms"]
        + training["launches"]["nms"] + two_stage["launches"]["nms"] + toy["nms"] + petct["launches"]["nms"]
        + dp["launches"]["nms"] + sp["launches"]["nms"] + spt["launches"]["nms"],
        **nms_entry,
    }, {
        "name": "roi_align",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/roi_align.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/roi_align_pallas.py:145",
        "launches": sum(r["launches"]["roi_align"] for r in mruns.values()) + patients["launches"]["roi_align"]
        + two_stage["launches"]["roi_align"] + dp["launches"]["roi_align"] + sp["launches"]["roi_align"]
        + spt["launches"]["roi_align"],
        **roi_entry,
    }, {
        "name": "roi_align_bwd",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/roi_align.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/roi_align_pallas.py:269",
        "launches": two_stage["launches"]["roi_align_bwd"] + dp["launches"]["roi_align_bwd"]
        + spt["launches"]["roi_align_bwd"],
        **bwd_entry,
    }, {
        "name": "stem_fwd",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/stem_conv.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/stem_conv_pallas.py:151",
        "launches": sum(r["launches"]["stem_fwd"] for r in truns.values()) + training["launches"]["stem_fwd"]
        + two_stage["launches"]["stem_fwd"] + det_unet["launches"]["stem_fwd"] + petct["launches"]["stem_fwd"]
        + dp["launches"]["stem_fwd"] + sp["launches"]["stem_fwd"] + spt["launches"]["stem_fwd"],
        **stem_entries["stem_fwd"],
    }, {
        "name": "stem_wgrad",
        "route": "cuda",
        "source": "medicaldetectiontoolkit_torch/csrc/stem_conv.cu",
        "replaces": "medicaldetectiontoolkit_tpu/ops/stem_conv_pallas.py:201",
        "launches": sum(r["launches"]["stem_wgrad"] for r in truns.values()) + training["launches"]["stem_wgrad"]
        + two_stage["launches"]["stem_wgrad"] + det_unet["launches"]["stem_wgrad"] + petct["launches"]["stem_wgrad"]
        + dp["launches"]["stem_wgrad"] + spt["launches"]["stem_wgrad"],
        **stem_entries["stem_wgrad"],
    }]
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name, "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
