"""Default configuration: the base attribute bag every layer reads.

Counterpart of ``medicaldetectiontoolkit_tpu/config.py``, with the same
attributes and defaults: configs are code, carry ~100 attributes with the
same names as the reference's ``default_configs.py``, and the per-experiment
``configs(server_env)`` subclasses compute derived geometry in their
``add_*_configs`` methods.

The attributes at the bottom were added for the TPU. The port reads them so
that a config (or an experiment directory's snapshot) means the same in both
packages. It ignores ``stage_mode`` (how flax lays out the backbone's
identity blocks; the port loads either layout). ``n_data_parallel`` /
``n_space_parallel`` (``MDT_DP`` / ``MDT_SP``, the TPU mesh) above 1 make the
port's training raise: it runs on one card. ``profile`` traces train steps
2-6 with ``torch.profiler`` in place of ``jax.profiler``. ``MDT_ZBLOCK_G``
and ``MDT_ZBAND`` select XLA conv rewrites of the JAX backbone and are not
read by the port at all. ``compute_dtype``, ``max_gt_boxes``, ``use_remat``
and ``grad_accum_steps`` the port honours.
"""

from __future__ import annotations

import os


class DefaultConfigs:
    def __init__(self, model, server_env=None, dim=2):
        #########################
        #         I/O           #
        #########################
        self.model = model
        self.dim = dim
        self.select_prototype_subset = None

        self.source_dir = os.path.dirname(os.path.realpath(__file__))
        self.input_df_name = "info_df.pickle"
        # kept for snapshot compatibility; models resolve via registry
        self.model_path = f"medicaldetectiontoolkit_torch/models/{model}.py"
        self.backbone_path = "medicaldetectiontoolkit_torch/models/backbone.py"

        #########################
        #      Data Loader      #
        #########################
        # random seed for fold_generator and batch_generator
        self.seed = 0
        # number of worker threads for host-side batch generation
        self.n_workers = 16 if server_env else 8
        self.class_specific_seg_flag = False

        #########################
        #      Architecture     #
        #########################
        self.weight_decay = 0.0
        self.relu = "relu"  # 'relu' | 'leaky_relu'
        self.custom_init = False
        self.weight_init = None
        self.norm = None  # None | 'instance_norm' | 'batch_norm'
        # adds high-res decoder levels P1 + P0 to the FPN
        self.operate_stride1 = False

        #########################
        #       Schedule        #
        #########################
        self.n_cv_splits = 5
        self.n_probabilistic_samples = None

        #########################
        #   Testing / Plotting  #
        #########################
        # mirror TTA (xy only)
        self.test_aug = True
        self.hold_out_test_set = False
        self.ensemble_folds = False
        self.box_color_palette = {
            "det": "b",
            "gt": "r",
            "neg_class": "purple",
            "prop": "w",
            "pos_class": "g",
            "pos_anchor": "c",
            "neg_anchor": "c",
        }
        self.scan_det_thresh = False
        self.plot_stat_curves = False
        self.per_patient_ap = False
        # IoU for clustering 2D predictions into 3D cubes (xy overlap)
        self.merge_3D_iou = 0.1
        self.n_monitoring_figures = 1
        self.assign_values_to_extra_figure = {}
        self.save_preds_to_csv = True
        self.max_test_patients = "all"

        #########################
        #        MRCNN          #
        #########################
        self.frcnn_mode = False
        self.return_masks_in_val = False
        self.return_masks_in_test = False
        self.sixth_pooling = False
        self.n_latent_dims = 0

        #########################
        #   Added for the TPU   #
        #########################
        # padding maximum for GT boxes per batch element (masked)
        self.max_gt_boxes = 32
        # padding maximum for GT masks (None = same as max_gt_boxes)
        self.max_gt_masks = None
        # compute dtype of the conv stack ('float32' | 'bfloat16'); losses
        # and box math stay float32
        self.compute_dtype = "float32"
        # recompute backbone activations in the backward pass; None = on in
        # 3D, off in 2D
        self.use_remat = None
        # a trace of train steps 2-6 (torch.profiler here, jax.profiler in JAX)
        self.profile = False
        # data-parallel ranks, one per card (MDT_DP; parallel/mesh.py): exec
        # starts them itself, or each joins an MDT_DIST_* job; batch_size
        # stays the global batch. Spatial partitioning (MDT_SP: the ranks of
        # a space group split each image's Y) runs training, validation and
        # test inference over MDT_DP x MDT_SP ranks
        self.n_data_parallel = (
            int(os.environ["MDT_DP"]) if os.environ.get("MDT_DP") else None
        )
        self.n_space_parallel = (
            int(os.environ["MDT_SP"]) if os.environ.get("MDT_SP") else None
        )
        # microbatches per optimizer step (MDT_GRAD_ACCUM); a batch that does
        # not divide rounds the count down to a divisor
        self.grad_accum_steps = int(os.environ.get("MDT_GRAD_ACCUM", "1") or 1)
        # the flax layout of the backbone's identity blocks ("unroll", "scan"
        # or "loop"; MDT_STAGE_MODE); read and ignored here: checkpoints in
        # either layout load into the port (utils/convert.py)
        self.stage_mode = os.environ.get("MDT_STAGE_MODE", "unroll")
