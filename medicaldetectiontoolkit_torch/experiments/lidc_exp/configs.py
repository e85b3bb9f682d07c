"""LIDC experiment configuration (2D/3D lung nodule detection) of the port.

Counterpart of ``experiments/lidc_exp/configs.py``: the same attributes and
values, the same environment overrides (``MDT_DIM`` (default 2),
``MDT_MODEL``, ``MDT_LIDC_ROOT``, ``MDT_LIDC_PP``, ``MDT_LIDC_PATCH``,
``MDT_LIDC_EPOCHS``, ``MDT_LIDC_NTB``, ``MDT_LIDC_BS``, ``MDT_LIDC_DTYPE``,
``MDT_LIDC_NVB``), on the port's ``DefaultConfigs``. Run it as
``--exp_source medicaldetectiontoolkit_torch/experiments/lidc_exp``.
"""

import os

import numpy as np

from medicaldetectiontoolkit_torch.config import DefaultConfigs


class configs(DefaultConfigs):
    def __init__(self, server_env=None):
        #########################
        #    Preprocessing      #
        #########################
        self.root_dir = os.environ.get("MDT_LIDC_ROOT", "/tmp/lidc")
        self.raw_data_dir = f"{self.root_dir}/data_nrrd"
        self.pp_dir = f"{self.root_dir}/pp_norm"
        self.target_spacing = (0.7, 0.7, 1.25)

        #########################
        #         I/O           #
        #########################
        self.dim = int(os.environ.get("MDT_DIM", 2))
        self.model = os.environ.get("MDT_MODEL", "retina_unet")

        DefaultConfigs.__init__(self, self.model, server_env, self.dim)

        self.select_prototype_subset = None

        self.pp_name = "lidc_mdt"
        self.input_df_name = "info_df.pickle"
        self.pp_data_path = os.environ.get("MDT_LIDC_PP", os.path.join(self.root_dir, self.pp_name))
        self.pp_test_data_path = self.pp_data_path

        #########################
        #      Data Loader      #
        #########################
        self.channels = [0]
        self.n_channels = len(self.channels)

        self.pre_crop_size_2D = [300, 300]
        self.patch_size_2D = [288, 288]
        self.pre_crop_size_3D = [156, 156, 96]
        self.patch_size_3D = [128, 128, 64]
        # scripted-run override: shrink the training geometry, keeping pre-crop slack proportional
        if os.environ.get("MDT_LIDC_PATCH"):
            p = [int(v) for v in os.environ["MDT_LIDC_PATCH"].split(",")]
            if self.dim == 2:
                self.patch_size_2D = p[:2]
                self.pre_crop_size_2D = [s + 12 for s in p[:2]]
            else:
                self.patch_size_3D = p[:3]
                self.pre_crop_size_3D = [p[0] + 28, p[1] + 28, p[2] + 16]
        self.patch_size = self.patch_size_2D if self.dim == 2 else self.patch_size_3D
        self.pre_crop_size = self.pre_crop_size_2D if self.dim == 2 else self.pre_crop_size_3D

        self.batch_sample_slack = 0.2
        self.merge_2D_to_3D_preds = self.dim == 2
        self.n_3D_context = None
        if self.n_3D_context is not None and self.dim == 2:
            self.n_channels *= self.n_3D_context * 2 + 1

        #########################
        #      Architecture     #
        #########################
        self.start_filts = 48 if self.dim == 2 else 18
        self.end_filts = self.start_filts * 4 if self.dim == 2 else self.start_filts * 2
        self.res_architecture = "resnet50"
        self.norm = None
        self.weight_decay = 0
        self.weight_init = None

        #########################
        #  Schedule / Selection #
        #########################
        # reference schedule; MDT_LIDC_* envs override for scripted runs
        # (synthetic convergence demos, dev smoke) without touching configs
        self.num_epochs = int(os.environ.get("MDT_LIDC_EPOCHS", 100))
        self.num_train_batches = int(os.environ.get("MDT_LIDC_NTB", 200))
        self.batch_size = int(os.environ.get("MDT_LIDC_BS", 20 if self.dim == 2 else 8))
        # conv-stack compute dtype: float32 by default, as the reference
        # trains; bfloat16 per run
        self.compute_dtype = os.environ.get("MDT_LIDC_DTYPE", "float32")

        self.do_validation = True
        self.val_mode = "val_sampling"
        if self.val_mode == "val_patient":
            self.max_val_patients = 50
        if self.val_mode == "val_sampling":
            self.num_val_batches = int(os.environ.get("MDT_LIDC_NVB", 50))

        #########################
        #   Testing / Plotting  #
        #########################
        self.save_n_models = 5
        self.test_n_epochs = 5
        self.min_save_thresh = 0
        self.report_score_level = ["patient", "rois"]
        self.class_dict = {1: "benign", 2: "malignant"}
        self.patient_class_of_interest = 2
        self.ap_match_ious = [0.1]
        self.model_selection_criteria = ["malignant_ap", "benign_ap"]
        self.min_det_thresh = 0.1
        self.wcs_iou = 1e-5
        self.plot_prediction_histograms = True
        self.plot_stat_curves = False

        #########################
        #   Data Augmentation   #
        #########################
        self.da_kwargs = {
            "do_elastic_deform": True,
            "alpha": (0.0, 1500.0),
            "sigma": (30.0, 50.0),
            "do_rotation": True,
            "angle_x": (0.0, 2 * np.pi),
            "angle_y": (0.0, 0),
            "angle_z": (0.0, 0),
            "do_scale": True,
            "scale": (0.8, 1.1),
            "random_crop": False,
            "rand_crop_dist": (self.patch_size[0] / 2.0 - 3, self.patch_size[1] / 2.0 - 3),
            "border_mode_data": "constant",
            "border_cval_data": 0,
            "order_data": 1,
        }
        if self.dim == 3:
            self.da_kwargs["do_elastic_deform"] = False
            self.da_kwargs["angle_x"] = (0, 0.0)
            self.da_kwargs["angle_y"] = (0, 0.0)  # must be 0: anisotropic z
            self.da_kwargs["angle_z"] = (0.0, 2 * np.pi)

        #########################
        #   Add model specifics #
        #########################
        {
            "detection_unet": self.add_det_unet_configs,
            "mrcnn": self.add_mrcnn_configs,
            "ufrcnn": self.add_mrcnn_configs,
            "retina_net": self.add_mrcnn_configs,
            "retina_unet": self.add_mrcnn_configs,
        }[self.model]()

    def add_det_unet_configs(self):
        self.learning_rate = [1e-4] * self.num_epochs
        self.aggregation_operation = "max"
        self.n_roi_candidates = 10 if self.dim == 2 else 30
        self.seg_loss_mode = "dice_wce"
        self.fp_dice_weight = 1
        self.wce_weights = [1, 1, 1]
        self.detection_min_confidence = self.min_det_thresh
        self.class_specific_seg_flag = True
        self.num_seg_classes = 3 if self.class_specific_seg_flag else 2
        self.head_classes = self.num_seg_classes
        self.operate_stride1 = True

    def add_mrcnn_configs(self):
        self.learning_rate = [1e-4] * self.num_epochs
        self.return_masks_in_val = True
        self.return_masks_in_test = False
        self.n_plot_rpn_props = 5 if self.dim == 2 else 30
        self.head_classes = 3
        self.num_seg_classes = 2

        self.backbone_strides = {"xy": [4, 8, 16, 32], "z": [1, 2, 4, 8]}
        self.rpn_anchor_scales = {"xy": [[8], [16], [32], [64]], "z": [[2], [4], [8], [16]]}
        self.pyramid_levels = [0, 1, 2, 3]
        self.n_rpn_features = 512 if self.dim == 2 else 128
        self.rpn_anchor_ratios = [0.5, 1, 2]
        self.rpn_anchor_stride = 1
        self.n_anchors_per_pos = len(self.rpn_anchor_ratios)
        self.rpn_nms_threshold = 0.7

        self.rpn_train_anchors_per_image = 6
        self.train_rois_per_image = 6
        self.roi_positive_ratio = 0.5
        self.anchor_matching_iou = 0.7
        self.shem_poolsize = 10

        self.pool_size = (7, 7) if self.dim == 2 else (7, 7, 3)
        self.mask_pool_size = (14, 14) if self.dim == 2 else (14, 14, 5)
        self.mask_shape = (28, 28) if self.dim == 2 else (28, 28, 10)

        self.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        self.bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        self.window = np.array([0, 0, self.patch_size[0], self.patch_size[1], 0, self.patch_size_3D[2]])
        self.scale = np.array(
            [self.patch_size[0], self.patch_size[1], self.patch_size[0], self.patch_size[1],
             self.patch_size_3D[2], self.patch_size_3D[2]]
        )
        if self.dim == 2:
            self.rpn_bbox_std_dev = self.rpn_bbox_std_dev[:4]
            self.bbox_std_dev = self.bbox_std_dev[:4]
            self.window = self.window[:4]
            self.scale = self.scale[:4]

        self.pre_nms_limit = 3000 if self.dim == 2 else 6000
        self.roi_chunk_size = 2500 if self.dim == 2 else 600
        self.post_nms_rois_training = 500 if self.dim == 2 else 75
        self.post_nms_rois_inference = 500

        self.model_max_instances_per_batch_element = 10 if self.dim == 2 else 30
        self.detection_nms_threshold = 1e-5
        self.model_min_confidence = 0.1

        if self.dim == 2:
            self.backbone_shapes = np.array(
                [[int(np.ceil(self.patch_size[0] / stride)), int(np.ceil(self.patch_size[1] / stride))]
                 for stride in self.backbone_strides["xy"]]
            )
        else:
            self.backbone_shapes = np.array(
                [
                    [int(np.ceil(self.patch_size[0] / stride)), int(np.ceil(self.patch_size[1] / stride)),
                     int(np.ceil(self.patch_size[2] / stride_z))]
                    for stride, stride_z in zip(self.backbone_strides["xy"], self.backbone_strides["z"])
                ]
            )

        if self.model == "ufrcnn":
            self.operate_stride1 = True
            self.class_specific_seg_flag = True
            self.num_seg_classes = 3 if self.class_specific_seg_flag else 2
            self.frcnn_mode = True

        if self.model in ("retina_net", "retina_unet"):
            self.rpn_anchor_scales["xy"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["xy"]
            ]
            self.rpn_anchor_scales["z"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["z"]
            ]
            self.n_anchors_per_pos = len(self.rpn_anchor_ratios) * 3
            self.n_rpn_features = 256 if self.dim == 2 else 64
            self.pre_nms_limit = 10000 if self.dim == 2 else 50000
            self.anchor_matching_iou = 0.5
            self.num_seg_classes = 3 if self.class_specific_seg_flag else 2
            if self.model == "retina_unet":
                self.operate_stride1 = True
