"""PET/CT TNM-classification experiment configuration (two-modality 3D) of the port.

Counterpart of ``experiments/pet_ct_tnm_classification/configs.py``: the same
attributes and values (CT and PET as two input channels, 3D patches
192x192x32 from a 280x280x48 pre-crop, one foreground class, a hold-out test
set with fold ensembling, no validation: model selection reads the train
metrics), the same environment overrides (``MDT_PETCT_ROOT``,
``MDT_PETCT_PP``, ``MDT_PETCT_PATCH``, ``MDT_PETCT_EPOCHS``,
``MDT_PETCT_NTB``, ``MDT_PETCT_BS``, ``MDT_MODEL``) and the same per-model
extras, on the port's ``DefaultConfigs``. Run it as ``--exp_source
medicaldetectiontoolkit_torch/experiments/pet_ct_tnm_classification``; its
data come from ``preprocessing.py::generate_synthetic_petct`` beside it.
"""

import os

import numpy as np

from medicaldetectiontoolkit_torch.config import DefaultConfigs


class configs(DefaultConfigs):
    def __init__(self, server_env=None):
        #########################
        #    Preprocessing      #
        #########################
        self.root_dir = os.environ.get("MDT_PETCT_ROOT", "/tmp/pet_ct")
        self.raw_data_dir = f"{self.root_dir}/LungStageData"
        self.pp_dir = f"{self.root_dir}/pp_norm"
        self.target_spacing = (1.5, 1.5, 3.0)

        #########################
        #         I/O           #
        #########################
        self.dim = 3
        self.model = os.environ.get("MDT_MODEL", "retina_unet")

        DefaultConfigs.__init__(self, self.model, server_env, self.dim)

        self.select_prototype_subset = None
        self.hold_out_test_set = True
        self.ensemble_folds = True

        self.pp_name = "pp_norm"
        self.input_df_name = "info_df.pickle"
        self.pp_data_path = os.environ.get("MDT_PETCT_PP", os.path.join(self.root_dir, self.pp_name))
        self.pp_test_data_path = self.pp_data_path
        self.pp_test_out_path = self.pp_data_path

        #########################
        #      Data Loader      #
        #########################
        self.channels = [0, 1]  # CT + PET modalities
        self.n_channels = len(self.channels)

        self.pre_crop_size_3D = [280, 280, 48]
        self.patch_size_3D = [192, 192, 32]
        # scripted-run geometry shrink (CPU smoke / chip A-Bs), proportional
        # pre-crop slack — mirrors MDT_LIDC_PATCH
        if os.environ.get("MDT_PETCT_PATCH"):
            p = [int(v) for v in os.environ["MDT_PETCT_PATCH"].split(",")]
            self.patch_size_3D = p[:3]
            self.pre_crop_size_3D = [p[0] + 40, p[1] + 40, p[2] + 16]
        self.patch_size = self.patch_size_3D
        self.pre_crop_size = self.pre_crop_size_3D

        self.batch_sample_slack = 0.2
        self.merge_2D_to_3D_preds = False
        self.n_3D_context = None

        #########################
        #      Architecture     #
        #########################
        self.start_filts = 18
        self.end_filts = self.start_filts * 2
        self.res_architecture = "resnet50"
        self.norm = None
        self.weight_decay = 0
        self.weight_init = None

        #########################
        #  Schedule / Selection #
        #########################
        self.num_epochs = int(os.environ.get("MDT_PETCT_EPOCHS", 100))
        self.num_train_batches = int(os.environ.get("MDT_PETCT_NTB", 60))
        self.batch_size = int(os.environ.get("MDT_PETCT_BS", 8))

        self.do_validation = False
        self.val_mode = "val_sampling"
        if self.val_mode == "val_patient":
            self.max_val_patients = 50
        if self.val_mode == "val_sampling":
            self.num_val_batches = 10

        #########################
        #   Testing / Plotting  #
        #########################
        self.save_n_models = 5
        self.test_n_epochs = 5
        self.min_save_thresh = 0
        self.report_score_level = ["patient", "rois"]
        self.class_dict = {1: "foreground"}
        self.patient_class_of_interest = 1
        self.ap_match_ious = [0.1]
        self.model_selection_criteria = ["foreground_ap"]
        self.min_det_thresh = 0.1
        self.wcs_iou = 1e-5
        self.plot_prediction_histograms = True
        self.plot_stat_curves = False

        #########################
        #   Data Augmentation   #
        #########################
        self.da_kwargs = {
            "do_elastic_deform": False,
            "alpha": (0.0, 1500.0),
            "sigma": (30.0, 50.0),
            "do_rotation": True,
            "angle_x": (0, 0.0),
            "angle_y": (0, 0.0),  # must be 0: anisotropic z
            "angle_z": (0.0, 2 * np.pi),
            "do_scale": True,
            "scale": (0.8, 1.1),
            "random_crop": False,
            "rand_crop_dist": (self.patch_size[0] / 2.0 - 3, self.patch_size[1] / 2.0 - 3),
            "border_mode_data": "constant",
            "border_cval_data": 0,
            "order_data": 1,
        }

        {
            "detection_unet": self.add_det_unet_configs,
            "mrcnn": self.add_mrcnn_configs,
            "ufrcnn": self.add_mrcnn_configs,
            "retina_net": self.add_mrcnn_configs,
            "retina_unet": self.add_mrcnn_configs,
        }[self.model]()

    def add_det_unet_configs(self):
        quarter = self.num_epochs // 4
        self.learning_rate = [1e-4] * quarter + [5e-5] * quarter + [1e-5] * (self.num_epochs - 2 * quarter)
        self.aggregation_operation = "max"
        self.n_roi_candidates = 30
        self.seg_loss_mode = "dice_wce"
        self.fp_dice_weight = 1
        self.wce_weights = [1, 1]
        self.detection_min_confidence = self.min_det_thresh
        self.class_specific_seg_flag = True
        self.num_seg_classes = 2
        self.head_classes = self.num_seg_classes
        self.operate_stride1 = True

    def add_mrcnn_configs(self):
        half = self.num_epochs // 2
        quarter = self.num_epochs // 4
        self.learning_rate = [1e-4] * half + [5e-5] * quarter + [1e-5] * (self.num_epochs - half - quarter)
        self.return_masks_in_val = True
        self.return_masks_in_test = False
        self.n_plot_rpn_props = 30
        self.head_classes = 2  # foreground + background
        self.num_seg_classes = 2

        self.backbone_strides = {"xy": [4, 8, 16, 32], "z": [1, 2, 4, 8]}
        self.rpn_anchor_scales = {"xy": [[8], [16], [32], [64]], "z": [[2], [4], [8], [16]]}
        self.pyramid_levels = [0, 1, 2, 3]
        self.n_rpn_features = 128
        self.rpn_anchor_ratios = [0.5, 1, 2]
        self.rpn_anchor_stride = 1
        self.n_anchors_per_pos = len(self.rpn_anchor_ratios)
        self.rpn_nms_threshold = 0.7

        self.rpn_train_anchors_per_image = 6
        self.train_rois_per_image = 6
        self.roi_positive_ratio = 0.5
        self.anchor_matching_iou = 0.7
        self.shem_poolsize = 10

        self.pool_size = (7, 7, 3)
        self.mask_pool_size = (14, 14, 5)
        self.mask_shape = (28, 28, 10)

        self.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        self.bbox_std_dev = np.array([0.1, 0.1, 0.1, 0.2, 0.2, 0.2])
        self.window = np.array([0, 0, self.patch_size[0], self.patch_size[1], 0, self.patch_size_3D[2]])
        self.scale = np.array(
            [self.patch_size[0], self.patch_size[1], self.patch_size[0], self.patch_size[1],
             self.patch_size_3D[2], self.patch_size_3D[2]]
        )

        self.pre_nms_limit = 6000
        self.roi_chunk_size = 600
        self.post_nms_rois_training = 75
        self.post_nms_rois_inference = 500

        self.model_max_instances_per_batch_element = 30
        self.detection_nms_threshold = 1e-5
        self.model_min_confidence = 0.1

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
            self.num_seg_classes = 2
            self.frcnn_mode = True

        if self.model in ("retina_net", "retina_unet"):
            self.rpn_anchor_scales["xy"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["xy"]
            ]
            self.rpn_anchor_scales["z"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["z"]
            ]
            self.n_anchors_per_pos = len(self.rpn_anchor_ratios) * 3
            self.n_rpn_features = 64
            self.pre_nms_limit = 50000
            self.anchor_matching_iou = 0.5
            self.num_seg_classes = 2
            if self.model == "retina_unet":
                self.operate_stride1 = True
