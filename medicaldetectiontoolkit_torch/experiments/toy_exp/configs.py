"""Toy experiment configuration (2D synthetic donuts / circles) of the port.

Counterpart of ``experiments/toy_exp/configs.py``: the same attributes and
values, the same environment overrides (``MDT_TOY_ROOT``, ``MDT_MODEL``,
``MDT_TOY_NTRAINVAL``, ``MDT_TOY_MODE``, ``MDT_TOY_PATCH``,
``MDT_TOY_EPOCHS``, ``MDT_TOY_NTB``, ``MDT_TOY_BS``, ``MDT_TOY_VAL_MODE``,
``MDT_TOY_MAXVAL``, ``MDT_TOY_SAVE_N``, ``MDT_TOY_TEST_N``,
``MDT_TOY_MAXTEST``) and the same per-model extras, on the port's
``DefaultConfigs``. Run it as ``--exp_source
medicaldetectiontoolkit_torch/experiments/toy_exp``; its data come from
``generate_toys.py`` beside it (or the JAX package's generator).
"""

import os

import numpy as np

from medicaldetectiontoolkit_torch.config import DefaultConfigs


class configs(DefaultConfigs):
    def __init__(self, server_env=None):
        #########################
        #    Preprocessing      #
        #########################
        self.root_dir = os.environ.get("MDT_TOY_ROOT", "/tmp/toy_mdt")

        #########################
        #         I/O           #
        #########################
        self.dim = 2
        self.model = os.environ.get("MDT_MODEL", "retina_net")

        DefaultConfigs.__init__(self, self.model, server_env, self.dim)

        self.select_prototype_subset = None
        self.hold_out_test_set = True
        # including val set. will be 3/4 train, 1/4 val.
        self.n_train_val_data = int(os.environ.get("MDT_TOY_NTRAINVAL", 1500))

        # one of ['donuts_shape', 'donuts_pattern', 'circles_scale']
        toy_mode = os.environ.get("MDT_TOY_MODE", "donuts_shape")

        self.input_df_name = "info_df.pickle"
        self.pp_name = os.path.join(toy_mode, "train")
        self.pp_data_path = os.path.join(self.root_dir, self.pp_name)
        self.pp_test_name = os.path.join(toy_mode, "test")
        self.pp_test_data_path = os.path.join(self.root_dir, self.pp_test_name)

        #########################
        #      Data Loader      #
        #########################
        self.channels = [0]
        self.n_channels = len(self.channels)
        self.pre_crop_size_2D = [320, 320]
        # patch override for cheap CPU smoke runs (training crops patches out
        # of the fixed 320x320 toy images; the reference schedule keeps 320)
        self.patch_size_2D = [
            int(v) for v in os.environ.get("MDT_TOY_PATCH", "320,320").split(",")
        ]
        self.patch_size = self.patch_size_2D
        self.pre_crop_size = self.pre_crop_size_2D
        self.batch_sample_slack = 0.2
        self.merge_2D_to_3D_preds = False
        self.n_3D_context = None

        #########################
        #      Architecture     #
        #########################
        self.start_filts = 48
        self.end_filts = self.start_filts * 4
        self.res_architecture = "resnet50"
        self.norm = None
        self.weight_decay = 0
        self.weight_init = None

        #########################
        #  Schedule / Selection #
        #########################
        self.num_epochs = int(os.environ.get("MDT_TOY_EPOCHS", 24))
        self.num_train_batches = int(os.environ.get("MDT_TOY_NTB", 100))
        self.batch_size = int(os.environ.get("MDT_TOY_BS", 20))

        self.do_validation = True
        self.val_mode = os.environ.get("MDT_TOY_VAL_MODE", "val_patient")  # | 'val_sampling'
        if self.val_mode == "val_patient":
            _mv = os.environ.get("MDT_TOY_MAXVAL")
            self.max_val_patients = int(_mv) if _mv else None
        if self.val_mode == "val_sampling":
            self.num_val_batches = 50

        #########################
        #   Testing / Plotting  #
        #########################
        self.save_n_models = int(os.environ.get("MDT_TOY_SAVE_N", 5))
        self.test_n_epochs = int(os.environ.get("MDT_TOY_TEST_N", 5))
        self.max_test_patients = (
            int(os.environ["MDT_TOY_MAXTEST"]) if os.environ.get("MDT_TOY_MAXTEST") else "all"
        )
        self.min_save_thresh = 0
        self.report_score_level = ["patient", "rois"]
        self.class_dict = {1: "benign", 2: "malignant"}
        self.patient_class_of_interest = 2
        self.ap_match_ious = [0.1]
        self.model_selection_criteria = ["benign_ap", "malignant_ap"]
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
        self.n_roi_candidates = 3
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
        self.frcnn_mode = False
        self.return_masks_in_val = True
        self.return_masks_in_test = False
        self.n_plot_rpn_props = 5
        self.head_classes = 3
        self.num_seg_classes = 2  # RPN-level fg/bg

        self.backbone_strides = {"xy": [4, 8, 16, 32], "z": [1, 2, 4, 8]}
        self.rpn_anchor_scales = {"xy": [[8], [16], [32], [64]], "z": [[2], [4], [8], [16]]}
        self.pyramid_levels = [0, 1, 2, 3]
        self.n_rpn_features = 512
        self.rpn_anchor_ratios = [0.5, 1, 2]
        self.rpn_anchor_stride = 1
        self.n_anchors_per_pos = len(self.rpn_anchor_ratios)
        self.rpn_nms_threshold = 0.7
        self.rpn_train_anchors_per_image = 2
        self.train_rois_per_image = 2
        self.roi_positive_ratio = 0.5
        self.anchor_matching_iou = 0.7
        self.shem_poolsize = 10

        self.pool_size = (7, 7)
        self.mask_pool_size = (14, 14)
        self.mask_shape = (28, 28)

        self.rpn_bbox_std_dev = np.array([0.1, 0.1, 0.2, 0.2])
        self.bbox_std_dev = np.array([0.1, 0.1, 0.2, 0.2])
        self.window = np.array([0, 0, self.patch_size[0], self.patch_size[1]])
        self.scale = np.array([self.patch_size[0], self.patch_size[1], self.patch_size[0], self.patch_size[1]])

        self.pre_nms_limit = 3000
        self.roi_chunk_size = 800
        self.post_nms_rois_training = 500
        self.post_nms_rois_inference = 500

        self.model_max_instances_per_batch_element = 10
        self.detection_nms_threshold = 1e-5
        self.model_min_confidence = 0.1

        self.backbone_shapes = np.array(
            [
                [int(np.ceil(self.patch_size[0] / stride)), int(np.ceil(self.patch_size[1] / stride))]
                for stride in self.backbone_strides["xy"]
            ]
        )

        if self.model == "ufrcnn":
            self.operate_stride1 = True
            self.class_specific_seg_flag = True
            self.num_seg_classes = 3 if self.class_specific_seg_flag else 2
            self.frcnn_mode = True

        if self.model in ("retina_net", "retina_unet"):
            # extra anchor scales per the RetinaNet publication
            self.rpn_anchor_scales["xy"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["xy"]
            ]
            self.rpn_anchor_scales["z"] = [
                [ii[0], ii[0] * (2 ** (1 / 3)), ii[0] * (2 ** (2 / 3))] for ii in self.rpn_anchor_scales["z"]
            ]
            self.n_anchors_per_pos = len(self.rpn_anchor_ratios) * 3
            self.n_rpn_features = 256
            self.pre_nms_limit = 10000
            self.anchor_matching_iou = 0.5
            self.num_seg_classes = 3 if self.class_specific_seg_flag else 2
            if self.model == "retina_unet":
                self.operate_stride1 = True
