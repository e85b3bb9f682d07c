#!/usr/bin/env python
"""Execution script of the port: test / analysis / create_exp.

Counterpart of the root ``exec.py``, with the same CLI (--mode, --folds,
--exp_dir, --exp_source, --server_env, --data_dest, --use_stored_settings,
--dev):

    python -m medicaldetectiontoolkit_torch.exec --mode test \\
        --exp_source medicaldetectiontoolkit_torch/experiments/lidc_exp --exp_dir EXP [--folds 0]

``test`` runs whole-patient inference of each fold (tiling, mirror TTA,
temporal ensembling over the fold's ranked checkpoints, WBC, 2D->3D merging)
on the CUDA card and scores it (``results.txt``); ``analysis`` re-scores the
raw prediction pickles; ``create_exp`` prepares an experiment directory. The
checkpoints may be the JAX package's (``{epoch}_best_checkpoint/params.pkl``,
loaded as they are). ``train`` and ``train_test`` are not ported yet
(ROADMAP.md, Queue 1). From Python, ``main(argv, device="cpu")`` runs on the
CPU with the plain PyTorch versions of the kernels.
"""

from __future__ import annotations

import argparse
import os
import tempfile
import time

import medicaldetectiontoolkit_torch.utils.exp_utils as utils
from medicaldetectiontoolkit_torch.evaluator import Evaluator
from medicaldetectiontoolkit_torch.models import build_model
from medicaldetectiontoolkit_torch.predictor import Predictor


def test(cf, data_loader, logger, device=None):
    """Testing for one fold (or the hold-out set): predict, consolidate,
    score. Returns {"results": consolidated results per patient,
    "predictor", "evaluator", "evaluation_s": host seconds of the scoring};
    the predictor's ``times`` hold the other stages."""
    logger.info(f"starting testing model of fold {cf.fold} in exp {cf.exp_dir}")
    net = build_model(cf, logger, device=device)
    net.initialize()
    test_predictor = Predictor(cf, net, logger, mode="test")
    test_evaluator = Evaluator(cf, logger, mode="test")
    batch_gen = data_loader.get_test_generator(cf, logger)
    test_results_list = test_predictor.predict_test_set(batch_gen, return_results=True)
    t0 = time.perf_counter()
    test_evaluator.evaluate_predictions(test_results_list)
    test_evaluator.score_test_df()
    return {"results": test_results_list, "predictor": test_predictor, "evaluator": test_evaluator,
            "evaluation_s": time.perf_counter() - t0}


def _close(logger):
    for hdlr in logger.handlers:
        hdlr.close()
    logger.handlers = []


def parse_args(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-m", "--mode", type=str, default="train_test",
                        help="pipeline stage to run: train | test | train_test | analysis | create_exp")
    parser.add_argument("-f", "--folds", nargs="+", type=int, default=None,
                        help="cross-validation folds to process (default: every fold)")
    parser.add_argument("--exp_dir", type=str, default=os.path.join(tempfile.gettempdir(), "mdt_torch_exp"),
                        help="experiment output directory (created on demand)")
    parser.add_argument("--server_env", default=False, action="store_true",
                        help="switch IO paths to the cluster layout from the experiment config")
    parser.add_argument("--data_dest", type=str, default=None,
                        help="override the config's preprocessed-data location")
    parser.add_argument("--use_stored_settings", default=False, action="store_true",
                        help="run with the config snapshot already in exp_dir rather than the source tree")
    parser.add_argument("--exp_source", type=str, default="medicaldetectiontoolkit_torch/experiments/lidc_exp",
                        help="experiment package providing configs.py and data_loader.py")
    parser.add_argument("-d", "--dev", default=False, action="store_true",
                        help="tiny-scale smoke mode: few batches, few epochs, one patient")
    return parser.parse_args(argv)


def main(argv=None, device=None):
    """Run the CLI on ``argv``; ``device`` None is the CUDA card. Returns
    ``{fold: test()'s result}`` in test mode."""
    args = parse_args(argv)
    folds = args.folds
    out = {}

    if args.mode in ("train", "train_test"):
        raise NotImplementedError(f"--mode {args.mode}: training is not ported yet (ROADMAP.md, Queue 1)")

    if args.mode == "test":
        cf = utils.prep_exp(args.exp_source, args.exp_dir, args.server_env, is_training=False, use_stored_settings=True)
        if args.dev:
            folds = [0, 1]
            cf.test_n_epochs = 1
            cf.max_test_patients = 1
        cf.data_dest = args.data_dest
        data_loader = utils.import_module("dl", os.path.join(args.exp_source, "data_loader.py"))
        if folds is None:
            folds = range(cf.n_cv_splits)
        for fold in folds:
            cf.fold_dir = os.path.join(cf.exp_dir, f"fold_{fold}")
            cf.fold = fold
            logger = utils.get_logger(cf.fold_dir)
            out[fold] = test(cf, data_loader, logger, device=device)
            _close(logger)

    elif args.mode == "analysis":
        cf = utils.prep_exp(args.exp_source, args.exp_dir, args.server_env, is_training=False, use_stored_settings=True)
        logger = utils.get_logger(cf.exp_dir)
        if cf.hold_out_test_set:
            cf.folds = args.folds
            predictor = Predictor(cf, net=None, logger=logger, mode="analysis")
            results_list = predictor.load_saved_predictions(apply_wbc=True)
            utils.create_csv_output(results_list, cf, logger)
        else:
            if folds is None:
                folds = range(cf.n_cv_splits)
            for fold in folds:
                cf.fold_dir = os.path.join(cf.exp_dir, f"fold_{fold}")
                cf.fold = fold
                predictor = Predictor(cf, net=None, logger=logger, mode="analysis")
                results_list = predictor.load_saved_predictions(apply_wbc=True)
                logger.info("starting evaluation...")
                evaluator = Evaluator(cf, logger, mode="test")
                evaluator.evaluate_predictions(results_list)
                evaluator.score_test_df()
        _close(logger)

    elif args.mode == "create_exp":
        cf = utils.prep_exp(args.exp_source, args.exp_dir, args.server_env, use_stored_settings=True)
        logger = utils.get_logger(cf.exp_dir)
        logger.info(f"created experiment directory at {args.exp_dir}")
        _close(logger)

    else:
        raise RuntimeError(f"unknown --mode {args.mode!r}; see --help for the supported stages")
    return out


if __name__ == "__main__":
    main()
