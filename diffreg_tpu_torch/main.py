"""CLI: test or train with reference-schema configs, on one CUDA card.

    python -m diffreg_tpu_torch.main --config configs/test/3dmatch.yaml
    python -m diffreg_tpu_torch.main --config configs/test/4dmatch.yaml --thr 0.55
    python -m diffreg_tpu_torch.main --config configs/test/3dmatch.yaml --demo
    python -m diffreg_tpu_torch.main --config configs/train/4dmatch.yaml --mode train --demo
    python -m diffreg_tpu_torch.main --config ... --device cpu     # the plain CPU path

Counterpart of the JAX package's main.py (the reference entry point,
Diff-Reg-3dmatch/main.py): YAML with ``!join`` tags -> typed configs -> model,
loaders and engine. 3DMatch and 4DMatch, test (``ThreeDMatchTester``,
``FourDMatchTester``) and train (``Trainer``). ``--demo``, or a missing
``data_root``, runs on synthetic pairs. A metric run on real data refuses
random weights. One process on one device: there is no mesh (data parallel
is in ROADMAP §1), and the 2D-3D tasks are not ported (ROADMAP §1). Runs
write under ``snapshot/<exp_dir>`` in the working directory.
"""
from __future__ import annotations

import argparse
import os


def build_argparser():
    p = argparse.ArgumentParser("diffreg_tpu_torch")
    p.add_argument("--config", required=True)
    p.add_argument("--thr", type=float, default=None,
                   help="match threshold of the 4DMatch extraction (default 0.55)")
    p.add_argument("--mode", default=None, choices=[None, "train", "test"])
    p.add_argument("--demo", action="store_true",
                   help="run on synthetic pairs (no dataset needed)")
    p.add_argument("--batch-size", type=int, default=None)
    p.add_argument("--num-pairs", type=int, default=16, help="demo pairs per epoch")
    p.add_argument("--resume", action="store_true")
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _dataset(name, split, data_root, raw, train):
    from .data.datasets import FourDMatchPairDataset, ThreeDMatchPairDataset

    if name == "4dmatch":
        return FourDMatchPairDataset(split, augment=train)
    return ThreeDMatchPairDataset(split, data_root, augment=train,
                                  augment_noise=float(raw.get("augment_noise", 0.005)))


def data_spec(ds, raw, pipeline_cfg):
    """(ShapeSpec, PyramidConfig) of a dataset under a config: the config's
    pyramid, calibrated from ``calibration_pairs`` pairs spread across the
    dataset (the first few tend to share a scene) at the reference's 90th
    neighbour percentile."""
    import numpy as np

    from .data.calibrate import calibrate_spec
    from .data.pyramid import PyramidConfig

    kp = raw.get("kpfcn_config", {})
    pyr_cfg = PyramidConfig(first_subsampling_dl=pipeline_cfg.kpfcn.first_subsampling_dl,
                            conv_radius=pipeline_cfg.kpfcn.conv_radius,
                            coarse_match_radius=float(kp.get("coarse_match_radius", 0.06)))
    n_calib = min(int(raw.get("calibration_pairs", 24)), len(ds))
    calib = [ds[int(i)] for i in np.linspace(0, len(ds) - 1, n_calib).astype(int)]
    spec = calibrate_spec([(c["src_pcd"], c["tgt_pcd"]) for c in calib], pyr_cfg,
                          neighbor_percentile=float(raw.get("neighbor_percentile", 90.0)))
    return spec, pyr_cfg


def _restore_weights(model, pretrain, optim_cfg, logger) -> bool:
    """Load the latest checkpoint of the directory ``pretrain`` into ``model``."""
    from .engine.checkpoint import CheckpointManager
    from .engine.train import create_train_state

    if CheckpointManager(pretrain).restore(create_train_state(model, optim_cfg)) is None:
        logger.warning(f"pretrain={pretrain!r} holds no checkpoint: the metric run uses "
                       "RANDOM weights and its numbers mean nothing")
        return False
    logger.info(f"restored weights from {pretrain}")
    return True


def main(argv=None):
    """Run the CLI; returns the test summary, or the last epoch's metrics of a
    training run (with ``steps``)."""
    args = build_argparser().parse_args(argv)

    import torch

    from .data.synthetic import synthetic_batch
    from .engine.tester import (FourDMatchTester, TestConfig, ThreeDMatchTester,
                                make_metric_points_fn)
    from .engine.train import create_train_state, make_eval_step, make_train_step
    from .engine.trainer import Trainer, TrainerConfig
    from .models.diffusion_matching import DiffusionMatchingModel
    from .utils.config import (build_loss_config, build_optim_config, build_pipeline_config,
                               load_yaml)
    from .utils.device import resolve_device
    from .utils.logging import Logger

    raw = load_yaml(args.config)
    mode = args.mode or raw.get("mode", "test")
    batch_size = args.batch_size or int(raw.get("batch_size", 1))
    dataset_name = str(raw.get("dataset", "3dmatch"))
    if dataset_name in ("rgbdv2", "7scenes"):
        raise NotImplementedError(f"dataset {dataset_name!r}: the 2D-3D tasks are not ported "
                                  "(ROADMAP §1: 2D-3D)")
    ev = raw.get("eval", {})
    if raw.get("parity_eval") or ev.get("pose_backend", "device") != "device":
        # the JAX package's metric-audit mode runs the host pose estimators
        raise NotImplementedError(
            "parity_eval / eval.pose_backend: the host pose estimators "
            "(eval/host_estimators.py) belong to the library surface, not ported yet "
            "(ROADMAP §1); the port estimates poses on the device")
    device = resolve_device(args.device)
    pipeline_cfg = build_pipeline_config(raw)
    loss_cfg = build_loss_config(raw)
    seed = int(raw.get("seed", 0))

    save_dir = os.path.join("snapshot", raw.get("exp_dir", "run"))
    logger = Logger(save_dir)
    logger.info(f"device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    logger.info(f"task={dataset_name} mode={mode} steps={pipeline_cfg.sample_steps}")
    model = DiffusionMatchingModel(pipeline_cfg, device=device, seed=seed)

    data_root = raw.get("data_root", "")
    demo = args.demo or not (data_root and os.path.exists(data_root))
    loader_stats = {}
    if demo:
        logger.info("demo mode: synthetic pairs")

        def make_iter(epoch=0):
            for i in range(max(1, args.num_pairs // batch_size)):
                batch, _, _ = synthetic_batch(batch_size=batch_size, n_points=768,
                                              seed=1000 * epoch + i,
                                              deformable=dataset_name == "4dmatch")
                yield batch, [{}] * batch_size

        n_pairs = args.num_pairs
    else:
        from .data.datasets import iterate_batches

        ds = _dataset(dataset_name, raw["split"]["test" if mode == "test" else "train"],
                      data_root, raw, mode == "train")
        spec, pyr_cfg = data_spec(ds, raw, pipeline_cfg)
        logger.info(f"calibrated spec: {spec}")
        num_workers = int(raw.get("num_workers", 8))

        def make_iter(epoch=0, dataset=ds, shuffle=mode == "train"):
            return iterate_batches(dataset, spec, pyr_cfg, batch_size, shuffle=shuffle,
                                   seed=epoch, num_workers=num_workers, stats=loader_stats)

        n_pairs = len(ds)
    # ExpLR decays per epoch: the schedule needs the epoch's length
    optim_cfg = build_optim_config(raw, steps_per_epoch=max(1, n_pairs // batch_size))

    if mode == "train":
        from .utils.snapshot import backup_sources

        backup_sources(save_dir, args.config)
        make_val_iter = val_step = None
        val_split = None if demo else raw.get("split", {}).get("val")
        if val_split and os.path.exists(val_split):
            val_ds = _dataset(dataset_name, val_split, data_root, raw, False)
            make_val_iter = lambda epoch: make_iter(0, dataset=val_ds, shuffle=False)
            val_step = make_eval_step(loss_cfg)
        trainer = Trainer(make_train_step(loss_cfg), create_train_state(model, optim_cfg),
                          make_iter, TrainerConfig(max_epoch=int(raw.get("max_epoch", 10)),
                                                   save_dir=save_dir),
                          make_val_iter=make_val_iter, val_step=val_step, logger=logger,
                          device=device, seed=seed)
        if args.resume:
            trainer.resume()
        state = trainer.train()
        result = {**trainer.metrics, "steps": state.step}
    else:
        pretrain = raw.get("pretrain", "")
        if pretrain and os.path.exists(pretrain):
            _restore_weights(model, pretrain, optim_cfg, logger)
        elif not demo:
            raise SystemExit(
                f"refusing a metric run on real data with random weights: pretrain={pretrain!r} "
                "not found. Pass a valid 'pretrain' in the config, or use --demo for a "
                "synthetic smoke run.")
        # the JAX package's device-RANSAC budget; eval.ransac_hypotheses overrides
        ransac_h = int(ev.get("ransac_hypotheses", 65536))
        generator = torch.Generator(device).manual_seed(seed)
        if dataset_name == "4dmatch":
            cfg = TestConfig(inlier_thr=0.04, match_thr=args.thr if args.thr is not None else 0.55,
                             ransac_hypotheses=ransac_h)
            result = FourDMatchTester(model, cfg, logger, device=device).test(
                make_iter, generator=generator, metric_points_fn=make_metric_points_fn())
        else:
            cfg = TestConfig(ransac_hypotheses=ransac_h)
            result = ThreeDMatchTester(model, cfg, logger, device=device).test(
                make_iter, generator=generator)
    if loader_stats.get("pairs_dropped"):
        logger.warning(f"{loader_stats['pairs_dropped']} pairs overflowed every bucket and were "
                       f"dropped ({loader_stats['pairs_used']} used): recalibrate with more "
                       "calibration_pairs or a larger headroom")
    logger.close()
    return result


if __name__ == "__main__":
    main()
