"""CLI: test or train with reference-schema configs, on one CUDA card.

    python -m diffreg_tpu_torch.main --config configs/test/3dmatch.yaml
    python -m diffreg_tpu_torch.main --config configs/test/4dmatch.yaml --thr 0.55
    python -m diffreg_tpu_torch.main --config configs/test/3dmatch.yaml --demo
    python -m diffreg_tpu_torch.main --config configs/test/3dmatch_fast.yaml   # bf16 fast path
    python -m diffreg_tpu_torch.main --config configs/train/4dmatch.yaml --mode train --demo
    python -m diffreg_tpu_torch.main --config configs/test/rgbdv2.yaml --demo
    python -m diffreg_tpu_torch.main --config configs/test/rgbdv2_dino.yaml  # needs the towers
    python -m diffreg_tpu_torch.main --config configs/test/7scenes.yaml
    python -m diffreg_tpu_torch.main --config configs/train/rgbdv2.yaml --mode train
    python -m diffreg_tpu_torch.main --config ... --device cpu     # the plain CPU path

Counterpart of the JAX package's main.py (the reference entry point,
Diff-Reg-3dmatch/main.py): YAML with ``!join`` tags -> typed configs -> model,
loaders and engine. 3DMatch and 4DMatch, test (``ThreeDMatchTester``,
``FourDMatchTester``) and train (``Trainer``); 2D-3D (RGB-D Scenes V2,
7Scenes) test (``TwoDThreeDTester``, then ``eval_from_cache``) and train
(``engine.train2d3d`` with Adam, the ``Trainer``), with the frozen towers
(``use_dino`` / ``use_mono_depth``: torch state_dicts at the YAML's
``towers.dinov2`` / ``towers.depth_anything``, run once per pair). The host
estimators are not ported (ROADMAP §1): where the estimator's library is
missing, the device estimator runs, as in the JAX package. ``--demo``, or a
missing ``data_root``, runs on synthetic pairs, which carry no tower
outputs. A metric run on real data refuses random weights. One process on
one device: there is no mesh (data parallel is in ROADMAP §1). Runs write
under ``snapshot/<exp_dir>`` in the working directory.
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
    from .eval.host_estimators import resolve_backend
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
        return run_2d3d(args, raw, mode, batch_size, dataset_name)
    ev = raw.get("eval", {})
    device = resolve_device(args.device)
    pipeline_cfg = build_pipeline_config({**raw, "mode": mode})
    loss_cfg = build_loss_config(raw)
    seed = int(raw.get("seed", 0))

    save_dir = os.path.join("snapshot", raw.get("exp_dir", "run"))
    logger = Logger(save_dir)
    logger.info(f"device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    logger.info(f"task={dataset_name} mode={mode} steps={pipeline_cfg.sample_steps}")
    if mode != "train":
        # parity_eval (the metric-audit mode) asks for the host estimators
        resolve_backend(str(ev.get("pose_backend", "open3d" if raw.get("parity_eval")
                                   else "device")), logger)
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


def pipeline_2d3d_config(raw):
    """The ``Pipeline2D3DConfig`` of a 2D-3D YAML (its ``model_2d3d`` section)."""
    from .models.pipeline_2d3d import Pipeline2D3DConfig
    from .nn.matching import MatchingConfig
    from .nn.point_backbone import PointBackboneConfig

    if raw.get("precision") not in (None, "highest"):
        raise NotImplementedError(
            f"precision={raw['precision']!r} on a 2D-3D config: the port's 2D-3D path computes "
            "in float32 (the policy reaches the 3D matchers only)")
    m = raw.get("model_2d3d", {})
    return Pipeline2D3DConfig(
        img_out_dim=int(m.get("img_out_dim", 128)),
        img_base_dim=int(m.get("img_base_dim", 128)),
        pcd_backbone=PointBackboneConfig(output_dim=int(m.get("pcd_output_dim", 128)),
                                         init_dim=int(m.get("pcd_init_dim", 64))),
        hidden_dim=int(m.get("hidden_dim", 256)),
        output_dim=int(m.get("output_dim", 256)),
        num_heads=int(m.get("num_heads", 4)),
        matching=MatchingConfig(feature_dim=int(m.get("output_dim", 256))),
        coarse_stride=int(m.get("coarse_stride", 8)),
        pcd_num_points_in_patch=int(m.get("pcd_num_points_in_patch", 32)),
        pcd_min_node_size=int(m.get("pcd_min_node_size", 5)),
        sample_steps=int(raw.get("SAMPLE_STEP", 10)),
        use_dino=bool(m.get("use_dino", False)),
        use_mono_depth=bool(m.get("use_mono_depth", False)),
        dino_dim=int(m.get("dino_dim", 1024)),
        procrustes_max_condition=float(raw.get("procrustes", {}).get("max_condition_num", 200.0)))


def loss_2d3d_configs(raw):
    """(CircleLossConfig, FineLossConfig) of a 2D-3D YAML: ``loss.coarse_loss``,
    and of ``loss.fine_loss`` its radii and log scale (default 24)."""
    from .engine.losses2d3d import CircleLossConfig, FineLossConfig

    lc = raw.get("loss", {}).get("coarse_loss", {})
    fl = raw.get("loss", {}).get("fine_loss", {})
    circle = CircleLossConfig(**{f: float(lc.get(f, getattr(CircleLossConfig, f))) for f in (
        "positive_margin", "negative_margin", "positive_optimal", "negative_optimal",
        "log_scale", "positive_overlap", "negative_overlap")})
    fine = FineLossConfig(**{f: float(fl.get(f, getattr(FineLossConfig, f))) for f in (
        "positive_radius_3d", "negative_radius_3d", "positive_radius_2d",
        "negative_radius_2d")}, circle=CircleLossConfig(log_scale=float(fl.get("log_scale", 24.0))))
    return circle, fine


def run_2d3d(args, raw, mode, batch_size, dataset_name):
    """2D-3D (RGB-D Scenes V2 / 7Scenes): the model, demo or on-disk pairs
    (calibrated from the data; with ``use_dino`` / ``use_mono_depth`` each
    pair's tower outputs from ``models.towers.load_tower_runner``), then test
    (the weights, ``TwoDThreeDTester`` and, on real data or with
    ``eval.write_cache``, ``eval_from_cache``) or train (Adam at the YAML's
    ``lr``, the ``Trainer``)."""
    import numpy as np
    import torch

    from .engine.tester2d3d import Test2D3DConfig, TwoDThreeDTester, eval_from_cache
    from .eval.host_estimators import resolve_backend
    from .models.pipeline_2d3d import DiffReg2D3D
    from .utils.device import resolve_device
    from .utils.logging import Logger

    cfg = pipeline_2d3d_config(raw)
    m, ev = raw.get("model_2d3d", {}), raw.get("eval", {})
    device = resolve_device(args.device)
    seed = int(raw.get("seed", 0))
    train = mode == "train"
    save_dir = os.path.join("snapshot", raw.get("exp_dir", "run-2d3d"))
    logger = Logger(save_dir)
    logger.info(f"device {device}"
                + (f" ({torch.cuda.get_device_name(device)})" if device.type == "cuda" else ""))
    logger.info(f"2D-3D task={dataset_name} mode={mode} steps={cfg.sample_steps}")
    model = DiffReg2D3D(cfg, device=device, seed=seed)

    data_root = raw.get("data_root", "")
    demo = args.demo or not (data_root and os.path.exists(data_root))
    towers = None
    if not demo and (cfg.use_dino or cfg.use_mono_depth):
        towers = _tower_runner(cfg, raw.get("towers", {}), device)
    if not train:
        pretrain = raw.get("pretrain", "")
        if pretrain and os.path.exists(pretrain):
            from .engine.train import OptimConfig

            _restore_weights(model, pretrain, OptimConfig(), logger)
        elif not demo:
            raise SystemExit(f"refusing a metric run on real data with random weights: "
                             f"pretrain={pretrain!r} not found (use --demo for a smoke run)")

    if demo:
        from .data.synthetic2d3d import synthetic_2d3d_batch

        logger.info("demo mode: synthetic image <-> cloud pairs")

        def make_iter():
            for i in range(max(1, args.num_pairs // batch_size)):
                # training reads the overlap and fine GT of the full loss
                yield synthetic_2d3d_batch(batch_size=batch_size, img_hw=(64, 96),
                                           n_points=512, seed=i, with_full_gt=train), \
                    [{}] * batch_size
    else:
        from .data.calibrate import calibrate_spec_2d3d
        from .data.collate2d3d import batch_2d3d, build_2d3d_sample
        from .data.datasets2d3d import RGBDScenes2D3DPairDataset, SevenScenes2D3DPairDataset

        ds_cls = SevenScenes2D3DPairDataset if dataset_name == "7scenes" \
            else RGBDScenes2D3DPairDataset
        ds = ds_cls(data_root, "train" if train else "test", use_augmentation=train)
        n_calib = min(int(raw.get("calibration_pairs", 16)), len(ds))
        spec = calibrate_spec_2d3d(
            [ds[int(i)]["points"] for i in np.linspace(0, len(ds) - 1, n_calib).astype(int)],
            init_radius=float(m.get("init_radius", 0.0625)))
        logger.info(f"calibrated 2d3d spec from {n_calib} pairs: {spec}")

        def make_iter():
            buf, metas = [], []
            for i in range(len(ds)):
                raw_s = ds[i]
                # crop to a window the coarse stride divides
                st = cfg.coarse_stride
                h = raw_s["depth"].shape[0] // st * st
                w = raw_s["depth"].shape[1] // st * st
                for k in ("depth", "image", "image_gray"):
                    raw_s[k] = raw_s[k][:h, :w]
                try:
                    sample = build_2d3d_sample(raw_s, spec, st)
                except ValueError:
                    continue
                if towers is not None:
                    rgb = raw_s["image"][None]
                    if cfg.use_dino:
                        sample["dino_feats"] = towers.dino_tokens(rgb)[0]
                    if cfg.use_mono_depth:
                        sample["mono_depth"] = towers.mono_depth(rgb)[0]
                buf.append(sample)
                metas.append(raw_s["scene_name"])
                if len(buf) == batch_size:
                    yield batch_2d3d(buf), metas
                    buf, metas = [], []

        if train:
            # the JAX package reads one batch to initialise its model; the
            # reader's augmentation draws go on from there, so read it too
            next(make_iter())

    if train:
        return _train_2d3d(args, raw, model, make_iter, save_dir, logger, device, seed)

    # the JAX tester runs fine matching at its defaults, whatever the YAML says
    fine = {"fine_topk": 2, "fine_threshold": 0.75}
    if any(float(m.get(k, v)) != v for k, v in fine.items()):
        logger.warning(f"model_2d3d.fine_topk / fine_threshold: the tester matches at {fine} "
                       "(as the JAX package's does), not at the YAML's values")
    pnp_backend = resolve_backend(str(ev.get("pnp_backend", "opencv" if raw.get("parity_eval")
                                             else "device")), logger)
    test_cfg = Test2D3DConfig(
        acceptance_radius=float(ev.get("acceptance_radius", 0.05)),
        ir_threshold=float(ev.get("ir_threshold", 0.1)),
        rmse_threshold=float(ev.get("rmse_threshold", 0.1)),
        pnp_tolerance_px=float(ev.get("pnp_tolerance_px", 8.0)), pnp_backend=pnp_backend)
    tester = TwoDThreeDTester(model, test_cfg, logger, device=device)
    # the reference protocol is two-stage: the test writes the npz prediction
    # cache, the evaluation re-scores it. Real-data runs always cache; demo
    # runs when asked
    cache_dir = ev.get("cache_dir") or (
        None if demo and not ev.get("write_cache", False) else os.path.join(save_dir, "cache"))
    result = tester.test(make_iter, torch.Generator(device).manual_seed(seed),
                         cache_dir=cache_dir)
    if cache_dir is not None:
        result["eval"] = eval_from_cache(cache_dir, test_cfg, logger,
                                         num_corr=ev.get("num_correspondences"),
                                         generator=torch.Generator(device).manual_seed(seed),
                                         device=device)
    logger.close()
    return result


def _tower_runner(cfg, tw, device):
    """The frozen towers the config asks for, from the YAML's ``towers``
    section; exits with the JAX package's message when a path is missing."""
    from .models import towers

    dino_ckpt = tw.get("dinov2") if cfg.use_dino else None
    da_ckpt = tw.get("depth_anything") if cfg.use_mono_depth else None
    if (cfg.use_dino and not (dino_ckpt and os.path.exists(dino_ckpt))) \
            or (cfg.use_mono_depth and not (da_ckpt and os.path.exists(da_ckpt))):
        raise SystemExit("use_dino/use_mono_depth need converted tower checkpoints: "
                         f"towers={tw!r} (run tools/convert_towers.py)")
    return towers.load_tower_runner(dino_ckpt, da_ckpt, device=device)


def _train_2d3d(args, raw, model, make_iter, save_dir, logger, device, seed):
    """2D-3D training as the JAX package's main runs it: the losses of
    ``loss_2d3d_configs`` (the plain focal loss's defaults), Adam at the YAML's
    ``lr`` with the optimizer's other defaults (the JAX main reads neither
    ``weight_decay`` nor the epoch length), the same batches every epoch, the
    ``Trainer`` (``--resume``). Returns the last epoch's metrics and ``steps``."""
    from .engine.losses import LossConfig
    from .engine.train import OptimConfig
    from .engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
    from .engine.trainer import Trainer, TrainerConfig
    from .utils.snapshot import backup_sources

    backup_sources(save_dir, args.config)
    circle_cfg, fine_cfg = loss_2d3d_configs(raw)
    optim_cfg = OptimConfig(optimizer="adam", lr=float(raw.get("lr", 1e-4)))
    trainer = Trainer(make_train_step_2d3d(circle_cfg, LossConfig(), fine_cfg),
                      create_train_state_2d3d(model, optim_cfg), lambda epoch: make_iter(),
                      TrainerConfig(max_epoch=int(raw.get("max_epoch", 10)), save_dir=save_dir),
                      logger=logger, device=device, seed=seed)
    if args.resume:
        trainer.resume()
    state = trainer.train()
    logger.close()
    return {**trainer.metrics, "steps": state.step}


if __name__ == "__main__":
    main()
