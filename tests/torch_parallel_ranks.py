"""What each process of ``tests/test_torch_parallel.py``'s gloo group runs.

The processes are spawned by ``diffreg_tpu_torch.parallel.run_ranks``, which
imports this module in each of them: it imports the port only, never JAX.
``rank_main`` runs the jobs the payload names, in order, and returns their
results (numpy arrays and floats); the test compares them.

Jobs (B pairs a global batch, rows split over the processes):
  * ``jax3d``: the data-parallel 3DMatch step on given weights, batch seed and
    draws (JAX's), SGD at lr 2**10 without momentum or decay;
  * ``3dmatch``, ``4dmatch`` (the motion term on), ``2d3d``: the
    data-parallel step, and on one process the single-process step on the
    global batch, from the same weights and draws;
  * ``loss4d``: the 4DMatch loss with its motion term on given outputs,
    whose first shard alone would gate the motion term off;
  * ``eval``: the data-parallel DDIM (4DMatch, stochastic) against the
    single-process DDIM on the global batch;
  * ``lockstep``: a Trainer epoch over ``iterate_batches``' shards, where one
    process drops a pair too large for every bucket;
  * ``cli``: ``diffreg_tpu_torch.main --mode train --demo`` in every process.
"""
from __future__ import annotations

import dataclasses
import os
import sys

import numpy as np
import torch

B = 4
STEP_SEEDS = {"3dmatch": (3, 0, 2), "4dmatch": (5, 1, 0), "2d3d": (0, 9, 3)}  # data, weights, draws


def _np(t):
    return None if t is None else t.detach().cpu().numpy().copy()


def _capture_gradients():
    """Record the gradients ``apply_gradients`` is handed (after the
    all-reduce in the data-parallel step)."""
    from diffreg_tpu_torch.engine import train

    seen = []
    original = train.apply_gradients

    def recording(optimizer, grads):
        seen.append([_np(g) for g in grads])
        return original(optimizer, grads)

    train.apply_gradients = recording
    return seen, lambda: setattr(train, "apply_gradients", original)


def _run_step(step, state, batch, inputs):
    names = list(state.optimizer.names)
    seen, restore = _capture_gradients()
    try:
        state, info = step(state, batch, inputs)
    finally:
        restore()
    return {"info": {k: float(v) for k, v in info.items()},
            "grads": dict(zip(names, seen[0])),
            "params": {n: _np(p) for n, p in zip(names, state.optimizer.params)}}


def model_3d(variant: str, seed: int, gate=None):
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate

    cfg = preset_tiny(variant, 2)
    if gate is not None:
        cfg = with_condition_gate(cfg, gate)
    return DiffusionMatchingModel(cfg, device="cpu", seed=seed)


def data_3d(variant: str, seed: int, n_points: int = 96):
    from diffreg_tpu_torch.data.synthetic import synthetic_batch

    return synthetic_batch(batch_size=B, n_points=n_points, seed=seed,
                           deformable=variant == "4dmatch")[0]


def loss_cfg_3d(variant: str):
    from diffreg_tpu_torch.engine.losses import LossConfig

    # configs/train/4dmatch.yaml's motion term
    return LossConfig(motion_weight=0.1, dataset="4dmatch") if variant == "4dmatch" \
        else LossConfig()


def model_2d3d(seed: int):
    from diffreg_tpu_torch.models import pipeline_2d3d as pp
    from diffreg_tpu_torch.nn import point_backbone as ppb
    from diffreg_tpu_torch.nn.matching import MatchingConfig

    cfg = pp.Pipeline2D3DConfig(
        img_out_dim=32, img_base_dim=16,
        pcd_backbone=ppb.PointBackboneConfig(output_dim=32, init_dim=16, init_radius=0.1,
                                             init_sigma=0.08),
        hidden_dim=64, output_dim=64, num_heads=2, matching=MatchingConfig(feature_dim=64),
        sample_steps=2)
    return pp.DiffReg2D3D(cfg, device="cpu", seed=seed)


def data_2d3d(seed: int):
    from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch

    return synthetic_2d3d_batch(batch_size=B, img_hw=(32, 48), n_points=160, seed=seed,
                                with_full_gt=True)


def step_case(name: str):
    """(model, batch, draws, train state, single step, parallel step) of a
    step job, from ``STEP_SEEDS``."""
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.losses2d3d import CircleLossConfig, FineLossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
    from diffreg_tpu_torch.parallel.mesh import (make_parallel_train_step,
                                                 make_parallel_train_step_2d3d)

    data_seed, weight_seed, draw_seed = STEP_SEEDS[name]
    if name == "2d3d":
        model, batch = model_2d3d(weight_seed), data_2d3d(data_seed)
        cfgs = (CircleLossConfig(), LossConfig(), FineLossConfig())
        return (model, batch, model.draw_train_inputs(batch, torch.Generator().manual_seed(
            draw_seed)), lambda m: create_train_state_2d3d(m, OptimConfig("adam", lr=1e-4)),
            make_train_step_2d3d(*cfgs), make_parallel_train_step_2d3d(*cfgs))
    model, batch = model_3d(name, weight_seed), data_3d(name, data_seed)
    loss_cfg = loss_cfg_3d(name)
    return (model, batch, model.draw_train_inputs(batch, torch.Generator().manual_seed(
        draw_seed)), lambda m: create_train_state(m, OptimConfig()), make_train_step(loss_cfg),
        make_parallel_train_step(loss_cfg))


def shard(rank: int, world: int, batch, draws: dict, axes=None):
    from diffreg_tpu_torch.parallel.mesh import shard_rows

    rows = shard_rows(batch.batch_size, rank, world)
    axes = axes or {}
    return batch.select(rows), {k: v[(slice(None),) * axes.get(k, 0) + (rows,)]
                                for k, v in draws.items()}


def job_step(name: str, rank: int, world: int, payload: dict) -> dict:
    """The data-parallel step on this process's rows; the single-process step
    on the global batch on process ``payload['single_rank'][name]``."""
    model, batch, draws, make_state, single, parallel = step_case(name)
    sd = {k: v.clone() for k, v in model.state_dict().items()}
    local_batch, local_draws = shard(rank, world, batch, draws)
    out = {"parallel": _run_step(parallel, make_state(model), local_batch, local_draws)}
    if rank == payload["single_rank"][name]:
        model.load_state_dict(sd)
        out["single"] = _run_step(single, make_state(model), batch, draws)
        out["draws"] = {k: _np(v) for k, v in draws.items()}
    return out


def job_jax3d(rank: int, world: int, payload: dict) -> dict:
    """The data-parallel 3DMatch step on JAX's weights (the port's, converted
    there), batch and draws."""
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.parallel.mesh import make_parallel_train_step

    p = payload["jax3d"]
    model = model_3d("3dmatch", p["weight_seed"], gate=p["gate"])
    batch = data_3d("3dmatch", p["data_seed"])
    draws = {k: torch.from_numpy(v) for k, v in p["draws"].items()}
    local_batch, local_draws = shard(rank, world, batch, draws)
    state = create_train_state(model, OptimConfig(lr=p["lr"], momentum=0.0, weight_decay=0.0))
    return _run_step(make_parallel_train_step(LossConfig()), state, local_batch, local_draws)


def job_eval(rank: int, world: int, payload: dict) -> dict:
    """4DMatch's stochastic DDIM through the data-parallel eval step (x_init
    [B, S, T] and ddim_noise [steps, B, S, T] split by rows, step_condition
    [steps, B] gathered along axis 1), and on process 0 the plain DDIM."""
    from diffreg_tpu_torch.parallel.mesh import make_parallel_eval_step

    model = model_3d("4dmatch", 2)
    batch = data_3d("4dmatch", 7)
    gen = torch.Generator().manual_seed(4)
    s, t = batch.src_mask.shape[1], batch.tgt_mask.shape[1]
    x_init = torch.randn((B, s, t), generator=gen)
    noise = torch.randn((model.cfg.sample_steps, B, s, t), generator=gen)
    with torch.no_grad():
        got = make_parallel_eval_step(model)(batch, x_init=x_init, ddim_noise=noise)
        out = {"parallel": {k: _np(v) for k, v in got.items()}}
        if rank == 0:
            ref = model.ddim_sample(batch, x_init, ddim_noise=noise)
            out["single"] = {k: _np(v) for k, v in ref.items()}
    return out


def tiny_pairs(n: int, big: int):
    """``n`` raw pairs of 96 points; pair ``big`` has 600, too many for
    ``tiny_spec(96)``'s every level."""
    from diffreg_tpu_torch.data.synthetic import make_pair

    pairs = []
    for i in range(n):
        src, tgt, rot, trn, _ = make_pair(np.random.RandomState(i), 600 if i == big else 96)
        pairs.append({"src_pcd": src, "tgt_pcd": tgt, "rot": rot, "trn": trn, "idx": i})
    return pairs


def job_lockstep(rank: int, world: int, payload: dict) -> dict:
    """One Trainer epoch (the data-parallel step) over ``iterate_batches``'
    shard of 5 pairs at batch 1, where pair 2 overflows every bucket: the
    process holding it has one batch fewer. Returns the steps taken, the
    loader's stats, the pairs seen and the checkpoint saves."""
    from diffreg_tpu_torch.data.datasets import iterate_batches
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import tiny_spec
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from diffreg_tpu_torch.parallel.mesh import make_parallel_train_step

    pairs = tiny_pairs(5, big=2)
    stats, seen = {}, []

    def make_iter(epoch):
        for batch, meta in iterate_batches(pairs, tiny_spec(96), PyramidConfig(
                first_subsampling_dl=0.06, coarse_match_radius=0.15), 1, shuffle=False,
                stats=stats, process_index=rank, process_count=world):
            seen.append(meta[0]["idx"])
            yield batch, meta

    model = model_3d("3dmatch", 0)
    trainer = Trainer(make_parallel_train_step(loss_cfg_3d("3dmatch")),
                      create_train_state(model, OptimConfig()), make_iter,
                      TrainerConfig(max_epoch=1, save_dir=payload["lockstep_dir"]),
                      device="cpu", seed=0)
    saves = []
    save = trainer.ckpt.save
    trainer.ckpt.save = lambda *a, **k: (saves.append(a[0]), save(*a, **k))
    state = trainer.train()
    return {"steps": state.step, "stats": dict(stats), "seen": seen, "saves": saves,
            "logger_dir": trainer.logger.log_dir,
            "params": {n: _np(p) for n, p in model.named_trained_parameters()}}


def job_cli(rank: int, world: int, payload: dict) -> dict:
    """``main --mode train --demo`` on the test YAML in the shared directory:
    the demo batches each process trains on and its optimizer."""
    from diffreg_tpu_torch import main as cli
    from diffreg_tpu_torch.data import synthetic
    from diffreg_tpu_torch.engine import train

    seeds, optims = [], []
    batch_fn, state_fn = synthetic.synthetic_batch, train.create_train_state

    def recording_batch(*a, **k):
        seeds.append(k["seed"])
        return batch_fn(*a, **k)

    def recording_state(model, optim_cfg):
        optims.append(dataclasses.asdict(optim_cfg))
        return state_fn(model, optim_cfg)

    synthetic.synthetic_batch, train.create_train_state = recording_batch, recording_state
    os.chdir(payload["cli_dir"])
    try:
        result = cli.main(["--config", payload["cli_yaml"], "--demo", "--mode", "train",
                           "--num-pairs", "8", "--device", "cpu"])
    finally:
        synthetic.synthetic_batch, train.create_train_state = batch_fn, state_fn
    return {"result": result, "seeds": seeds, "optim": optims[0]}


DIFFERENTIATED = ("conf_matrix_pred", "conf_matrix_gt_hat", "s_pcd", "rotation_pred",
                  "translation_pred")


def job_loss4d(rank: int, world: int, payload: dict) -> dict:
    """``diffreg_loss`` with the 4DMatch motion term on given outputs: this
    process's rows through ``GlobalBatch``, and on process 0 the global
    batch in one process; the loss terms and the gradients of the outputs.
    ``shard_recall`` is this process's rows' own recall."""
    from types import SimpleNamespace

    from diffreg_tpu_torch.engine.losses import diffreg_loss, match_recall_precision
    from diffreg_tpu_torch.parallel.mesh import GlobalBatch, shard_rows

    p, cfg = payload["loss4d"], loss_cfg_3d("4dmatch")

    def run(rows, *reduce):
        outputs = {k: torch.from_numpy(v[rows]).requires_grad_(k in DIFFERENTIATED)
                   for k, v in p["outputs"].items()}
        batch = SimpleNamespace(**{k: torch.from_numpy(v[rows]) for k, v in p["batch"].items()})
        loss, info = diffreg_loss(outputs, batch, cfg, *reduce)
        grads = torch.autograd.grad(loss, [outputs[k] for k in DIFFERENTIATED])
        return {"info": {k: float(v.detach()) for k, v in info.items()},
                "grads": dict(zip(DIFFERENTIATED, map(_np, grads)))}

    rows = shard_rows(B, rank, world)
    gt, pred = (torch.from_numpy(p["outputs"][k][rows]) for k in ("matrix_gt", "match_mask_pred"))
    out = {"parallel": run(rows, GlobalBatch()),
           "shard_recall": float(match_recall_precision(gt, pred)[0])}
    if rank == 0:
        out["single"] = run(slice(None))
    return out


def fail_on_rank_1(rank: int, world: int):
    """Process 1 raises while process 0 waits in a barrier."""
    from diffreg_tpu_torch.parallel.distributed import barrier

    if rank == 1:
        raise ValueError("rank 1 fails")
    barrier()


JOBS = {"jax3d": job_jax3d, "loss4d": job_loss4d, "eval": job_eval, "lockstep": job_lockstep, "cli": job_cli,
        **{name: (lambda rank, world, payload, name=name: job_step(name, rank, world, payload))
           for name in STEP_SEEDS}}


def rank_main(rank: int, world: int, payload: dict) -> dict:
    """Run ``payload['jobs']`` in order; each job's result, its seconds, and
    whether JAX was imported in this process."""
    import time

    torch.set_num_threads(payload.get("threads", 1))
    out = {}
    for name in payload["jobs"]:
        t0 = time.perf_counter()
        out[name] = JOBS[name](rank, world, payload)
        out[name + "_s"] = time.perf_counter() - t0
    out["jax_imported"] = "jax" in sys.modules
    return out
