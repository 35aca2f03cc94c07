"""Train the small-but-full 4DMatch story model on synthetic deformable pairs,
with the PyTorch port on one CUDA card.

The port's counterpart of tools/train_synthetic_4d.py, with its protocol: the
4DMatch branch (Gaussian + sigmoid noising, the stochastic DDIM, the sigmoid
head with thr-mutual extraction, gate 40 in training and eval) on the bf16
fast path, trained with the 4DMatch loss (motion weight 0.1) by Adam at 1e-3
with a 300-step warmup and a cosine decay to 0.1x, over a STREAMED pool of
synthetic deformable pairs (512 points, the scene scaled by 1/6 so that the
preset's first_subsampling_dl 0.01 gives the reference's geometry against the
protocol's absolute 0.04 m thresholds; 48 batches of 8 pairs, seeds 0-47; a
producer thread builds fresh batches from seed 1,000,000 on and swaps one into
the pool per step when one is ready). Every DIFFREG_EVAL_EVERY steps the VAL
split (seeds 20,000+) goes through the 4DMatch tester protocol: the DDIM from
fixed draws (the start and each step's noise from generators seeded START_SEED
and NOISE_SEED, passed in as tensors), the thr-mutual mask at 0.55 with the
pad masks, 256 correspondences, IR at 0.04 m with the coarse GT flow and NFMR
at 0.04 m on the raw source points (anchor motion blending). Each improvement
of val NFMR (a result at least the best so far) is saved as a checkpoint (the
model's parameters and buffers, no optimizer state), and metrics.json is
rewritten with ``partial: true`` under the JAX tool's keys. Its
``selected_step`` is the one record of the selected checkpoint, which is always
the newest on disk, and its ``legs`` record each leg's cosine horizon, warmup
and rate estimate. At the end the val-selected weights are evaluated on the
disjoint TEST split (seeds 10,000-10,003, 32 pairs) and written as
``params.npz`` (float32, under the port's state_dict names).

The JAX tool sets ``flash_attention=False`` (its XLA attention); the port has
one attention path, so the model's CUDA tensors go through the hand-written
kernel (csrc/attention.cu, bf16 instance) all the same.

Run:      python tools/train_synthetic_4d_port.py [minutes] [batch_size] [out_dir]
              [--steps N] [--device cpu]
Finalize: python tools/train_synthetic_4d_port.py finalize [out_dir] [batch_size]
              [--device cpu]
          restores metrics.json's selected checkpoint from disk, reruns the test split,
          flips metrics.json's ``partial`` and rewrites params.npz.
``--steps`` stops the run at that global step (the time budget still holds).
It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA is
missing.
Env: DIFFREG_POOL (pool slots), DIFFREG_FRESH=0 (no streaming),
     DIFFREG_EVAL_EVERY, DIFFREG_RATE_EST (steps/s for the cosine horizon),
     DIFFREG_VAL_BATCHES, DIFFREG_PRECISION (the matchers' similarity product:
     default = TF32 on CUDA, highest = float32), DIFFREG_RESUME=1 (continue
     from out_dir's selected checkpoint with a fresh optimizer and the cosine
     schedule over the new budget; the step numbering and the curves go on).
"""
from __future__ import annotations

import argparse
import dataclasses
import os
import queue
import sys
import threading
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import numpy as np  # noqa: E402
import torch  # noqa: E402

from diffreg_tpu_torch.data.pyramid import (PyramidConfig, batch_from_samples,  # noqa: E402
                                            build_pair_pyramid)
from diffreg_tpu_torch.data.synthetic import make_pair, tiny_spec  # noqa: E402
from diffreg_tpu_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from diffreg_tpu_torch.engine.losses import LossConfig  # noqa: E402
from diffreg_tpu_torch.engine.train import (OptimConfig, create_train_state,  # noqa: E402
                                            make_train_step)
from diffreg_tpu_torch.eval.metrics import inlier_ratio, nfmr  # noqa: E402
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel  # noqa: E402
from diffreg_tpu_torch.models.presets import preset_4dmatch  # noqa: E402
from diffreg_tpu_torch.ops.select import (extract_correspondences,  # noqa: E402
                                          thresholded_mutual_argmax_mask)
from diffreg_tpu_torch.utils.device import resolve_device  # noqa: E402
from train_synthetic_port import (ModelWeights, device_name, load_params,  # noqa: E402,F401
                                  read_metrics, save_params, write_metrics)

STORY_DIR = "snapshot/train-synthetic-4d-torch"
N_POINTS = 512
M_METRIC = 512        # padded metric-point capacity (all raw source points)
# the JAX tool's scene: scaled by 1/6 so that dl 0.01 and the absolute 0.04 m
# thresholds keep the reference's geometry; flow 0.6 before scaling (0.1 after)
SCENE_SCALE = 1.0 / 6.0
FLOW_AMP = 0.60
TEST_SEED, VAL_SEED, FRESH_SEED = 10_000, 20_000, 1_000_000
TEST_BATCHES = 4
# steps/s of this tool's train step (batch 8, the producer streaming, a val
# every 300 steps) on an NVIDIA H100 80GB HBM3 at 700 W: its measuring leg,
# 826 steps in 240.1 s
RATE_EST = 3.4
START_SEED, NOISE_SEED = 99, 98    # the eval's DDIM start and per-step noise
MATCH_THR = 0.55      # the reference CLI's --thr
MAX_CORR = 256
INLIER_THR = RECALL_THR = 0.04
LOSS = LossConfig(dataset="4dmatch", motion_weight=0.1)   # configs/train/4dmatch.yaml
KEEP = 3          # checkpoints kept: the last val improvements, the selected one newest
PROTOCOL = ("best-val(NFMR)-checkpoint evaluated on disjoint test split (val seeds 20k+, "
            "test seeds 10k+)")


def build_model(device=None, compute_dtype="bfloat16", precision=None):
    """The small-but-full 4DMatch story model of tools/train_synthetic_4d.py:
    preset_4dmatch(sample_steps=10) (first_subsampling_dl 0.01, VolPE voxel
    0.04, gate 40 in training and eval, the stochastic DDIM and the sigmoid
    head) with feature width 96 and 4 heads of 24, first_feats_dim 64, fine 32,
    ``compute_dtype`` in the KPFCN and the transformers (the story's bf16;
    None: f32), the matchers' similarity product at ``precision`` (else
    DIFFREG_PRECISION, else "default"). Weights from seed 0."""
    precision = precision or os.environ.get("DIFFREG_PRECISION", "default")
    base = preset_4dmatch(sample_steps=10)
    matching = dataclasses.replace(base.coarse_matching, feature_dim=96, precision=precision)
    transformer = dataclasses.replace(
        base.coarse_transformer, feature_dim=96, n_head=4, feature_matching=matching,
        compute_dtype=compute_dtype)
    kpfcn = dataclasses.replace(base.kpfcn, first_feats_dim=64, coarse_feature_dim=96,
                                fine_feature_dim=32, compute_dtype=compute_dtype)
    cfg = dataclasses.replace(base, kpfcn=kpfcn, coarse_transformer=transformer,
                              coarse_matching=matching)
    return DiffusionMatchingModel(cfg, device=device, seed=0)


def optim_config(total_steps):
    """Adam at 1e-3, a 300-step warmup, then a cosine decay to 0.1x at
    ``total_steps``."""
    return OptimConfig(optimizer="adam", lr=1e-3, scheduler="warmup_cosine", warmup_steps=300,
                       total_steps=total_steps, eta_min=0.1)


def deformable_batch(batch_size, seed, device="cpu", n_points=N_POINTS):
    """``batch_size`` synthetic deformable pairs (the JAX tool's
    ``deformable_batch``) and their metric points: (PairBatch, (metric_pcd
    [B, M_METRIC, 3], metric_flow [B, M_METRIC, 3], metric_valid [B,
    M_METRIC])), the raw source points with their GT flow padded to
    M_METRIC, on ``device``."""
    rng = np.random.RandomState(seed)
    cfg = PyramidConfig(first_subsampling_dl=0.06 * SCENE_SCALE,
                        coarse_match_radius=0.15 * SCENE_SCALE)
    spec = tiny_spec(n_points)
    samples, mp, mf, mv = [], [], [], []
    for _ in range(batch_size):
        src, tgt, rot, trn, flow = make_pair(rng, n_points, deformable=True, flow_amp=FLOW_AMP,
                                             scale=SCENE_SCALE)
        samples.append(build_pair_pyramid(src, tgt, rot, trn, cfg, spec, scene_flow=flow))
        n = min(len(src), M_METRIC)
        pcd = np.zeros((M_METRIC, 3), np.float32)
        fl = np.zeros((M_METRIC, 3), np.float32)
        va = np.zeros(M_METRIC, bool)
        pcd[:n], fl[:n], va[:n] = src[:n], flow[:n], True
        mp.append(pcd), mf.append(fl), mv.append(va)
    metric = tuple(torch.from_numpy(np.stack(x)).to(device) for x in (mp, mf, mv))
    return batch_from_samples(samples).to(device), metric


def split_batches(seed0, count, batch_size, device, n_points=N_POINTS):
    return [deformable_batch(batch_size, seed0 + s, device, n_points) for s in range(count)]


def eval_draws(batch, steps):
    """The eval's fixed draws for ``batch``, on the CPU: the DDIM start [B, S,
    T] (seed START_SEED) and each step's noise [steps, B, S, T] (seed
    NOISE_SEED), the same for every batch of a shape, as the JAX tool's one
    key 99."""
    shape = (batch.src_mask.shape[0], batch.src_mask.shape[1], batch.tgt_mask.shape[1])
    x_init = torch.randn(shape, generator=torch.Generator().manual_seed(START_SEED))
    noise = torch.randn((steps,) + shape, generator=torch.Generator().manual_seed(NOISE_SEED))
    return x_init, noise


def match_mask(out, batch, thr=MATCH_THR):
    """The thr-mutual match mask of a DDIM output, with the pad masks."""
    mask = thresholded_mutual_argmax_mask(out["conf_matrix_pred"], thr, mutual=True)
    return mask & batch.src_mask[:, :, None] & batch.tgt_mask[:, None, :]


def pair_metrics(out, batch, metric, thr=MATCH_THR):
    """Per pair of a DDIM output: (IR at 0.04 m with the coarse GT flow, NFMR
    at 0.04 m on the metric points, the number of correspondences kept) of
    the thr-mutual mask's first MAX_CORR correspondences by confidence."""
    mask = match_mask(out, batch, thr)
    corrs = extract_correspondences(mask, out["conf_matrix_pred"], MAX_CORR)
    rows = lambda pts, idx: torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))  # noqa: E731
    src_c, tgt_c = rows(out["s_pcd"], corrs.src_idx), rows(out["t_pcd"], corrs.tgt_idx)
    ir = inlier_ratio(src_c, tgt_c, corrs.valid, batch.rot_gt, batch.trn_gt,
                      inlier_thr=INLIER_THR,
                      coarse_flow_corr=rows(batch.coarse_flow, corrs.src_idx))
    mp, mf, mv = metric
    nf = torch.stack([nfmr(mp[i], mf[i], batch.rot_gt[i], batch.trn_gt[i], src_c[i], tgt_c[i],
                           corrs.valid[i], mv[i], recall_thr=RECALL_THR)
                      for i in range(mask.shape[0])])
    return ir, nf, corrs.valid.sum(dim=1)


def make_split_metrics(model):
    """``split_metrics(batches) -> (mean IR, mean NFMR)`` of the model's
    current weights over ``(batch, metric)`` pairs: per batch the DDIM from
    ``eval_draws`` and ``pair_metrics``."""
    device = next(model.parameters()).device
    steps = model.cfg.sample_steps
    draws = {}

    @torch.no_grad()
    def one_batch(batch, metric):
        key = (tuple(batch.src_mask.shape), batch.tgt_mask.shape[1])
        if key not in draws:
            draws[key] = tuple(d.to(device) for d in eval_draws(batch, steps))
        x_init, noise = draws[key]
        out = model.ddim_sample(batch, x_init, ddim_noise=noise)
        ir, nf, _ = pair_metrics(out, batch, metric)
        return ir.cpu(), nf.cpu()

    def split_metrics(batches):
        res = [one_batch(b, m) for b, m in batches]
        return (float(torch.cat([r[0] for r in res]).mean()),
                float(torch.cat([r[1] for r in res]).mean()))

    return split_metrics


def finalize(out_dir=STORY_DIR, batch_size=8, device=None, n_points=N_POINTS):
    """Restore metrics.json's selected checkpoint from disk, rerun the test
    split, flip metrics.json's ``partial`` and write params.npz."""
    device = resolve_device(device)
    model = build_model(device)
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, device, n_points)
    payload = read_metrics(out_dir)
    if payload is None or payload.get("selected_step") is None:
        raise SystemExit(f"no selected checkpoint recorded in {out_dir}/metrics.json")
    step = int(payload["selected_step"])
    CheckpointManager(os.path.join(out_dir, "checkpoints"), max_to_keep=KEEP).restore(
        ModelWeights(model), step)
    ir1, nfmr1 = make_split_metrics(model)(heldout)
    print(f"finalize: best-val ckpt @{step}: test IR {ir1:.3f} NFMR {nfmr1:.3f}", flush=True)
    payload.update({"partial": False, "heldout_ir_after": ir1, "heldout_nfmr_after": nfmr1,
                    "finalized_from_checkpoint": True,
                    "test_pairs": len(heldout) * batch_size,
                    "protocol": "best-val(NFMR)-checkpoint (recovered from disk) evaluated on "
                                "disjoint test split (val seeds 20k+, test seeds 10k+)"})
    save_params(os.path.join(out_dir, "params.npz"), model.state_dict())
    print("finalized", write_metrics(out_dir, payload), flush=True)
    return payload


def train(minutes=60.0, batch_size=8, out_dir=STORY_DIR, device=None, n_points=N_POINTS,
          max_steps=None):
    """The training run (module docstring); stops at ``minutes`` or at global
    step ``max_steps``, whichever comes first. Returns the final payload."""
    device = resolve_device(device)
    model = build_model(device)
    n_pool = int(os.environ.get("DIFFREG_POOL", "48"))
    print(f"building {n_pool} pool batches (batch {batch_size})...", flush=True)
    pool = [b for b, _ in split_batches(0, n_pool, batch_size, device, n_points)]
    # disjoint splits: VAL picks the checkpoint, TEST is only reported
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, device, n_points)
    n_val = int(os.environ.get("DIFFREG_VAL_BATCHES", "4"))
    val_batches = split_batches(VAL_SEED, n_val, batch_size, device, n_points)

    stop_producer = threading.Event()
    fresh_q: "queue.Queue" = queue.Queue(maxsize=8)

    def _produce_fresh():
        seed = FRESH_SEED
        while not stop_producer.is_set():
            b = deformable_batch(batch_size, seed, "cpu", n_points)[0]
            seed += 1
            while not stop_producer.is_set():
                try:
                    fresh_q.put(b, timeout=1.0)
                    break
                except queue.Full:
                    continue

    stream_fresh = os.environ.get("DIFFREG_FRESH", "1") != "0"
    rate_est = float(os.environ.get("DIFFREG_RATE_EST", str(RATE_EST)))
    ocfg = optim_config(max(int(minutes * 60.0 * rate_est), 2000))

    # DIFFREG_RESUME=1: continue from metrics.json's selected checkpoint, with
    # a fresh optimizer (checkpoints hold no optimizer state). A fresh run
    # starts from an empty checkpoint directory, so that its selected
    # checkpoint stays the newest there.
    start_step = 0
    prev_train_curve, prev_val_curve, prev_legs, prev_before = [], [], [], None
    mgr = CheckpointManager(os.path.join(out_dir, "checkpoints"), max_to_keep=KEEP)
    resume = os.environ.get("DIFFREG_RESUME", "0") == "1"
    prior = read_metrics(out_dir) if resume else None
    if (prior is None or prior.get("selected_step") is None) and mgr.all_steps():
        raise SystemExit(f"{mgr.directory} holds another run's checkpoints: resume it with "
                         "DIFFREG_RESUME=1 or choose another out_dir")
    if prior is not None and prior.get("selected_step") is not None:
        start_step = int(prior["selected_step"])
        mgr.restore(ModelWeights(model), start_step)
        prev_train_curve = [list(x) for x in prior["train_curve"] if x[0] <= start_step]
        prev_val_curve = [list(x) for x in prior["val_curve"] if x[0] <= start_step]
        prev_legs = prior.get("legs", [])
        prev_before = (prior["heldout_ir_before"], prior["heldout_nfmr_before"])
        print(f"resumed from the selected checkpoint @{start_step}", flush=True)
    elif resume:
        print("DIFFREG_RESUME=1 but no selected checkpoint recorded; fresh run", flush=True)
    leg = {"start_step": start_step, "steps": 0, "total_steps": ocfg.total_steps,
           "warmup_steps": ocfg.warmup_steps, "rate_est": rate_est, "minutes": minutes,
           "batch_size": batch_size}
    state = create_train_state(model, ocfg)
    n_params = sum(p.numel() for p in model.parameters())
    n_trained = sum(p.numel() for p in state.optimizer.params)
    print(f"params: {n_params / 1e6:.2f}M ({n_trained} trained), pool pairs: "
          f"{n_pool * batch_size}, device {device_name(device)}", flush=True)

    step = make_train_step(LOSS)
    split_metrics = make_split_metrics(model)
    ir0, nfmr0 = split_metrics(heldout)
    vir0, vnf0 = split_metrics(val_batches)
    print(f"held-out(test) before: IR={ir0:.3f} NFMR={nfmr0:.3f} (val IR={vir0:.3f} "
          f"NFMR={vnf0:.3f})", flush=True)
    if prev_before is not None:
        # a resumed leg keeps the untrained baseline as its "before"
        ir0, nfmr0 = prev_before
    os.makedirs(out_dir, exist_ok=True)
    epoch_steps = n_pool                   # one pass over the pool

    def _dump(partial, i, train_curve, val_curve, extra=None):
        leg["steps"] = i
        payload = {"steps": start_step + i, "heldout_ir_before": ir0,
                   "heldout_nfmr_before": nfmr0,
                   "epochs": (start_step + i) / max(epoch_steps, 1),
                   "train_curve": train_curve, "val_curve": val_curve,
                   "pool_pairs": n_pool * batch_size, "partial": partial, "variant": "4dmatch",
                   "device": device_name(device), "legs": prev_legs + [leg]}
        if val_curve and partial:
            # best-so-far stand-ins, so that a partial artifact is scoreable
            payload["heldout_nfmr_after"] = max(v[2] for v in val_curve)
            payload["heldout_ir_after"] = max(v[1] for v in val_curve)
        payload.update(extra or {})
        write_metrics(out_dir, payload)
        return payload

    deadline = time.time() + minutes * 60.0
    # one generator for every step's draws (t, the normal draw, Euler angles)
    gen = torch.Generator(device=device).manual_seed(start_step)
    eval_every = int(os.environ.get("DIFFREG_EVAL_EVERY", "2000"))
    train_curve = list(prev_train_curve)
    val_curve = list(prev_val_curve) or [[0, vir0, vnf0]]
    if start_step and val_curve[-1][0] < start_step:
        val_curve.append([start_step, vir0, vnf0])
    # the selected checkpoint: every val improvement goes to disk at once, so
    # a killed run keeps it, and it is always the newest file there
    best = {"val": vnf0, "step": start_step}
    if not start_step:                     # a fresh run is resumable from its start
        mgr.save(0, ModelWeights(model))
        _dump(True, 0, train_curve, val_curve, extra={"fresh_batches": 0, "selected_step": 0})
    fresh_used = slot = i = 0
    if stream_fresh:
        threading.Thread(target=_produce_fresh, daemon=True).start()
    t0 = time.time()
    while time.time() < deadline and (max_steps is None or start_step + i < max_steps):
        batch = pool[i % n_pool]
        state, info = step(state, batch, model.draw_train_inputs(batch, gen))
        i += 1
        # swap one fresh batch into the pool per step when the producer has one
        if stream_fresh:
            try:
                nb = fresh_q.get_nowait()
            except queue.Empty:
                nb = None
            if nb is not None:
                pool[slot] = nb.to(device)
                slot = (slot + 1) % n_pool
                fresh_used += 1
        g = start_step + i
        if i % 200 == 0:
            loss = float(info["loss"])
            train_curve.append([g, loss])
            print(f"step {g}: loss={loss:.4f} ({(time.time() - t0) / i:.4f}s/step, "
                  f"{fresh_used} fresh batches)", flush=True)
        if i % eval_every == 0:
            vir, vnf = split_metrics(val_batches)
            val_curve.append([g, vir, vnf])
            if vnf >= best["val"]:
                best = {"val": vnf, "step": g}
                mgr.save(g, ModelWeights(model))
            print(f"  val @{g}: IR={vir:.3f} NFMR={vnf:.3f} "
                  f"(best {best['val']:.3f} @{best['step']})", flush=True)
            _dump(True, i, train_curve, val_curve,
                  extra={"fresh_batches": fresh_used, "selected_step": best["step"]})
    stop_producer.set()
    seconds = time.time() - t0

    ir_fin, nfmr_fin = split_metrics(heldout)
    vir_fin, vnf_fin = split_metrics(val_batches)
    val_curve.append([start_step + i, vir_fin, vnf_fin])
    if vnf_fin >= best["val"]:
        best = {"val": vnf_fin, "step": start_step + i}
        mgr.save(start_step + i, ModelWeights(model))
    # the reported held-out numbers: the val-selected weights on the test split
    mgr.restore(ModelWeights(model), best["step"])
    ir1, nfmr1 = split_metrics(heldout)
    print(f"final params: test IR {ir_fin:.3f} NFMR {nfmr_fin:.3f}; val-selected "
          f"@{best['step']}: test IR {ir1:.3f} NFMR {nfmr1:.3f}; {i} steps in {seconds:.1f} s "
          f"({i / max(seconds, 1e-9):.3f} steps/s)", flush=True)
    save_params(os.path.join(out_dir, "params.npz"), model.state_dict())
    leg["seconds"] = seconds
    payload = _dump(False, i, train_curve, val_curve, extra={
        "heldout_ir_after": ir1, "heldout_nfmr_after": nfmr1, "final_ir": ir_fin,
        "final_nfmr": nfmr_fin, "selected_step": best["step"], "fresh_batches": fresh_used,
        "test_pairs": len(heldout) * batch_size, "protocol": PROTOCOL,
        "steps_per_s": i / max(seconds, 1e-9)})
    print("saved", out_dir, flush=True)
    return payload


def main(argv=None):
    argv = list(sys.argv[1:] if argv is None else argv)
    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--device", default=None, help="cuda (default) or cpu")
    if argv and argv[0] == "finalize":
        parser.add_argument("out_dir", nargs="?", default=STORY_DIR)
        parser.add_argument("batch_size", nargs="?", type=int, default=8)
        args = parser.parse_args(argv[1:])
        return finalize(args.out_dir, args.batch_size, args.device)
    parser.add_argument("minutes", nargs="?", type=float, default=60.0)
    parser.add_argument("batch_size", nargs="?", type=int, default=8)
    parser.add_argument("out_dir", nargs="?", default=STORY_DIR)
    parser.add_argument("--steps", type=int, default=None, help="stop at this global step")
    args = parser.parse_args(argv)
    return train(args.minutes, args.batch_size, args.out_dir, args.device,
                 max_steps=args.steps)


if __name__ == "__main__":
    main()
