"""Train the small-but-full 3DMatch story model on synthetic pairs, with the
PyTorch port on one CUDA card.

The port's counterpart of tools/train_synthetic.py, with its protocol: the
warp-active training config (gate 200) on the bf16 fast path, Adam at 1e-3
with a 300-step warmup and a cosine decay to 0.1x, over a STREAMED pool of
synthetic pairs (48 batches of 8 pairs, seeds 0-47; a producer thread builds
fresh batches from seed 1,000,000 on and swaps one into the pool per step when
one is ready). Every DIFFREG_EVAL_EVERY steps the VAL split (seeds 20,000+)
goes through the DDIM + RANSAC path; each improvement (a val success at
least the best so far) is saved as a checkpoint (the model's parameters and
buffers, no optimizer state), and metrics.json is rewritten with
``partial: true``. Its ``selected_step`` is the one record of the selected
checkpoint, which is always the newest on disk, and its ``legs`` record each
leg's cosine horizon, warmup and rate estimate. At the end the val-selected
weights are evaluated on the disjoint TEST split (seeds 10,000-10,003, 32
pairs): success is RRE < 5 degrees, IR is the union mask's inlier ratio at
0.1 m. The selected weights are also written as ``params.npz`` (float32,
under the port's state_dict names).

Run:      python tools/train_synthetic_port.py [minutes] [batch_size] [out_dir]
              [--steps N] [--device cpu]
Finalize: python tools/train_synthetic_port.py finalize [out_dir] [batch_size]
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
import json
import os
import queue
import subprocess
import sys
import threading
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np
import torch

from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
from diffreg_tpu_torch.engine.losses import LossConfig
from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
from diffreg_tpu_torch.eval.metrics import masked_inlier_ratio
from diffreg_tpu_torch.eval.ransac import ransac_pose
from diffreg_tpu_torch.geometry.se3 import rotation_error_deg
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_3dmatch
from diffreg_tpu_torch.ops.select import extract_correspondences
from diffreg_tpu_torch.utils.device import resolve_device

STORY_DIR = "snapshot/train-synthetic-torch"
N_POINTS = 512
TEST_SEED, VAL_SEED, FRESH_SEED = 10_000, 20_000, 1_000_000
TEST_BATCHES = 4
# steps/s of this tool's train step (batch 8, the producer streaming) on an
# NVIDIA H100 80GB HBM3 at 700 W: its first run on the card, 8,410 steps in
# 2,400 s
RATE_EST = 3.5
START_SEED, RANSAC_SEED = 99, 7    # the eval's DDIM start and RANSAC draws
MAX_CORR, HYPOTHESES = 512, 16384
KEEP = 3          # checkpoints kept: the last val improvements, the selected one newest
PROTOCOL = ("best-val-checkpoint evaluated on disjoint test split (val seeds 20k+, "
            "test seeds 10k+)")


def build_model(device=None):
    """The small-but-full 3DMatch story model of tools/train_synthetic.py,
    warp active (gate 200): feature width 96 with 4 heads of 24, first_feats_dim
    64, fine 32, first_subsampling_dl 0.06, bf16 compute in the KPFCN and the
    transformers, the matchers' similarity product at DIFFREG_PRECISION (else
    "default"). Weights from seed 0."""
    precision = os.environ.get("DIFFREG_PRECISION", "default")
    base = preset_3dmatch(sample_steps=10, train=True)
    matching = dataclasses.replace(base.coarse_matching, feature_dim=96, precision=precision)
    transformer = dataclasses.replace(
        base.coarse_transformer, feature_dim=96, n_head=4, feature_matching=matching,
        compute_dtype="bfloat16")
    kpfcn = dataclasses.replace(base.kpfcn, first_feats_dim=64, coarse_feature_dim=96,
                                fine_feature_dim=32, first_subsampling_dl=0.06,
                                compute_dtype="bfloat16")
    cfg = dataclasses.replace(base, kpfcn=kpfcn, coarse_transformer=transformer,
                              coarse_matching=matching)
    return DiffusionMatchingModel(cfg, device=device, seed=0)


def optim_config(total_steps):
    """Adam at 1e-3, a 300-step warmup, then a cosine decay to 0.1x at
    ``total_steps``."""
    return OptimConfig(optimizer="adam", lr=1e-3, scheduler="warmup_cosine", warmup_steps=300,
                       total_steps=total_steps, eta_min=0.1)


def eval_draws(batch):
    """The eval's fixed draws for ``batch``: the DDIM start [B, S, T] (seed 99)
    and RANSAC's hypotheses [B, 16384, 3] (seed 7, the same rows for every
    pair, as the JAX tool's one key under vmap), on the CPU."""
    b, s = batch.src_mask.shape
    x_init = torch.randn((b, s, batch.tgt_mask.shape[1]),
                         generator=torch.Generator().manual_seed(START_SEED))
    u = torch.rand((1, HYPOTHESES, 3), generator=torch.Generator().manual_seed(RANSAC_SEED))
    return x_init, u.expand(b, -1, -1)


def make_split_success(model):
    """``split_success(batches) -> (success@5deg, RREs, mean IR)`` of the
    model's current weights: per batch the DDIM from ``eval_draws``' start,
    ``extract_correspondences(mask, conf, 512)``, RANSAC at 0.05 m over
    16,384 hypotheses, the RRE against the GT and the union mask's IR at
    0.1 m."""
    device = next(model.parameters()).device

    @torch.no_grad()
    def one_batch(batch):
        x_init, u = eval_draws(batch)
        out = model.ddim_sample(batch, x_init.to(device))
        ir = masked_inlier_ratio(out["corr_mask"], out["s_pcd"], out["t_pcd"], batch.rot_gt,
                                 batch.trn_gt, inlier_thr=0.1)
        corrs = extract_correspondences(out["corr_mask"], out["conf_matrix_pred"], MAX_CORR)
        rows = lambda pts, idx: torch.gather(pts, 1, idx[..., None].expand(-1, -1, 3))  # noqa: E731
        res = ransac_pose(u.to(device), rows(out["s_pcd"], corrs.src_idx),
                          rows(out["t_pcd"], corrs.tgt_idx), corrs.valid,
                          distance_threshold=0.05)
        return rotation_error_deg(res.rotation, batch.rot_gt).cpu(), ir.cpu()

    def split_success(batches):
        res = [one_batch(b) for b in batches]
        rres = torch.cat([r[0] for r in res]).numpy()
        irs = torch.cat([r[1] for r in res]).numpy()
        return float((rres < 5.0).mean()), rres, float(irs.mean())

    return split_success


class ModelWeights:
    """What a story checkpoint holds: the model's parameters and buffers, as
    the JAX tool saves {params, buffers} (no optimizer state)."""

    def __init__(self, model):
        self.model = model

    def state_dict(self):
        return self.model.state_dict()

    def load_state_dict(self, state):
        self.model.load_state_dict(state)


def save_params(path, state):
    """A state_dict as one float32 npz under its own names."""
    tmp = path + ".tmp.npz"
    np.savez(tmp, **{k: v.detach().cpu().float().numpy() for k, v in state.items()})
    os.replace(tmp, path)


def load_params(model, path):
    """Load ``save_params``' npz into ``model`` (every key, strictly)."""
    with np.load(path) as f:
        model.load_state_dict({k: torch.from_numpy(f[k]) for k in f.files})
    return model


def device_name(device) -> str:
    """The card's name and power limit as nvidia-smi prints them, or "cpu"."""
    if device.type != "cuda":
        return "cpu"
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader", f"--id={device.index or 0}"],
                         capture_output=True, text=True, check=True, timeout=60)
    return out.stdout.strip()


def read_metrics(out_dir):
    """out_dir's metrics.json, or None before a run's first val."""
    path = os.path.join(out_dir, "metrics.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def split_batches(seed0, count, batch_size, n_points, device):
    return [synthetic_batch(batch_size=batch_size, n_points=n_points, seed=seed0 + s)[0].to(device)
            for s in range(count)]


def write_metrics(out_dir, payload):
    path = os.path.join(out_dir, "metrics.json")
    with open(path + ".tmp", "w") as f:
        json.dump(payload, f, indent=1)
    os.replace(path + ".tmp", path)
    return path


def finalize(out_dir=STORY_DIR, batch_size=8, device=None, n_points=N_POINTS):
    """Restore metrics.json's selected checkpoint from disk, rerun the test
    split, flip metrics.json's ``partial`` and write params.npz."""
    device = resolve_device(device)
    model = build_model(device)
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, n_points, device)
    payload = read_metrics(out_dir)
    if payload is None or payload.get("selected_step") is None:
        raise SystemExit(f"no selected checkpoint recorded in {out_dir}/metrics.json")
    step = int(payload["selected_step"])
    CheckpointManager(os.path.join(out_dir, "checkpoints"), max_to_keep=KEEP).restore(
        ModelWeights(model), step)
    s1, rres, ir1 = make_split_success(model)(heldout)
    print(f"finalize: best-val ckpt @{step}: test success {s1:.2f} IR {ir1:.3f} "
          f"(RRE {np.round(rres, 1)})", flush=True)
    payload.update({"partial": False, "heldout_success_after": s1, "heldout_ir_after": ir1,
                    "heldout_rre_deg": rres.tolist(),
                    "finalized_from_checkpoint": True,
                    "test_pairs": len(heldout) * batch_size,
                    "protocol": "best-val-checkpoint (recovered from disk) evaluated on "
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
    pool = split_batches(0, n_pool, batch_size, n_points, device)
    # disjoint splits: VAL picks the checkpoint, TEST is only reported
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, n_points, device)
    n_val = int(os.environ.get("DIFFREG_VAL_BATCHES", "2"))
    val_batches = split_batches(VAL_SEED, n_val, batch_size, n_points, device)

    stop_producer = threading.Event()
    fresh_q: "queue.Queue" = queue.Queue(maxsize=8)

    def _produce_fresh():
        seed = FRESH_SEED
        while not stop_producer.is_set():
            b = synthetic_batch(batch_size=batch_size, n_points=n_points, seed=seed)[0]
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
        prev_before = (prior["heldout_success_before"], prior["heldout_ir_before"])
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

    step = make_train_step(LossConfig())
    split_success = make_split_success(model)
    s0, _, ir0 = split_success(heldout)
    v0, _, irv0 = split_success(val_batches)
    print(f"held-out(test) success@5deg before training: {s0:.2f} IR={ir0:.3f} "
          f"(val {v0:.2f})", flush=True)
    if prev_before is not None:
        # a resumed leg keeps the untrained baseline as its "before"
        s0, ir0 = prev_before
    os.makedirs(out_dir, exist_ok=True)
    epoch_steps = n_pool                   # one pass over the pool

    def _dump(partial, i, train_curve, val_curve, extra=None):
        leg["steps"] = i
        payload = {"steps": start_step + i, "heldout_success_before": s0,
                   "heldout_ir_before": ir0,
                   "epochs": (start_step + i) / max(epoch_steps, 1),
                   "train_curve": train_curve, "val_curve": val_curve,
                   "pool_pairs": n_pool * batch_size, "partial": partial,
                   "device": device_name(device), "legs": prev_legs + [leg]}
        if val_curve and partial:
            # best-so-far stand-ins, so that a partial artifact is scoreable
            payload["heldout_success_after"] = max(v[1] for v in val_curve)
            payload["heldout_ir_after"] = max(v[2] for v in val_curve)
        payload.update(extra or {})
        write_metrics(out_dir, payload)
        return payload

    deadline = time.time() + minutes * 60.0
    # one generator for every step's draws (t, the normal draw, Euler angles)
    gen = torch.Generator(device=device).manual_seed(start_step)
    eval_every = int(os.environ.get("DIFFREG_EVAL_EVERY", "2000"))
    train_curve = list(prev_train_curve)
    val_curve = list(prev_val_curve) or [[0, v0, irv0]]
    if start_step and val_curve[-1][0] < start_step:
        val_curve.append([start_step, v0, irv0])
    # the selected checkpoint: every val improvement goes to disk at once, so
    # a killed run keeps it, and it is always the newest file there
    best = {"val": v0, "step": start_step}
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
            s, _, irv = split_success(val_batches)
            val_curve.append([g, s, irv])
            if s >= best["val"]:
                best = {"val": s, "step": g}
                mgr.save(g, ModelWeights(model))
            print(f"  val @{g}: success={s:.2f} IR={irv:.3f} "
                  f"(best {best['val']:.2f} @{best['step']})", flush=True)
            _dump(True, i, train_curve, val_curve,
                  extra={"fresh_batches": fresh_used, "selected_step": best["step"]})
    stop_producer.set()
    seconds = time.time() - t0

    s_fin, _, ir_fin = split_success(heldout)
    v_fin, _, irv_fin = split_success(val_batches)
    val_curve.append([start_step + i, v_fin, irv_fin])
    if v_fin >= best["val"]:
        best = {"val": v_fin, "step": start_step + i}
        mgr.save(start_step + i, ModelWeights(model))
    # the reported held-out numbers: the val-selected weights on the test split
    mgr.restore(ModelWeights(model), best["step"])
    s1, rres, ir1 = split_success(heldout)
    print(f"final params: test success {s_fin:.2f} IR {ir_fin:.3f}; val-selected "
          f"@{best['step']}: test success {s1:.2f} IR {ir1:.3f} (RRE {np.round(rres, 1)}); "
          f"{i} steps in {seconds:.1f} s ({i / max(seconds, 1e-9):.3f} steps/s)", flush=True)
    save_params(os.path.join(out_dir, "params.npz"), model.state_dict())
    leg["seconds"] = seconds
    payload = _dump(False, i, train_curve, val_curve, extra={
        "heldout_success_after": s1, "heldout_ir_after": ir1, "heldout_rre_deg": rres.tolist(),
        "final_success": s_fin, "final_ir": ir_fin, "selected_step": best["step"],
        "fresh_batches": fresh_used, "test_pairs": len(heldout) * batch_size,
        "protocol": PROTOCOL, "steps_per_s": i / max(seconds, 1e-9)})
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
