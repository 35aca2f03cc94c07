"""Train the small-but-full 2D-3D story model on synthetic image <-> cloud
pairs, with the PyTorch port on one CUDA card.

The port's counterpart of tools/train_synthetic_2d3d.py, with its protocol: a
DiffReg2D3D at reduced widths (UNet 32 -> 64, point backbone 32 -> 64, fusion
128-wide with 4 heads of 32, coarse stride 14, 10 DDIM steps) trained with the
reference's OverallLoss (coarse circle + gt_hat focal + fine circle) by Adam
at 5e-4 with a 200-step warmup and a cosine decay to 0.1x, over a STREAMED pool
of synthetic pairs (112 x 154 images, 1024-point clouds, the overlap and fine
GT of the collate helpers; 24 batches of 4 pairs, seeds 0-23; a producer
thread builds fresh batches from seed 1,000,000 on and swaps one into the pool
per step when one is ready). Every DIFFREG_EVAL_EVERY steps the VAL split
(seeds 20,000+) goes through the reference eval protocol (TwoDThreeDTester:
DDIM, fine matching, device PnP-RANSAC over 4096 hypotheses, 512 fine
correspondences): RR (RMSE < 0.1 m), IR at 0.05 m and FMR. The selection is
lexicographic on (val RR, val IR), as in the JAX tool; each result at least
the best so far is saved as a checkpoint (the model's parameters and buffers,
no optimizer state), and metrics.json is rewritten with ``partial: true``.
Its ``selected_step`` is the one record of the selected checkpoint, which is
always the newest on disk, and its ``legs`` record each leg's cosine horizon,
warmup and rate estimate. At the end the val-selected weights are evaluated
on the disjoint TEST split (seeds 10,000-10,003, 16 pairs) and written as
``params.npz`` (float32, under the port's state_dict names).

The whole model runs in f32 (TF32 off): the port's 2D-3D path has no
``precision: default`` policy, where the JAX tool sets one.
Every eval takes its DDIM starts and PnP draws from one generator seeded with
EVAL_SEED on the model's device, so an eval repeats.

Run:      python tools/train_synthetic_2d3d_port.py [minutes] [batch_size] [out_dir]
              [--steps N] [--device cpu]
Finalize: python tools/train_synthetic_2d3d_port.py finalize [out_dir] [batch_size]
              [--device cpu]
          restores metrics.json's selected checkpoint from disk, reruns the test split,
          flips metrics.json's ``partial`` and rewrites params.npz.
``--steps`` stops the run at that global step (the time budget still holds).
It runs on CUDA unless ``--device cpu`` is given, and raises where CUDA is
missing.
Env: DIFFREG_2D3D_HW ("112,154"), DIFFREG_2D3D_POINTS (1024), DIFFREG_2D3D_STEPS
     (10 DDIM steps), DIFFREG_POOL (pool slots), DIFFREG_FRESH=0 (no streaming),
     DIFFREG_EVAL_EVERY, DIFFREG_RATE_EST (steps/s for the cosine horizon),
     DIFFREG_VAL_BATCHES, DIFFREG_RESUME=1 (continue from out_dir's selected
     checkpoint with a fresh optimizer and the cosine schedule over the new
     budget; the step numbering and the curves go on).
"""
from __future__ import annotations

import argparse
import os
import queue
import sys
import threading
import time

TOOLS = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(TOOLS))
sys.path.insert(0, TOOLS)

import torch  # noqa: E402

from diffreg_tpu_torch.data.synthetic2d3d import synthetic_2d3d_batch  # noqa: E402
from diffreg_tpu_torch.engine.checkpoint import CheckpointManager  # noqa: E402
from diffreg_tpu_torch.engine.losses import LossConfig  # noqa: E402
from diffreg_tpu_torch.engine.losses2d3d import CircleLossConfig, FineLossConfig  # noqa: E402
from diffreg_tpu_torch.engine.tester2d3d import Test2D3DConfig, TwoDThreeDTester  # noqa: E402
from diffreg_tpu_torch.engine.train import OptimConfig  # noqa: E402
from diffreg_tpu_torch.engine.train2d3d import (create_train_state_2d3d,  # noqa: E402
                                                make_train_step_2d3d)
from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D, Pipeline2D3DConfig  # noqa: E402
from diffreg_tpu_torch.nn.matching import MatchingConfig  # noqa: E402
from diffreg_tpu_torch.nn.point_backbone import PointBackboneConfig  # noqa: E402
from diffreg_tpu_torch.utils.device import resolve_device  # noqa: E402
from train_synthetic_port import (ModelWeights, device_name, load_params,  # noqa: E402,F401
                                  read_metrics, save_params, write_metrics)

STORY_DIR = "snapshot/train-synthetic-2d3d-torch"
IMG_HW = tuple(int(x) for x in os.environ.get("DIFFREG_2D3D_HW", "112,154").split(","))
N_POINTS = int(os.environ.get("DIFFREG_2D3D_POINTS", "1024"))
SAMPLE_STEPS = int(os.environ.get("DIFFREG_2D3D_STEPS", "10"))
COARSE_STRIDE = 14
TEST_SEED, VAL_SEED, FRESH_SEED = 10_000, 20_000, 1_000_000
TEST_BATCHES = 4
# the JAX tool's steps/s estimate for the cosine horizon
RATE_EST = 3.0
EVAL_SEED = 0     # the eval's DDIM starts and PnP draws
# the reference protocol: 4096 PnP hypotheses, 512 fine correspondences
TEST_CONFIG = Test2D3DConfig(pnp_hypotheses=4096, max_fine_corr=512)
KEEP = 3          # checkpoints kept: the last val improvements, the selected one newest
PROTOCOL = ("best-val(RR,IR)-checkpoint evaluated on disjoint test split (val seeds 20k+, "
            "test seeds 10k+)")


def build_model(device=None):
    """The JAX tool's model (tools/train_synthetic_2d3d.py:build_model): image
    UNet out 64 / base 32, point backbone out 64 / init 32 (radius 0.15, sigma
    0.12), fusion hidden and output 128 with 4 heads, the matchers at 128,
    coarse stride 14, DIFFREG_2D3D_STEPS DDIM steps. Weights from seed 0."""
    cfg = Pipeline2D3DConfig(
        img_out_dim=64, img_base_dim=32,
        pcd_backbone=PointBackboneConfig(output_dim=64, init_dim=32, init_radius=0.15,
                                         init_sigma=0.12),
        hidden_dim=128, output_dim=128, num_heads=4, matching=MatchingConfig(feature_dim=128),
        coarse_stride=COARSE_STRIDE, sample_steps=SAMPLE_STEPS)
    return DiffReg2D3D(cfg, device=device, seed=0)


def optim_config(total_steps):
    """Adam at 5e-4, a 200-step warmup, then a cosine decay to 0.1x at
    ``total_steps``."""
    return OptimConfig(optimizer="adam", lr=5e-4, scheduler="warmup_cosine", warmup_steps=200,
                       total_steps=total_steps, eta_min=0.1)


def make_batch(batch_size, seed, img_hw=IMG_HW, n_points=N_POINTS):
    """One batch of the JAX tool's pairs (``make_batch``), as CPU tensors."""
    return synthetic_2d3d_batch(batch_size=batch_size, img_hw=img_hw, n_points=n_points,
                                seed=seed, coarse_stride=COARSE_STRIDE, with_full_gt=True,
                                n_overlap=256, n_fine_gt=128)


def split_batches(seed0, count, batch_size, device, img_hw=IMG_HW, n_points=N_POINTS):
    return [make_batch(batch_size, seed0 + s, img_hw, n_points).to(device) for s in range(count)]


def make_split_eval(model):
    """``split_eval(batches) -> (RR, IR, FMR)`` of the model's current weights
    through the reference protocol's tester (TEST_CONFIG), the draws from a
    generator seeded with EVAL_SEED."""
    device = next(model.parameters()).device
    tester = TwoDThreeDTester(model, TEST_CONFIG, device=device)

    @torch.no_grad()
    def split_eval(batches):
        summary = tester.test(lambda: ((b, [f"s{j}"] * b.batch_size)
                                       for j, b in enumerate(batches)),
                              torch.Generator(device).manual_seed(EVAL_SEED))
        return float(summary["RR"]), float(summary["IR"]), float(summary["FMR"])

    return split_eval


def finalize(out_dir=STORY_DIR, batch_size=4, device=None, img_hw=IMG_HW, n_points=N_POINTS):
    """Restore metrics.json's selected checkpoint from disk, rerun the test
    split, flip metrics.json's ``partial`` and write params.npz."""
    device = resolve_device(device)
    model = build_model(device)
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, device, img_hw, n_points)
    payload = read_metrics(out_dir)
    if payload is None or payload.get("selected_step") is None:
        raise SystemExit(f"no selected checkpoint recorded in {out_dir}/metrics.json")
    step = int(payload["selected_step"])
    CheckpointManager(os.path.join(out_dir, "checkpoints"), max_to_keep=KEEP).restore(
        ModelWeights(model), step)
    rr1, ir1, fmr1 = make_split_eval(model)(heldout)
    print(f"finalize: best-val ckpt @{step}: test RR {rr1:.3f} IR {ir1:.3f} FMR {fmr1:.3f}",
          flush=True)
    payload.update({"partial": False, "heldout_rr_after": rr1, "heldout_ir_after": ir1,
                    "heldout_fmr_after": fmr1, "finalized_from_checkpoint": True,
                    "test_pairs": len(heldout) * batch_size,
                    "protocol": "best-val(RR,IR)-checkpoint (recovered from disk) evaluated "
                                "on disjoint test split (val seeds 20k+, test seeds 10k+)"})
    save_params(os.path.join(out_dir, "params.npz"), model.state_dict())
    print("finalized", write_metrics(out_dir, payload), flush=True)
    return payload


def train(minutes=45.0, batch_size=4, out_dir=STORY_DIR, device=None, img_hw=IMG_HW,
          n_points=N_POINTS, max_steps=None):
    """The training run (module docstring); stops at ``minutes`` or at global
    step ``max_steps``, whichever comes first. Returns the final payload."""
    device = resolve_device(device)
    model = build_model(device)
    n_pool = int(os.environ.get("DIFFREG_POOL", "24"))
    print(f"building {n_pool} pool batches (batch {batch_size})...", flush=True)
    pool = split_batches(0, n_pool, batch_size, device, img_hw, n_points)
    # disjoint splits: VAL picks the checkpoint, TEST is only reported
    heldout = split_batches(TEST_SEED, TEST_BATCHES, batch_size, device, img_hw, n_points)
    n_val = int(os.environ.get("DIFFREG_VAL_BATCHES", "2"))
    val_batches = split_batches(VAL_SEED, n_val, batch_size, device, img_hw, n_points)

    stop_producer = threading.Event()
    fresh_q: "queue.Queue" = queue.Queue(maxsize=4)

    def _produce_fresh():
        seed = FRESH_SEED
        while not stop_producer.is_set():
            b = make_batch(batch_size, seed, img_hw, n_points)
            seed += 1
            while not stop_producer.is_set():
                try:
                    fresh_q.put(b, timeout=1.0)
                    break
                except queue.Full:
                    continue

    stream_fresh = os.environ.get("DIFFREG_FRESH", "1") != "0"
    rate_est = float(os.environ.get("DIFFREG_RATE_EST", str(RATE_EST)))
    ocfg = optim_config(max(int(minutes * 60.0 * rate_est), 1000))

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
        prev_before = (prior["heldout_rr_before"], prior["heldout_ir_before"],
                       prior["heldout_fmr_before"])
        print(f"resumed from the selected checkpoint @{start_step}", flush=True)
    elif resume:
        print("DIFFREG_RESUME=1 but no selected checkpoint recorded; fresh run", flush=True)
    leg = {"start_step": start_step, "steps": 0, "total_steps": ocfg.total_steps,
           "warmup_steps": ocfg.warmup_steps, "rate_est": rate_est, "minutes": minutes,
           "batch_size": batch_size}
    state = create_train_state_2d3d(model, ocfg)
    n_params = sum(p.numel() for p in model.parameters())
    print(f"params: {n_params / 1e6:.2f}M, pool pairs: {n_pool * batch_size}, device "
          f"{device_name(device)}", flush=True)

    step = make_train_step_2d3d(CircleLossConfig(), LossConfig(), FineLossConfig())
    split_eval = make_split_eval(model)
    rr0, ir0, fmr0 = split_eval(heldout)
    vrr0, vir0, _ = split_eval(val_batches)
    print(f"held-out(test) before: RR={rr0:.3f} IR={ir0:.3f} FMR={fmr0:.3f} "
          f"(val RR={vrr0:.3f} IR={vir0:.3f})", flush=True)
    if prev_before is not None:
        # a resumed leg keeps the untrained baseline as its "before"
        rr0, ir0, fmr0 = prev_before
    os.makedirs(out_dir, exist_ok=True)
    epoch_steps = n_pool                   # one pass over the pool

    def _dump(partial, i, train_curve, val_curve, extra=None):
        leg["steps"] = i
        payload = {"steps": start_step + i, "heldout_rr_before": rr0,
                   "heldout_ir_before": ir0, "heldout_fmr_before": fmr0,
                   "epochs": (start_step + i) / max(epoch_steps, 1),
                   "train_curve": train_curve, "val_curve": val_curve,
                   "pool_pairs": n_pool * batch_size, "partial": partial, "variant": "2d3d",
                   "device": device_name(device), "legs": prev_legs + [leg]}
        if val_curve and partial:
            # best-so-far stand-ins, so that a partial artifact is scoreable
            payload["heldout_rr_after"] = max(v[1] for v in val_curve)
            payload["heldout_ir_after"] = max(v[2] for v in val_curve)
        payload.update(extra or {})
        write_metrics(out_dir, payload)
        return payload

    deadline = time.time() + minutes * 60.0
    # one generator for every step's draws (t, the normal draw)
    gen = torch.Generator(device=device).manual_seed(start_step)
    eval_every = int(os.environ.get("DIFFREG_EVAL_EVERY", "500"))
    train_curve = list(prev_train_curve)
    val_curve = list(prev_val_curve) or [[0, vrr0, vir0]]
    if start_step and val_curve[-1][0] < start_step:
        val_curve.append([start_step, vrr0, vir0])
    # the selected checkpoint: every val result at least the best goes to disk
    # at once, so a killed run keeps it, and it is always the newest file there
    best = {"key": (vrr0, vir0), "step": start_step}
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
        if i % 100 == 0:
            loss = float(info["loss"])
            train_curve.append([g, loss])
            print(f"step {g}: loss={loss:.4f} ({(time.time() - t0) / i:.4f}s/step, "
                  f"{fresh_used} fresh batches)", flush=True)
        if i % eval_every == 0:
            vrr, vir, _ = split_eval(val_batches)
            val_curve.append([g, vrr, vir])
            if (vrr, vir) >= best["key"]:
                best = {"key": (vrr, vir), "step": g}
                mgr.save(g, ModelWeights(model))
            print(f"  val @{g}: RR={vrr:.3f} IR={vir:.3f} (best {best['key']} "
                  f"@{best['step']})", flush=True)
            _dump(True, i, train_curve, val_curve,
                  extra={"fresh_batches": fresh_used, "selected_step": best["step"]})
    stop_producer.set()
    seconds = time.time() - t0

    rr_fin, ir_fin, fmr_fin = split_eval(heldout)
    vrr_fin, vir_fin, _ = split_eval(val_batches)
    val_curve.append([start_step + i, vrr_fin, vir_fin])
    if (vrr_fin, vir_fin) >= best["key"]:
        best = {"key": (vrr_fin, vir_fin), "step": start_step + i}
        mgr.save(start_step + i, ModelWeights(model))
    # the reported held-out numbers: the val-selected weights on the test split
    mgr.restore(ModelWeights(model), best["step"])
    rr1, ir1, fmr1 = split_eval(heldout)
    print(f"final params: test RR {rr_fin:.3f} IR {ir_fin:.3f} FMR {fmr_fin:.3f}; "
          f"val-selected @{best['step']}: test RR {rr1:.3f} IR {ir1:.3f} FMR {fmr1:.3f}; "
          f"{i} steps in {seconds:.1f} s ({i / max(seconds, 1e-9):.3f} steps/s)", flush=True)
    save_params(os.path.join(out_dir, "params.npz"), model.state_dict())
    leg["seconds"] = seconds
    payload = _dump(False, i, train_curve, val_curve, extra={
        "heldout_rr_after": rr1, "heldout_ir_after": ir1, "heldout_fmr_after": fmr1,
        "final_rr": rr_fin, "final_ir": ir_fin, "final_fmr": fmr_fin,
        "selected_step": best["step"], "fresh_batches": fresh_used,
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
        parser.add_argument("batch_size", nargs="?", type=int, default=4)
        args = parser.parse_args(argv[1:])
        return finalize(args.out_dir, args.batch_size, args.device)
    parser.add_argument("minutes", nargs="?", type=float, default=45.0)
    parser.add_argument("batch_size", nargs="?", type=int, default=4)
    parser.add_argument("out_dir", nargs="?", default=STORY_DIR)
    parser.add_argument("--steps", type=int, default=None, help="stop at this global step")
    args = parser.parse_args(argv)
    return train(args.minutes, args.batch_size, args.out_dir, args.device,
                 max_steps=args.steps)


if __name__ == "__main__":
    main()
