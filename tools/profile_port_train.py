"""Where the device time of one training step of the PyTorch port goes, on one CUDA card.

Builds chip_smoke.py's training configuration (preset_3dmatch(train=True):
condition gate 200, 432-dim, 4 pairs of 4096 points per side, random weights
from seed 0, the reference SGD), takes two warm-up steps, times three steps
without the profiler, then records one step with ``torch.profiler`` in three
ranges (forward with the loss, backward, optimizer) and prints, from the
trace: the step's wall time, the device's busy time (union of kernel, memcpy
and memset intervals) and idle share, the device launches per step, and the
device time by group and by kernel. Groups: the hand-written forward kernels,
the plain backward recomputes of KPConv and attention (their profiler
ranges), cuBLAS GEMMs and the rest of forward and backward, and the
optimizer. The last line is one JSON object with those numbers.
``--bf16`` profiles the bf16 step instead (compute_dtype bfloat16 and
precision default, as the JAX package's tools/bench_train.py trains): the
bf16 kernel instances forward, their plain bf16 recomputes backward.
``--story`` profiles the synthetic training story's step instead
(tools/train_synthetic_port.py: its bf16 model, Adam with its schedule, pool
batch 0 of 8 pairs at 512 tokens a side), and times ten steps with a thread
building synthetic batches beside them, as the story's producer does,
against ten without.
``--story4d`` does the same for the 4DMatch story's step
(tools/train_synthetic_4d_port.py: its bf16 model at gate 40, the 4DMatch
loss with the motion term, pool batch 0 of 8 deformable pairs at 512 tokens a
side), its thread building deformable batches.

    python3 tools/profile_port_train.py [--bf16 | --story | --story4d]
"""
from __future__ import annotations

import argparse
import bisect
import importlib.util
import json
import os
import re
import subprocess
import sys
import tempfile
import threading
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")
PAIRS, N_POINTS = 4, 4096
PHASES = ("train/forward", "train/backward", "train/optimizer")
RECOMPUTES = ("kpconv_backward_recompute", "masked_attention_backward_recompute",
              "kpconv_bf16_backward_recompute", "masked_attention_bf16_backward_recompute")
HAND_WRITTEN = re.compile(r"\b(kpconv_kernel|kpconv_tc_kernel|kpconv_tc_bf16_kernel|"
                          r"masked_attention_kernel|masked_attention_bf16_kernel)\b")
CUBLAS = re.compile(r"gemm|cublas|cutlass", re.IGNORECASE)


def group_of(name: str, ranges) -> str:
    """The group of a kernel from its name and the ranges its launch fell in."""
    phase = next((r for r in ranges if r in PHASES), None)
    recompute = next((r for r in ranges if r in RECOMPUTES), None)
    if phase == "train/optimizer":
        return "optimizer"
    if recompute is not None:
        return f"backward: {recompute.replace('_backward_recompute', '')} plain recompute"
    side = "forward" if phase == "train/forward" else "backward"
    if HAND_WRITTEN.search(name):
        return f"{side}: hand-written kernels"
    return f"{side}: {'cuBLAS' if CUBLAS.search(name) else 'other'}"


def summarize(trace_path: str, wall_s: float, top: int = 8) -> dict:
    """Busy time, idle share, launches and device time by group and kernel."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    ranges = sorted((float(ev["ts"]), float(ev["ts"]) + float(ev.get("dur", 0.0)), ev["name"])
                    for ev in events if ev.get("ph") == "X"
                    and ev.get("cat") == "user_annotation"
                    and ev["name"] in PHASES + RECOMPUTES)
    starts = [r[0] for r in ranges]
    launch_ts = {ev["args"]["correlation"]: float(ev["ts"]) for ev in events
                 if ev.get("ph") == "X" and ev.get("cat") in ("cuda_runtime", "cuda_driver")
                 and "correlation" in ev.get("args", {})}
    spans, groups, kernels, launches = [], defaultdict(float), defaultdict(float), 0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((start, start + dur))
        ts = launch_ts.get(ev.get("args", {}).get("correlation"), start)
        inside = [name for lo, hi, name in ranges[:bisect.bisect_right(starts, ts)]
                  if lo <= ts <= hi]
        group = group_of(ev["name"], inside)
        groups[group] += dur
        kernels[(group, ev["name"][:90])] += dur
        launches += ev["cat"] == "kernel"
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy_s = busy * 1e-6
    by_group = {}
    for group, total in sorted(groups.items(), key=lambda kv: -kv[1]):
        ranked = sorted(((n, d) for (g, n), d in kernels.items() if g == group),
                        key=lambda kv: -kv[1])[:top]
        by_group[group] = {"ms": total * 1e-3, "top_kernels_ms": [[n, d * 1e-3] for n, d in ranked]}
    return {"wall_s": wall_s, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall_s if wall_s > 0 else None,
            "kernel_launches": launches, "groups": by_group}


def main() -> int:
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--bf16", action="store_true",
                      help="profile the bf16 step (compute_dtype bfloat16, precision default)")
    args.add_argument("--story", action="store_true",
                      help="profile the synthetic training story's step")
    args.add_argument("--story4d", action="store_true",
                      help="profile the 4DMatch synthetic training story's step")
    args = args.parse_args()
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_port_train: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.engine.train import OptimConfig, apply_gradients, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch, with_fast_path

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pairs, loss_cfg = PAIRS, LossConfig()
    story = args.story or args.story4d
    if story:
        name = "train_synthetic_4d_port" if args.story4d else "train_synthetic_port"
        sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
        spec = importlib.util.spec_from_file_location(
            name, os.path.join(os.path.dirname(os.path.abspath(__file__)), name + ".py"))
        tool = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(tool)
        pairs = 8
        if args.story4d:
            make = lambda seed: tool.deformable_batch(pairs, seed)[0]  # noqa: E731
            loss_cfg = tool.LOSS
        else:
            make = lambda seed: synthetic_batch(  # noqa: E731
                batch_size=pairs, n_points=tool.N_POINTS, seed=seed)[0]
        batch = make(0).to("cuda")
        model = tool.build_model("cuda")
        state = create_train_state(model, tool.optim_config(12000))
    else:
        pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
        cal_rng = np.random.RandomState(0)
        spec = calibrate_spec([make_pair(cal_rng, N_POINTS)[:2] for _ in range(2)], pcfg,
                              k_cap=40, neighbor_percentile=90.0)
        batch, _, _ = synthetic_batch(batch_size=PAIRS, n_points=N_POINTS, seed=0, spec=spec,
                                      cfg=pcfg)
        batch = batch.to("cuda")
        cfg = preset_3dmatch(train=True)
        model = DiffusionMatchingModel(with_fast_path(cfg) if args.bf16 else cfg,
                                       device="cuda", seed=0)
        state = create_train_state(model, OptimConfig())
    gen = torch.Generator("cuda").manual_seed(0)

    def step():
        with record_function(PHASES[0]):
            out = model.train_forward(batch, **model.draw_train_inputs(batch, gen))
            loss = diffreg_loss(out, batch, loss_cfg)[0]
        with record_function(PHASES[1]):
            grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
        with record_function(PHASES[2]):
            apply_gradients(state.optimizer, grads)

    def timed():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        step()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    for _ in range(2):
        step()
    torch.cuda.reset_peak_memory_stats()
    plain_walls = [timed() for _ in range(3)]
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = timed()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = summarize(path, wall_s)
    summary["unprofiled_wall_s"] = plain_walls
    summary["peak_gib"] = peak_gib
    if story:
        # ten steps alone, then ten beside a thread building the story's batches
        stop = threading.Event()

        def produce():
            seed = 1_000_000
            while not stop.is_set():
                make(seed)
                seed += 1
        alone = sum(timed() for _ in range(10)) / 10
        producer = threading.Thread(target=produce, daemon=True)
        producer.start()
        beside = sum(timed() for _ in range(10)) / 10
        stop.set()
        producer.join()
        summary["step_s_alone"], summary["step_s_beside_producer"] = alone, beside
        print(f"story step: {alone:.4f} s alone, {beside:.4f} s beside a thread building "
              f"batches ({1 / alone:.3f} / {1 / beside:.3f} steps/s)", flush=True)
    dtype = ("story4d bf16" if args.story4d else "story bf16" if args.story
             else "bf16" if args.bf16 else "f32")
    gate = model.cfg.procrustes.max_condition_num
    print(f"train step {dtype} (gate {gate:g}, {pairs} pairs): wall {wall_s:.4f} s profiled "
          f"(unprofiled {', '.join(f'{w:.4f}' for w in plain_walls)} s, peak memory "
          f"{peak_gib:.2f} GiB), device busy "
          f"{summary['device_busy_s']:.4f} s, idle share {summary['idle_share']:.3f}, "
          f"{summary['kernel_launches']} kernel launches", flush=True)
    for group, entry in summary["groups"].items():
        print(f"  {entry['ms']:9.3f} ms  {group}", flush=True)
        for name, ms in entry["top_kernels_ms"]:
            print(f"      {ms:9.3f} ms  {name}", flush=True)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "dtype": dtype, "pairs": pairs,
                      **summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
