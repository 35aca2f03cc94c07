"""Where the device time goes in the PyTorch port's main path, on one CUDA card.

Builds chip_smoke.py's configuration (preset_3dmatch at full width, 4 pairs
of 4096 points per side, 20 DDIM steps, 8192 RANSAC hypotheses, random
weights from seed 0), warms ``register`` up, then records one ``register``
call per condition gate (0 and 40) with ``torch.profiler`` and prints, from
the recorded trace: the call's wall time, the device's busy time (union of
kernel, memcpy and memset intervals) and idle share, the device launches
per DDIM step, and the kernels that take the most device time. The last
line is one JSON object with those numbers.

    python3 tools/profile_port.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

DEVICE_CATEGORIES = ("kernel", "gpu_memcpy", "gpu_memset")


def summarize(trace_path: str, wall_s: float, top: int = 12) -> dict:
    """Busy time, idle share and the top kernels of a chrome trace."""
    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    spans, per_name, launches = [], defaultdict(float), 0
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        start, dur = float(ev["ts"]), float(ev.get("dur", 0.0))
        spans.append((start, start + dur))
        per_name[ev["name"][:90]] += dur
        launches += ev["cat"] == "kernel"
    busy, end = 0.0, float("-inf")
    for start, stop in sorted(spans):
        if stop > end:
            busy += stop - max(start, end)
            end = stop
    busy_s = busy * 1e-6
    ranked = sorted(per_name.items(), key=lambda kv: -kv[1])[:top]
    return {"wall_s": wall_s, "device_busy_s": busy_s,
            "idle_share": 1.0 - busy_s / wall_s if wall_s > 0 else None,
            "kernel_launches": launches,
            "top_kernels_ms": [[name, dur * 1e-3] for name, dur in ranked]}


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("profile_port: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch, with_condition_gate

    pairs, n_points, steps, hypotheses = 4, 4096, 20, 8192
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    cal_rng = np.random.RandomState(0)
    spec = calibrate_spec([make_pair(cal_rng, n_points)[:2] for _ in range(2)], pcfg,
                          k_cap=40, neighbor_percentile=90.0)
    batch, _, _ = synthetic_batch(batch_size=pairs, n_points=n_points, seed=0, spec=spec,
                                  cfg=pcfg)
    batch = batch.to("cuda")
    gen = torch.Generator().manual_seed(0)
    x_init = torch.randn(pairs, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(pairs, hypotheses, 3, generator=gen)

    results = {}
    for gate in (0.0, 40.0):
        model = DiffusionMatchingModel(with_condition_gate(preset_3dmatch(steps), gate),
                                       device="cuda", seed=0)
        register(model, batch, x_init, u)
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            register(model, batch, x_init, u)
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
        with tempfile.TemporaryDirectory() as tmp:
            path = os.path.join(tmp, "trace.json")
            prof.export_chrome_trace(path)
            summary = summarize(path, wall_s)
        summary["launches_per_ddim_step"] = summary["kernel_launches"] / steps
        results[f"gate_{gate:g}"] = summary
        print(f"gate {gate}: wall {wall_s:.4f} s (profiled), device busy "
              f"{summary['device_busy_s']:.4f} s, idle share {summary['idle_share']:.3f}, "
              f"{summary['kernel_launches']} kernel launches "
              f"({summary['launches_per_ddim_step']:.0f} per DDIM step)", flush=True)
        for name, ms in summary["top_kernels_ms"]:
            print(f"  {ms:9.3f} ms  {name}", flush=True)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": pairs,
                      "ddim_steps": steps, **results}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
