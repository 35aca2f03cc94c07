"""Where the device time goes in the PyTorch port's 4DMatch path, on one CUDA card.

Builds chip_smoke.py's 4DMatch configuration (preset_4dmatch at full width:
528-dim, 4 heads of 132, gate 40, the stochastic DDIM with 20 steps; 4
deformable pairs of 4096 points at scene scale 1/3 and the spec calibrated
from such pairs; random weights from seed 0), warms ``FourDMatchTester.test`` up
(IR and NFMR included), then records one call with ``torch.profiler`` and
prints, as tools/profile_port.py does for the 3DMatch path: the call's wall
time, the device's busy time and idle share, the device launches per DDIM
step, and the kernels that take the most device time. The last line is one
JSON object with those numbers.

    python3 tools/profile_port_4dmatch.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("profile_port_4dmatch: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import MATCH_THR_4D, METRIC_POINTS, STEPS, deformable_data
    from diffreg_tpu_torch.engine.tester import (FourDMatchTester, TestConfig,
                                                 make_metric_points_fn)
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_4dmatch
    from profile_port import summarize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    batch, meta, spec, _ = deformable_data()
    batch = batch.to("cuda")
    model = DiffusionMatchingModel(preset_4dmatch(STEPS), device="cuda", seed=0)
    tester = FourDMatchTester(model, TestConfig(inlier_thr=0.04, match_thr=MATCH_THR_4D),
                              device="cuda")
    metric_points = make_metric_points_fn(METRIC_POINTS)

    def run():
        return tester.test(lambda: iter([(batch, meta)]),
                           torch.Generator("cuda").manual_seed(0), metric_points)

    with torch.inference_mode():
        run()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = summarize(path, wall_s)
    summary["launches_per_ddim_step"] = summary["kernel_launches"] / STEPS
    print(f"4dmatch (tokens {spec.n_src} x {spec.n_tgt}): wall {wall_s:.4f} s (profiled), device busy "
          f"{summary['device_busy_s']:.4f} s, idle share {summary['idle_share']:.3f}, "
          f"{summary['kernel_launches']} kernel launches "
          f"({summary['launches_per_ddim_step']:.0f} per DDIM step)", flush=True)
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}", flush=True)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": batch.batch_size,
                      "ddim_steps": STEPS, "tokens": [spec.n_src, spec.n_tgt],
                      "4dmatch": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
