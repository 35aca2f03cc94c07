"""Where the device time goes in the PyTorch port's 2D-3D path, on one CUDA card.

Builds chip_smoke.py's 2D-3D configuration (configs/test/rgbdv2.yaml at full
width: image UNet 128 / 128, point backbone 64 -> 128, fusion 256-wide with
4 heads of 64, SAMPLE_STEP 50; 4 RGB-D Scenes V2-like pairs written as an
on-disk split, read back through the port's reader, calibrated and cropped to
472 x 624 as main.py does; random weights from seed 0), or with ``--dino``
its phase 17 (configs/test/rgbdv2_dino.yaml: the same pairs cropped to
476 x 630 at stride 14, each with the outputs of the seeded ViT-L/14 towers,
which run before the profiled call), warms
``TwoDThreeDTester.test`` up, then records one call with ``torch.profiler``
and prints: the call's wall time, the device's busy time and idle share, the
device launches per DDIM step, device time by kernel group (attention,
KPConv, GEMMs, convolutions, sort and top-k, eigh, elementwise and
reductions, copies) and the kernels that take the most. The last line is one
JSON object with those numbers.

    python3 tools/profile_port_2d3d.py [--dino]
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time
from collections import defaultdict

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
sys.path.insert(0, os.path.join(REPO, "tools"))

# (group, substrings of a kernel's name), first match wins
GROUPS = (
    ("attention kernel", ("masked_attention_kernel",)),
    ("KPConv kernel", ("kpconv",)),
    ("convolutions (cuDNN)", ("fprop", "dgrad", "wgrad", "conv", "winograd", "fft", "cudnn")),
    ("GEMMs (cuBLAS)", ("gemm", "Gemm", "cutlass", "splitK")),
    ("sort and top-k", ("sort", "Sort", "topk", "TopK", "radix", "bitonic")),
    ("eigh (cuSOLVER)", ("syevj", "syevd", "eig", "jacobi")),
    ("elementwise and reductions", ("elementwise", "reduce", "Reduce", "softmax", "norm",
                                    "Norm", "scan", "Scan", "index", "Index", "gather")),
    ("copies and concatenations", ("Cat", "copy", "Copy", "fill", "Fill")),
)


def group_summary(trace_path: str) -> dict:
    """Device milliseconds per kernel group of a chrome trace."""
    from profile_port import DEVICE_CATEGORIES

    with open(trace_path) as f:
        events = json.load(f)["traceEvents"]
    groups = defaultdict(float)
    for ev in events:
        if ev.get("ph") != "X" or ev.get("cat") not in DEVICE_CATEGORIES:
            continue
        name = ev["name"]
        group = next((g for g, keys in GROUPS if any(k in name for k in keys)), "other")
        groups[group] += float(ev.get("dur", 0.0)) * 1e-3
    return dict(sorted(groups.items(), key=lambda kv: -kv[1]))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--dino", action="store_true",
                    help="configs/test/rgbdv2_dino.yaml with the seeded towers' outputs")
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("profile_port_2d3d: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile

    from chip_smoke import FINE_THR_2D3D, data_2d3d, seeded_towers, write_2d3d_split
    from diffreg_tpu_torch.engine.tester2d3d import Test2D3DConfig, TwoDThreeDTester
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.models.towers import TowerRunner
    from diffreg_tpu_torch.utils.config import load_yaml
    from profile_port import summarize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    name = "rgbdv2_dino.yaml" if args.dino else "rgbdv2.yaml"
    cfg = pipeline_2d3d_config(load_yaml(os.path.join(REPO, "configs", "test", name)))
    stride = cfg.coarse_stride
    towers = TowerRunner(*seeded_towers(), device="cuda") if args.dino else None
    with tempfile.TemporaryDirectory() as root:
        write_2d3d_split(root)
        batch, spec, scenes, pixels = data_2d3d(root, stride=stride, towers=towers)
    del towers
    torch.cuda.empty_cache()
    batch = batch.to("cuda")
    tester = TwoDThreeDTester(DiffReg2D3D(cfg, device="cuda", seed=0),
                              Test2D3DConfig(fine_threshold=FINE_THR_2D3D), device="cuda")

    def run():
        return tester.test(lambda: iter([(batch, scenes)]), torch.Generator("cuda").manual_seed(0))

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
        summary = summarize(path, wall_s, top=15)
        summary["groups_ms"] = group_summary(path)
    summary["launches_per_ddim_step"] = summary["kernel_launches"] / cfg.sample_steps
    print(f"2d3d {name} ({batch.batch_size} pairs, {pixels // stride ** 2} image tokens, "
          f"{batch.points[-1].shape[1]} node slots, {cfg.sample_steps} DDIM steps): wall "
          f"{wall_s:.4f} s (profiled), device busy {summary['device_busy_s']:.4f} s, idle share "
          f"{summary['idle_share']:.3f}, {summary['kernel_launches']} kernel launches "
          f"({summary['launches_per_ddim_step']:.0f} per DDIM step)", flush=True)
    for group, ms in summary["groups_ms"].items():
        print(f"  {ms:9.3f} ms  {group}", flush=True)
    for name, ms in summary["top_kernels_ms"]:
        print(f"  {ms:9.3f} ms  {name}", flush=True)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": batch.batch_size,
                      "config": name, "ddim_steps": cfg.sample_steps,
                      "image_tokens": pixels // stride ** 2,
                      "node_slots": batch.points[-1].shape[1], "2d3d": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
