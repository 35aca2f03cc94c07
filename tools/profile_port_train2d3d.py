"""Where the device time of one 2D-3D training step of the PyTorch port goes,
on one CUDA card.

Builds chip_smoke.py's 2D-3D training configuration (configs/train/rgbdv2.yaml
at full width: image UNet 128 / 128, point backbone 64 -> 128, two fusion
transformers 256-wide with 4 heads of 64, Adam at lr 1e-4; one pair a step of
the RGB-D Scenes V2-like train subset that chip_smoke.py writes, read back
through the port's reader with its augmentation, calibrated and cropped to
472 x 624 as main.py does; random weights from seed 0), takes two warm-up
steps, times three steps without the profiler, then records one step with
``torch.profiler`` in three ranges (forward with the loss, backward,
optimizer) and prints: the step's wall time, the device's busy time and idle
share, the device launches, the device time by phase group (hand-written
forward kernels, the KPConv and attention plain recomputes, cuBLAS, the rest,
the optimizer) and by kernel group (attention, KPConv, GEMMs, convolutions,
sort and top-k, eigh, elementwise and reductions, copies). The last line is
one JSON object with those numbers.

``--story`` profiles the 2D-3D synthetic training story's step instead
(tools/train_synthetic_2d3d_port.py: its model, 4 pairs a step of its pool
batches 0-1, Adam at 5e-4, the circle, focal and fine losses).

    python3 tools/profile_port_train2d3d.py [--story]
"""
from __future__ import annotations

import argparse
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
    args = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    args.add_argument("--story", action="store_true",
                      help="profile the 2D-3D synthetic training story's step")
    args = args.parse_args()
    import torch

    if not torch.cuda.is_available():
        print("profile_port_train2d3d: CUDA is not available", file=sys.stderr)
        return 1
    from torch.profiler import ProfilerActivity, profile, record_function

    from chip_smoke import data_2d3d, write_2d3d_split
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.losses2d3d import loss_2d3d
    from diffreg_tpu_torch.engine.train import OptimConfig, apply_gradients
    from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d
    from diffreg_tpu_torch.main import loss_2d3d_configs, pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.utils.config import load_yaml
    from profile_port_2d3d import group_summary
    from profile_port_train import PHASES, summarize

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.story:
        import train_synthetic_2d3d_port as tool
        from diffreg_tpu_torch.engine.losses2d3d import CircleLossConfig, FineLossConfig

        circle_cfg, fine_cfg = CircleLossConfig(), FineLossConfig()
        pairs = [tool.make_batch(4, seed).to("cuda") for seed in range(2)]
        model = tool.build_model("cuda")
        state = create_train_state_2d3d(model, tool.optim_config(1000))
        label = "2d3d story"
    else:
        raw = load_yaml(os.path.join(REPO, "configs", "train", "rgbdv2.yaml"))
        cfg = pipeline_2d3d_config(raw)
        circle_cfg, fine_cfg = loss_2d3d_configs(raw)
        with tempfile.TemporaryDirectory() as root:
            write_2d3d_split(root, subset="train", seed=8)
            batch, _, _, _ = data_2d3d(root, "train", augment=True)
        pairs = [batch.select(slice(i, i + 1)).to("cuda") for i in range(batch.batch_size)]
        model = DiffReg2D3D(cfg, device="cuda", seed=0)
        state = create_train_state_2d3d(model, OptimConfig(optimizer="adam", lr=1e-4))
        label = "2d3d"
    shape = pairs[0]
    n_pairs = shape.batch_size
    tokens = (shape.image.shape[1] // model.cfg.coarse_stride) \
        * (shape.image.shape[2] // model.cfg.coarse_stride)
    gen = torch.Generator("cuda").manual_seed(0)
    count = [0]

    def step():
        one = pairs[count[0] % len(pairs)]
        count[0] += 1
        with record_function(PHASES[0]):
            out = model.train_forward(one, **model.draw_train_inputs(one, gen))
            loss = loss_2d3d(out, circle_cfg, LossConfig(), batch=one, fine_cfg=fine_cfg)[0]
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
    peak = torch.cuda.max_memory_allocated() / 2**30
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        wall_s = timed()
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        summary = summarize(path, wall_s)
        summary["kernel_groups_ms"] = group_summary(path)
    summary.update(unprofiled_wall_s=plain_walls, peak_gib=peak)
    print(f"{label} train step ({n_pairs} pairs, {tokens} image tokens, "
          f"{shape.points[-1].shape[1]} node slots): wall {wall_s:.4f} s profiled (unprofiled "
          f"{', '.join(f'{w:.4f}' for w in plain_walls)} s), device busy "
          f"{summary['device_busy_s']:.4f} s, idle share {summary['idle_share']:.3f}, "
          f"{summary['kernel_launches']} kernel launches, peak memory {peak:.2f} GiB", flush=True)
    for group, entry in summary["groups"].items():
        print(f"  {entry['ms']:9.3f} ms  {group}", flush=True)
        for name, ms in entry["top_kernels_ms"]:
            print(f"      {ms:9.3f} ms  {name}", flush=True)
    print("by kernel group:", flush=True)
    for group, ms in summary["kernel_groups_ms"].items():
        print(f"  {ms:9.3f} ms  {group}", flush=True)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "pairs": n_pairs,
                      "image_tokens": tokens, "node_slots": shape.points[-1].shape[1],
                      "story" if args.story else "train_2d3d": summary}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
