"""How far one bf16 train step of pair 0 lies from itself, on one CUDA card.

chip_smoke.py holds the bf16 train step of one pair, card (the kernels' bf16
instances) against CPU (the plain bf16 versions), to limits that must lie
between the two devices' spread and the gap between the card's bf16 and f32
steps (``chip_smoke.py:TRAIN_BF16_LIMITS``). This prints both, on
chip_smoke.py's training configuration (preset_3dmatch(train=True) through
``with_fast_path``, pair 0 of its 4-pair batch, random weights from seed 0):
for each of ten draws (t, g, Euler angles from ``torch.Generator`` seeds
0-9), the card against the CPU and the card's bf16 step against its f32 step
(loss, worst tensor, median tensor, whole gradient, as ``step_gaps``
measures them); then the CPU's bf16 step at 4 and 2 threads against the
default thread count. The last line is one JSON object with those numbers.

    python3 tools/spread_port_train_bf16.py
"""
from __future__ import annotations

import json
import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)
DRAWS = 10
KEYS = ("loss", "worst", "median", "global")


def main() -> int:
    import argparse

    import numpy as np
    import torch

    parser = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    parser.add_argument("--4dmatch", dest="deformable", action="store_true")
    args = parser.parse_args()

    if not torch.cuda.is_available():
        print("spread_port_train_bf16: CUDA is not available", file=sys.stderr)
        return 1
    import chip_smoke as smoke
    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch, preset_4dmatch, with_fast_path

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    print(card, flush=True)
    if args.deformable:
        batch = smoke.deformable_data()[0]
        cfg = preset_4dmatch(sample_steps=smoke.STEPS)
        loss_cfg = LossConfig(**smoke.LOSS_4D)
    else:
        pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
        cal_rng = np.random.RandomState(0)
        spec = calibrate_spec([make_pair(cal_rng, smoke.N_POINTS)[:2] for _ in range(2)], pcfg,
                              k_cap=40, neighbor_percentile=90.0)
        batch, _, _ = synthetic_batch(batch_size=smoke.BATCH_PAIRS, n_points=smoke.N_POINTS,
                                      seed=0, spec=spec, cfg=pcfg)
        cfg = preset_3dmatch(train=True)
        loss_cfg = LossConfig()
    one = batch.select(slice(0, 1))
    models = {"CPU": DiffusionMatchingModel(with_fast_path(cfg), device="cpu", seed=0),
              "card": DiffusionMatchingModel(with_fast_path(cfg), device="cuda", seed=0),
              "card f32": DiffusionMatchingModel(cfg, device="cuda", seed=0)}
    names = [n for n, _ in models["CPU"].named_trained_parameters()]

    def step(name, inputs):
        """Loss and gradients of one train step, in ``step_gaps``' form."""
        model = models[name]
        dev = "cpu" if name == "CPU" else "cuda"
        b = one.to(dev)
        params = [p for _, p in model.named_trained_parameters()]
        out = model.train_forward(b, **{k: v.to(dev) for k, v in inputs.items()})
        loss, _ = diffreg_loss(out, b, loss_cfg)
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return {"loss": float(loss.detach()),
                "grads": [None if g is None else g.cpu() for g in grads]}

    draws = []
    for seed in range(DRAWS):
        inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(seed))
        steps = {name: step(name, inputs) for name in models}
        row = {"seed": seed,
               "card_vs_cpu": {k: smoke.step_gaps(steps["card"], steps["CPU"], names)[k]
                               for k in KEYS},
               "bf16_vs_f32": {k: smoke.step_gaps(steps["card"], steps["card f32"], names)[k]
                               for k in KEYS}}
        draws.append(row)
        print(f"draw {seed}: card vs CPU " + ", ".join(
            f"{k} {row['card_vs_cpu'][k]:.3e}" for k in KEYS) + "; card bf16 vs card f32 "
            + ", ".join(f"{k} {row['bf16_vs_f32'][k]:.3e}" for k in KEYS), flush=True)
    inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(1))
    default_threads = torch.get_num_threads()
    base = step("CPU", inputs)
    threads = {}
    for n in (4, 2):
        torch.set_num_threads(n)
        threads[n] = {k: smoke.step_gaps(step("CPU", inputs), base, names)[k] for k in KEYS}
        print(f"CPU at {n} threads against {default_threads}: " + ", ".join(
            f"{k} {threads[n][k]:.3e}" for k in KEYS), flush=True)
    torch.set_num_threads(default_threads)
    print(card)
    print(json.dumps({"device": torch.cuda.get_device_name(0), "variant": cfg.variant,
                      "cpu_threads": default_threads,
                      "draws": draws, "cpu_threads_against_default": threads}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
