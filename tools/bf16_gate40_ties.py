"""The bf16 DDIM's pair 0 at condition gate 40, the card against the CPU, each
on its own soft-Procrustes top-k choices, once under each tie rule of the
top-k: ``torch.topk``'s (``ops/topk.py:top_k``) and the lower index first
(``stable_top_k``, as ``jax.lax.top_k``). chip_smoke.py's phase 8b holds this
pair with the CPU's choices replayed on the card; these are the readings
without the replay, so that what a kernel's sums move and what the tie rule
moves can be told apart. To compare two trees, copy the tool into the other
checkout's ``tools/`` and run it from each in one call.

    python3 tools/bf16_gate40_ties.py

Uses the checkout's chip_smoke.py (its pairs, draws, limits and
``bf16_pair_check``); prints that check's line for each rule, each rule's
time at soft Procrustes' rows and, last, one JSON line. Needs one CUDA card.
"""
import contextlib
import json
import os
import subprocess
import sys
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

GATE = 40.0
RULES = ("top_k", "stable_top_k")


@contextlib.contextmanager
def tie_rule(name):
    """Soft Procrustes takes its top-k with ``ops/topk.py``'s ``name``."""
    from diffreg_tpu_torch.geometry import procrustes
    from diffreg_tpu_torch.ops import topk

    used = "stable_top_k" if hasattr(procrustes, "stable_top_k") else "top_k"
    original = getattr(procrustes, used)
    setattr(procrustes, used, getattr(topk, name))
    try:
        yield
    finally:
        setattr(procrustes, used, original)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("bf16_gate40_ties: CUDA is not available", file=sys.stderr)
        return 1
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import (preset_3dmatch, with_condition_gate,
                                                  with_fast_path)
    from diffreg_tpu_torch.utils.cuda import build_kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip()
    print(card, REPO, flush=True)
    t0 = time.perf_counter()
    build_kernels()
    print(f"build {time.perf_counter() - t0:.1f} s", flush=True)
    spec, batch_cpu = cs.path_data()
    batch, one = batch_cpu.to("cuda"), batch_cpu.select(slice(0, 1))
    gen = torch.Generator().manual_seed(0)                     # chip_smoke's draws
    x_init = torch.randn(cs.BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(cs.BATCH_PAIRS, cs.HYPOTHESES, 3, generator=gen)
    base = with_condition_gate(preset_3dmatch(sample_steps=cs.STEPS), GATE)
    fast = with_condition_gate(with_fast_path(preset_3dmatch(sample_steps=cs.STEPS)), GATE)
    models = {"bf16": DiffusionMatchingModel(fast, device="cuda", seed=0),
              "f32": DiffusionMatchingModel(base, device="cuda", seed=0),
              "cpu": DiffusionMatchingModel(fast, device="cpu", seed=0)}
    lines, log = [], cs.log
    cs.log = lambda msg: (lines.append(msg), log(msg))
    readings = {}
    for rule in RULES:
        with tie_rule(rule):
            got = register(models["bf16"], batch, x_init, u)
            f32 = register(models["f32"], batch, x_init, u)
            ref = register(models["cpu"], one, x_init[:1], u[:1], device="cpu")
            try:
                cs.bf16_pair_check(got, ref, f32, one, models["cpu"], f"gate {GATE}, {rule}")
                held = True
            except AssertionError:
                held = False
        readings[rule] = {"within_phase_8b_limits": held, "line": lines[-1]}
    cs.log = log
    # each rule's time on the card at soft Procrustes' rows ([B, N M], k = max(N, M))
    from diffreg_tpu_torch.ops import topk

    conf = got["conf_matrix_pred"]
    flat, k = conf.reshape(conf.shape[0], -1), max(conf.shape[1:])
    ms = {rule: cs.time_cuda(lambda: getattr(topk, rule)(flat, k), 50) for rule in RULES}
    print(f"top-k of {k} in rows {list(flat.shape)} {flat.dtype}: " + ", ".join(
        f"{rule} {t:.4f} ms" for rule, t in ms.items()), flush=True)
    print(json.dumps({"card": card, "gate": GATE, "readings": readings, "topk_ms": ms,
                      "topk_rows": list(flat.shape), "k": k}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
