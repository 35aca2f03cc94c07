"""How far chip_smoke.py phase 22's model variants lie from themselves, card
against CPU, on one CUDA card.

Phase 22 holds pair 0 of variants A and B (``chip_smoke.py:VARIANTS``:
``preset_3dmatch`` at full width with the variant's settings, random weights
from seed 0, the 3DMatch phases' pairs) card against CPU: the DDIM at gate 0
(and at gate 40, the card keeping the CPU's top-k choices) by its
confidences relative to the largest CPU confidence
(``VARIANT_CONF_REL_TOL``), backbone_forward by its confidences
(``VARIANT_BACKBONE_REL_TOL``), mask and pose, and variant A's fitting
regularizer on pair 0's encode (``VARIANT_REG_REL_TOL``). This prints, for
each variant: backbone_forward's confidence difference, soft Procrustes'
top-k cut gap, the pose difference, the mask entries that differ and the
real source rows free of a near-tie at twice a few candidate limits; and for
each DDIM start (CPU-generator seeds 0, 1, ...; phase 22 uses the 4-pair
start of seed 0, whose first pair this is not) the same of the DDIM at gate
0 and gate 40 (with the step conditions' least distance from the gate); once
a variant the regularizer's difference and the discrete choices that flip
(closest's kernel point, the deformable in-range cut); and one train step of
pair 0 at gate 200, card against CPU (``chip_smoke.py:train_step_card_vs_cpu``,
the draws from CPU-generator seeds ``TRAIN_FIRST_SEEDS`` on, variant A's with
the CPU's top-k choices kept, as phase 22 runs it): the loss, the
gradients' worst tensor, median and whole, the parameters after the SGD
step (what phase 8's limits must lie above). One JSON line a draw;
the list also goes to chiprun_out/spread_port_variants.json.

With ``--witness`` it prints instead, for the preset and each variant, why
one train step's loss can lie so far card from CPU (one draw, as
``train_step_card_vs_cpu`` picks it): the loss and its terms on both devices;
the positioning layer's confidences at soft Procrustes' top-k cut and its
condition; the dual-softmax logits' largest magnitude and how far the card's
lie from the CPU's; the loss the CPU's own logits give when rounded in float64
and when moved one float32 ulp (each logit times 1 + r 2^-24, r = +-1 from a
seed); the CPU step whose parameters are moved one ulp likewise; and two
faulty card steps: TF32 matrix products (the port's float32 pin off), and for
a gaussian variant the influence's 2 sigma^2 1% too large; and the card's loss
when it keeps the CPU's top-k choices in soft Procrustes
(``chip_smoke.py:topk_choices``). Then, per variant, the gated DDIM of pair 0
at gate 40 from the starts of seeds 1 to ``START_SEEDS``: each start's least
top-k cut gap in the gated warps and least distance of a step's condition from
the gate, and for the first starts card
against CPU (confidences relative to the largest, pose, mask entries that
differ), with the card's own top-k choices and with the CPU's. With
``--phase22`` it runs chip_smoke.py's phase 22 alone.

    python3 tools/spread_port_variants.py [draws | --witness | --phase22]
"""
from __future__ import annotations

import json
import math
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

DRAWS = 4
TRAIN_FIRST_SEEDS = (0, 10, 20, 30)
TIE_LIMITS = (1e-5, 1e-4, 1e-3)
START_SEEDS = 12
START_CPU_RUNS = 4
ULP = 2.0 ** -24


def main() -> int:
    import torch

    import chip_smoke as smoke
    from diffreg_tpu_torch.engine.loss_library import p2p_fitting_regularizer
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch, with_condition_gate
    from diffreg_tpu_torch.utils.cuda import build_kernels

    if not torch.cuda.is_available():
        print("spread_port_variants: no CUDA device", file=sys.stderr)
        return 1
    build_kernels()
    spec, batch_cpu = smoke.path_data()
    one = batch_cpu.select(slice(0, 1))
    if sys.argv[1:] == ["--witness"]:
        return witness_main(smoke, one)
    if sys.argv[1:] == ["--phase22"]:
        return phase22_main(smoke, spec, batch_cpu)
    draws = int(sys.argv[1]) if len(sys.argv) > 1 else DRAWS
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    rows = []

    def compare(card, cpu):
        conf, ref = card["conf_matrix_pred"].cpu(), cpu["conf_matrix_pred"]
        top = float(ref[valid].max())
        top2 = torch.where(valid, ref, torch.full_like(ref, -1.0)).topk(2, dim=2).values[0]
        return {"conf_rel": float((conf - ref).abs()[valid].max()) / top, "top": top,
                "cut_gap": smoke.cut_gap(ref, one.src_mask, one.tgt_mask),
                "pose": max(float((card[k].cpu() - cpu[k]).abs().max())
                            for k in ("rotation_pred", "translation_pred")),
                "mask_differ": int(((card["corr_mask"].cpu() != cpu["corr_mask"]) & valid).sum()),
                "tie_free_rows": {f"{lim:g}": float(((top2[:, 0] - top2[:, 1]) > 2 * lim * top)[
                    one.src_mask[0]].float().mean()) for lim in TIE_LIMITS}}

    for name in smoke.VARIANTS:
        cfg = smoke.variant_cfg(preset_3dmatch(sample_steps=smoke.STEPS), name)
        models = {(dev, gate): DiffusionMatchingModel(with_condition_gate(cfg, gate),
                                                      device=dev, seed=0)
                  for dev in ("cuda", "cpu") for gate in smoke.GATES}
        for seed in range(draws):
            gen = torch.Generator().manual_seed(seed)
            x_init = torch.randn(1, spec.n_src, spec.n_tgt, generator=gen)
            u = torch.rand(1, smoke.HYPOTHESES, 3, generator=gen)
            row = {"variant": name, "seed": seed}
            for gate in smoke.GATES:
                card = register(models["cuda", gate], one, x_init, u)
                cpu = register(models["cpu", gate], one, x_init, u, device="cpu")
                row[f"gate_{gate:g}"] = compare(card, cpu)
                cond = card.get("step_condition")
                row[f"gate_{gate:g}"]["gate_distance"] = \
                    None if cond is None else float((cond - gate).abs().min())
            if seed == 0:
                card_model, cpu_model = models["cuda", 0.0], models["cpu", 0.0]
                with torch.no_grad():
                    row["backbone"] = compare(card_model.backbone_forward(one.to("cuda")),
                                              cpu_model.backbone_forward(one))
                if smoke.VARIANTS[name]["deformable"]:
                    flips, real = smoke.range_flips(card_model, cpu_model, one)
                    reg = [float(p2p_fitting_regularizer(m).cpu()) for m in (card_model, cpu_model)]
                    row.update(range_flips=flips, real_neighbours=real,
                               regularizer_rel=abs(reg[0] - reg[1]) / abs(reg[1]))
                if smoke.VARIANTS[name]["modes"][1] == "closest":
                    flips, ties, real = smoke.closest_flips(card_model, one)
                    row.update(closest_flips=flips, closest_near_ties=ties, real_neighbours=real)
            print(json.dumps(row), flush=True)
            rows.append(row)
        train_cfg = smoke.variant_cfg(preset_3dmatch(train=True), name)
        loose = dict.fromkeys(("loss", "worst", "median", "global", "update"), math.inf)
        for first in TRAIN_FIRST_SEEDS:
            gaps = smoke.train_step_card_vs_cpu(train_cfg, one, limits=loose,
                                                tag=f" variant {name}", first_seed=first,
                                                align_topk=smoke.VARIANT_ALIGN_TOPK[name])
            row = {"variant": name, "train_first_seed": first, **gaps}
            print(json.dumps(row), flush=True)
            rows.append(row)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "spread_port_variants.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for name in smoke.VARIANTS:
        train = [r for r in rows if r["variant"] == name and "train_first_seed" in r]
        print(f"variant {name} train step, {len(train)} draws: " + ", ".join(
            f"{k} {min(r[k] for r in train):.3e} to {max(r[k] for r in train):.3e}"
            for k in ("loss", "worst", "median", "global", "params", "update")))
        bb = next(r["backbone"] for r in rows if r["variant"] == name and "backbone" in r)
        print(f"variant {name} backbone_forward: card vs CPU confidences {bb['conf_rel']:.3e} "
              f"of the largest, cut gap {bb['cut_gap']:.3e}, pose {bb['pose']:.3e}, "
              f"{bb['mask_differ']} mask entries differ")
        for gate in smoke.GATES:
            spread = [r[f"gate_{gate:g}"]["conf_rel"] for r in rows
                      if r["variant"] == name and "seed" in r]
            print(f"variant {name} DDIM gate {gate:g}: card vs CPU confidences {min(spread):.3e} "
                  f"to {max(spread):.3e} of the largest over {len(spread)} draws")
    return 0


def loss_run(model, one, inputs, dev, faulty=None):
    """One train forward of pair 0 on ``dev`` without a graph, recording every
    dual-softmax call's inputs: (loss, terms, outputs, [(sim, temperature,
    masks)] on the CPU). ``faulty``: a context the forward runs in."""
    import contextlib

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.nn import matching

    calls = []
    original = matching.dual_softmax_conf_matrix

    def recording(sim, temperature, src_mask=None, tgt_mask=None):
        calls.append((sim.detach().cpu(), temperature, src_mask.cpu(), tgt_mask.cpu()))
        return original(sim, temperature, src_mask, tgt_mask)

    matching.dual_softmax_conf_matrix = recording
    batch = one.to(dev)
    try:
        with torch.no_grad(), (faulty or contextlib.nullcontext()):
            out = model.train_forward(batch, **{k: v.to(dev) for k, v in inputs.items()})
            loss, info = diffreg_loss(out, batch, LossConfig())
    finally:
        matching.dual_softmax_conf_matrix = original
    return float(loss), {k: float(v) for k, v in info.items()}, out, calls


def cut_values(layer, one):
    """The positioning layer's confidences around soft Procrustes' top-k cut."""
    top = layer["conf_matrix"][0].detach().cpu().flatten().sort(descending=True).values
    cut = int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    return {"cut": cut, "around": top[cut - 3:cut + 3].tolist(),
            "equal_to_last_kept": int((top == top[cut - 1]).sum()),
            "positive": int((top > 0).sum()), "condition": float(layer["condition"][0])}


def train_witness(smoke, name, one):
    """The train-step witness of ``name`` (a variant, or "preset")."""
    import contextlib

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, focal_correspondence_loss
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch
    from diffreg_tpu_torch.ops import kpconv as kp_ops
    from diffreg_tpu_torch.ops.sinkhorn import dual_softmax_conf_matrix

    cfg = preset_3dmatch(train=True)
    if name != "preset":
        cfg = smoke.variant_cfg(cfg, name)
    cpu = DiffusionMatchingModel(cfg, device="cpu", seed=0)
    card = DiffusionMatchingModel(cfg, device="cuda", seed=0)
    for seed in range(50):
        inputs = cpu.draw_train_inputs(one, torch.Generator().manual_seed(seed))
        if smoke.noisy_warp_cut_gap(cpu, one, inputs) > smoke.CUT_GAP_MIN:
            break
    loss_cpu, terms_cpu, out_cpu, sims_cpu = loss_run(cpu, one, inputs, "cpu")
    loss_card, terms_card, out_card, sims_card = loss_run(card, one, inputs, "cuda")
    # the card keeping the CPU's top-k choices in soft Procrustes
    choices, cut = [], int(max(one.src_mask.sum(), one.tgt_mask.sum()))
    with smoke.topk_choices(record=choices):
        loss_run(cpu, one, inputs, "cpu")
    with smoke.topk_choices(replay=choices, cut=cut) as seen:
        loss_aligned = loss_run(card, one, inputs, "cuda")[0]

    def rel(a, b):
        return abs(a - b) / abs(b)

    row = {"model": name, "draw_seed": seed, "loss_cpu": loss_cpu, "loss_card": loss_card,
           "loss_rel": rel(loss_card, loss_cpu), "loss_rel_aligned": rel(loss_aligned, loss_cpu),
           "topk_aligned": seen,
           "terms_rel": {k: rel(terms_card[k], v) for k, v in terms_cpu.items() if v},
           "terms_cpu": terms_cpu}
    if out_cpu["position_layers"]:
        row["positioning_cpu"] = cut_values(out_cpu["position_layers"][0], one)
        row["positioning_card"] = cut_values(out_card["position_layers"][0], one)
    # the dual-softmax logits and the loss from the CPU's own logits
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    gen = torch.Generator().manual_seed(0)
    logits = []
    for (sim, t, sm, tm), (sim_card, _, _, _) in zip(sims_cpu, sims_card):
        logits.append({"max_abs": float((sim / t).abs().max()),
                       "card_vs_cpu_max_abs": float(((sim_card - sim) / t).abs().max())})
    row["logits"] = logits
    heads = {"focal_coarse": out_cpu["conf_matrix_pred"],
             "loss_matrix_gt_hat": out_cpu["conf_matrix_gt_hat"]}
    witness = {}
    for term, conf in heads.items() if sims_cpu else ():
        # the recorded call that gave this head's confidences
        err, sim, t, sm, tm = min(
            ((float((dual_softmax_conf_matrix(*c) - conf).abs().max()),) + c for c in sims_cpu),
            key=lambda e: e[0])
        sign = torch.randint(0, 2, sim.shape, generator=gen).float() * 2 - 1
        base = float(focal_correspondence_loss(conf, out_cpu["matrix_gt"], valid, LossConfig()))
        f64 = float(focal_correspondence_loss(dual_softmax_conf_matrix(sim.double(), t, sm, tm),
                                              out_cpu["matrix_gt"].double(), valid,
                                              LossConfig()))
        ulp = float(focal_correspondence_loss(
            dual_softmax_conf_matrix(sim * (1 + ULP * sign), t, sm, tm), out_cpu["matrix_gt"],
            valid, LossConfig()))
        witness[term] = {"recorded_err": err, "f64_rel": rel(base, f64),
                         "ulp_rel": rel(ulp, base),
                         "of_loss_f64": abs(base - f64) / abs(loss_cpu),
                         "of_loss_ulp": abs(ulp - base) / abs(loss_cpu)}
    row["final_stage"] = witness
    # the CPU step with its parameters moved one ulp
    moved = DiffusionMatchingModel(cfg, device="cpu", seed=0)
    with torch.no_grad():
        for prm in moved.parameters():
            prm.mul_(1 + ULP * (torch.randint(0, 2, prm.shape, generator=gen).float() * 2 - 1))
    row["cpu_params_ulp_rel"] = rel(loss_run(moved, one, inputs, "cpu")[0], loss_cpu)
    del moved

    @contextlib.contextmanager
    def tf32():
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
        try:
            yield
        finally:
            torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False

    row["fault_tf32_rel"] = rel(loss_run(card, one, inputs, "cuda", tf32())[0], loss_cpu)
    if cfg.kpfcn.kp_influence == "gaussian":
        @contextlib.contextmanager
        def sigma_off():
            original = kp_ops.gaussian_denominator
            kp_ops.gaussian_denominator = lambda e: 1.01 * original(e)
            try:
                yield
            finally:
                kp_ops.gaussian_denominator = original

        row["fault_sigma_rel"] = rel(loss_run(card, one, inputs, "cuda", sigma_off())[0],
                                     loss_cpu)
    return row


def loop_cut_gaps(smoke, model, one, x, u):
    """``register`` of pair 0 on the card from ``x`` and ``u``, and per DDIM step
    the gap at soft Procrustes' top-k cut in the gated warp
    (``chip_smoke.py:cut_gap``). Returns (out, gaps)."""
    from diffreg_tpu_torch.eval.register import register

    warp = model._warp_from_noisy_matrix
    gaps = []

    def recording(xx, s_pcd, t_pcd, src_mask, tgt_mask):
        conf = model.denoising_coarse_matching.sinkhorn(xx, src_mask, tgt_mask)
        gaps.append(smoke.cut_gap(conf, src_mask, tgt_mask))
        return warp(xx, s_pcd, t_pcd, src_mask, tgt_mask)

    model._warp_from_noisy_matrix = recording
    try:
        out = register(model, one.to("cuda"), x.cuda(), u.cuda())
    finally:
        del model._warp_from_noisy_matrix
    return out, gaps


def gate_starts(smoke, name, one):
    """Pair 0 of variant ``name`` at gate 40 from the starts of seeds 1 to
    START_SEEDS: each start's least top-k cut gap in the gated warps and least
    distance of a step's condition from the gate on the card, and for the
    first START_CPU_RUNS starts card against CPU, the card choosing its own
    top-k in soft Procrustes and keeping the CPU's."""
    import torch

    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_3dmatch, with_condition_gate

    cfg = with_condition_gate(smoke.variant_cfg(preset_3dmatch(sample_steps=smoke.STEPS), name),
                              40.0)
    card = DiffusionMatchingModel(cfg, device="cuda", seed=0)
    cpu = DiffusionMatchingModel(cfg, device="cpu", seed=0)
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    cut = int(max(one.src_mask.sum(), one.tgt_mask.sum()))

    def compare(got, ref):
        conf = ref["conf_matrix_pred"]
        return {"conf_rel": float((got["conf_matrix_pred"].cpu() - conf).abs()[valid].max())
                / float(conf[valid].max()),
                "pose": max(float((got[k].cpu() - ref[k]).abs().max())
                            for k in ("rotation_pred", "translation_pred")),
                "mask_differ": int(((got["corr_mask"].cpu() != ref["corr_mask"])
                                    & valid).sum())}

    rows = []
    for seed in range(1, START_SEEDS + 1):
        g = torch.Generator().manual_seed(seed)
        x = torch.randn((1, one.src_mask.shape[1], one.tgt_mask.shape[1]), generator=g)
        u = torch.rand(1, smoke.HYPOTHESES, 3, generator=g)
        got, gaps = loop_cut_gaps(smoke, card, one, x, u)
        row = {"variant": name, "start_seed": seed, "loop_cut_gap_min": min(gaps),
               "gate_distance": float((got["step_condition"] - 40.0).abs().min())}
        if seed <= START_CPU_RUNS:
            choices = []
            with smoke.topk_choices(record=choices):
                ref = register(cpu, one, x, u, device="cpu")
            with smoke.topk_choices(replay=choices, cut=cut) as seen:
                aligned = register(card, one.to("cuda"), x.cuda(), u.cuda())
            row.update(own=compare(got, ref), aligned=compare(aligned, ref), topk=seen)
        print(json.dumps(row), flush=True)
        rows.append(row)
    return rows


def witness_main(smoke, one) -> int:
    rows = []
    for name in ("preset",) + tuple(smoke.VARIANTS):
        row = train_witness(smoke, name, one)
        print(json.dumps(row), flush=True)
        rows.append(row)
    for name in smoke.VARIANTS:
        rows += gate_starts(smoke, name, one)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "spread_port_variants_witness.json"), "w") as f:
        json.dump(rows, f, indent=1)
    return 0


def phase22_main(smoke, spec, batch_cpu) -> int:
    import collections

    import torch

    gen = torch.Generator().manual_seed(0)
    x_init = torch.randn(smoke.BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(smoke.BATCH_PAIRS, smoke.HYPOTHESES, 3, generator=gen)
    entries = smoke.run_variants(REPO, batch_cpu.to("cuda"), batch_cpu, spec, x_init, u,
                                 collections.defaultdict(int), gen)
    print(json.dumps(entries), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
