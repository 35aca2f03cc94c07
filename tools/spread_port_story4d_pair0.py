"""How far the trained 4DMatch story model's DDIM lies from itself, card
against CPU, on one CUDA card.

chip_smoke.py phase 20c holds test pair 0 of the 4DMatch story
(tools/train_synthetic_4d_port.py, the committed weights
snapshot/train-synthetic-4d-torch/params.npz) at batch 1, card against CPU,
in bf16 and in f32 (``chip_smoke.py:STORY4D_LIMITS``), at the protocol's
threshold 0.55. A limit tells the precisions apart where it lies above the
card-vs-CPU spread and below the distance between the bf16 and f32 paths.
This prints both over 11 draws at batch 1 (the 8 pairs of test batch 0 from
the eval's fixed draws, pair 0 from the draws of CPU-generator seeds 1-3, as
phase 20c draws them): the sigmoid confidences relative to the largest CPU
confidence on the valid entries and the pose's largest entry difference,
card vs CPU in bf16 and in f32, bf16 vs f32 on the card and on the CPU; at
0.55 the match counts, the thr-mutual entries that differ, IR and NFMR; the
share of real source rows free of a near-tie and of the threshold at several
limits; the card's smallest top-k cut gap and distance of a step condition
from the gate; and, for the eval's draws, the card's batch-8 run against its
batch-1 run. One JSON line a draw; the list also goes to
chiprun_out/spread_port_story4d_pair0.json.

    python3 tools/spread_port_story4d_pair0.py
"""
from __future__ import annotations

import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

TIE_LIMITS = (1e-3, 3e-3, 1e-2, 3e-2)


def rel(a, b, valid, top):
    return float((a.cpu() - b.cpu()).abs()[valid].max()) / top


def tie_free(conf, one, valid, rel_limit, top, thr):
    """Share of the real source rows whose best two confidences lie more than
    twice ``rel_limit`` (of ``top``) apart and whose best lies that far from
    ``thr``."""
    import torch

    near = 2 * rel_limit * top
    top2 = torch.where(valid, conf, torch.full_like(conf, -1.0)).topk(2, dim=2).values[0]
    free = ((top2[:, 0] - top2[:, 1]) > near) & ((top2[:, 0] - thr).abs() > near)
    return float((free & one.src_mask[0]).sum()) / max(int(one.src_mask[0].sum()), 1)


def main() -> int:
    import torch

    import chip_smoke as smoke
    from diffreg_tpu_torch.utils.cuda import build_kernels

    if not torch.cuda.is_available():
        print("spread_port_story4d_pair0: no CUDA device", file=sys.stderr)
        return 1
    build_kernels()
    tool = smoke.story_tool(REPO, "train_synthetic_4d_port")
    path = os.path.join(REPO, smoke.STORY4D_PARAMS)
    models = {}
    for name, dtype, precision in (("bf16", "bfloat16", None), ("f32", None, "highest")):
        for dev in ("cuda", "cpu"):
            models[name, dev] = tool.load_params(tool.build_model(dev, dtype, precision), path)
    gate = models["bf16", "cuda"].cfg.procrustes.max_condition_num
    steps = models["bf16", "cuda"].cfg.sample_steps
    b8, m8 = tool.deformable_batch(smoke.STORY4D_BATCH, tool.TEST_SEED)
    x8, noise8 = tool.eval_draws(b8, steps)
    rows = []
    with torch.no_grad():
        card8 = models["bf16", "cuda"].ddim_sample(b8.to("cuda"), x8.cuda(),
                                                   ddim_noise=noise8.cuda())["conf_matrix_pred"]
        cases = [(p, None) for p in range(smoke.STORY4D_BATCH)] + [(0, s) for s in (1, 2, 3)]
        for p, seed in cases:
            one = b8.select(slice(p, p + 1))
            metric = tuple(m[p:p + 1] for m in m8)
            if seed is None:
                x, noise = x8[p:p + 1], noise8[:, p:p + 1]
            else:
                g = torch.Generator().manual_seed(seed)
                x = torch.randn(x8[:1].shape, generator=g)
                noise = torch.randn(noise8[:, :1].shape, generator=g)
            valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
            out, gaps = {}, {}
            for key, model in models.items():
                dev = key[1]
                out[key], gaps[key] = smoke.ddim_cut_gaps_4d(
                    model, one.to(dev), x.to(dev), noise.to(dev))
                out[key] = {k: v.cpu() for k, v in out[key].items()}
            top = float(out["bf16", "cpu"]["conf_matrix_pred"][valid].max())
            row = {"pair": p, "draw_seed": seed, "top": top}
            for name in ("bf16", "f32"):
                got, ref = out[name, "cuda"], out[name, "cpu"]
                mask, ref_mask = tool.match_mask(got, one), tool.match_mask(ref, one)
                (ir, nf, n), (rir, rnf, rn) = (
                    (float(v[0]) for v in tool.pair_metrics(o, one, metric)) for o in (got, ref))
                row[name] = {
                    "card_vs_cpu": rel(got["conf_matrix_pred"], ref["conf_matrix_pred"], valid,
                                       top),
                    "pose_card_vs_cpu": max(float((got[k] - ref[k]).abs().max())
                                            for k in ("rotation_pred", "translation_pred")),
                    "matches": [int(n), int(rn)], "mask_differ": int((mask != ref_mask).sum()),
                    "ir": [ir, rir], "nfmr": [nf, rnf],
                    "card_cut_gap_min": min(gaps[name, "cuda"]),
                    "card_gate_clear": float((got["step_condition"] - gate).abs().min()),
                    "cpu_gate_clear": float((ref["step_condition"] - gate).abs().min())}
            row["card_bf16_vs_card_f32"] = rel(out["bf16", "cuda"]["conf_matrix_pred"],
                                               out["f32", "cuda"]["conf_matrix_pred"], valid, top)
            row["cpu_bf16_vs_cpu_f32"] = rel(out["bf16", "cpu"]["conf_matrix_pred"],
                                             out["f32", "cpu"]["conf_matrix_pred"], valid, top)
            row["pose_card_bf16_vs_f32"] = max(
                float((out["bf16", "cuda"][k] - out["f32", "cuda"][k]).abs().max())
                for k in ("rotation_pred", "translation_pred"))
            row["tie_free"] = {f"{lim:g}": tie_free(out["bf16", "cpu"]["conf_matrix_pred"], one,
                                                    valid, lim, top, tool.MATCH_THR)
                               for lim in TIE_LIMITS}
            if seed is None:
                row["card_b8_vs_card_b1"] = rel(card8[p:p + 1],
                                                out["bf16", "cuda"]["conf_matrix_pred"], valid,
                                                top)
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "spread_port_story4d_pair0.json"), "w") as f:
        json.dump(rows, f, indent=1)
    for name in ("bf16", "f32"):
        print(f"{name}: card vs CPU {min(r[name]['card_vs_cpu'] for r in rows):.3e} to "
              f"{max(r[name]['card_vs_cpu'] for r in rows):.3e}, pose to "
              f"{max(r[name]['pose_card_vs_cpu'] for r in rows):.3e}")
    print(f"bf16 vs f32: card {min(r['card_bf16_vs_card_f32'] for r in rows):.3e} to "
          f"{max(r['card_bf16_vs_card_f32'] for r in rows):.3e}, CPU "
          f"{min(r['cpu_bf16_vs_cpu_f32'] for r in rows):.3e} to "
          f"{max(r['cpu_bf16_vs_cpu_f32'] for r in rows):.3e}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
