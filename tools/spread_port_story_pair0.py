"""How far the trained story model's DDIM confidences lie from themselves, on
one CUDA card.

chip_smoke.py phase 18b holds test pair 0 of the synthetic story
(tools/train_synthetic_port.py, the committed weights
snapshot/train-synthetic-torch/params.npz) at batch 1, card against CPU, in
bf16 and in f32 (``chip_smoke.py:STORY_CONF_BF16_REL_TOL`` and
``STORY_CONF_F32_REL_TOL``). A limit tells the precisions apart where it lies
above the card-vs-CPU spread and below the distance between the bf16 and f32
paths. This prints both over 13 draws at batch 1 (the 8 pairs of test batch
0 from the eval's DDIM start, pair 0 from starts of seeds 100-104), relative
to the largest CPU confidence on the valid entries: card vs CPU in bf16 and
in f32, bf16 vs f32 on the card and on the CPU, the share of real source rows
free of a near-tie at 2e-3, and, for the eval's start, the card's batch-8 run
against its batch-1 run. One JSON line a draw; the list also goes to
chiprun_out/spread_port_story_pair0.json.

    python3 tools/spread_port_story_pair0.py
"""
from __future__ import annotations

import dataclasses
import json
import os
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def rel(a, b, valid, top):
    return float((a.cpu() - b.cpu()).abs()[valid].max()) / top


def tie_free(conf, one, valid, rel_limit, top):
    import torch

    c = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top2 = c.topk(2, dim=2).values
    free = ((top2[..., 0] - top2[..., 1]) > 2 * rel_limit * top)[0] & one.src_mask[0]
    return float(free.sum()) / max(int(one.src_mask[0].sum()), 1)


def main() -> int:
    import torch

    import chip_smoke as smoke
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.utils.cuda import build_kernels

    if not torch.cuda.is_available():
        print("spread_port_story_pair0: no CUDA device", file=sys.stderr)
        return 1
    build_kernels()
    tool = smoke.story_tool(REPO)
    path = os.path.join(REPO, smoke.STORY_PARAMS)
    card = tool.load_params(tool.build_model("cuda"), path)
    f32_cfg = dataclasses.replace(
        card.cfg, kpfcn=dataclasses.replace(card.cfg.kpfcn, compute_dtype=None),
        coarse_transformer=dataclasses.replace(card.cfg.coarse_transformer,
                                               compute_dtype=None))
    card_f32 = tool.load_params(DiffusionMatchingModel(f32_cfg, device="cuda"), path)
    cpu = tool.load_params(tool.build_model("cpu"), path)
    cpu_f32 = tool.load_params(DiffusionMatchingModel(f32_cfg, device="cpu"), path)
    b8 = tool.split_batches(tool.TEST_SEED, 1, 8, tool.N_POINTS, "cpu")[0]
    x8 = tool.eval_draws(b8)[0]
    rows = []
    with torch.no_grad():
        card8 = card.ddim_sample(b8.to("cuda"), x8.cuda())["conf_matrix_pred"]
        cases = [(p, None) for p in range(8)] + [(0, s) for s in (100, 101, 102, 103, 104)]
        for p, seed in cases:
            one = b8.select(slice(p, p + 1))
            if seed is None:
                x = x8[p:p + 1]
            else:
                x = torch.randn(x8[:1].shape, generator=torch.Generator().manual_seed(seed))
            valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
            ref = cpu.ddim_sample(one, x)["conf_matrix_pred"]
            top = float(ref[valid].max())
            got = card.ddim_sample(one.to("cuda"), x.cuda())["conf_matrix_pred"]
            f32 = card_f32.ddim_sample(one.to("cuda"), x.cuda())["conf_matrix_pred"]
            ref32 = cpu_f32.ddim_sample(one, x)["conf_matrix_pred"]
            row = {"pair": p, "start_seed": seed, "top": top,
                   "card_vs_cpu": rel(got, ref, valid, top),
                   "card_bf16_vs_card_f32": rel(got, f32, valid, top),
                   "cpu_bf16_vs_cpu_f32": rel(ref, ref32, valid, top),
                   "card_f32_vs_cpu_f32": rel(f32, ref32, valid, top),
                   "tie_free_2e-3": tie_free(ref, one, valid, 2e-3, top)}
            if seed is None:
                row["card_b8_vs_card_b1"] = rel(card8[p:p + 1], got, valid, top)
                row["card_b8_vs_cpu_b1"] = rel(card8[p:p + 1], ref, valid, top)
            rows.append(row)
            print(json.dumps(row), flush=True)
    os.makedirs(os.path.join(REPO, "chiprun_out"), exist_ok=True)
    with open(os.path.join(REPO, "chiprun_out", "spread_port_story_pair0.json"), "w") as f:
        json.dump(rows, f, indent=1)
    print("max card_vs_cpu", max(r["card_vs_cpu"] for r in rows),
          "min card_bf16_vs_card_f32", min(r["card_bf16_vs_card_f32"] for r in rows))
    return 0


if __name__ == "__main__":
    sys.exit(main())
