"""Drive the PyTorch port's 3DMatch DDIM registration on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels (nvcc, sm_90a) from csrc/ and prints the
     build seconds and ptxas' register/shared-memory report;
  3. holds each kernel against its plain PyTorch version on the card, at the
     main path's shapes (KPConv: every distinct layer of the encoder, on the
     activations the encoder really feeds it; attention: the denoiser's self
     shape [2B] and cross shape [B] with the batch's key masks), and times
     the kernel, the plain version and, for attention, PyTorch's
     scaled_dot_product_attention as a yardstick (the port never calls it);
  4. runs the main path at full width (preset_3dmatch: 432-dim, 4 heads,
     17-block KPFCN, 704 coarse tokens per side from 4096-point clouds,
     20 DDIM steps, RANSAC with 8192 hypotheses) with random weights from a
     seed, at condition gate 0 and gate 40: one warm-up and three timed runs
     each (pairs/s from the median), with the kernels' launch counts asserted
     for every run and the outputs checked;
  5. runs one pair through the same port on the CPU (plain versions) and
     holds the card's result against it, and holds RANSAC on the card and
     on the CPU against a known pose (pair 0's coarse points, 40% outliers);
  6. prints the kernels' JSON line, and as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises and exits nonzero. Without CUDA, or outside a checkout of
the repository, it exits nonzero and prints no result.
"""
from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

BATCH_PAIRS = 4
N_POINTS = 4096
STEPS = 20
HYPOTHESES = 8192
GATES = (0.0, 40.0)
TIMED_RUNS = 3
# H100 SXM data-sheet peaks (dense): HBM bandwidth, the tensor cores' TF32
# rate (the kernels' matrix products) and the f32 rate outside them
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
# kernel vs plain version on the card: both sum in f32, in different orders;
# KPConv sums up to K * P * Cin = 307,200 products per output
KPCONV_REL_TOL = 1e-4      # of max |plain output|
ATTENTION_ABS_TOL = 2e-5   # outputs are convex combinations of v ~ N(0, 1)
# the card's full path against the CPU's (plain versions), one pair
CONF_ABS_TOL = 1e-7        # Sinkhorn confidences, valid entries (measured 2.1e-9)
POSE_ABS_TOL = 1e-4        # soft-Procrustes rotation entries / translation (measured 2e-6)
MASK_AGREEMENT = 0.9999    # top-1 union mask: near-ties may flip a few of 495,616 entries


def log(msg: str) -> None:
    print(msg, flush=True)


def time_cuda(fn, iters: int, warmup: int = 2) -> float:
    """Milliseconds per call of ``fn`` on the current stream (CUDA events)."""
    import torch

    for _ in range(warmup):
        fn()
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    stop.record()
    torch.cuda.synchronize()
    return start.elapsed_time(stop) / iters


def wall(fn):
    """(result, seconds) of ``fn`` ending in a device synchronize."""
    import torch

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def bound_ms(nbytes: float, mma_flops: float, f32_flops: float):
    """Least time for the work: bytes at the memory rate, matrix-product flops
    at the dense TF32 tensor-core rate, the other flops at the f32 rate; the
    units run side by side, so the largest of the three. 3xTF32 spends three
    tensor-core products per f32 product, so it can reach at most a third of
    this bound where the products set it."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mma_flops / TF32_FLOPS_PER_S, f32_flops / F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kpconv_work(q, s, inds, x, w):
    """(bytes, matrix-product flops, other flops) of one KPConv call on these inputs."""
    b, nq, k = inds.shape
    ns, cin = x.shape[1], x.shape[2]
    p, _, cout = w.shape
    real = inds < ns                                   # non-sentinel neighbors
    n_nb = int(real.sum())
    n_q = int(real.any(dim=-1).sum())
    nbytes = 4 * (q.numel() + s.numel() + inds.numel() + x.numel() + p * 3 + w.numel()
                  + b * nq * cout)
    # per neighbor: offset and norm (8), per kernel point distance + influence
    # (13), feature-sum test (Cin), influence x features (2 P Cin);
    # per query: the division, and the [P Cin] x Cout contraction (the product)
    flops = n_nb * (8 + 13 * p + cin + 2 * p * cin) + n_q * cout
    return nbytes, n_q * 2 * p * cin * cout, flops


def attention_work(q, k, kv_mask):
    b, h, l, d = q.shape
    s = k.shape[2]
    valid_keys = float(kv_mask.sum())                 # summed over the batch
    nbytes = 4 * (2 * q.numel() + 2 * k.numel()) + kv_mask.numel()
    # QK^T and PV are the products; exp, sum and scale the rest
    return nbytes, h * l * valid_keys * 4 * d, h * l * valid_keys * 3


def check_kpconv(model, batch):
    """Kernel vs plain KPConv at every distinct encoder layer, on the inputs the
    encoder really feeds each layer. Returns the kernel's JSON entry."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.kpconv import kpconv, kpconv_cuda

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args)))
             for m in model.backbone.modules() if isinstance(m, KPConv)]
    with torch.inference_mode():
        model.encode(batch)
    for h in hooks:
        h.remove()
    if len(seen) != 11:
        raise AssertionError(f"expected 11 KPConv calls per encode, saw {len(seen)}")

    shapes = {}
    for mod, (q, s, inds, x) in seen:
        key = (q.shape[1], s.shape[1], inds.shape[2], x.shape[2], mod.weights.shape[2])
        shapes.setdefault(key, [mod, (q, s, inds, x), 0])[2] += 1
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0, "flops": 0.0}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for (nq, ns, k, cin, cout), (mod, (q, s, inds, x), calls) in shapes.items():
            args = (q, s, inds, x.contiguous(), mod.kernel_points, mod.weights.detach(),
                    mod.extent)
            before = kpconv_cuda.launches
            got = kpconv_cuda(*args)
            ref = kpconv(*args)
            torch.cuda.synchronize()
            assert kpconv_cuda.launches == before + 1
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            if not math.isfinite(err) or err > KPCONV_REL_TOL * max(scale, 1.0):
                raise AssertionError(f"kpconv {nq}/{ns}/{k}/{cin}->{cout}: max abs err {err} "
                                     f"(max |plain| {scale})")
            worst = max(worst, err)
            ms = time_cuda(lambda: kpconv_cuda(*args), 20)
            plain = time_cuda(lambda: kpconv(*args), 3, warmup=1)
            work = kpconv_work(q, s, inds, x, mod.weights)
            bms, by = bound_ms(*work)
            tensor_cores = cin >= 64 and cin % 32 == 0 and k <= 40 and cout in (64, 128, 256, 512)
            path = "tensor cores" if tensor_cores else "CUDA cores"
            per_shape.append({"nq": nq, "ns": ns, "k": k, "cin": cin, "cout": cout,
                              "calls": calls, "path": path, "ms": ms, "plain_ms": plain,
                              "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                              "max_abs_plain": scale})
            log(f"kpconv {nq}/{ns}/K{k}/{cin}->{cout} x{calls} ({path}): err {err:.3e} "
                f"(limit {KPCONV_REL_TOL * max(scale, 1.0):.3e}) kernel {ms:.4f} ms plain "
                f"{plain:.4f} ms bound {bms:.4f} ms ({by})")
            totals["ms"] += calls * ms
            totals["plain_ms"] += calls * plain
            for key, val in zip(("bytes", "mma_flops", "flops"), work):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"])
    return {"name": "kpconv", "route": "cuda", "source": "diffreg_tpu_torch/csrc/kpconv.cu",
            "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
            "launches": None, "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": None, "per": "one encode (11 calls)", "shapes": per_shape}


def check_attention(batch, cfg, gen):
    """Kernel vs plain attention at the denoiser's self [2B] and cross [B]
    shapes; times scaled_dot_product_attention as the yardstick."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_plain

    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
    b, length = src_mask.shape
    cases = [("self", torch.cat([src_mask, tgt_mask]), 3),   # 3 self layers, [2B] each
             ("cross", tgt_mask, 3), ("cross_back", src_mask, 3)]
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0,
              "flops": 0.0}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for name, kv_mask, calls in cases:
            bb = kv_mask.shape[0]
            q, k, v = (torch.randn(bb, h, length, d, generator=gen).cuda() for _ in range(3))
            kv_mask = kv_mask.contiguous()
            before = masked_attention_cuda.launches
            got = masked_attention_cuda(q, k, v, kv_mask, scale)
            ref = masked_attention_plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert masked_attention_cuda.launches == before + 1
            err = float((got - ref).abs().max())
            if not math.isfinite(err) or err > ATTENTION_ABS_TOL:
                raise AssertionError(f"attention {name}: max abs err {err}")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=scale)
            lib_err = float((lib - ref).abs().max())
            ms = time_cuda(lambda: masked_attention_cuda(q, k, v, kv_mask, scale), 20)
            plain = time_cuda(lambda: masked_attention_plain(q, k, v, kv_mask, scale), 10)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            nbytes, mma_flops, flops = attention_work(q, k, kv_mask)
            bms, by = bound_ms(nbytes, mma_flops, flops)
            per_shape.append({"case": name, "b": bb, "h": h, "l": length, "s": length, "d": d,
                              "calls": calls, "ms": ms, "plain_ms": plain, "library_ms": lib_ms,
                              "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                              "library_max_abs_err": lib_err})
            log(f"attention {name} [{bb},{h},{length},{d}] x{calls}: err {err:.3e} (limit "
                f"{ATTENTION_ABS_TOL:.1e}) kernel "
                f"{ms:.4f} ms plain {plain:.4f} ms sdpa {lib_ms:.4f} ms (err {lib_err:.3e}) "
                f"bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("mma_flops", mma_flops), ("flops", flops)):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"])
    return {"name": "masked_attention", "route": "cuda",
            "source": "diffreg_tpu_torch/csrc/attention.cu",
            "replaces": "diffreg_tpu/ops/pallas/attention_kernel.py:24",
            "launches": None, "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": totals["library_ms"], "per": "one DDIM step (9 calls)",
            "shapes": per_shape}


def check_outputs(out, tag):
    import torch

    for key in ("conf_matrix_pred", "rotation_pred", "translation_pred", "ransac_rotation",
                "ransac_translation"):
        if not bool(torch.isfinite(out[key]).all()):
            raise AssertionError(f"{tag}: {key} is not finite")
    for key in ("rotation_pred", "ransac_rotation"):
        r = out[key].double()
        eye = torch.eye(3, dtype=r.dtype, device=r.device)
        orth = float((r @ r.transpose(1, 2) - eye).abs().max())
        det = torch.linalg.det(r)
        if orth > 1e-4 or float((det - 1).abs().max()) > 1e-4:
            raise AssertionError(f"{tag}: {key} not a rotation (orth {orth}, det {det.tolist()})")


def check_ransac(src, rot, trn, u, gen):
    import torch

    from diffreg_tpu_torch.eval.ransac import ransac_pose

    src = src.cpu()[None]
    tgt = src @ rot.T + trn.T
    # outliers: moved 0.3 to 0.8 m off their true position, so none is an inlier
    outliers = torch.rand(src.shape[1], generator=gen) < 0.4
    away = torch.randn(int(outliers.sum()), 3, generator=gen)
    away = away / away.norm(dim=1, keepdim=True) * (0.3 + 0.5 * torch.rand(len(away), 1,
                                                                               generator=gen))
    tgt[0, outliers] += away
    valid = torch.ones(src.shape[:2], dtype=torch.bool)
    poses = {"card": ransac_pose(u.cuda(), src.cuda(), tgt.cuda(), valid.cuda()),
             "CPU": ransac_pose(u, src, tgt, valid)}
    for name, res in poses.items():
        err = max(float((res.rotation[0].cpu() - rot).abs().max()),
                  float((res.translation[0].cpu() - trn).abs().max()))
        log(f"RANSAC on the {name}: {int(res.inlier_count[0])} inliers of {src.shape[1]} "
            f"({int((~outliers).sum())} true), pose error {err:.3e}")
        if not err <= POSE_ABS_TOL:
            raise AssertionError(f"RANSAC on the {name} missed the ground-truth pose by {err}")


def main() -> int:
    try:
        import numpy as np
        import torch
    except ImportError:
        print("chip_smoke: numpy and torch are needed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available", file=sys.stderr)
        return 1
    repo = os.path.dirname(os.path.abspath(__file__))
    sys.path.insert(0, repo)
    try:
        from diffreg_tpu_torch.data.calibrate import calibrate_spec
        from diffreg_tpu_torch.data.pyramid import PyramidConfig
        from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
        from diffreg_tpu_torch.eval.register import correspond_and_ransac, register
        from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
        from diffreg_tpu_torch.models.presets import preset_3dmatch, with_condition_gate
        from diffreg_tpu_torch.ops.attention import masked_attention_cuda
        from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
        from diffreg_tpu_torch.utils.cuda import build_kernels
    except ImportError as e:
        print(f"chip_smoke: the port is not importable here ({e}); run from a checkout",
              file=sys.stderr)
        return 1

    t_start = time.perf_counter()
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          check=True, timeout=60).stdout.strip().splitlines()[0]
    log(card)
    log(f"torch {torch.__version__} cuda {torch.version.cuda} device "
        f"{torch.cuda.get_device_name(0)} x{torch.cuda.device_count()}")

    # ---- 2. build ----
    t0 = time.perf_counter()
    report = build_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.2f} s "
        f"({', '.join(f'{k} {v['seconds']:.2f} s' for k, v in report.items())})")
    for name, rep in report.items():
        for line in rep["log"].splitlines():
            if "Function properties" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")

    # ---- data and model ----
    t0 = time.perf_counter()
    pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    cal_rng = np.random.RandomState(0)
    spec = calibrate_spec([make_pair(cal_rng, N_POINTS)[:2] for _ in range(2)], pcfg,
                          k_cap=40, neighbor_percentile=90.0)
    batch_cpu, _, _ = synthetic_batch(batch_size=BATCH_PAIRS, n_points=N_POINTS, seed=0,
                                      spec=spec, cfg=pcfg)
    log(f"spec {spec}; host data {time.perf_counter() - t0:.2f} s")
    batch = batch_cpu.to("cuda")
    cfg = preset_3dmatch(sample_steps=STEPS)
    models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cuda", seed=0)
              for gate in GATES}
    gen = torch.Generator().manual_seed(0)
    x_init = torch.randn(BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(BATCH_PAIRS, HYPOTHESES, 3, generator=gen)

    # ---- 3. kernels against their plain versions ----
    kernels = [check_kpconv(models[0.0], batch), check_attention(batch, cfg, gen)]

    # ---- 4. the main path ----
    results, launches = {}, {"kpconv": 0, "masked_attention": 0}
    for gate, model in models.items():
        register(model, batch, x_init, u)                      # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            out, seconds = wall(lambda: register(model, batch, x_init, u))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != 9 * STEPS:
                raise AssertionError(f"gate {gate}: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want {9 * STEPS})")
            launches["kpconv"] += n_kp
            launches["masked_attention"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        check_outputs(out, f"gate {gate}")
        with torch.inference_mode():
            _, enc_s = wall(lambda: model.encode(batch))
            ddim_out, ddim_s = wall(lambda: model.ddim_sample(batch, x_init.cuda()))
            _, ransac_s = wall(lambda: correspond_and_ransac(ddim_out, u.cuda()))
        results[gate] = out
        cond = out.get("step_condition")
        accepted = "" if cond is None else \
            f", warps accepted {int((cond < gate).sum())}/{cond.numel()}"
        log(f"main path gate {gate}: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = "
            f"{BATCH_PAIRS / seconds:.3f} pairs/s; encode {enc_s:.4f} s, DDIM "
            f"{ddim_s - enc_s:.4f} s, correspondences + RANSAC {ransac_s:.4f} s; "
            f"launches kpconv {n_kp} attention {n_at}{accepted}; peak memory "
            f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
    kernels[0]["launches"] = launches["kpconv"]
    kernels[1]["launches"] = launches["masked_attention"]

    # ---- 5. one pair through the same port on the CPU ----
    one = batch_cpu.select(slice(0, 1))
    for gate in GATES:
        cpu_model = DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cpu", seed=0)
        t0 = time.perf_counter()
        ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
        cpu_s = time.perf_counter() - t0
        got = {k: v[:1].cpu() for k, v in results[gate].items() if k != "step_condition"}
        valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
        conf_err = float((got["conf_matrix_pred"] - ref["conf_matrix_pred"]).abs()[valid].max())
        rot_err = float((got["rotation_pred"] - ref["rotation_pred"]).abs().max())
        trn_err = float((got["translation_pred"] - ref["translation_pred"]).abs().max())
        mask_agree = float((got["corr_mask"] == ref["corr_mask"])[valid].float().mean())
        log(f"card vs CPU gate {gate} (CPU {cpu_s:.1f} s): conf {conf_err:.3e}, corr_mask "
            f"agreement {mask_agree:.6f}, rotation {rot_err:.3e}, translation {trn_err:.3e}")
        if not conf_err <= CONF_ABS_TOL:
            raise AssertionError(f"gate {gate}: conf differs from the CPU run by {conf_err}")
        if not mask_agree >= MASK_AGREEMENT:
            raise AssertionError(f"gate {gate}: corr_mask agrees on {mask_agree} of entries")
        if not max(rot_err, trn_err) <= POSE_ABS_TOL:
            raise AssertionError(f"gate {gate}: pose differs from the CPU run by "
                                 f"{max(rot_err, trn_err)}")
        check_outputs(ref, f"CPU gate {gate}")

    # ---- RANSAC against the ground truth, on the card and on the CPU ----
    # With random weights the path's correspondences are noise, where ties
    # among near-equal hypotheses decide the pose; so RANSAC is held on pair
    # 0's coarse source points under its ground-truth pose, 40% outliers.
    check_ransac(results[0.0]["s_pcd"][0, :int(batch_cpu.src_mask[0].sum())],
                 batch_cpu.rot_gt[0], batch_cpu.trn_gt[0], u[:1], gen)

    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
