"""Drive the PyTorch port's 3DMatch registration and training on one CUDA card.

Run from the root of a checkout, on a machine with one NVIDIA card:

    python3 chip_smoke.py

In order, it
  1. prints the card's name and power limit (nvidia-smi);
  2. builds the port's CUDA kernels (nvcc, sm_90a) from csrc/ and prints the
     build seconds and ptxas' register/shared-memory report;
  3. holds each kernel against its plain PyTorch version on the card, at the
     main path's shapes (KPConv: every distinct layer of the encoder, on the
     activations the encoder really feeds it; attention: the self shape [2B]
     and cross shape [B] with the batch's key masks), and times the kernel,
     the plain version and, for attention, PyTorch's
     scaled_dot_product_attention as a yardstick (the port never calls it);
     then, at the same shapes, the gradients through each kernel's autograd
     Function (forward: the kernel; backward: the plain recompute) against
     plain autograd, with the backward's time;
  4. runs the DDIM path (``register``) at full width (preset_3dmatch: 432-dim,
     4 heads, 17-block KPFCN, 704 coarse tokens per side from 4096-point
     clouds, 20 DDIM steps, RANSAC with 8192 hypotheses) with random weights
     from a seed, at condition gate 0 and gate 40: one warm-up and three timed
     runs each (pairs/s from the median), the kernels' launches asserted for
     every run and the outputs checked;
  5. runs one pair of the DDIM path through the same port on the CPU (plain
     versions) and holds the card's result against it, and holds RANSAC on the
     card and on the CPU against a known pose (pair 0's coarse points, 40%
     outliers);
  6. runs ``backbone_forward`` (gate 0) on the same 4 pairs: one warm-up and
     three timed runs, launches asserted, pair 0 held against the CPU;
  7. trains at full width (preset_3dmatch(train=True): gate 200, the
     reference SGD) with the ``Trainer``: one epoch of a warm-up and five
     timed steps on the 4 pairs into a temporary directory, launches, the
     loss and the gradients' finiteness asserted per step, then ``resume``
     from its checkpoint; one more backward checks that every trained
     parameter but the positioning layer's matcher gets a finite gradient;
  8. takes one train step of one pair on the card and on the CPU from the
     same weights and draws and compares the loss, every gradient and the
     parameters after the SGD step;
  9. prints the kernels' JSON line, and as its last line
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
# backbone_forward's confidences come straight from the matcher, not through the
# DDIM loop's last Sinkhorn of a smooth matrix, so the encoder's card-vs-CPU
# difference shows in them: held relative to their largest entry (measured
# 1.2e-5 on the H100; poses and the union mask keep the DDIM phase's limits)
BACKBONE_CONF_REL_TOL = 1e-4
# gradients through each kernel's Function against plain autograd: the backward
# is the same plain recompute, so only the order of its atomic sums differs
GRAD_REL_TOL = 1e-5        # of max |plain gradient| of that input
TRAIN_STEPS = 6            # one warm-up and five timed steps
# one train step, card against CPU (plain versions), one pair. The encoder's
# features differ by ~4e-6 of their scale (the kernels' 3xTF32 sums through 13
# normalised blocks); a difference that size flips a few leaky-ReLU signs,
# max-pool winners and density counts, each of which moves a gradient entry
# discretely. So a gradient tensor's worst entry is held loosely, the median
# over tensors and the whole gradient's relative norm tightly.
LOSS_REL_TOL = 1e-5
GRAD_WORST_TOL = 0.1       # worst tensor: max |card - CPU| / max |CPU gradient| (1.8e-2)
GRAD_MEDIAN_TOL = 5e-3     # median of that over the trained tensors (measured 6.7e-4)
GRAD_GLOBAL_TOL = 1e-2     # ||card - CPU|| / ||CPU|| over all gradients together (1.4e-3)
PARAM_ABS_TOL = 1e-4       # parameters after the SGD step (lr 0.015)
CUT_GAP_MIN = 1e-7         # soft Procrustes' top-k cut must not fall on a near-tie
# the positioning layer's matcher feeds only the detached position code: its
# gradient is exactly zero in the JAX package and None here
NO_GRADIENT = "coarse_transformer.layers.2.0."


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
    with torch.no_grad():
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
    entry = {"name": "kpconv", "route": "cuda", "source": "diffreg_tpu_torch/csrc/kpconv.cu",
             "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
             "launches": None, "max_abs_err": worst, "ms": totals["ms"],
             "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
             "library_ms": None, "per": "one encode (11 calls)", "shapes": per_shape}
    return entry, shapes


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


def grad_case(name, function, inputs, wanted, plain, gen, calls, counter):
    """Gradients of a fixed random projection of ``function``'s output (the
    kernel's autograd Function) against the same through ``plain``, for the
    inputs at positions ``wanted``; one launch per forward. Returns
    (worst relative error, backward ms per call)."""
    import torch

    def leaves():
        return [t.detach().clone().requires_grad_(i in wanted) for i, t in enumerate(inputs)]
    args = leaves()
    before = counter.launches
    out = function(*args)
    assert counter.launches == before + 1, f"{name}: {counter.launches - before} launches"
    if out.grad_fn is None:
        raise AssertionError(f"{name}: the kernel's output has no grad_fn")
    proj = torch.randn(out.shape, generator=gen).to(out.device)
    got = torch.autograd.grad(out, [args[i] for i in wanted], proj, retain_graph=True)
    assert counter.launches == before + 1, f"{name}: the backward launched the kernel"
    ref_args = leaves()
    ref = torch.autograd.grad(plain(*ref_args), [ref_args[i] for i in wanted], proj)
    torch.cuda.synchronize()
    worst = 0.0
    for g, r in zip(got, ref):
        err = float((g - r).abs().max()) / max(float(r.abs().max()), 1e-30)
        if not math.isfinite(err) or err > GRAD_REL_TOL:
            raise AssertionError(f"{name}: gradient differs from plain autograd by {err} "
                                 "of its largest entry")
        worst = max(worst, err)
    ms = time_cuda(lambda: torch.autograd.grad(out, [args[i] for i in wanted], proj,
                                               retain_graph=True), 5, warmup=1)
    log(f"grad {name} x{calls}: dinputs rel err {worst:.3e} (limit {GRAD_REL_TOL:.0e}), "
        f"backward {ms:.4f} ms")
    return worst, ms


def check_gradients(kernels, kp_shapes, batch, cfg, gen):
    """Phase 3b: each kernel's autograd Function at the main path's shapes."""
    import torch

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionFunction, masked_attention_cuda,
                                                 masked_attention_plain)
    from diffreg_tpu_torch.ops.kpconv import KPConvFunction, kpconv, kpconv_cuda

    worst, total = 0.0, 0.0
    for (nq, ns, k, cin, cout), (mod, (q, s, inds, x), calls) in kp_shapes.items():
        ext = mod.extent
        err, ms = grad_case(
            f"kpconv {nq}/{ns}/K{k}/{cin}->{cout}",
            lambda *a: KPConvFunction.apply(*a, ext),
            (q, s, inds, x.contiguous(), mod.kernel_points, mod.weights.detach()), (3, 5),
            lambda *a: kpconv(*a, ext), gen, calls, kpconv_cuda)
        worst, total = max(worst, err), total + calls * ms
    kernels[0].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})

    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
    length = src_mask.shape[1]
    worst, total = 0.0, 0.0
    for name, kv_mask, calls in (("self", torch.cat([src_mask, tgt_mask]), 3),
                                 ("cross", tgt_mask, 3), ("cross_back", src_mask, 3)):
        bb = kv_mask.shape[0]
        qkv = [torch.randn(bb, h, length, d, generator=gen).cuda() for _ in range(3)]
        err, ms = grad_case(
            f"attention {name} [{bb},{h},{length},{d}]",
            lambda *a: MaskedAttentionFunction.apply(*a, scale), (*qkv, kv_mask.contiguous()),
            (0, 1, 2), lambda *a: masked_attention_plain(*a, scale), gen, calls,
            masked_attention_cuda)
        worst, total = max(worst, err), total + calls * ms
    kernels[1].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})


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


def compare_pair(got, ref, valid, tag, conf_tol=CONF_ABS_TOL):
    """Pair 0 of the card's output against the CPU's: confidences within
    ``conf_tol``, the DDIM phase's limits on poses and the union mask."""
    conf_err = float((got["conf_matrix_pred"][:1].cpu() - ref["conf_matrix_pred"]).abs()[valid].max())
    rot_err = float((got["rotation_pred"][:1].cpu() - ref["rotation_pred"]).abs().max())
    trn_err = float((got["translation_pred"][:1].cpu() - ref["translation_pred"]).abs().max())
    mask_agree = float((got["corr_mask"][:1].cpu() == ref["corr_mask"])[valid].float().mean())
    log(f"card vs CPU {tag}: conf {conf_err:.3e} (limit {conf_tol:.3e}), corr_mask agreement "
        f"{mask_agree:.6f}, rotation {rot_err:.3e}, translation {trn_err:.3e}")
    if not conf_err <= conf_tol:
        raise AssertionError(f"{tag}: conf differs from the CPU run by {conf_err}")
    if not mask_agree >= MASK_AGREEMENT:
        raise AssertionError(f"{tag}: corr_mask agrees on {mask_agree} of entries")
    if not max(rot_err, trn_err) <= POSE_ABS_TOL:
        raise AssertionError(f"{tag}: pose differs from the CPU run by {max(rot_err, trn_err)}")


def run_backbone(model, batch, cpu_model, one, launches):
    """Phase 6: ``backbone_forward`` on the card, timed, and pair 0 on the CPU."""
    import torch

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    with torch.no_grad():
        model.backbone_forward(batch)                          # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            out, seconds = wall(lambda: model.backbone_forward(batch))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != 6:
                raise AssertionError(f"backbone_forward: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want 6)")
            launches["kpconv"] += n_kp
            launches["masked_attention"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        for key in ("conf_matrix_pred", "rotation_pred", "translation_pred"):
            if not bool(torch.isfinite(out[key]).all()):
                raise AssertionError(f"backbone_forward: {key} is not finite")
        log(f"backbone_forward gate 0: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {BATCH_PAIRS / seconds:.3f} pairs/s; "
            f"launches kpconv {n_kp} attention {n_at}")
        t0 = time.perf_counter()
        ref = cpu_model.backbone_forward(one)
        cpu_s = time.perf_counter() - t0
        feats, ref_feats = model.encode(batch)[0][:1].cpu(), cpu_model.encode(one)[0]
    rows = one.src_mask
    feat_err = float((feats - ref_feats)[rows].abs().max()) / float(ref_feats[rows].abs().max())
    log(f"encode card vs CPU, pair 0: source features differ by {feat_err:.3e} of their "
        "largest entry")
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    top = float(ref["conf_matrix_pred"][valid].max())
    compare_pair(out, ref, valid, f"backbone_forward (CPU {cpu_s:.1f} s, "
                 f"max confidence {top:.4f})", BACKBONE_CONF_REL_TOL * top)


def trained_grads_finite(model, grads, tag):
    """Every trained parameter but the positioning matcher has a finite gradient."""
    import torch

    missing = [n for (n, _), g in zip(model.named_trained_parameters(), grads)
               if not n.startswith(NO_GRADIENT) and (g is None or not bool(torch.isfinite(g).all()))]
    if missing:
        raise AssertionError(f"{tag}: no finite gradient for {missing}")
    nonzero = sum(int(g is not None and bool((g != 0).any())) for g in grads)
    log(f"{tag}: {len(grads)} trained parameters, {nonzero} with a nonzero gradient, "
        f"all finite but the positioning matcher's")


def run_training(cfg_train, batch, launches):
    """Phase 7: the Trainer for one epoch at full width, then resume."""
    import tempfile

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.logging import Timers

    optim = OptimConfig(steps_per_epoch=TRAIN_STEPS)      # the reference SGD, ExpLR per epoch
    step = make_train_step(LossConfig())
    rows = []

    def counted_step(state, b, inputs, timers=None):
        phases = Timers()
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        state, info = step(state, b, inputs, phases)
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        loss = float(info["loss"])
        if n_kp != 11 or n_at != 15:
            raise AssertionError(f"train step: {n_kp} KPConv launches (want 11), {n_at} "
                                 f"attention launches (want 15)")
        if not math.isfinite(loss) or not bool(info["grads_finite"]):
            raise AssertionError(f"train step: loss {loss}, grads finite "
                                 f"{bool(info['grads_finite'])}")
        launches["kpconv"] += n_kp
        launches["masked_attention"] += n_at
        rows.append({"loss": loss, "grad_norm": float(info["grad_norm"]), **phases.summary()})
        return state, info

    model = DiffusionMatchingModel(cfg_train, device="cuda", seed=0)
    state = create_train_state(model, optim)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(counted_step, state, lambda epoch: ((batch, None)
                                                              for _ in range(TRAIN_STEPS)),
                          TrainerConfig(max_epoch=1, log_every=TRAIN_STEPS, save_dir=tmp),
                          seed=0)
        t0 = time.perf_counter()
        state = trainer.train()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        fresh = create_train_state(DiffusionMatchingModel(cfg_train, device="cuda", seed=1),
                                   optim)
        resumed = Trainer(step, fresh, lambda epoch: iter(()),
                          TrainerConfig(max_epoch=1, save_dir=tmp), seed=0)
        resumed.resume()
    same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                 resumed.state.model.parameters()))
    if not (same and resumed.start_epoch == 1 and resumed.state.step == TRAIN_STEPS
            and resumed.state.optimizer.count == TRAIN_STEPS):
        raise AssertionError(f"resume: params equal {same}, epoch {resumed.start_epoch}, step "
                             f"{resumed.state.step}, updates {resumed.state.optimizer.count}")
    timed = rows[1:]
    med = lambda key: sorted(r[key] for r in timed)[len(timed) // 2]
    step_s = med("forward") + med("backward") + med("optimizer")
    log(f"train (gate 200, {BATCH_PAIRS} pairs, SGD lr {optim.lr}): {TRAIN_STEPS} steps in "
        f"{epoch_s:.3f} s (epoch with checkpoint); per timed step median forward "
        f"{med('forward'):.4f} s, backward {med('backward'):.4f} s, optimizer "
        f"{med('optimizer'):.4f} s = {step_s:.4f} s: {1 / step_s:.3f} steps/s, "
        f"{BATCH_PAIRS / step_s:.3f} pairs/s; peak memory {peak:.2f} GiB; resume ok")
    log("train losses " + ", ".join(f"{r['loss']:.5f}" for r in rows) + "; grad norms "
        + ", ".join(f"{r['grad_norm']:.4f}" for r in rows))
    log("train step seconds (forward, backward, optimizer) " + "; ".join(
        f"{r['forward']:.4f} {r['backward']:.4f} {r['optimizer']:.4f}" for r in rows))

    inputs = model.draw_train_inputs(batch, trainer.generator)
    out = model.train_forward(batch, **inputs)
    params = [p for _, p in model.named_trained_parameters()]
    grads = torch.autograd.grad(diffreg_loss(out, batch, LossConfig())[0], params,
                                allow_unused=True)
    trained_grads_finite(model, grads, f"train backward ({BATCH_PAIRS} pairs)")
    return {"steps_per_s": 1 / step_s, "pairs_per_s": BATCH_PAIRS / step_s,
            "forward_s": med("forward"), "backward_s": med("backward"),
            "optimizer_s": med("optimizer"), "peak_gib": peak,
            "losses": [r["loss"] for r in rows]}


def noisy_warp_cut_gap(model, batch, inputs):
    """Cut gap of soft Procrustes' top-k in the gated warp of the noisy GT matrix."""
    import torch

    from diffreg_tpu_torch.diffusion.schedule import q_sample, signed_fractional_noise
    from diffreg_tpu_torch.models.diffusion_matching import masked_min

    with torch.no_grad():
        x = q_sample(model.schedule, batch.matrix_gt(), inputs["t"],
                     signed_fractional_noise(inputs["g"]))
        x = torch.nan_to_num(x, nan=0.0)
        x = x - masked_min(x, batch.src_mask, batch.tgt_mask)
        conf = model.denoising_coarse_matching.sinkhorn(x, batch.src_mask, batch.tgt_mask)
        return cut_gap(conf, batch.src_mask, batch.tgt_mask)


def cut_gap(conf, src_mask, tgt_mask):
    """Smallest gap, over the pairs, at soft Procrustes' top-k cut."""
    gaps = []
    for i in range(conf.shape[0]):
        top = conf[i].detach().flatten().sort(descending=True).values
        cut = int(max(src_mask[i].sum(), tgt_mask[i].sum()))
        gaps.append(float(top[cut - 1] - top[cut]))
    return min(gaps)


def train_step_card_vs_cpu(cfg_train, one):
    """Phase 8: one train step of one pair on the card and on the CPU."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
    from diffreg_tpu_torch.engine.train import OptimConfig, apply_gradients, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    models = {"CPU": DiffusionMatchingModel(cfg_train, device="cpu", seed=0),
              "card": DiffusionMatchingModel(cfg_train, device="cuda", seed=0)}
    # draws whose noisy-matrix warp cuts its top-k in a wide gap
    for seed in range(50):
        inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(seed))
        warp_gap = noisy_warp_cut_gap(models["CPU"], one, inputs)
        if warp_gap > CUT_GAP_MIN:
            break
    res = {}
    for name, model in models.items():
        dev = "cpu" if name == "CPU" else "cuda"
        batch = one.to(dev)
        state = create_train_state(model, OptimConfig())
        t0 = time.perf_counter()
        out = model.train_forward(batch, **{k: v.to(dev) for k, v in inputs.items()})
        loss, _ = diffreg_loss(out, batch, LossConfig())
        grads = torch.autograd.grad(loss, state.optimizer.params, allow_unused=True)
        finite, _ = apply_gradients(state.optimizer, grads)
        res[name] = {"loss": float(loss.detach()), "finite": bool(finite), "out": out,
                     "grads": [None if g is None else g.cpu() for g in grads],
                     "params": [p.detach().cpu() for p in state.optimizer.params],
                     "seconds": time.perf_counter() - t0}
    cpu, card = res["CPU"], res["card"]
    layer = cpu["out"]["position_layers"][0]
    pos_gap = cut_gap(layer["conf_matrix"], one.src_mask, one.tgt_mask)
    cond = float(layer["condition"][0].detach())
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    names = [n for n, _ in models["CPU"].named_trained_parameters()]
    errs, diff_sq, ref_sq = [], 0.0, 0.0
    for n, g_card, g_cpu in zip(names, card["grads"], cpu["grads"]):
        if (g_card is None) != (g_cpu is None):
            raise AssertionError(f"train step: gradient of {n} is None on one side only")
        if g_cpu is not None:
            diff = (g_card - g_cpu).double()
            errs.append((float(diff.abs().max()) / max(float(g_cpu.abs().max()), 1e-30), n))
            diff_sq += float((diff * diff).sum())
            ref_sq += float((g_cpu.double() ** 2).sum())
    errs.sort(reverse=True)
    worst, median = errs[0][0], errs[len(errs) // 2][0]
    global_err = math.sqrt(diff_sq / ref_sq)
    param_err = max(float((a - b).abs().max()) for a, b in zip(card["params"], cpu["params"]))
    log(f"train step card vs CPU (1 pair, CPU {cpu['seconds']:.1f} s): draw seed {seed}, "
        f"noisy-warp cut gap {warp_gap:.3e}, positioning cut gap {pos_gap:.3e} and condition "
        f"{cond:.3f} (gate 200); loss {card['loss']:.6f} vs {cpu['loss']:.6f} (rel err "
        f"{loss_err:.3e}, limit {LOSS_REL_TOL:.0e}); gradients: worst tensor {worst:.3e} "
        f"(limit {GRAD_WORST_TOL:.0e}), median {median:.3e} (limit {GRAD_MEDIAN_TOL:.0e}), "
        f"global {global_err:.3e} (limit {GRAD_GLOBAL_TOL:.0e}); params after SGD "
        f"{param_err:.3e} (limit {PARAM_ABS_TOL:.0e})")
    log("  worst gradient tensors: " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]))
    trained_grads_finite(models["card"], [None if g is None else g.cuda() for g in card["grads"]],
                         "train step on the card (1 pair)")
    if not (warp_gap > CUT_GAP_MIN and pos_gap > CUT_GAP_MIN and abs(cond - 200.0) > 1.0):
        raise AssertionError("train step: a top-k cut or the gate falls on a near-tie")
    if not (card["finite"] and cpu["finite"]):
        raise AssertionError("train step: non-finite gradients")
    if not loss_err <= LOSS_REL_TOL:
        raise AssertionError(f"train step: loss differs from the CPU's by {loss_err}")
    if not (worst <= GRAD_WORST_TOL and median <= GRAD_MEDIAN_TOL
            and global_err <= GRAD_GLOBAL_TOL):
        raise AssertionError(f"train step: gradients differ from the CPU's (worst {worst}, "
                             f"median {median}, global {global_err})")
    if not param_err <= PARAM_ABS_TOL:
        raise AssertionError(f"train step: parameters differ by {param_err} after the update")


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
    one = batch_cpu.select(slice(0, 1))
    cfg = preset_3dmatch(sample_steps=STEPS)
    models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cuda", seed=0)
              for gate in GATES}
    cpu_models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cpu",
                                               seed=0) for gate in GATES}
    gen = torch.Generator().manual_seed(0)
    x_init = torch.randn(BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
    u = torch.rand(BATCH_PAIRS, HYPOTHESES, 3, generator=gen)

    # ---- 3. kernels against their plain versions, forward and gradients ----
    kpconv_entry, kp_shapes = check_kpconv(models[0.0], batch)
    kernels = [kpconv_entry, check_attention(batch, cfg, gen)]
    check_gradients(kernels, kp_shapes, batch, cfg, gen)
    del kp_shapes

    # ---- 4. the DDIM path ----
    torch.cuda.reset_peak_memory_stats()      # the gradient checks above are not its peak
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

    # ---- 5. one pair of the DDIM path through the same port on the CPU ----
    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    for gate in GATES:
        t0 = time.perf_counter()
        ref = register(cpu_models[gate], one, x_init[:1], u[:1], device="cpu")
        compare_pair(results[gate], ref, valid,
                     f"gate {gate} (CPU {time.perf_counter() - t0:.1f} s)")
        check_outputs(ref, f"CPU gate {gate}")

    # ---- RANSAC against the ground truth, on the card and on the CPU ----
    # With random weights the path's correspondences are noise, where ties
    # among near-equal hypotheses decide the pose; so RANSAC is held on pair
    # 0's coarse source points under its ground-truth pose, 40% outliers.
    check_ransac(results[0.0]["s_pcd"][0, :int(batch_cpu.src_mask[0].sum())],
                 batch_cpu.rot_gt[0], batch_cpu.trn_gt[0], u[:1], gen)
    del results

    # ---- 6. backbone_forward ----
    run_backbone(models[0.0], batch, cpu_models[0.0], one, launches)
    del models, cpu_models

    # ---- 7. training at full width through the Trainer, then resume ----
    cfg_train = preset_3dmatch(train=True)
    run_training(cfg_train, batch, launches)

    # ---- 8. one train step, card against CPU ----
    train_step_card_vs_cpu(cfg_train, one)

    kernels[0]["launches"] = launches["kpconv"]
    kernels[1]["launches"] = launches["masked_attention"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
