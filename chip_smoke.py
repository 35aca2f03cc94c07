"""Drive the PyTorch port's 3DMatch registration (f32 and the bf16 fast path)
and training, its 4DMatch registration, its 2D-3D registration and training
(with and without the DINOv2 / DepthAnything towers) and its CLI on one CUDA
card.

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
     plain autograd, with the backward's time; then the same at the 4DMatch
     shapes (KPConv per layer of preset_4dmatch's encoder, attention at head
     width 132, a self call per side, with its gradients) on the 4DMatch
     phase's data;
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
 8b. the bf16 fast path (compute_dtype bfloat16, precision default, as
     configs/test/3dmatch_fast.yaml sets them): each kernel's bf16 instance
     against its plain bf16 version (KPConv at the 11 layers of a bf16 encode
     on the activations it feeds them, attention at the 3DMatch self and
     cross shapes, D = 108, and at the 4DMatch shapes, D = 132), timed beside
     the plain version and, for attention, SDPA in bf16, and at the edges
     of their tilings (attention at 70 x 45, 1 x 768, 768 x 1, one valid
     key, a key range past the kept logits; KPConv at K 1 and 40, a short
     tile, the kernel-point split on and off, Cin 32 and 512); the bf16 DDIM path
     at full width, gate 0 and 40, one warm-up and three timed runs (pairs/s
     beside the f32 path's of phase 4, peak memory), 11 bf16 KPConv and 180
     bf16 attention launches asserted per run and no f32 kernel launch;
     pair 0 against the port's CPU run in bf16 (confidences, poses, the
     union mask up to near-ties; the card's bf16-vs-f32 gap printed); and
     ``diffreg_tpu_torch.main`` on configs/test/3dmatch_fast.yaml with --demo;
  9. runs the 4DMatch path at full width through FourDMatchTester
     (preset_4dmatch: 528-dim, 4 heads of 132, gate 40, stochastic DDIM with
     20 steps) on 4 deformable pairs of 4096 points at scene scale 1/3, at the
     spec calibrated from such pairs as main.py calibrates (704 source and 768
     target tokens, so each self layer is one call per side), with the DDIM
     start, the noise and the metric points from seeded generators: one
     warm-up and three timed runs (pairs/s from the median), 11 KPConv and
     the spec's attention launches (12 a DDIM step) asserted per forward,
     matches, IR and NFMR printed;
 10. runs pair 0 of that path on the CPU with the same weights and draws and
     holds the sigmoid confidences, the soft-Procrustes pose, the thr-mutual
     match mask, IR and NFMR against the card's;
 11. runs the entry point ``diffreg_tpu_torch.main`` in a temporary working
     directory: configs/test/4dmatch.yaml with --demo at the protocol's
     threshold 0.55; the same config on phase 9's pairs written as an
     on-disk 4DMatch split with a checkpoint of random weights (main's own
     calibration from the YAML's pyramid, the loader, the restore, NFMR on
     the metric_index points; matches asserted at MATCH_THR_4D);
     configs/test/3dmatch.yaml with --demo; and configs/train/4dmatch.yaml
     with --demo --mode train (its max_epoch cut to 1: two steps and a
     checkpoint), each with its summary and launches checked;
 12. writes 4 RGB-D Scenes V2-like pairs as an on-disk split (16-bit depth
     and 8-bit colour PNGs of a smooth scene on a 480 x 640 Kinect sensor,
     clouds of 30,000 points that partly overlap the view, intrinsics,
     metadata), reads them back through the port's reader, calibrates and
     crops them to 472 x 624 (4602 image tokens) as main.py does, and holds
     both kernels against their plain versions at the 2D-3D shapes: KPConv at
     each distinct layer of the point backbone on the activations it really
     feeds them (K = 64 at level 0), attention at head width 64 in the
     fusion's four shapes with the batch's masks and at a node count that is
     not a multiple of 32, with SDPA's time; the gradients through each
     kernel's Function at the widest KPConv layer and at all four attention
     shapes, with the backward's time;
 13. runs the 2D-3D path at full width (configs/test/rgbdv2.yaml, SAMPLE_STEP
     50, random weights from seed 0) through TwoDThreeDTester: one warm-up
     and three timed runs (pairs/s from the median), 8 KPConv and 612
     attention launches asserted per forward, where the time goes (encode,
     partition, one fusion pass, the DDIM steps, fine matching and PnP);
 14. runs pair 0 on the CPU at 10 DDIM steps with the same weights and draws
     (the matchers sharpened) and holds the Sinkhorn confidences, the top-1
     mask (up to near-ties) and the fine matches on the same coarse
     correspondences against the card's, and in backbone mode the coarse
     matcher's confidences and mask (up to near-ties, at most 1% of its
     entries, with at least half of the real node rows free of a near-tie:
     the DDIM's mask is held only up to near-ties, which cover its rows);
     holds PnP-RANSAC on the card and the CPU against pair 0's known pose
     (40% outlier pixels);
 15. runs ``diffreg_tpu_torch.main`` on configs/test/rgbdv2.yaml and
     7scenes.yaml with --demo, and on the split of phase 12 with a checkpoint
     of random weights (calibration, the PNG reader, the restore, the npz
     cache, eval_from_cache), each with its summary and launches checked;
 16. trains the 2D-3D model at configs/train/rgbdv2.yaml widths (batch 1, Adam
     at lr 1e-4; the circle, focal and fine losses) on a train subset written
     beside the test split (4 more pairs of the same size, read with the
     reader's augmentation): the Trainer for a warm-up and five timed steps
     (forward, backward and optimizer seconds, steps/s, peak memory; 8 KPConv
     and 24 attention launches and finite loss terms and gradients asserted
     per step), then ``resume``; one train step of pair 0 on the card and on
     the CPU from the same weights and draws (the loss, every gradient; the
     draw chosen so that soft Procrustes' top-k cut on the noisy matrix lies
     in a gap wider than the two devices' difference there); and
     ``diffreg_tpu_torch.main --mode train`` on configs/train/rgbdv2.yaml
     with that split (one epoch), its loss terms and checkpoint checked;
 17. runs the published model (configs/test/rgbdv2_dino.yaml: DINOv2 tokens
     fused, DepthAnything centres, stride 14): builds ViT-L/14 DINOv2 and
     DepthAnything with weights from a seed and holds the card's tokens and
     depth on pair 0's 476 x 630 image against the CPU's, with each tower's
     ms an image and peak memory; reads the split at stride 14 (34 x 45 =
     1530 image tokens) with each pair's tower outputs from the card; holds
     KPConv per point-backbone layer and attention in the fusion's four
     shapes (head width 64) against their plain versions; runs the path
     through TwoDThreeDTester (SAMPLE_STEP 50; one warm-up and three timed
     runs, 8 KPConv and 612 attention launches asserted per forward, ms a
     DDIM step, peak memory), pair 0 on the CPU against the card (the 2D-3D
     limits of phase 14) and PnP; and ``diffreg_tpu_torch.main`` on a copy of
     the YAML whose ``towers`` are the seeded towers' state_dicts, on the
     split with a checkpoint of random weights;
 18. prints the kernels' JSON line, and as its last line
     {"ok": true, "device": {"platform": "gpu", "kind": ..., "count": 1}}.
Any failure raises and exits nonzero. Without CUDA, or outside a checkout of
the repository, it exits nonzero and prints no result.
"""
from __future__ import annotations

import dataclasses
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
# 4DMatch phase: deformable pairs at scene scale 1/3 (the 0.01 voxel of
# configs/test/4dmatch.yaml gives the 3DMatch phase's grid), flow 0.1 after
# scaling (tools/train_synthetic_4d.py:49-50); metric points per pair for NFMR
SCALE_4D = 1.0 / 3.0
FLOW_AMP_4D = 0.3
METRIC_POINTS = 2048
# 2D-3D phases: RGB-D Scenes V2-like pairs on a Kinect-sized sensor (the
# reader crops 476 x 630, main.py 472 x 624: 59 x 78 = 4602 image tokens), a
# cloud of 30,000 points that partly overlaps the view, configs/test/rgbdv2.yaml
SENSOR_HW = (480, 640)
CLOUD_POINTS = 30000
KINECT_F = 570.3
STEPS_2D3D_CPU = 10        # pair 0 on the CPU at configs/test/7scenes.yaml's count
PNP_HYPOTHESES = 8192
# Random weights: the image and the cloud encoders are independent random
# networks, so a pixel's and a point's cosine similarity is about N(0, 1/128)
# and the mutual top-2 sit near 0.2; the protocol's 0.75 extracts nothing.
# The tester phase and pair 0 extract at 0 (the CLI runs keep the config's)
FINE_THR_2D3D = 0.0
# Pair 0, card vs CPU. Plain random weights leave the final Sinkhorn
# confidences near-uniform (all ~1.6e-4, every row's best two within 2e-8:
# the top-1 union mask holds 1.8M tied entries a pair); this phase scales
# both matchers' projections by SHARPEN_2D3D, which spreads them (~8k
# entries). Each entry where the two masks differ must lie in a row or
# column whose best two CPU confidences are within twice the confidence
# limit. With random weights the DDIM's final confidences are flat even so
# (no real node row free of a near-tie), so the DDIM mask check excuses every
# differing entry: the DDIM output is held by its confidence limit only, and
# its tie-free share is printed (ROADMAP §3: open until trained weights). The
# tie-free share and the cap hold the coarse matcher, not the DDIM output:
# on the same pair and weights (backbone mode) at least TIE_FREE_ROWS_MIN of
# the real node rows must be free of a near-tie, and at most
# MASK_DIFFER_SHARE of its mask may differ. The fine matches are held on the same coarse
# correspondences (the card's): the card's against the CPU's fine matching
# of the CPU's features.
SHARPEN_2D3D = 8.0
CONF_2D3D_ABS_TOL = 5e-7   # Sinkhorn confidences, valid entries (measured 1.2e-7 DDIM,
#                            3.6e-8 coarse matcher)
FINE_2D3D_AGREEMENT = 0.99  # fine correspondences: shared share of the union (measured 1.0)
PNP_POSE_TOL = 1e-3        # PnP on a known pose (measured 9.6e-6 card, 1.2e-4 CPU)
TIE_FREE_ROWS_MIN = 0.5    # (measured 0.989 of 750 rows, coarse matcher)
MASK_DIFFER_SHARE = 0.01   # plus 2: the CPU test's cap (measured 0 of 5322 entries differ)
# the published model's towers (ViT-L/14, weights from a seed), card against
# CPU: plain f32 (TF32 off) in both, in different orders of summation
TOWER_REL_TOL = 1e-4       # of max |CPU output| (measured 2.0e-6 tokens, 1.3e-5 depth)
# 2D-3D training (configs/train/rgbdv2.yaml, batch 1, Adam lr 1e-4): a step runs
# the coarse and the denoising fusion passes (12 attention calls each) and one
# point-backbone pass (8 KPConv calls); the card-vs-CPU step keeps the 3D
# step's limits (LOSS_REL_TOL, GRAD_*_TOL below)
TIMED_STEPS_2D3D = 5       # after one warm-up step
TRAIN_ATTENTION_2D3D = 24
LOSS_TERMS_2D3D = ("circle", "gt_hat", "fine", "fine_recall", "focal")
# softmax is unchanged by a bias added to every key: those gradients are
# rounding, held apart from the others
KEY_BIAS = "k_token_layer.bias"
KEY_BIAS_TOL = 1e-6
# H100 SXM data-sheet peaks (dense): HBM bandwidth, the tensor cores' TF32
# rate (the kernels' matrix products) and the f32 rate outside them
HBM_BYTES_PER_S = 3.35e12
TF32_FLOPS_PER_S = 495e12
F32_FLOPS_PER_S = 67e12
BF16_FLOPS_PER_S = 989e12  # the bf16 instances' matrix products
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
# the bf16 fast path (compute_dtype bfloat16, precision default): each bf16
# instance against its plain bf16 version, whose roundings it shares; they
# differ where f32 sums in another order land on the other side of a bf16
# rounding, each such flip moving an entry by 2^-8 of itself. KPConv's flips
# are in its inner sums (measured at most 3.3e-4 of max |plain|, the first
# layer); attention's in its bf16 output itself, one ulp of an entry
# (measured 3.7e-3)
KPCONV_BF16_REL_TOL = 2e-3     # of max |plain output|
ATTENTION_BF16_REL_TOL = 1e-2  # of max |plain output|
# pair 0 of the bf16 DDIM, card (kernels) against CPU (plain bf16 versions):
# the confidences relative to their largest (measured 1.0e-3 to 1.1e-3; the
# card's f32 path is 4.2e-3 to 4.3e-3 away, so the limit tells the two paths
# apart), the union mask's agreement (measured 0.99975 and 0.99977: 64 and 58
# of 253,967 entries, near-ties flipped by those differences; the limit
# allows twice the larger count) and no difference outside a near-tie, the
# pose solve on the same confidences (measured 1.3e-6 against POSE_ABS_TOL;
# bf16_pair_check)
CONF_BF16_REL_TOL = 2e-3
MASK_BF16_AGREEMENT = 0.9995
# With random weights the 4DMatch sigmoid confidences sit just above 0.5, so
# the protocol's threshold 0.55 extracts no match; the 4DMatch phase and the
# CLI's on-disk run extract at 0.5 (the mutual-argmax matches), so that IR
# and NFMR do their full work
MATCH_THR_4D = 0.5
# 4DMatch pair 0, card against CPU: sigmoid confidences, valid entries. The
# sigmoid's slope near 0.5 is 1/4 and no Sinkhorn follows it (measured 6.0e-8
# on the H100)
CONF_4D_ABS_TOL = 1e-6
METRIC_4D_ABS_TOL = 1e-2   # IR and NFMR: a flipped match moves IR by 1/n_corr
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


def bound_ms(nbytes: float, mma_flops: float, f32_flops: float,
             mma_rate: float = TF32_FLOPS_PER_S):
    """Least time for the work: bytes at the memory rate, matrix-product flops
    at the dense tensor-core rate of their type (TF32 for the f32 kernels,
    whose 3xTF32 spends three tensor-core products per f32 product and so
    reaches at most a third of this bound where the products set it; bf16 for
    the bf16 instances), the other flops at the f32 rate; the units run side
    by side, so the largest of the three."""
    t_bytes = nbytes / HBM_BYTES_PER_S
    t_ops = max(mma_flops / mma_rate, f32_flops / F32_FLOPS_PER_S)
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def kpconv_work(q, s, inds, x, w, bf16=False, aggregation_on_tensor_cores=None):
    """(bytes, matrix-product flops, other flops) of one KPConv call on these
    inputs; ``bf16``: the bf16 instance's, whose support table (hi, lo,
    features) and weights are bf16, and whose aggregation (influence x
    features, 2 P Cin flops a real neighbour) is a matrix product on the
    tensor cores (``aggregation_on_tensor_cores`` False counts it as other
    flops, the f32 rate, as the first bf16 version's bound did)."""
    b, nq, k = inds.shape
    ns, cin = x.shape[1], x.shape[2]
    p, _, cout = w.shape
    real = inds < ns                                   # non-sentinel neighbors
    n_nb = int(real.sum())
    n_q = int(real.any(dim=-1).sum())
    nbytes = 4 * (q.numel() + inds.numel() + p * 3 + b * nq * cout)
    if bf16:
        nbytes += 2 * (b * (ns + 1) * (6 + cin) + w.numel())
    else:
        nbytes += 4 * (s.numel() + x.numel() + w.numel())
    # per neighbor: offset and norm (8), per kernel point distance + influence
    # (13), feature-sum test (Cin), influence x features (2 P Cin);
    # per query: the division, and the [P Cin] x Cout contraction (the product)
    flops = n_nb * (8 + 13 * p + cin + 2 * p * cin) + n_q * cout
    if aggregation_on_tensor_cores is None:
        aggregation_on_tensor_cores = bf16
    if aggregation_on_tensor_cores:
        aggregation = n_nb * 2 * p * cin
        return nbytes, n_q * 2 * p * cin * cout + aggregation, flops - aggregation
    return nbytes, n_q * 2 * p * cin * cout, flops


def attention_work(q, k, kv_mask):
    b, h, l, d = q.shape
    s = k.shape[2]
    valid_keys = float(kv_mask.sum())                 # summed over the batch
    nbytes = q.element_size() * (2 * q.numel() + 2 * k.numel()) + kv_mask.numel()
    # QK^T and PV are the products; exp, sum and scale the rest
    return nbytes, h * l * valid_keys * 4 * d, h * l * valid_keys * 3


def kpconv_layer_calls(model, run, module_type):
    """(q, s, inds, x, kernel_points, weights, extent) of every KPConv call that
    ``run()`` makes through ``module_type`` modules of ``model``: nn/kpfcn.py's
    KPConv (called (q, s, inds, x)) or nn/point_backbone.py's KPConvBias
    (called (q, s, x, inds); its extent is ``sigma``)."""
    import torch

    from diffreg_tpu_torch.nn.kpfcn import KPConv

    seen = []
    hooks = [m.register_forward_pre_hook(lambda mod, args: seen.append((mod, args)))
             for m in model.modules() if isinstance(m, module_type)]
    with torch.no_grad():
        run()
    for h in hooks:
        h.remove()
    calls = []
    for mod, args in seen:
        if module_type is KPConv:
            q, s, inds, x = args
            extent = mod.extent
        else:
            q, s, x, inds = args
            extent = mod.sigma
        calls.append((q, s, inds, x.contiguous(), mod.kernel_points, mod.weights.detach(),
                      extent))
    return calls


def check_kpconv(calls, n_calls, per, tag="", bf16=False):
    """Kernel vs plain KPConv at every distinct layer of ``calls`` (the inputs
    the backbone really feeds each layer); ``bf16``: the bf16 instance against
    the plain bf16 version. Returns the kernel's JSON entry and the distinct
    layers {(nq, ns, k, cin, cout): (inputs, calls)}."""
    import torch

    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)

    if bf16:
        # the kernel's own inputs (the bf16 table and weights), built once a shape
        def kernel(q, s, inds, x, kp, w, extent):
            return kpconv_cuda_bf16(q, tables[id(x)], inds, kp, weights[id(w)], extent)
        counted, plain, limit = kpconv_cuda_bf16, kpconv_bf16_plain, KPCONV_BF16_REL_TOL
        tables = {id(a[3]): kpconv_bf16_table_aligned(a[1], a[3]) for a in calls}
        weights = {id(a[5]): a[5].to(torch.bfloat16).contiguous() for a in calls}
    else:
        kernel, counted, plain, limit = kpconv_cuda, kpconv_cuda, kpconv, KPCONV_REL_TOL

    if len(calls) != n_calls:
        raise AssertionError(f"expected {n_calls} KPConv calls per encode, saw {len(calls)}")
    shapes = {}
    for args in calls:
        q, s, inds, x, _, w, _ = args
        key = (q.shape[1], s.shape[1], inds.shape[2], x.shape[2], w.shape[2])
        shapes.setdefault(key, [args, 0])[1] += 1
    totals = {"ms": 0.0, "plain_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0, "flops": 0.0}
    first_bound = {"bytes": 0.0, "mma_flops": 0.0, "flops": 0.0}  # bf16: aggregation at the f32 rate
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for (nq, ns, k, cin, cout), (args, count) in shapes.items():
            q, s, inds, x, _, w, _ = args
            before = counted.launches
            got = kernel(*args)
            ref = plain(*args)
            torch.cuda.synchronize()
            assert counted.launches == before + 1
            err = float((got - ref).abs().max())
            scale = float(ref.abs().max())
            allowed = limit * (scale if bf16 else max(scale, 1.0))
            if not math.isfinite(err) or err > allowed:
                raise AssertionError(f"kpconv{tag} {nq}/{ns}/{k}/{cin}->{cout}: max abs err "
                                     f"{err} (max |plain| {scale})")
            worst = max(worst, err)
            ms = time_cuda(lambda: kernel(*args), 20)
            plain_ms = time_cuda(lambda: plain(*args), 3, warmup=1)
            work = kpconv_work(q, s, inds, x, w, bf16)
            bms, by = bound_ms(*work, BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
            tensor_cores = (cin >= (32 if bf16 else 64) and cin % 32 == 0 and k <= 40
                            and cout in (64, 128, 256, 512))
            path = "tensor cores" if tensor_cores else "CUDA cores"
            per_shape.append({"nq": nq, "ns": ns, "k": k, "cin": cin, "cout": cout,
                              "calls": count, "path": path, "ms": ms, "plain_ms": plain_ms,
                              "bound_ms": bms, "bound_by": by, "max_abs_err": err,
                              "max_abs_plain": scale})
            log(f"kpconv{tag} {nq}/{ns}/K{k}/{cin}->{cout} x{count} ({path}): err {err:.3e} "
                f"= {err / max(scale, 1e-30):.3e} of max |plain| (limit {allowed:.3e}) kernel "
                f"{ms:.4f} ms plain "
                f"{plain_ms:.4f} ms bound {bms:.4f} ms ({by})")
            totals["ms"] += count * ms
            totals["plain_ms"] += count * plain_ms
            for key, val in zip(("bytes", "mma_flops", "flops"), work):
                totals[key] += count * val
            if bf16:
                old = kpconv_work(q, s, inds, x, w, True, aggregation_on_tensor_cores=False)
                per_shape[-1]["bound_ms_aggregation_f32"] = bound_ms(*old, BF16_FLOPS_PER_S)[0]
                for key, val in zip(("bytes", "mma_flops", "flops"), old):
                    first_bound[key] += count * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"],
                       BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
    entry = {"name": "kpconv_bf16" if bf16 else "kpconv", "route": "cuda",
             "source": "diffreg_tpu_torch/csrc/kpconv.cu",
             "replaces": "diffreg_tpu/ops/pallas/kpconv_kernel.py:38",
             "launches": None, "max_abs_err": worst, "ms": totals["ms"],
             "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
             "library_ms": None, "per": per, "shapes": per_shape}
    if bf16:
        entry["bound_ms_aggregation_f32"], _ = bound_ms(
            first_bound["bytes"], first_bound["mma_flops"], first_bound["flops"], BF16_FLOPS_PER_S)
        log(f"kpconv{tag}: bound {bms:.4f} ms ({by}; aggregation as bf16 matrix flops), "
            f"{entry['bound_ms_aggregation_f32']:.4f} ms with it at the f32 rate")
    return entry, shapes


def attention_calls(n_src, n_tgt, layer_types):
    """Attention launches of one pass of a transformer with these layer types
    (nn/transformer.py): a self layer is one [2B] call when both sides have as
    many tokens and one call per side when not; a cross layer is two calls."""
    per_self = 1 if n_src == n_tgt else 2
    return sum(per_self if lt == "self" else 2 if lt == "cross" else 0 for lt in layer_types)


def attention_cases(batch, cfg):
    """The denoiser's attention calls in one DDIM step, as (name, query
    length, key mask, calls): the self layers as one [2B] call, or one per
    side when the sides' token counts differ; then both cross directions."""
    import torch

    src_mask, tgt_mask = batch.src_mask, batch.tgt_mask
    s, t = src_mask.shape[1], tgt_mask.shape[1]
    n_self = cfg.denoising_layer_types.count("self")
    n_cross = cfg.denoising_layer_types.count("cross")
    if s == t:
        cases = [("self", s, torch.cat([src_mask, tgt_mask]), n_self)]
    else:
        cases = [("self_src", s, src_mask, n_self), ("self_tgt", t, tgt_mask, n_self)]
    return cases + [("cross", s, tgt_mask, n_cross), ("cross_back", t, src_mask, n_cross)]


def check_attention(batch, cfg, gen, tag="", bf16=False):
    """Kernel vs plain attention at the denoiser's shapes (``attention_cases``)
    with the batch's key masks; times scaled_dot_product_attention (in the
    same dtype) as the yardstick. ``bf16``: the bf16 instance on bf16 q, k, v
    against the plain bf16 version, the error relative to the largest plain
    entry. Returns the kernel's JSON entry (totals per DDIM step of ``cfg``)."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)

    if bf16:
        kernel, plain, dtype = masked_attention_cuda_bf16, masked_attention_bf16_plain, \
            torch.bfloat16
    else:
        kernel, plain, dtype = masked_attention_cuda, masked_attention_plain, torch.float32

    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    cases = attention_cases(batch, cfg)
    totals = {"ms": 0.0, "plain_ms": 0.0, "library_ms": 0.0, "bytes": 0.0, "mma_flops": 0.0,
              "flops": 0.0}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for name, length, kv_mask, calls in cases:
            bb, keys = kv_mask.shape
            q = torch.randn(bb, h, length, d, generator=gen).to("cuda", dtype)
            k, v = (torch.randn(bb, h, keys, d, generator=gen).to("cuda", dtype)
                    for _ in range(2))
            kv_mask = kv_mask.contiguous()
            before = kernel.launches
            got = kernel(q, k, v, kv_mask, scale)
            ref = plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert kernel.launches == before + 1 and got.dtype == dtype
            err = float((got.float() - ref.float()).abs().max())
            limit = ATTENTION_BF16_REL_TOL * float(ref.float().abs().max()) if bf16 \
                else ATTENTION_ABS_TOL
            if not math.isfinite(err) or err > limit:
                raise AssertionError(f"attention {name}{tag}: max abs err {err} (limit {limit})")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=scale)
            lib_err = float((lib.float() - ref.float()).abs().max())
            ms = time_cuda(lambda: kernel(q, k, v, kv_mask, scale), 20)
            plain_ms = time_cuda(lambda: plain(q, k, v, kv_mask, scale), 10)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            nbytes, mma_flops, flops = attention_work(q, k, kv_mask)
            rate = BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S
            bms, by = bound_ms(nbytes, mma_flops, flops, rate)
            per_shape.append({"case": name + tag, "b": bb, "h": h, "l": length, "s": keys, "d": d,
                              "calls": calls, "ms": ms, "plain_ms": plain_ms,
                              "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                              "max_abs_err": err, "library_max_abs_err": lib_err})
            log(f"attention{' bf16' if bf16 else ''} {name}{tag} [{bb},{h},{length}x{keys},{d}] "
                f"x{calls}: err {err:.3e} = {err / float(ref.float().abs().max()):.3e} of max "
                f"|plain| (limit {limit:.1e}) kernel {ms:.4f} ms plain "
                f"{plain_ms:.4f} ms sdpa {lib_ms:.4f} ms (err {lib_err:.3e}) "
                f"bound {bms:.4f} ms ({by})")
            for key, val in (("ms", ms), ("plain_ms", plain_ms), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("mma_flops", mma_flops), ("flops", flops)):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"],
                       BF16_FLOPS_PER_S if bf16 else TF32_FLOPS_PER_S)
    return {"name": "masked_attention_bf16" if bf16 else "masked_attention", "route": "cuda",
            "source": "diffreg_tpu_torch/csrc/attention.cu",
            "replaces": "diffreg_tpu/ops/pallas/attention_kernel.py:24",
            "launches": None, "max_abs_err": worst, "ms": totals["ms"],
            "plain_ms": totals["plain_ms"], "bound_ms": bms, "bound_by": by,
            "library_ms": totals["library_ms"],
            "per": f"one DDIM step ({sum(c[3] for c in cases)} calls)", "shapes": per_shape}


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
    worst, total = kpconv_gradients(kp_shapes, gen)
    kernels[0].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})
    worst, total = attention_gradients(batch, cfg, gen)
    kernels[1].update({"backward_ms": total, "backward_route": "plain recompute",
                       "backward_max_rel_err": worst})


def kpconv_gradients(kp_shapes, gen):
    """KPConvFunction against plain autograd at each distinct layer; returns
    (worst relative error, backward ms of all the layers' calls)."""
    from diffreg_tpu_torch.ops.kpconv import KPConvFunction, kpconv, kpconv_cuda

    worst, total = 0.0, 0.0
    for (nq, ns, k, cin, cout), ((*inputs, ext), calls) in kp_shapes.items():
        err, ms = grad_case(
            f"kpconv {nq}/{ns}/K{k}/{cin}->{cout}",
            lambda *a: KPConvFunction.apply(*a, ext), tuple(inputs), (3, 5),
            lambda *a: kpconv(*a, ext), gen, calls, kpconv_cuda)
        worst, total = max(worst, err), total + calls * ms
    return worst, total


def attention_gradients(batch, cfg, gen):
    """MaskedAttentionFunction against plain autograd at the denoiser's shapes
    of ``cfg``; returns (worst relative error, backward ms per DDIM step)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionFunction, masked_attention_cuda,
                                                 masked_attention_plain)

    h = cfg.coarse_transformer.n_head
    d = cfg.coarse_transformer.feature_dim // h
    scale = d ** -0.5
    worst, total = 0.0, 0.0
    for name, length, kv_mask, calls in attention_cases(batch, cfg):
        bb, keys = kv_mask.shape
        qkv = [torch.randn(bb, h, n, d, generator=gen).cuda() for n in (length, keys, keys)]
        err, ms = grad_case(
            f"attention {name} [{bb},{h},{length}x{keys},{d}]",
            lambda *a: MaskedAttentionFunction.apply(*a, scale), (*qkv, kv_mask.contiguous()),
            (0, 1, 2), lambda *a: masked_attention_plain(*a, scale), gen, calls,
            masked_attention_cuda)
        worst, total = max(worst, err), total + calls * ms
    return worst, total


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


def deformable_data():
    """The 4DMatch phase's data: BATCH_PAIRS deformable pairs of N_POINTS at
    scene scale SCALE_4D (4DMatch's 0.01 voxel), the spec calibrated from two
    more such pairs as main.py calibrates (its sides' token counts differ),
    their pyramid batch, each pair's metric points (raw source, GT flow, a
    seeded metric_index) and the raw pairs (src, tgt, rot, trn, flow)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig, batch_from_samples, build_pair_pyramid
    from diffreg_tpu_torch.data.synthetic import make_pair

    pair = lambda rng: make_pair(rng, N_POINTS, deformable=True, flow_amp=FLOW_AMP_4D,
                                 scale=SCALE_4D)
    # configs/test/4dmatch.yaml:9,22
    pcfg = PyramidConfig(first_subsampling_dl=0.01, coarse_match_radius=0.024)
    cal_rng = np.random.RandomState(0)
    spec = calibrate_spec([pair(cal_rng)[:2] for _ in range(2)], pcfg, k_cap=40,
                          neighbor_percentile=90.0)
    rng, pick = np.random.RandomState(1), np.random.RandomState(2)
    samples, meta, pairs = [], [], []
    for _ in range(BATCH_PAIRS):
        pairs.append(pair(rng))
        src, tgt, rot, trn, flow = pairs[-1]
        samples.append(build_pair_pyramid(src, tgt, rot, trn, pcfg, spec, scene_flow=flow))
        idx = np.sort(pick.choice(len(src), min(len(src), METRIC_POINTS), replace=False))
        meta.append({"src_pcd": src, "scene_flow": flow, "metric_index": idx})
    return batch_from_samples(samples), meta, spec, pairs


def run_4dmatch(batch_cpu, meta, spec, launches):
    """Phase 9: the 4DMatch path at full width through FourDMatchTester, then
    pair 0 on the CPU (phase 10). Returns the numbers for the summary."""
    import torch

    from diffreg_tpu_torch.engine.tester import (FourDMatchTester, TestConfig,
                                                 make_metric_points_fn, match_mask_4dmatch,
                                                 pair_metrics_4dmatch)
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_4dmatch
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda

    cfg = preset_4dmatch(sample_steps=STEPS)
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    model = DiffusionMatchingModel(cfg, device="cuda", seed=0)
    tcfg = TestConfig(inlier_thr=0.04, match_thr=MATCH_THR_4D)
    tester = FourDMatchTester(model, tcfg, device="cuda")
    metric_points = make_metric_points_fn(METRIC_POINTS)
    batch = batch_cpu.to("cuda")
    make_iter = lambda: iter([(batch, meta)])
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        tester.test(make_iter, torch.Generator("cuda").manual_seed(0), metric_points)  # warm-up
        times = []
        for run in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: tester.test(
                make_iter, torch.Generator("cuda").manual_seed(1 + run), metric_points))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != per_step * STEPS:
                raise AssertionError(f"4DMatch tester: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want {per_step * STEPS})")
            launches["kpconv"] += n_kp
            launches["masked_attention_d132"] += n_at
            times.append(seconds)
            if not (summary["pairs"] == BATCH_PAIRS and summary["matches"] > 0
                    and math.isfinite(summary["IR"])
                    and math.isfinite(summary.get("NFMR", math.nan))):
                raise AssertionError(f"4DMatch tester summary {summary}")
        seconds = sorted(times)[TIMED_RUNS // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"4DMatch path (FourDMatchTester, gate 40, stochastic DDIM, {STEPS} steps, match "
            f"threshold {MATCH_THR_4D}): {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {BATCH_PAIRS / seconds:.3f} pairs/s; "
            f"IR {summary['IR']:.4f} NFMR {summary['NFMR']:.4f}, {summary['matches']:.1f} "
            f"matches a pair; launches kpconv {n_kp} "
            f"attention {n_at}; peak memory {peak:.2f} GiB")

        # ---- 10. pair 0 on the CPU, same weights and draws ----
        gen = torch.Generator().manual_seed(3)
        x_init = torch.randn(BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
        noise = torch.randn(STEPS, BATCH_PAIRS, spec.n_src, spec.n_tgt, generator=gen)
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        out, fwd_s = wall(lambda: model.ddim_sample(batch, x_init.cuda(),
                                                    ddim_noise=noise.cuda()))
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 11 or n_at != per_step * STEPS:
            raise AssertionError(f"4DMatch ddim_sample: {n_kp} KPConv, {n_at} attention launches")
        launches["kpconv"] += n_kp
        launches["masked_attention_d132"] += n_at
        cond = out["step_condition"]
        accepted = int((cond < cfg.procrustes.max_condition_num).sum())
        log(f"4DMatch ddim_sample: {fwd_s:.4f} s, warps accepted {accepted}/{cond.numel()}")
        cpu_model = DiffusionMatchingModel(cfg, device="cpu", seed=0)
        one = batch_cpu.select(slice(0, 1))
        t0 = time.perf_counter()
        ref = cpu_model.ddim_sample(one, x_init[:1], ddim_noise=noise[:, :1])
        cpu_s = time.perf_counter() - t0
        valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
        got = {k: v[:1].cpu() for k, v in out.items() if k != "step_condition"}
        conf_err = float((got["conf_matrix_pred"] - ref["conf_matrix_pred"]).abs()[valid].max())
        pose_err = max(float((got[k] - ref[k]).abs().max())
                       for k in ("rotation_pred", "translation_pred"))
        gap = cut_gap(ref["conf_matrix_pred"], one.src_mask, one.tgt_mask)
        mask, ref_mask = (match_mask_4dmatch(o, one, tcfg) for o in (got, ref))
        agree = float((mask == ref_mask)[valid].float().mean())
        ir, n_corr = pair_metrics_4dmatch(got, one, tcfg)
        ref_ir, ref_n = pair_metrics_4dmatch(ref, one, tcfg)
        cpu_tester = FourDMatchTester(cpu_model, tcfg, device="cpu")
        nfmr = cpu_tester.nfmr_for_batch(got, one, meta[:1], metric_points)[0]
        ref_nfmr = cpu_tester.nfmr_for_batch(ref, one, meta[:1], metric_points)[0]
        cond_cpu = ref["step_condition"][:, 0]
        cond_gap = float((cond_cpu - cfg.procrustes.max_condition_num).abs().min())
    log(f"4DMatch card vs CPU, pair 0 (CPU {cpu_s:.1f} s): sigmoid conf {conf_err:.3e} (limit "
        f"{CONF_4D_ABS_TOL:.0e}), pose {pose_err:.3e} (limit {POSE_ABS_TOL:.0e}), cut gap "
        f"{gap:.3e}, nearest step condition to the gate {cond_gap:.3f}, thr-mutual mask "
        f"agreement {agree:.7f}, matches {int(n_corr[0])} vs {int(ref_n[0])}, IR "
        f"{float(ir[0]):.5f} vs {float(ref_ir[0]):.5f}, NFMR {nfmr:.5f} vs {ref_nfmr:.5f}")
    if not gap > CUT_GAP_MIN:
        raise AssertionError(f"4DMatch: soft Procrustes' cut falls on a near-tie ({gap})")
    if not conf_err <= CONF_4D_ABS_TOL:
        raise AssertionError(f"4DMatch: confidences differ from the CPU's by {conf_err}")
    if not pose_err <= POSE_ABS_TOL:
        raise AssertionError(f"4DMatch: pose differs from the CPU's by {pose_err}")
    if not agree >= MASK_AGREEMENT:
        raise AssertionError(f"4DMatch: thr-mutual masks agree on {agree} of entries")
    if not (abs(float(ir[0]) - float(ref_ir[0])) <= METRIC_4D_ABS_TOL
            and abs(nfmr - ref_nfmr) <= METRIC_4D_ABS_TOL):
        raise AssertionError("4DMatch: IR or NFMR differ from the CPU's")
    return {"pairs_per_s": BATCH_PAIRS / seconds, "peak_gib": peak}


def write_4dmatch_split(directory, pairs, meta):
    """The pairs as 4DMatch .npz entries (src_pcd, tgt_pcd, s2t_flow, rot,
    trans, metric_index), as data/datasets.py:FourDMatchPairDataset reads them."""
    import numpy as np

    os.makedirs(directory)
    for i, ((src, tgt, rot, trn, flow), m) in enumerate(zip(pairs, meta)):
        np.savez(os.path.join(directory, f"pair{i}.npz"), src_pcd=src, tgt_pcd=tgt,
                 s2t_flow=flow, rot=rot, trans=trn, metric_index=m["metric_index"][:, None])


def run_cli(repo, pairs4, meta4, launches):
    """Phase 11: ``diffreg_tpu_torch.main`` on the card, in a temporary working
    directory: 4DMatch test on the demo pairs at the protocol's threshold;
    4DMatch test on the 4DMatch phase's pairs written as an on-disk split,
    with a checkpoint of random weights (calibration from the YAML's pyramid,
    the loader, the restore, NFMR on the metric_index points) at MATCH_THR_4D;
    3DMatch test (65,536 RANSAC hypotheses); one 4DMatch training epoch (its
    config with max_epoch cut to 1)."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.data.datasets import FourDMatchPairDataset
    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import create_train_state
    from diffreg_tpu_torch.main import data_spec
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import (build_optim_config, build_pipeline_config,
                                                load_yaml)

    configs = os.path.join(repo, "configs")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        train_cfg = load_yaml(os.path.join(configs, "train", "4dmatch.yaml"))
        train_cfg["max_epoch"] = 1
        with open(os.path.join(tmp, "train_4dmatch.yaml"), "w") as f:
            yaml.safe_dump(train_cfg, f)
        disk_cfg = load_yaml(os.path.join(configs, "test", "4dmatch.yaml"))
        write_4dmatch_split(os.path.join(tmp, "4dmatch", "test"), pairs4, meta4)
        disk_cfg.update(data_root=os.path.join(tmp, "4dmatch"), exp_dir="disk-4dmatch",
                        split={"test": os.path.join(tmp, "4dmatch", "test")},
                        pretrain=os.path.join(tmp, "ckpt"), num_workers=4)
        pipeline = build_pipeline_config(disk_cfg)
        CheckpointManager(disk_cfg["pretrain"]).save(1, create_train_state(
            DiffusionMatchingModel(pipeline, device="cpu", seed=0),
            build_optim_config(disk_cfg, steps_per_epoch=1)))
        with open(os.path.join(tmp, "disk_4dmatch.yaml"), "w") as f:
            yaml.safe_dump(disk_cfg, f)
        disk_spec, _ = data_spec(FourDMatchPairDataset(disk_cfg["split"]["test"]), disk_cfg,
                                 pipeline)
        _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
        layers = pipeline.denoising_layer_types
        ddim = lambda spec: STEPS * attention_calls(spec.n_src, spec.n_tgt, layers)
        train = attention_calls(demo_spec.n_src, demo_spec.n_tgt,
                                tuple(pipeline.coarse_transformer.layer_types) + layers)
        # (name, config, extra arguments, pairs per batch, summary keys, attention
        # launches per batch: a 20-step DDIM sample or a train step)
        runs = [("4DMatch test (demo)", os.path.join(configs, "test", "4dmatch.yaml"),
                 ["--demo", "--thr", "0.55"], BATCH_PAIRS, ("IR",), ddim(demo_spec)),
                ("4DMatch test (on disk)", os.path.join(tmp, "disk_4dmatch.yaml"),
                 ["--thr", str(MATCH_THR_4D)], BATCH_PAIRS, ("IR", "NFMR", "matches"),
                 ddim(disk_spec)),
                ("3DMatch test (demo)", os.path.join(configs, "test", "3dmatch.yaml"), ["--demo"],
                 BATCH_PAIRS, ("IR", "FMR", "RR"), ddim(demo_spec)),
                ("4DMatch train (demo)", os.path.join(tmp, "train_4dmatch.yaml"),
                 ["--demo", "--mode", "train"], 2, ("loss",), train)]
        os.chdir(tmp)
        try:
            for name, config, extra, batch_size, keys, attn_per_batch in runs:
                kpconv_cuda.launches = 0
                masked_attention_cuda.launches = 0
                argv = ["--config", config, "--num-pairs", str(BATCH_PAIRS),
                        "--batch-size", str(batch_size), *extra]
                summary, seconds = wall(lambda: cli(argv))
                n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
                batches = BATCH_PAIRS // batch_size
                if n_kp != 11 * batches or n_at != attn_per_batch * batches:
                    raise AssertionError(f"main {name}: {n_kp} KPConv, {n_at} attention launches")
                if not all(math.isfinite(summary[k]) for k in keys):
                    raise AssertionError(f"main {name}: summary {summary}")
                if "matches" in keys and not summary["matches"] > 0:
                    raise AssertionError(f"main {name}: no match extracted ({summary})")
                launches["kpconv"] += n_kp
                launches["masked_attention_d132" if "4DMatch" in name
                         else "masked_attention"] += n_at
                log(f"main {name}, {BATCH_PAIRS} pairs: {seconds:.2f} s, launches kpconv "
                    f"{n_kp} attention {n_at}; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in summary.items()))
            log(f"main 4DMatch on-disk spec {disk_spec}")
            if not os.path.isfile(os.path.join(tmp, "snapshot", "train-4dmatch", "checkpoints",
                                               "1.pt")):
                raise AssertionError("main 4DMatch train: no checkpoint")
        finally:
            os.chdir(cwd)


# ---------------------------------------------------------------- bf16


def bf16_pair_check(got, ref, f32, one, cpu_model, tag):
    """Pair 0 of the card's bf16 DDIM against the CPU's (the same roundings,
    so they differ where f32 sums in another order flip a bf16 rounding):
    the confidences within CONF_BF16_REL_TOL of the largest; the union mask
    agreeing on MASK_BF16_AGREEMENT of the valid entries, and differing only in
    rows or columns whose best two CPU confidences lie within twice that
    limit (near-ties); the pose solve on the card's confidences against the
    CPU's solve of the same confidences within POSE_ABS_TOL. With random
    weights the confidences are near-uniform, so soft Procrustes amplifies
    their card-vs-CPU difference into the end-to-end pose: that gap, and the
    card's bf16-vs-f32 gaps, are printed beside the limits."""
    import torch

    valid = one.src_mask[:, :, None] & one.tgt_mask[:, None, :]
    conf = ref["conf_matrix_pred"]
    top = float(conf[valid].max())
    limit = CONF_BF16_REL_TOL * top
    card = got["conf_matrix_pred"][:1].cpu()
    conf_err = float((card - conf).abs()[valid].max())
    f32_gap = float((card - f32["conf_matrix_pred"][:1].cpu()).abs()[valid].max())
    pose_gap = lambda a, b: max(float((a[k][:1].cpu() - b[k][:1].cpu()).abs().max())  # noqa: E731
                                for k in ("rotation_pred", "translation_pred"))
    solve = cpu_model._pose(card, ref["s_pcd"], ref["t_pcd"], one.src_mask, one.tgt_mask)
    solve_err = pose_gap(got, {"rotation_pred": solve.rotation,
                               "translation_pred": solve.translation})
    c = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top_r, top_c = c.topk(2, dim=2).values, c.topk(2, dim=1).values
    row_tie = (top_r[..., 0] - top_r[..., 1]) <= 2 * limit                    # [1, S]
    col_tie = (top_c[:, 0] - top_c[:, 1]) <= 2 * limit                        # [1, T]
    differ = (got["corr_mask"][:1].cpu() != ref["corr_mask"]) & valid
    agree = 1.0 - float(differ.sum()) / float(valid.sum())
    unexplained = int((differ & ~(row_tie[:, :, None] | col_tie[:, None, :])).sum())
    real = one.src_mask[0]
    tie_free = float((~row_tie[0] & real).sum()) / max(int(real.sum()), 1)
    log(f"bf16 card vs CPU {tag}: conf {conf_err:.3e} (limit {limit:.3e}, max conf {top:.3e}; "
        f"card bf16 vs card f32 {f32_gap:.3e}); corr_mask agreement {agree:.6f} (limit "
        f"{MASK_BF16_AGREEMENT}), {int(differ.sum())} of {int(valid.sum())} entries differ, "
        f"{unexplained} outside a near-tie (limit 0), real rows free of a near-tie "
        f"{tie_free:.4f}; pose solve on the card's confidences vs the CPU's {solve_err:.3e} "
        f"(limit {POSE_ABS_TOL:.0e}); end-to-end pose card vs CPU {pose_gap(got, ref):.3e}, "
        f"card bf16 vs f32 {pose_gap(got, f32):.3e}")
    if not (conf_err <= limit and agree >= MASK_BF16_AGREEMENT and unexplained == 0
            and solve_err <= POSE_ABS_TOL):
        raise AssertionError(f"bf16 {tag}: conf {conf_err}, mask agreement {agree}, "
                             f"{unexplained} entries outside a near-tie, pose solve {solve_err}")


def bf16_edge_cases(gen):
    """Both bf16 kernels against their plain bf16 versions, at the limits of
    the main-path check, where the new tilings and splits have edges:
    attention at L x S of 70 x 45, 1 x 768 and 768 x 1, with a batch row
    whose key mask holds one valid key, and at S = 1500 (a block's key range
    past the kept-logits limit: the recompute branch), at both head widths;
    KPConv at K = 1 and K = 40, Nq short of one 32-query tile, grids short of
    two waves (the kernel-point split on) and long (off), and Cin = 32 and
    512. Returns (attention cases, KPConv cases)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda_bf16)
    from diffreg_tpu_torch.ops.kpconv import (kpconv_bf16_plain, kpconv_bf16_table_aligned,
                                              kpconv_cuda_bf16)

    att, kp = [], []
    with torch.inference_mode():
        for d in (108, 132):
            for name, b, length, keys, one_valid in (
                    ("70x45", 2, 70, 45, False), ("1x768", 2, 1, 768, False),
                    ("768x1", 2, 768, 1, False), ("one valid key", 2, 704, 704, True),
                    ("recompute 1500", 2, 300, 1500, False)):
                q = torch.randn(b, 4, length, d, generator=gen).to("cuda", torch.bfloat16)
                k, v = (torch.randn(b, 4, keys, d, generator=gen).to("cuda", torch.bfloat16)
                        for _ in range(2))
                mask = torch.arange(keys)[None] < torch.tensor([keys, max(keys - 37, 1)])[:, None]
                if one_valid:
                    mask[0] = False
                    mask[0, keys // 2] = True
                mask = mask.cuda()
                got = masked_attention_cuda_bf16(q, k, v, mask, d ** -0.5).float()
                ref = masked_attention_bf16_plain(q, k, v, mask, d ** -0.5).float()
                err, top = float((got - ref).abs().max()), float(ref.abs().max())
                log(f"attention bf16 edge {name}, D {d}: err {err:.3e} = {err / top:.3e} of max "
                    f"|plain| (limit {ATTENTION_BF16_REL_TOL:.0e})")
                if not math.isfinite(err) or err > ATTENTION_BF16_REL_TOL * top:
                    raise AssertionError(f"attention bf16 edge {name}, D {d}: err {err}")
                att.append({"case": name, "d": d, "l": length, "s": keys, "max_abs_err": err,
                            "max_abs_plain": top})
        for name, b, nq, ns, k, cin, cout in (
                ("K 1, split off", 4, 8704, 8704, 1, 64, 64),
                ("K 40, split on", 4, 1536, 1536, 40, 128, 128),
                ("Nq 20 (short of a tile)", 4, 20, 300, 40, 64, 64),
                ("Nq 5, K 7, Cin 32", 1, 5, 40, 7, 32, 128),
                ("Cin 32, split off", 4, 8704, 8704, 34, 32, 64),
                ("Cin 512, K 16, split on", 2, 300, 1000, 16, 512, 512),
                ("Cin 512, split off", 4, 4352, 4352, 40, 512, 64)):
            s_pts = torch.rand(b, ns, 3, generator=gen) * 2.0 + torch.tensor([3.2, -2.1, 1.7])
            q_pts = s_pts[:, torch.randint(0, ns, (nq,), generator=gen)] + \
                0.01 * torch.randn(b, nq, 3, generator=gen)
            inds = torch.randint(0, ns + 1, (b, nq, k), generator=gen).int()
            x = torch.randn(b, ns, cin, generator=gen)
            kpts = torch.randn(15, 3, generator=gen) * 0.3
            w = torch.randn(15, cin, cout, generator=gen) * 0.05
            q_pts, s_pts, inds, x, kpts, w = (t.cuda().contiguous()
                                               for t in (q_pts, s_pts, inds, x, kpts, w))
            got = kpconv_cuda_bf16(q_pts, kpconv_bf16_table_aligned(s_pts, x), inds, kpts,
                                   w.to(torch.bfloat16).contiguous(), 0.6)
            ref = kpconv_bf16_plain(q_pts, s_pts, inds, x, kpts, w, 0.6)
            err, top = float((got - ref).abs().max()), float(ref.abs().max())
            log(f"kpconv bf16 edge {name} (B {b}, Nq {nq}, K {k}, {cin}->{cout}): err {err:.3e} "
                f"= {err / top:.3e} of max |plain| (limit {KPCONV_BF16_REL_TOL:.0e})")
            if not math.isfinite(err) or err > KPCONV_BF16_REL_TOL * top:
                raise AssertionError(f"kpconv bf16 edge {name}: err {err}")
            kp.append({"case": name, "b": b, "nq": nq, "k": k, "cin": cin, "cout": cout,
                       "max_abs_err": err, "max_abs_plain": top})
    return att, kp


def profile_call(repo, fn):
    """One call of ``fn`` (ending in a synchronize) under torch.profiler,
    summarised by tools/profile_port.py:summarize: wall time, the device's
    busy time and idle share, kernel launches and the top kernels."""
    import importlib.util
    import tempfile

    import torch
    from torch.profiler import ProfilerActivity, profile

    spec = importlib.util.spec_from_file_location(
        "profile_port", os.path.join(repo, "tools", "profile_port.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_s = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        return module.summarize(path, wall_s)


def run_bf16(repo, batch, batch_cpu, spec, x_init, u, f32_ref, batch4_cpu, gen, launches):
    """Phase 8b, the bf16 fast path (configs/test/3dmatch_fast.yaml): each
    bf16 instance against its plain bf16 version at the main path's shapes
    (KPConv at the 11 layers of a bf16 encode, attention at the 3DMatch self
    and cross shapes, D = 108, and the 4DMatch ones, D = 132), with SDPA in
    bf16 as the attention yardstick, and at the edges of their tilings
    (``bf16_edge_cases``); the bf16 DDIM at full width, gate 0 and
    40 (one warm-up and three timed runs, the bf16 launches asserted and no
    f32 kernel launched), pair 0 against the CPU, and ``main`` on
    3dmatch_fast.yaml with --demo. Returns the two kernels' JSON entries and
    pairs/s per gate."""
    import tempfile

    import torch

    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import (preset_3dmatch, preset_4dmatch,
                                                  with_condition_gate, with_fast_path)
    from diffreg_tpu_torch.nn.kpfcn import KPConv
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_cuda_bf16
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda, kpconv_cuda_bf16

    cfg = with_fast_path(preset_3dmatch(sample_steps=STEPS))
    models = {gate: DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cuda", seed=0)
              for gate in GATES}
    kp, _ = check_kpconv(kpconv_layer_calls(models[0.0], lambda: models[0.0].encode(batch),
                                            KPConv), 11, "one encode (11 calls)", " (bf16)",
                         bf16=True)
    at = check_attention(batch, cfg, gen, " (bf16)", bf16=True)
    cfg4 = with_fast_path(preset_4dmatch(sample_steps=STEPS))
    at4 = check_attention(batch4_cpu.to("cuda"), cfg4, gen, " (bf16, 4DMatch)", bf16=True)
    at["d132"] = {k: at4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms", "bound_by",
                                       "library_ms", "per")}
    at["shapes"] += at4["shapes"]
    at["max_abs_err"] = max(at["max_abs_err"], at4["max_abs_err"])
    at["edge_cases"], kp["edge_cases"] = bf16_edge_cases(gen)

    torch.cuda.reset_peak_memory_stats()
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    pairs_per_s, outs, profiles = {}, {}, {}
    for gate, model in models.items():
        register(model, batch, x_init, u)                      # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            for fn in (kpconv_cuda, masked_attention_cuda, kpconv_cuda_bf16,
                       masked_attention_cuda_bf16):
                fn.launches = 0
            out, seconds = wall(lambda: register(model, batch, x_init, u))
            n_kp, n_at = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches
            f32 = kpconv_cuda.launches + masked_attention_cuda.launches
            if n_kp != 11 or n_at != per_step * STEPS or f32:
                raise AssertionError(f"bf16 gate {gate}: {n_kp} bf16 KPConv launches (want "
                                     f"11), {n_at} bf16 attention (want {per_step * STEPS}), "
                                     f"{f32} f32 kernel launches (want 0)")
            launches["kpconv_bf16"] += n_kp
            launches["masked_attention_bf16"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        check_outputs(out, f"bf16 gate {gate}")
        pairs_per_s[gate] = BATCH_PAIRS / seconds
        outs[gate] = {k: out[k][:1] for k in ("conf_matrix_pred", "corr_mask", "rotation_pred",
                                              "translation_pred")}
        with torch.inference_mode():
            _, enc_s = wall(lambda: model.encode(batch))
            _, ddim_s = wall(lambda: model.ddim_sample(batch, x_init.cuda()))
        cond = out.get("step_condition")
        accepted = "" if cond is None else \
            f", warps accepted {int((cond < gate).sum())}/{cond.numel()}"
        log(f"bf16 path gate {gate}: {BATCH_PAIRS} pairs in {seconds:.4f} s (median of "
            f"{', '.join(f'{t:.4f}' for t in times)}) = {pairs_per_s[gate]:.3f} pairs/s "
            f"(f32 path {f32_ref[gate]['pairs_per_s']:.3f}); encode {enc_s:.4f} s, DDIM "
            f"{ddim_s - enc_s:.4f} s; launches bf16 kpconv {n_kp} attention {n_at}, f32 0"
            f"{accepted}; peak memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")
        prof = profile_call(repo, lambda: register(model, batch, x_init, u))
        profiles[str(gate)] = {k: prof[k] for k in ("wall_s", "device_busy_s", "idle_share",
                                                    "kernel_launches", "top_kernels_ms")}
        log(f"bf16 path gate {gate}, one profiled call: wall {prof['wall_s']:.4f} s, device "
            f"busy {prof['device_busy_s']:.4f} s, idle share {prof['idle_share']:.3f}, "
            f"{prof['kernel_launches']} kernel launches "
            f"({prof['kernel_launches'] / STEPS:.0f} per DDIM step); top kernels (ms): "
            + "; ".join(f"{ms:.3f} {name}" for name, ms in prof["top_kernels_ms"][:6]))
    del models

    one = batch_cpu.select(slice(0, 1))
    for gate in GATES:
        t0 = time.perf_counter()
        cpu_model = DiffusionMatchingModel(with_condition_gate(cfg, gate), device="cpu", seed=0)
        ref = register(cpu_model, one, x_init[:1], u[:1], device="cpu")
        bf16_pair_check(outs[gate], ref, f32_ref[gate], one, cpu_model,
                        f"gate {gate} (CPU {time.perf_counter() - t0:.1f} s)")

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        os.chdir(tmp)
        try:
            for fn in (kpconv_cuda, masked_attention_cuda, kpconv_cuda_bf16,
                       masked_attention_cuda_bf16):
                fn.launches = 0
            config = os.path.join(repo, "configs", "test", "3dmatch_fast.yaml")
            summary, seconds = wall(lambda: cli(["--config", config, "--demo", "--num-pairs",
                                                 str(BATCH_PAIRS), "--batch-size",
                                                 str(BATCH_PAIRS)]))
        finally:
            os.chdir(cwd)
    from diffreg_tpu_torch.data.synthetic import synthetic_batch

    _, demo_spec, _ = synthetic_batch(batch_size=1, n_points=768, seed=0)
    want = STEPS * attention_calls(demo_spec.n_src, demo_spec.n_tgt, cfg.denoising_layer_types)
    n_kp, n_at = kpconv_cuda_bf16.launches, masked_attention_cuda_bf16.launches
    f32 = kpconv_cuda.launches + masked_attention_cuda.launches
    if n_kp != 11 or n_at != want or f32 or not all(
            math.isfinite(summary[k]) for k in ("IR", "FMR", "RR")):
        raise AssertionError(f"main 3dmatch_fast.yaml: {n_kp} bf16 KPConv, {n_at} bf16 "
                             f"attention, {f32} f32 launches; summary {summary}")
    launches["kpconv_bf16"] += n_kp
    launches["masked_attention_bf16"] += n_at
    log(f"main 3DMatch fast (configs/test/3dmatch_fast.yaml, demo), {BATCH_PAIRS} pairs: "
        f"{seconds:.2f} s, launches bf16 kpconv {n_kp} attention {n_at}, f32 0; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in summary.items()))
    at["ddim_profile"] = profiles
    return [kp, at], pairs_per_s


# ---------------------------------------------------------------- 2D-3D


def _png_chunk(kind, body):
    import struct
    import zlib

    return struct.pack(">I", len(body)) + kind + body + struct.pack(
        ">I", zlib.crc32(kind + body) & 0xFFFFFFFF)


def write_png(path, img):
    """An 8-bit RGB [H, W, 3] or 16-bit gray [H, W] PNG whose rows cycle
    through the five filter types (the port's reader must undo each)."""
    import struct
    import zlib

    import numpy as np

    h, w = img.shape[:2]
    ch = 1 if img.ndim == 2 else img.shape[2]
    nbytes = img.dtype.itemsize
    rows = (img.astype(">u2").view(np.uint8) if nbytes == 2 else img).reshape(h, -1)
    rows = rows.astype(np.int32)
    bpp = ch * nbytes
    raw, prev = [], np.zeros(rows.shape[1], np.int32)
    for y in range(h):
        ftype, cur = y % 5, rows[y]
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        upleft = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ftype == 0:
            pred = np.zeros_like(cur)
        elif ftype == 1:
            pred = left
        elif ftype == 2:
            pred = prev
        elif ftype == 3:
            pred = (left + prev) // 2
        else:
            p = left + prev - upleft
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - upleft)
            pred = np.where((pa <= pb) & (pa <= pc), left, np.where(pb <= pc, prev, upleft))
        raw.append(bytes([ftype]) + ((cur - pred) % 256).astype(np.uint8).tobytes())
        prev = cur
    header = struct.pack(">IIBBBBB", w, h, 8 * nbytes, 0 if ch == 1 else 2, 0, 0, 0)
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n" + _png_chunk(b"IHDR", header)
                + _png_chunk(b"IDAT", zlib.compress(b"".join(raw), 6)) + _png_chunk(b"IEND", b""))


def write_2d3d_split(root, subset="test", seed=7):
    """BATCH_PAIRS RGB-D Scenes V2-like pairs as the reader's on-disk layout:
    data/<scene>/{camera-intrinsics.txt, depth, image, cloud} and
    metadata/<subset>.pkl (the test subset's scenes are scene_00 and scene_01,
    another subset's <subset>_00 and <subset>_01).
    A pair: a smooth scene's 16-bit depth (mm) and 8-bit RGB texture on a
    480 x 640 Kinect sensor (f = 570.3, principal point at the centre), and a
    cloud of CLOUD_POINTS points of the same surface, sampled at continuous
    pixel positions over columns 0.3 W .. 1.4 W (so it partly overlaps the
    view), in a world frame under a known camera-from-cloud pose."""
    import pickle

    import numpy as np
    from scipy.spatial.transform import Rotation

    rs = np.random.RandomState(seed)
    h, w = SENSOR_HW
    k = np.array([[KINECT_F, 0, (w - 1) / 2], [0, KINECT_F, (h - 1) / 2], [0, 0, 1]])
    meta = []
    for i in range(BATCH_PAIRS):
        scene = f"{'scene' if subset == 'test' else subset}_{i // 2:02d}"
        a = rs.rand(6)

        def depth_at(u, v):
            return (1.8 + 0.4 * a[0] + 0.3 * np.sin(u / 70.0 + 6 * a[1])
                    + 0.2 * np.cos(v / 55.0 + 6 * a[2]) + 4e-4 * (u - w / 2) * (a[3] - 0.5))

        vv, uu = np.mgrid[0:h, 0:w].astype(np.float64)
        depth_mm = np.round(depth_at(uu, vv) * 1000).astype(np.uint16)
        depth_mm[: 12 + int(20 * a[4]), : 40] = 0                # a hole without depth
        tex = 0.5 + 0.25 * np.sin(uu / 9.0 + 6 * a[5]) * np.cos(vv / 13.0) \
            + 0.1 * rs.rand(h, w)
        rgb = np.clip(np.stack([tex, tex ** 1.2, 1.0 - 0.5 * tex], -1) * 255, 0, 255)
        u = rs.uniform(0.3 * w, 1.4 * w, CLOUD_POINTS)
        v = rs.uniform(0, h, CLOUD_POINTS)
        z = depth_at(u, v)
        cam = np.stack([(u - k[0, 2]) * z / KINECT_F, (v - k[1, 2]) * z / KINECT_F, z], -1)
        rot = Rotation.from_euler("zyx", rs.uniform(-np.pi, np.pi, 3)).as_matrix()
        trn = rs.randn(3) * 0.5
        tfm = np.eye(4)
        tfm[:3, :3], tfm[:3, 3] = rot, trn
        world = ((cam - trn) @ rot).astype(np.float32)
        d = os.path.join(root, "data", scene)
        for sub in ("depth", "image", "cloud"):
            os.makedirs(os.path.join(d, sub), exist_ok=True)
        np.savetxt(os.path.join(d, "camera-intrinsics.txt"), k)
        write_png(os.path.join(d, "depth", f"{i:06d}.png"), depth_mm)
        write_png(os.path.join(d, "image", f"{i:06d}.png"), rgb.astype(np.uint8))
        np.save(os.path.join(d, "cloud", f"{i:06d}.npy"), world)
        meta.append({"scene_name": scene, "depth_file": f"{scene}/depth/{i:06d}.png",
                     "image_file": f"{scene}/image/{i:06d}.png",
                     "cloud_file": f"{scene}/cloud/{i:06d}.npy", "overlap": 0.5,
                     "cloud_to_image": tfm.astype(np.float32)})
    os.makedirs(os.path.join(root, "metadata"), exist_ok=True)
    with open(os.path.join(root, "metadata", f"{subset}.pkl"), "wb") as f:
        pickle.dump(meta, f)


def data_2d3d(root, subset="test", augment=False, stride=8, towers=None):
    """A subset of the split read back through the port's reader (with the
    training augmentation when ``augment``), calibrated and cropped to the
    coarse ``stride`` as main.py does, with each pair's tower outputs from the
    TowerRunner ``towers`` when given: (batch of CPU tensors, spec, scene
    names, pixels a pair)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec_2d3d
    from diffreg_tpu_torch.data.collate2d3d import batch_2d3d, build_2d3d_sample
    from diffreg_tpu_torch.data.datasets2d3d import RGBDScenes2D3DPairDataset

    ds = RGBDScenes2D3DPairDataset(root, subset, use_augmentation=augment)
    raws = [ds[i] for i in range(len(ds))]
    spec = calibrate_spec_2d3d([r["points"] for r in raws])
    samples = []
    for r in raws:
        h, w = (n // stride * stride for n in r["depth"].shape)
        for key in ("depth", "image", "image_gray"):
            r[key] = r[key][:h, :w]
        samples.append(build_2d3d_sample(r, spec, stride))
        if towers is not None:
            samples[-1]["dino_feats"] = towers.dino_tokens(r["image"][None])[0]
            samples[-1]["mono_depth"] = towers.mono_depth(r["image"][None])[0]
    batch = batch_2d3d(samples)
    return batch, spec, [r["scene_name"] for r in raws], int(np.prod(batch.image.shape[1:3]))


def attention_cases_2d3d(batch, n_tokens):
    """The fusion's attention calls of one pass, as (name, query length, key
    mask, calls): image self (no mask), node self (the nodes' padding), image
    -> node, node -> image, three of each."""
    import torch

    b = batch.batch_size
    nodes = batch.masks[-1].cuda()
    img = torch.ones(b, n_tokens, dtype=torch.bool, device="cuda")
    n = nodes.shape[1]
    return [("image_self", n_tokens, img, 3), ("node_self", n, nodes, 3),
            ("image_to_node", n_tokens, nodes, 3), ("node_to_image", n, img, 3)]


def check_attention_2d3d(batch, n_tokens, cfg, gen):
    """Kernel vs plain attention at the fusion's shapes (head width 64), and a
    node count that is not a multiple of 32 (pair 0's real nodes); SDPA as the
    yardstick. Returns the JSON entry (totals per fusion pass) and the cases."""
    import torch
    import torch.nn.functional as F

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda, masked_attention_plain

    h = cfg.num_heads
    d = cfg.hidden_dim // h
    scale = d ** -0.5
    cases = attention_cases_2d3d(batch, n_tokens)
    real = int(batch.masks[-1][0].sum())
    real -= 1 if real % 32 == 0 else 0
    tail = [("node_self_tail", real, batch.masks[-1][:1, :real].cuda().contiguous(), 0)]
    totals = {k: 0.0 for k in ("ms", "plain_ms", "library_ms", "bytes", "mma_flops", "flops")}
    worst, per_shape = 0.0, []
    with torch.inference_mode():
        for name, length, kv_mask, calls in cases + tail:
            bb, keys = kv_mask.shape
            q = torch.randn(bb, h, length, d, generator=gen).cuda()
            k, v = (torch.randn(bb, h, keys, d, generator=gen).cuda() for _ in range(2))
            kv_mask = kv_mask.contiguous()
            before = masked_attention_cuda.launches
            got = masked_attention_cuda(q, k, v, kv_mask, scale)
            ref = masked_attention_plain(q, k, v, kv_mask, scale)
            torch.cuda.synchronize()
            assert masked_attention_cuda.launches == before + 1
            err = float((got - ref).abs().max())
            if not math.isfinite(err) or err > ATTENTION_ABS_TOL:
                raise AssertionError(f"attention {name} (2D-3D): max abs err {err}")
            worst = max(worst, err)
            lib_mask = kv_mask[:, None, None, :]
            lib = F.scaled_dot_product_attention(q, k, v, attn_mask=lib_mask, scale=scale)
            lib_err = float((lib - ref).abs().max())
            ms = time_cuda(lambda: masked_attention_cuda(q, k, v, kv_mask, scale), 20)
            plain = time_cuda(lambda: masked_attention_plain(q, k, v, kv_mask, scale), 5,
                              warmup=1)
            lib_ms = time_cuda(lambda: F.scaled_dot_product_attention(
                q, k, v, attn_mask=lib_mask, scale=scale), 20)
            nbytes, mma_flops, flops = attention_work(q, k, kv_mask)
            bms, by = bound_ms(nbytes, mma_flops, flops)
            per_shape.append({"case": name + " (2D-3D)", "b": bb, "h": h, "l": length, "s": keys,
                              "d": d, "calls": calls, "ms": ms, "plain_ms": plain,
                              "library_ms": lib_ms, "bound_ms": bms, "bound_by": by,
                              "max_abs_err": err, "library_max_abs_err": lib_err})
            log(f"attention {name} (2D-3D) [{bb},{h},{length}x{keys},{d}] x{calls}: err "
                f"{err:.3e} (limit {ATTENTION_ABS_TOL:.1e}) kernel {ms:.4f} ms plain "
                f"{plain:.4f} ms sdpa {lib_ms:.4f} ms (err {lib_err:.3e}) bound {bms:.4f} ms "
                f"({by})")
            for key, val in (("ms", ms), ("plain_ms", plain), ("library_ms", lib_ms),
                             ("bytes", nbytes), ("mma_flops", mma_flops), ("flops", flops)):
                totals[key] += calls * val
    bms, by = bound_ms(totals["bytes"], totals["mma_flops"], totals["flops"])
    entry = {"max_abs_err": worst, "ms": totals["ms"], "plain_ms": totals["plain_ms"],
             "bound_ms": bms, "bound_by": by, "library_ms": totals["library_ms"],
             "per": "one fusion pass (12 calls)"}
    return entry, per_shape, cases


def attention_gradients_2d3d(cases, cfg, gen):
    """MaskedAttentionFunction against plain autograd at each of the fusion's
    four shapes; returns (worst relative error, backward ms per call by case,
    backward ms per fusion pass)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (MaskedAttentionFunction, masked_attention_cuda,
                                                 masked_attention_plain)

    h = cfg.num_heads
    d = cfg.hidden_dim // h
    scale = d ** -0.5
    worst, per_call, per_pass = 0.0, {}, 0.0
    for name, length, kv_mask, calls in cases:
        bb, keys = kv_mask.shape
        qkv = [torch.randn(bb, h, n, d, generator=gen).cuda() for n in (length, keys, keys)]
        err, ms = grad_case(f"attention {name} (2D-3D) [{bb},{h},{length}x{keys},{d}]",
                            lambda *a: MaskedAttentionFunction.apply(*a, scale),
                            (*qkv, kv_mask.contiguous()), (0, 1, 2),
                            lambda *a: masked_attention_plain(*a, scale), gen, calls,
                            masked_attention_cuda)
        del qkv
        torch.cuda.empty_cache()
        worst, per_call[name] = max(worst, err), ms
        per_pass += calls * ms
    return worst, per_call, per_pass


def fixed_draws_tester(model, cfg, device, x_init, u):
    """A TwoDThreeDTester whose draws are the given tensors (pair 0 on the card
    and on the CPU from the same start and PnP draws)."""
    from diffreg_tpu_torch.engine.tester2d3d import TwoDThreeDTester

    t = TwoDThreeDTester(model, cfg, device=device)
    t.draw_start = lambda batch, n, m, generator: x_init.to(device)
    t.draw_pnp = lambda batch, generator: u.to(device)
    return t


def check_pnp_2d3d(batch_cpu, u, gen):
    """PnP-RANSAC on the card and on the CPU against pair 0's ground-truth pose:
    2048 of its cloud points in front of the camera, projected under the pose,
    40% of the pixels moved 20 to 100 px, so that none is an inlier at the
    8 px tolerance. (A random pixel can land within 8 px of its point's
    projection; a pose that counts it beats the exact one by one inlier, and
    RANSAC rightly keeps that pose.)"""
    import torch

    from diffreg_tpu_torch.eval.pnp import pnp_ransac

    pts = batch_cpu.points[0][0][batch_cpu.masks[0][0]]
    tfm, k = batch_cpu.transform[0], batch_cpu.intrinsics[0]
    cam = pts @ tfm[:3, :3].T + tfm[:3, 3]
    keep = torch.nonzero(cam[:, 2] > 0.2)[:, 0]
    sel = keep[torch.randperm(len(keep), generator=gen)[:2048]]
    pts, cam = pts[sel], cam[sel]
    pix = torch.stack([cam[:, 0] / cam[:, 2] * k[0, 0] + k[0, 2],
                       cam[:, 1] / cam[:, 2] * k[1, 1] + k[1, 2]], -1)
    bad = torch.rand(len(pix), generator=gen) < 0.4
    angle = torch.rand(int(bad.sum()), generator=gen) * 2 * math.pi
    radius = 20.0 + 80.0 * torch.rand(int(bad.sum()), generator=gen)
    pix[bad] += torch.stack([torch.cos(angle), torch.sin(angle)], -1) * radius[:, None]
    valid = torch.ones(len(pts), dtype=torch.bool)
    for name, dev in (("card", "cuda"), ("CPU", "cpu")):
        res = pnp_ransac(u.to(dev), pts.to(dev), pix.to(dev), valid.to(dev), k.to(dev))
        err = max(float((res.rotation.cpu() - tfm[:3, :3]).abs().max()),
                  float((res.translation.cpu()[:, 0] - tfm[:3, 3]).abs().max()))
        log(f"PnP on the {name}: {int(res.inlier_count)} inliers of {len(pts)} "
            f"({int((~bad).sum())} true), pose error {err:.3e} (limit {PNP_POSE_TOL:.0e})")
        if not (bool(res.success) and err <= PNP_POSE_TOL):
            raise AssertionError(f"PnP on the {name} missed the ground-truth pose by {err}")


def mask_agreement(got, ref):
    """Pair 0's top-1 union masks, card (``got``) against CPU (``ref``): the
    confidences' largest difference on valid entries, the entries that differ
    (and the cap, 1% of the CPU mask's entries plus 2), those outside a
    near-tie (a row's or column's best two CPU confidences within twice the
    confidence limit), and the share of real node rows free of a near-tie."""
    import torch

    valid = ref["node_masks"][:, :, None] & ref["img_valid_c"][:, None, :]
    conf = ref["conf_matrix_pred"]
    conf_err = float((got["conf_matrix_pred"].cpu() - conf).abs()[valid].max())
    differ = (got["corr_mask"].cpu() != ref["corr_mask"]) & valid
    c = torch.where(valid, conf, torch.full_like(conf, -1.0))
    top_r, top_c = c.topk(2, dim=2).values, c.topk(2, dim=1).values
    row_tie = (top_r[..., 0] - top_r[..., 1]) <= 2 * CONF_2D3D_ABS_TOL        # [1, N]
    col_tie = (top_c[:, 0] - top_c[:, 1]) <= 2 * CONF_2D3D_ABS_TOL            # [1, M]
    real = ref["node_masks"][0]
    out = {"conf_err": conf_err, "differ": int(differ.sum()),
           "cap": MASK_DIFFER_SHARE * max(int(ref["corr_mask"].sum()), 1) + 2,
           "unexplained": int((differ & ~(row_tie[:, :, None] | col_tie[:, None, :])).sum()),
           "tie_free": float((~row_tie[0] & real).sum()) / max(int(real.sum()), 1)}
    out["text"] = (f"conf {conf_err:.3e} (limit {CONF_2D3D_ABS_TOL:.0e}, max conf "
                   f"{float(conf.max()):.3e}), {out['differ']} of {int(valid.sum())} valid mask "
                   f"entries differ (cap {out['cap']:.0f}), {out['unexplained']} outside a "
                   f"near-tie (limit 0), real node rows free of a near-tie {out['tie_free']:.4f} "
                   f"of {int(real.sum())} (limit {TIE_FREE_ROWS_MIN}), masks "
                   f"{int(got['corr_mask'].sum())} vs {int(ref['corr_mask'].sum())}")
    return out


def pair0_2d3d(cfg, tcfg, batch_cpu, x_init, u, launches, key, tag):
    """Pair 0 on the card and on the CPU (plain versions) at STEPS_2D3D_CPU DDIM
    steps with the same weights and draws, the matchers sharpened: the DDIM's
    and the coarse matcher's confidences and top-1 masks (mask_agreement's
    limits), and the fine matches on the card's coarse correspondences. The
    card's attention launches count under ``launches[key]``."""
    import torch

    from diffreg_tpu_torch.models.pipeline_2d3d import (DiffReg2D3D, fine_matching,
                                                        patch_pixel_table)
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.ops.vision import create_meshgrid

    cfg_short = dataclasses.replace(cfg, sample_steps=STEPS_2D3D_CPU)
    one = batch_cpu.select(slice(0, 1))
    res = {}
    for dev in ("cuda", "cpu"):
        m2 = DiffReg2D3D(cfg_short, device=dev, seed=0)
        with torch.no_grad():
            for matcher in (m2.coarse_matching, m2.denoising_coarse_matching):
                matcher.src_proj.weight.mul_(SHARPEN_2D3D)
        t = fixed_draws_tester(m2, tcfg, dev, x_init[:1], u[:1])
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        t0 = time.perf_counter()
        with torch.inference_mode():
            res[dev] = t.forward(one.to(dev), None)
            res[dev + "_backbone"] = m2(one.to(dev), mode="backbone")
        res[dev + "_s"] = time.perf_counter() - t0
        if dev == "cuda":
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 16 or n_at != 12 * (2 + STEPS_2D3D_CPU):
                raise AssertionError(f"{tag} pair 0: {n_kp} KPConv, {n_at} attention launches")
            launches["kpconv"] += n_kp
            launches[key] += n_at
    (got, got_corrs, got_pairs), (ref, _, ref_pairs) = res["cuda"], res["cpu"]
    ddim = mask_agreement(got, ref)
    coarse = mask_agreement(res["cuda_backbone"], res["cpu_backbone"])

    # the CPU's fine matching of its own features on the card's coarse correspondences
    h, w = one.image.shape[1:3]
    table = torch.from_numpy(patch_pixel_table(h, w, cfg.coarse_stride))
    pix = create_meshgrid(h, w, flatten=True).flip(-1).contiguous()
    part = ref["partition"]
    fm_ref = fine_matching(
        ref["img_feats_f"][0], one.img_points[0], pix, ref["pcd_feats_f"][0], one.points[0][0],
        got_corrs.src_idx[0].cpu(), got_corrs.tgt_idx[0].cpu(), got_corrs.valid[0].cpu(),
        part.node_knn_indices[0], part.node_knn_masks[0], table, tcfg.max_fine_corr,
        topk=tcfg.fine_topk, threshold=tcfg.fine_threshold)

    def fine_set(fm):
        v = fm["corr_valid"].cpu()
        return set(zip(fm["img_corr_indices"].cpu()[v].tolist(),
                       fm["pcd_corr_indices"].cpu()[v].tolist()))
    fg, fr = fine_set(got_pairs[0]["fm"]), fine_set(fm_ref)
    fine_agree = len(fg & fr) / max(len(fg | fr), 1)
    log(f"{tag} card vs CPU, pair 0 ({STEPS_2D3D_CPU} steps, matchers sharpened x{SHARPEN_2D3D}, "
        f"CPU {res['cpu_s']:.1f} s, card {res['cuda_s']:.2f} s): DDIM {ddim['text']}; coarse "
        f"matcher (backbone mode) {coarse['text']}; fine correspondences on the card's coarse "
        f"ones {len(fg)} vs {len(fr)}, shared {fine_agree:.4f} of the union (limit "
        f"{FINE_2D3D_AGREEMENT}); the CPU's own run {int(ref_pairs[0]['n_corr'])}; IR "
        f"{float(got_pairs[0]['IR']):.4f} vs {float(ref_pairs[0]['IR']):.4f}")
    for name, agree in (("DDIM", ddim), ("coarse matcher", coarse)):
        if not agree["conf_err"] <= CONF_2D3D_ABS_TOL:
            raise AssertionError(f"{tag} {name}: confidences differ from the CPU's by "
                                 f"{agree['conf_err']}")
        if agree["unexplained"]:
            raise AssertionError(f"{tag} {name}: {agree['unexplained']} corr_mask entries differ "
                                 "outside near-ties")
    # the cap and the tie-free share hold the coarse matcher's mask, not the
    # DDIM's: with random weights the DDIM's rows are all near-ties
    if not (coarse["differ"] <= coarse["cap"] and coarse["tie_free"] >= TIE_FREE_ROWS_MIN):
        raise AssertionError(f"{tag} coarse matcher: {coarse['text']}")
    if not (len(fr) > 0 and fine_agree >= FINE_2D3D_AGREEMENT):
        raise AssertionError(f"{tag}: fine correspondences share {fine_agree} of the union")


def run_2d3d(batch_cpu, scenes, cfg, launches, gen, key="masked_attention_d64", tag="2D-3D",
             config="configs/test/rgbdv2.yaml"):
    """The 2D-3D path at full width through TwoDThreeDTester (one warm-up, three
    timed runs, launches asserted), where its time goes, pair 0 on the CPU
    against the card at STEPS_2D3D_CPU steps, and PnP on a known pose. The
    attention launches count under ``launches[key]``."""
    import torch

    from diffreg_tpu_torch.engine.tester2d3d import Test2D3DConfig, TwoDThreeDTester
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.ops.partition import point_to_node_partition

    per_forward = 12 * (1 + cfg.sample_steps)
    tcfg = Test2D3DConfig(fine_threshold=FINE_THR_2D3D)
    model = DiffReg2D3D(cfg, device="cuda", seed=0)
    tester = TwoDThreeDTester(model, tcfg, device="cuda")
    batch = batch_cpu.to("cuda")
    make_iter = lambda: iter([(batch, scenes)])  # noqa: E731
    torch.cuda.reset_peak_memory_stats()
    with torch.inference_mode():
        tester.test(make_iter, torch.Generator("cuda").manual_seed(0))           # warm-up
        times = []
        for run in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: tester.test(
                make_iter, torch.Generator("cuda").manual_seed(1 + run)))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 8 or n_at != per_forward:
                raise AssertionError(f"{tag} tester: {n_kp} KPConv launches (want 8), {n_at} "
                                     f"attention launches (want {per_forward})")
            launches["kpconv"] += n_kp
            launches[key] += n_at
            times.append(seconds)
            if not (summary["pairs"] == BATCH_PAIRS and summary["n_corr"] > 0
                    and all(math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE",
                                                                  "RTE"))):
                raise AssertionError(f"{tag} tester summary {summary}")
        seconds = sorted(times)[TIMED_RUNS // 2]
        peak = torch.cuda.max_memory_allocated() / 2**30
        n = batch.points[-1].shape[1]
        s = cfg.coarse_stride
        m = (batch.image.shape[1] // s) * (batch.image.shape[2] // s)
        x_init = torch.randn(BATCH_PAIRS, n, m, generator=gen)
        u = torch.rand(BATCH_PAIRS, PNP_HYPOTHESES, 6, generator=gen)
        fixed = fixed_draws_tester(model, tcfg, "cuda", x_init, u)
        _, enc_s = wall(lambda: model.encode(batch))
        _, part_s = wall(lambda: point_to_node_partition(
            batch.points[0], batch.points[-1], batch.masks[0], batch.masks[-1],
            cfg.pcd_num_points_in_patch))
        _, bb_s = wall(lambda: model(batch, mode="backbone"))
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        _, ddim_s = wall(lambda: model(batch, mode="ddim", x_init=x_init.cuda()))
        (out, corrs, pairs), fwd_s = wall(lambda: fixed.forward(batch, None))
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 16 or n_at != 2 * per_forward:
            raise AssertionError(f"{tag} forwards: {n_kp} KPConv, {n_at} attention launches")
        launches["kpconv"] += n_kp
        launches[key] += n_at
    coarse = [int(c) for c in out["corr_mask"].sum(dim=(1, 2))]
    fine = [int(p["n_corr"]) for p in pairs]
    log(f"{tag} path (TwoDThreeDTester, {config} widths, SAMPLE_STEP "
        f"{cfg.sample_steps}, fine threshold {FINE_THR_2D3D}): {BATCH_PAIRS} pairs in "
        f"{seconds:.4f} s (median of {', '.join(f'{t:.4f}' for t in times)}) = "
        f"{BATCH_PAIRS / seconds:.3f} pairs/s; IR {summary['IR']:.4f} PIR {summary['PIR']:.4f} "
        f"RR {summary['RR']:.4f} RRE {summary['RRE']:.3f} RTE {summary['RTE']:.4f}; coarse "
        f"correspondences {coarse}, fine {fine}; launches kpconv {n_kp // 2} attention "
        f"{n_at // 2} a forward; peak memory {peak:.2f} GiB")
    log(f"{tag} where the time goes ({BATCH_PAIRS} pairs): encode {enc_s:.4f} s, partition "
        f"{part_s:.4f} s, backbone mode (encode, partition, one fusion pass, matcher) "
        f"{bb_s:.4f} s, ddim forward {ddim_s:.4f} s (so {cfg.sample_steps} DDIM steps "
        f"{ddim_s - bb_s:.4f} s = {(ddim_s - bb_s) / cfg.sample_steps * 1e3:.2f} ms a step), "
        f"fine matching + PnP {fwd_s - ddim_s:.4f} s")

    # ---- pair 0 on the CPU, same weights and draws, at STEPS_2D3D_CPU ----
    pair0_2d3d(cfg, tcfg, batch_cpu, x_init, u, launches, key, tag)
    check_pnp_2d3d(batch_cpu, u[0], gen)
    return {"pairs_per_s": BATCH_PAIRS / seconds, "peak_gib": peak,
            "ms_per_ddim_step": (ddim_s - bb_s) / cfg.sample_steps * 1e3, "encode_s": enc_s,
            "backbone_s": bb_s, "ddim_s": ddim_s, "fine_and_pnp_s": fwd_s - ddim_s}


def run_cli_2d3d(repo, split_root, launches):
    """``diffreg_tpu_torch.main`` on the 2D-3D configs in a temporary working
    directory: rgbdv2.yaml and 7scenes.yaml with --demo, and rgbdv2.yaml on the
    split under ``split_root`` with a checkpoint of random weights (main's own
    calibration, the PNG reader, the restore, the npz cache, eval_from_cache)."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    configs = os.path.join(repo, "configs", "test")
    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        disk = load_yaml(os.path.join(configs, "rgbdv2.yaml"))
        disk.update(data_root=split_root, exp_dir="disk-rgbdv2", pretrain=os.path.join(tmp, "ckpt"))
        CheckpointManager(disk["pretrain"]).save(1, create_train_state(
            DiffReg2D3D(pipeline_2d3d_config(disk), device="cpu", seed=0), OptimConfig()))
        with open(os.path.join(tmp, "disk_rgbdv2.yaml"), "w") as f:
            yaml.safe_dump(disk, f)
        # (name, config, extra arguments, DDIM steps)
        runs = [("rgbdv2 test (demo)", os.path.join(configs, "rgbdv2.yaml"), ["--demo"], 50),
                ("7scenes test (demo)", os.path.join(configs, "7scenes.yaml"), ["--demo"], 10),
                ("rgbdv2 test (on disk)", os.path.join(tmp, "disk_rgbdv2.yaml"), [], 50)]
        os.chdir(tmp)
        try:
            for name, config, extra, steps in runs:
                kpconv_cuda.launches = 0
                masked_attention_cuda.launches = 0
                argv = ["--config", config, "--num-pairs", str(BATCH_PAIRS),
                        "--batch-size", str(BATCH_PAIRS), *extra]
                summary, seconds = wall(lambda: cli(argv))
                n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
                if n_kp != 8 or n_at != 12 * (1 + steps):
                    raise AssertionError(f"main {name}: {n_kp} KPConv, {n_at} attention launches")
                if not (summary["pairs"] == BATCH_PAIRS and all(
                        math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE", "RTE"))):
                    raise AssertionError(f"main {name}: summary {summary}")
                if "disk" in name:
                    ev = summary.get("eval", {})
                    if sorted(ev.get("scenes", {})) != ["scene_00", "scene_01"] \
                            or not math.isfinite(ev.get("PIR", math.nan)):
                        raise AssertionError(f"main {name}: eval_from_cache gave {ev}")
                launches["kpconv"] += n_kp
                launches["masked_attention_d64"] += n_at
                log(f"main {name}, {BATCH_PAIRS} pairs: {seconds:.2f} s, launches kpconv {n_kp} "
                    f"attention {n_at}; " + ", ".join(
                        f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                        for k, v in summary.items() if k != "eval"))
        finally:
            os.chdir(cwd)


def counted_train_step_2d3d(step, rows, launches):
    """``step`` with its launches counted and asserted (8 KPConv, 24
    attention), its loss terms and gradients' finiteness checked, and its
    forward / backward / optimizer seconds recorded in ``rows``."""
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.logging import Timers

    def counted(state, batch, inputs, timers=None):
        phases = Timers()
        kpconv_cuda.launches = 0
        masked_attention_cuda.launches = 0
        state, info = step(state, batch, inputs, phases)
        n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
        if n_kp != 8 or n_at != TRAIN_ATTENTION_2D3D:
            raise AssertionError(f"2D-3D train step: {n_kp} KPConv launches (want 8), {n_at} "
                                 f"attention launches (want {TRAIN_ATTENTION_2D3D})")
        terms = {k: float(info[k]) for k in LOSS_TERMS_2D3D}
        if not (all(math.isfinite(v) for v in terms.values()) and bool(info["grads_finite"])):
            raise AssertionError(f"2D-3D train step: {terms}, grads finite "
                                 f"{bool(info['grads_finite'])}")
        launches["kpconv_train_2d3d"] += n_kp
        launches["masked_attention_train_2d3d"] += n_at
        rows.append({**terms, "grad_norm": float(info["grad_norm"]), **phases.summary()})
        return state, info
    return counted


def train_2d3d_trainer(cfg, batch_cpu, circle_cfg, fine_cfg, launches):
    """The Trainer at configs/train/rgbdv2.yaml widths (batch 1, Adam at lr
    1e-4): one epoch of a warm-up and TIMED_STEPS_2D3D timed steps over the
    train split's pairs, then ``resume`` from its checkpoint."""
    import tempfile

    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig
    from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
    from diffreg_tpu_torch.engine.trainer import Trainer, TrainerConfig
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D

    optim = OptimConfig(optimizer="adam", lr=1e-4)
    step = make_train_step_2d3d(circle_cfg, LossConfig(), fine_cfg)
    rows = []
    steps = 1 + TIMED_STEPS_2D3D
    pairs = [batch_cpu.select(slice(i % BATCH_PAIRS, i % BATCH_PAIRS + 1)) for i in range(steps)]
    state = create_train_state_2d3d(DiffReg2D3D(cfg, device="cuda", seed=0), optim)
    torch.cuda.reset_peak_memory_stats()
    with tempfile.TemporaryDirectory() as tmp:
        trainer = Trainer(counted_train_step_2d3d(step, rows, launches), state,
                          lambda epoch: ((p, None) for p in pairs),
                          TrainerConfig(max_epoch=1, log_every=steps, save_dir=tmp), seed=0)
        t0 = time.perf_counter()
        state = trainer.train()
        epoch_s = time.perf_counter() - t0
        peak = torch.cuda.max_memory_allocated() / 2**30
        fresh = create_train_state_2d3d(DiffReg2D3D(cfg, device="cuda", seed=1), optim)
        resumed = Trainer(step, fresh, lambda epoch: iter(()),
                          TrainerConfig(max_epoch=1, save_dir=tmp), seed=0)
        resumed.resume()
    same = all(torch.equal(p, q) for p, q in zip(state.model.parameters(),
                                                 resumed.state.model.parameters()))
    if not (same and resumed.start_epoch == 1 and resumed.state.step == steps
            and resumed.state.optimizer.count == steps):
        raise AssertionError(f"2D-3D resume: params equal {same}, epoch {resumed.start_epoch}, "
                             f"step {resumed.state.step}, updates {resumed.state.optimizer.count}")
    timed = rows[1:]
    med = lambda key: sorted(r[key] for r in timed)[len(timed) // 2]  # noqa: E731
    step_s = med("forward") + med("backward") + med("optimizer")
    log(f"2D-3D train (configs/train/rgbdv2.yaml widths, 1 pair a step, Adam lr {optim.lr}): "
        f"{steps} steps in {epoch_s:.3f} s (epoch with checkpoint); per timed step median "
        f"forward {med('forward'):.4f} s, backward {med('backward'):.4f} s, optimizer "
        f"{med('optimizer'):.4f} s = {step_s:.4f} s: {1 / step_s:.3f} steps/s (backward "
        f"{med('backward') / step_s:.3f} of the step); peak memory {peak:.2f} GiB; launches a "
        f"step kpconv 8 attention {TRAIN_ATTENTION_2D3D}; resume ok")
    log("2D-3D train losses " + "; ".join(
        ", ".join(f"{k} {r[k]:.5f}" for k in LOSS_TERMS_2D3D) for r in rows))
    log("2D-3D train step seconds (forward, backward, optimizer) " + "; ".join(
        f"{r['forward']:.4f} {r['backward']:.4f} {r['optimizer']:.4f}" for r in rows))
    return {"steps_per_s": 1 / step_s, "forward_s": med("forward"),
            "backward_s": med("backward"), "optimizer_s": med("optimizer"), "peak_gib": peak}


def noisy_warp_2d3d(model, batch, inputs):
    """The Sinkhorn confidences of the noisy GT matrix that the 2D-3D warp
    solves soft Procrustes on, and that solve's condition numbers."""
    import torch

    from diffreg_tpu_torch.diffusion.schedule import q_sample
    from diffreg_tpu_torch.geometry.procrustes import soft_procrustes
    from diffreg_tpu_torch.models.pipeline_2d3d import _matrix_from_indices
    from diffreg_tpu_torch.ops.partition import point_to_node_partition

    cfg = model.cfg
    with torch.no_grad():
        part = point_to_node_partition(batch.points[0], batch.points[-1], batch.masks[0],
                                       batch.masks[-1], cfg.pcd_num_points_in_patch)
        nodes = part.node_masks & (part.node_sizes > cfg.pcd_min_node_size)
        centers, valid = model.patch_centers(batch)
        x = q_sample(model.schedule, _matrix_from_indices(
            batch.gt_src, batch.gt_tgt, batch.gt_valid, nodes.shape[1], valid.shape[1]),
            inputs["t"], inputs["noise"])
        conf = model.denoising_coarse_matching.sinkhorn(x, nodes, valid, batch.masks[-1],
                                                        torch.ones_like(valid))
        res = soft_procrustes(conf, batch.points[-1], centers, nodes, valid,
                              sample_rate=cfg.procrustes_sample_rate,
                              max_condition_num=cfg.procrustes_max_condition,
                              use_masked_lengths=True)
    return conf, nodes, valid, res.condition


def train_step_2d3d_card_vs_cpu(cfg, one, circle_cfg, fine_cfg):
    """One 2D-3D train step of one pair on the card and on the CPU, from the
    same weights and draws: the loss, every gradient, the noisy matrix's
    top-k cut gap against the two devices' difference there."""
    import torch

    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.losses2d3d import loss_2d3d
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D

    models = {"CPU": DiffReg2D3D(cfg, device="cpu", seed=0),
              "card": DiffReg2D3D(cfg, device="cuda", seed=0)}
    # a draw whose noisy-matrix warp cuts its top-k in a gap wider than the
    # two devices' difference of those confidences
    for seed in range(50):
        inputs = models["CPU"].draw_train_inputs(one, torch.Generator().manual_seed(seed))
        conf, nodes, valid, cond = noisy_warp_2d3d(models["CPU"], one, inputs)
        gap = cut_gap(conf, nodes, valid)
        if gap > CUT_GAP_MIN and abs(float(cond[0]) - cfg.procrustes_max_condition) > 1.0:
            break
    card_conf = noisy_warp_2d3d(models["card"], one.to("cuda"),
                                {k: v.cuda() for k, v in inputs.items()})[0]
    warp_err = float((card_conf.cpu() - conf).abs().max())
    res = {}
    for name, model in models.items():
        dev = "cpu" if name == "CPU" else "cuda"
        batch = one.to(dev)
        t0 = time.perf_counter()
        out = model.train_forward(batch, **{k: v.to(dev) for k, v in inputs.items()})
        loss, info = loss_2d3d(out, circle_cfg, LossConfig(), batch=batch, fine_cfg=fine_cfg)
        params = [p for _, p in model.named_trained_parameters()]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        res[name] = {"loss": float(loss.detach()),
                     "info": {k: float(v.detach()) for k, v in info.items()},
                     "grads": [None if g is None else g.cpu() for g in grads],
                     "seconds": time.perf_counter() - t0}
    cpu, card = res["CPU"], res["card"]
    loss_err = abs(card["loss"] - cpu["loss"]) / abs(cpu["loss"])
    names = [n for n, _ in models["CPU"].named_trained_parameters()]
    errs, diff_sq, ref_sq, finite, key_bias = [], 0.0, 0.0, True, 0.0
    largest = max(float(g.abs().max()) for g in cpu["grads"] if g is not None)
    for n, g_card, g_cpu in zip(names, card["grads"], cpu["grads"]):
        if (g_card is None) != (g_cpu is None):
            raise AssertionError(f"2D-3D train step: gradient of {n} is None on one side only")
        if g_cpu is None:
            continue
        finite &= bool(torch.isfinite(g_card).all()) and bool(torch.isfinite(g_cpu).all())
        if n.endswith(KEY_BIAS):
            # softmax ignores a key bias: its gradient is rounding on both devices
            key_bias = max(key_bias, float(g_card.abs().max()), float(g_cpu.abs().max()))
            continue
        diff = (g_card - g_cpu).double()
        errs.append((float(diff.abs().max()) / max(float(g_cpu.abs().max()), 1e-30), n))
        diff_sq += float((diff * diff).sum())
        ref_sq += float((g_cpu.double() ** 2).sum())
    errs.sort(reverse=True)
    worst, median = errs[0][0], errs[len(errs) // 2][0]
    global_err = math.sqrt(diff_sq / ref_sq)
    log(f"2D-3D train step card vs CPU (1 pair, CPU {cpu['seconds']:.1f} s, card "
        f"{card['seconds']:.2f} s): draw seed {seed}, noisy-warp cut gap {gap:.3e} against the "
        f"devices' difference there {warp_err:.3e}, condition {float(cond[0]):.3f} (gate "
        f"{cfg.procrustes_max_condition}); loss {card['loss']:.6f} vs {cpu['loss']:.6f} (rel err "
        f"{loss_err:.3e}, limit {LOSS_REL_TOL:.0e}); terms " + ", ".join(
            f"{k} {card['info'][k]:.6f}/{cpu['info'][k]:.6f}" for k in LOSS_TERMS_2D3D)
        + f"; gradients of {len(errs)} tensors: worst {worst:.3e} (limit {GRAD_WORST_TOL:.0e}), "
        f"median {median:.3e} (limit {GRAD_MEDIAN_TOL:.0e}), global {global_err:.3e} (limit "
        f"{GRAD_GLOBAL_TOL:.0e}); attention key biases (no gradient but rounding) "
        f"{key_bias / largest:.3e} of the largest gradient entry (limit {KEY_BIAS_TOL:.0e})")
    log("  worst gradient tensors: " + ", ".join(f"{n} {e:.3e}" for e, n in errs[:5]))
    if not key_bias <= KEY_BIAS_TOL * largest:
        raise AssertionError(f"2D-3D train step: an attention key bias has a gradient of {key_bias}")
    if not (gap > CUT_GAP_MIN and gap > 10 * warp_err
            and abs(float(cond[0]) - cfg.procrustes_max_condition) > 1.0):
        raise AssertionError(f"2D-3D train step: the warp's top-k cut (gap {gap}, devices "
                             f"{warp_err}) or its gate falls on a near-tie")
    if not finite:
        raise AssertionError("2D-3D train step: non-finite gradients")
    if not loss_err <= LOSS_REL_TOL:
        raise AssertionError(f"2D-3D train step: loss differs from the CPU's by {loss_err}")
    if not (worst <= GRAD_WORST_TOL and median <= GRAD_MEDIAN_TOL
            and global_err <= GRAD_GLOBAL_TOL):
        raise AssertionError(f"2D-3D train step: gradients differ from the CPU's (worst {worst}, "
                             f"median {median}, global {global_err})")


def run_cli_train_2d3d(repo, split_root, launches):
    """``diffreg_tpu_torch.main`` on a copy of configs/train/rgbdv2.yaml with
    ``data_root`` at the split (its train subset, augmented) and one epoch: a
    step per pair, the loss terms checked, a checkpoint written."""
    import tempfile

    import yaml

    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        raw = load_yaml(os.path.join(repo, "configs", "train", "rgbdv2.yaml"))
        raw.update(data_root=split_root, max_epoch=1)
        config = os.path.join(tmp, "train_rgbdv2.yaml")
        with open(config, "w") as f:
            yaml.safe_dump(raw, f)
        os.chdir(tmp)
        try:
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            summary, seconds = wall(lambda: cli(["--config", config, "--mode", "train"]))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            ckpt = os.path.isfile(os.path.join(tmp, "snapshot", raw["exp_dir"], "checkpoints",
                                               "1.pt"))
        finally:
            os.chdir(cwd)
    steps = summary.get("steps")
    if not (steps == BATCH_PAIRS and n_kp == 8 * steps and n_at == TRAIN_ATTENTION_2D3D * steps):
        raise AssertionError(f"main rgbdv2 train: {steps} steps, {n_kp} KPConv, {n_at} attention "
                             "launches")
    if not (ckpt and all(math.isfinite(summary.get(k, math.nan))
                         for k in LOSS_TERMS_2D3D + ("loss",))):
        raise AssertionError(f"main rgbdv2 train: checkpoint {ckpt}, summary {summary}")
    launches["kpconv_train_2d3d"] += n_kp
    launches["masked_attention_train_2d3d"] += n_at
    log(f"main rgbdv2 train (on disk, {BATCH_PAIRS} pairs, batch 1, one epoch): {seconds:.2f} s, "
        f"launches kpconv {n_kp} attention {n_at}; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}" for k, v in summary.items()))


def run_train_2d3d_phase(repo, split_root, launches):
    """Phase 16: the train subset beside the test split, the Trainer, one step
    card against CPU, and the CLI's train path."""
    from diffreg_tpu_torch.main import loss_2d3d_configs, pipeline_2d3d_config
    from diffreg_tpu_torch.utils.config import load_yaml

    raw = load_yaml(os.path.join(repo, "configs", "train", "rgbdv2.yaml"))
    cfg = pipeline_2d3d_config(raw)
    circle_cfg, fine_cfg = loss_2d3d_configs(raw)
    t0 = time.perf_counter()
    write_2d3d_split(split_root, subset="train", seed=8)
    batch_cpu, spec, _, pixels = data_2d3d(split_root, "train", augment=True)
    log(f"2D-3D train split: written, read and collated in {time.perf_counter() - t0:.2f} s; "
        f"spec {spec}; {pixels // 64} image tokens; overlap pairs "
        f"{[int(v.sum()) for v in batch_cpu.ov_valid]}, fine pairs "
        f"{[int(v.sum()) for v in batch_cpu.fine_valid]}")
    result = train_2d3d_trainer(cfg, batch_cpu, circle_cfg, fine_cfg, launches)
    train_step_2d3d_card_vs_cpu(cfg, batch_cpu.select(slice(0, 1)), circle_cfg, fine_cfg)
    run_cli_train_2d3d(repo, split_root, launches)
    return result


# ---------------------------------------------------------------- 2D-3D with the towers


def vit_flops(cfg, tokens):
    """Float operations of one DINOv2 forward over ``tokens`` tokens (the
    matrix products: qkv, attention's two, proj, the MLP's two)."""
    d = cfg.embed_dim
    per_block = 2 * tokens * d * (3 * d + d + 2 * int(d * cfg.mlp_ratio)) + 4 * tokens ** 2 * d
    return cfg.depth * per_block


def seeded_towers():
    """ViT-L/14 DINOv2 and DepthAnything (DPT 256, out channels 256/512/1024/1024)
    on the CPU, with weights from seeds 0 and 1."""
    from diffreg_tpu_torch.models.towers import synthesise_tower_weights
    from diffreg_tpu_torch.nn.depth_anything import DepthAnything, DPTConfig
    from diffreg_tpu_torch.nn.dinov2 import DinoVisionTransformer, vit_large_config

    vit = vit_large_config()
    dino, da = DinoVisionTransformer(vit), DepthAnything(vit, DPTConfig())
    synthesise_tower_weights(dino, 0)
    synthesise_tower_weights(da, 1)
    return dino, da


def check_towers(image_rgb):
    """The seeded towers (``seeded_towers``) on one RGB image [1, H, W, 3]: the card's
    tokens and depth against the CPU's, the times of each tower an image on
    the card (the module alone, and TowerRunner's call with its host copies),
    peak memory. Returns (the card's TowerRunner, the CPU's modules, numbers)."""
    import copy

    import numpy as np
    import torch

    from diffreg_tpu_torch.models.towers import IMAGENET_MEAN, IMAGENET_STD, TowerRunner
    from diffreg_tpu_torch.nn.dinov2 import vit_large_config

    dino, da = seeded_towers()
    cpu = TowerRunner(copy.deepcopy(dino), copy.deepcopy(da), device="cpu")
    t0 = time.perf_counter()
    ref_tokens, ref_depth = cpu.dino_tokens(image_rgb), cpu.mono_depth(image_rgb)
    cpu_s = time.perf_counter() - t0
    torch.cuda.reset_peak_memory_stats()
    card = TowerRunner(dino, da, device="cuda")
    tokens, depth = card.dino_tokens(image_rgb), card.mono_depth(image_rgb)
    errs = {}
    for name, got, ref in (("tokens", tokens, ref_tokens), ("depth", depth, ref_depth)):
        if got.shape != ref.shape or not np.isfinite(got).all():
            raise AssertionError(f"tower {name}: shape {got.shape} vs {ref.shape} or non-finite")
        errs[name] = float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)
        if not errs[name] <= TOWER_REL_TOL:
            raise AssertionError(f"tower {name}: card vs CPU {errs[name]:.3e} of the scale "
                                 f"(limit {TOWER_REL_TOL:.0e})")
    if not float(ref_depth.max()) > 0:
        raise AssertionError("DepthAnything's depth is zero everywhere")
    x = torch.from_numpy(image_rgb).cuda().permute(0, 3, 1, 2).contiguous()
    xn = torch.from_numpy((image_rgb - IMAGENET_MEAN) / IMAGENET_STD).cuda().permute(
        0, 3, 1, 2).contiguous()
    with torch.no_grad():
        dino_ms = time_cuda(lambda: card.dino(x), 5, warmup=1)
        da_ms = time_cuda(lambda: card.depth_anything(xn), 5, warmup=1)
    _, runner_s = wall(lambda: (card.dino_tokens(image_rgb), card.mono_depth(image_rgb)))
    peak = torch.cuda.max_memory_allocated() / 2**30
    n_tokens = (image_rgb.shape[1] // 14) * (image_rgb.shape[2] // 14) + 1
    vit = vit_large_config()
    flops = vit_flops(vit, n_tokens)
    out = {"dino_ms": dino_ms, "depth_anything_ms": da_ms, "runner_ms": runner_s * 1e3,
           "peak_gib": peak, "tokens_rel_err": errs["tokens"], "depth_rel_err": errs["depth"],
           "vit_tflop": flops / 1e12}
    log(f"towers (ViT-L/14, weights from a seed) on one {image_rgb.shape[1]} x "
        f"{image_rgb.shape[2]} image, f32 with TF32 off: DINOv2 {dino_ms:.3f} ms "
        f"({flops / 1e12:.3f} TFLOP of matrix products, {flops / dino_ms / 1e9:.1f} TFLOP/s), "
        f"DepthAnything {da_ms:.3f} ms, TowerRunner's two calls with host copies "
        f"{runner_s * 1e3:.1f} ms; card vs CPU: tokens {errs['tokens']:.3e}, depth "
        f"{errs['depth']:.3e} of the scale (limit {TOWER_REL_TOL:.0e}); CPU {cpu_s:.1f} s; "
        f"peak memory {peak:.2f} GiB")
    return card, cpu, out


def run_cli_dino(repo, split_root, cpu_towers, launches):
    """``diffreg_tpu_torch.main`` on a written copy of configs/test/
    rgbdv2_dino.yaml: ``towers`` at the seeded towers' state_dicts, the split
    under ``split_root`` and a checkpoint of random weights; its summary,
    eval_from_cache and launches checked."""
    import tempfile

    import torch
    import yaml

    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.main import main as cli
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.utils.config import load_yaml

    cwd = os.getcwd()
    with tempfile.TemporaryDirectory() as tmp:
        raw = load_yaml(os.path.join(repo, "configs", "test", "rgbdv2_dino.yaml"))
        raw.update(data_root=split_root, exp_dir="disk-rgbdv2-dino",
                   pretrain=os.path.join(tmp, "ckpt"),
                   towers={"dinov2": os.path.join(tmp, "dinov2.pth"),
                           "depth_anything": os.path.join(tmp, "depth_anything.pth")})
        t0 = time.perf_counter()
        torch.save(cpu_towers.dino.state_dict(), raw["towers"]["dinov2"])
        torch.save(cpu_towers.depth_anything.state_dict(), raw["towers"]["depth_anything"])
        CheckpointManager(raw["pretrain"]).save(1, create_train_state(
            DiffReg2D3D(pipeline_2d3d_config(raw), device="cpu", seed=0), OptimConfig()))
        path = os.path.join(tmp, "rgbdv2_dino.yaml")
        with open(path, "w") as f:
            yaml.safe_dump(raw, f)
        write_s = time.perf_counter() - t0
        os.chdir(tmp)
        try:
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            argv = ["--config", path, "--num-pairs", str(BATCH_PAIRS), "--batch-size",
                    str(BATCH_PAIRS)]
            summary, seconds = wall(lambda: cli(argv))
        finally:
            os.chdir(cwd)
    n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
    steps = int(raw["SAMPLE_STEP"])
    if n_kp != 8 or n_at != 12 * (1 + steps):
        raise AssertionError(f"main rgbdv2_dino: {n_kp} KPConv, {n_at} attention launches")
    ev = summary.get("eval", {})
    if not (summary["pairs"] == BATCH_PAIRS and all(
            math.isfinite(summary[k]) for k in ("IR", "PIR", "RR", "RRE", "RTE"))
            and sorted(ev.get("scenes", {})) == ["scene_00", "scene_01"]
            and math.isfinite(ev.get("PIR", math.nan))):
        raise AssertionError(f"main rgbdv2_dino: summary {summary}")
    launches["kpconv"] += n_kp
    launches["masked_attention_d64_dino"] += n_at
    log(f"main rgbdv2_dino test (on disk, towers from state_dicts, {BATCH_PAIRS} pairs): "
        f"{seconds:.2f} s (the towers' and checkpoint's files written in {write_s:.1f} s), "
        f"launches kpconv {n_kp} attention {n_at}; " + ", ".join(
            f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
            for k, v in summary.items() if k != "eval"))


def run_dino_phase(repo, split_root, kernels, launches, gen):
    """Phase 17, the published model (configs/test/rgbdv2_dino.yaml): the towers
    card against CPU, the split at stride 14 with the card's tower outputs,
    both kernels at its shapes, the path through TwoDThreeDTester, pair 0 on
    the CPU, PnP, and the CLI on a copy of the YAML."""
    import torch

    from diffreg_tpu_torch.data.datasets2d3d import RGBDScenes2D3DPairDataset
    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.utils.config import load_yaml

    cfg = pipeline_2d3d_config(load_yaml(os.path.join(repo, "configs", "test",
                                                      "rgbdv2_dino.yaml")))
    s = cfg.coarse_stride
    image = RGBDScenes2D3DPairDataset(split_root, "test")[0]["image"]
    image = image[:image.shape[0] // s * s, :image.shape[1] // s * s][None]
    card, cpu_towers, tower_numbers = check_towers(image)
    t0 = time.perf_counter()
    batch_cpu, _, scenes, pixels = data_2d3d(split_root, stride=s, towers=card)
    n_tokens = pixels // (s * s)
    log(f"2D-3D dino data: read, calibrated, collated with the towers' outputs in "
        f"{time.perf_counter() - t0:.2f} s; image {tuple(batch_cpu.image.shape)}, {n_tokens} "
        f"image tokens, dino_feats {tuple(batch_cpu.dino_feats.shape)}, mono_depth "
        f"{tuple(batch_cpu.mono_depth.shape)}")
    del card

    batch = batch_cpu.to("cuda")
    model = DiffReg2D3D(cfg, device="cuda", seed=0)
    kp, _ = check_kpconv(
        kpconv_layer_calls(model, lambda: model.pcd_backbone(batch), KPConvBias), 8,
        "one point-backbone pass (8 calls)", tag=" (2D-3D dino)")
    kernels[0]["2d3d_dino"] = {k: kp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                  "bound_by", "per")}
    kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], kp["max_abs_err"])
    del model, batch
    torch.cuda.empty_cache()
    at, at_shapes, _ = check_attention_2d3d(batch_cpu, n_tokens, cfg, gen)
    kernels[1]["d64_dino"] = at
    kernels[1]["shapes"] += [dict(row, case=row["case"].replace("(2D-3D)", "(2D-3D dino)"))
                             for row in at_shapes]
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at["max_abs_err"])

    result = run_2d3d(batch_cpu, scenes, cfg, launches, gen, key="masked_attention_d64_dino",
                      tag="2D-3D dino", config="configs/test/rgbdv2_dino.yaml")
    kernels[1]["d64_dino"]["path"] = {**result, "towers": tower_numbers}
    run_cli_dino(repo, split_root, cpu_towers, launches)


def run_2d3d_phases(repo, kernels, launches, gen):
    """Phases 12-17: the kernels at the 2D-3D shapes, the 2D-3D path, pair 0 on
    the CPU, PnP, the CLI on the 2D-3D configs, 2D-3D training, and the
    published model with its towers."""
    import tempfile

    from diffreg_tpu_torch.main import pipeline_2d3d_config
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.nn.point_backbone import KPConvBias
    from diffreg_tpu_torch.utils.config import load_yaml

    cfg = pipeline_2d3d_config(load_yaml(os.path.join(repo, "configs", "test", "rgbdv2.yaml")))
    with tempfile.TemporaryDirectory() as split_root:
        t0 = time.perf_counter()
        write_2d3d_split(split_root)
        t1 = time.perf_counter()
        batch_cpu, spec, scenes, pixels = data_2d3d(split_root)
        n_tokens = pixels // 64
        log(f"2D-3D data: split written in {t1 - t0:.2f} s, read, calibrated and collated in "
            f"{time.perf_counter() - t1:.2f} s; spec {spec}; image {tuple(batch_cpu.image.shape)}"
            f", {n_tokens} image tokens; real nodes "
            f"{[int(m.sum()) for m in batch_cpu.masks[-1]]} of {batch_cpu.masks[-1].shape[1]}")

        # ---- 12. the kernels at the 2D-3D shapes ----
        batch = batch_cpu.to("cuda")
        model = DiffReg2D3D(cfg, device="cuda", seed=0)
        kp, kp_shapes = check_kpconv(
            kpconv_layer_calls(model, lambda: model.pcd_backbone(batch), KPConvBias), 8,
            "one point-backbone pass (8 calls)", tag=" (2D-3D)")
        kernels[0]["shapes_2d3d"] = kp["shapes"]
        kernels[0]["2d3d"] = {k: kp[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                                 "bound_by", "per")}
        key = max(kp_shapes, key=lambda s: s[3])                 # the widest layer
        err, back = kpconv_gradients({key: kp_shapes[key]}, gen)
        kernels[0]["2d3d"].update({"backward_ms_widest_layer": back, "backward_max_rel_err": err})
        kernels[0]["max_abs_err"] = max(kernels[0]["max_abs_err"], kp["max_abs_err"])
        del kp_shapes, model, batch
        at, at_shapes, cases = check_attention_2d3d(batch_cpu, n_tokens, cfg, gen)
        err, per_call, per_pass = attention_gradients_2d3d(cases, cfg, gen)
        at.update({"backward_ms": per_pass, "backward_ms_per_call": per_call,
                   "backward_max_rel_err": err})
        kernels[1]["d64"] = at
        kernels[1]["shapes"] += at_shapes
        kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at["max_abs_err"])
        del cases

        # ---- 13-14. the 2D-3D path; pair 0 on the CPU; PnP ----
        run_2d3d(batch_cpu, scenes, cfg, launches, gen)

        # ---- 15. the entry point on the 2D-3D configs ----
        run_cli_2d3d(repo, split_root, launches)

        # ---- 16. 2D-3D training: the Trainer, card vs CPU, the entry point ----
        kernels[1]["d64"]["train_2d3d"] = run_train_2d3d_phase(repo, split_root, launches)

        # ---- 17. the published model: the towers, rgbdv2_dino.yaml's path, the CLI ----
        run_dino_phase(repo, split_root, kernels, launches, gen)


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
        from diffreg_tpu_torch.models.presets import (preset_3dmatch, preset_4dmatch,
                                                      with_condition_gate)
        from diffreg_tpu_torch.nn.kpfcn import KPConv
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
    kpconv_entry, kp_shapes = check_kpconv(
        kpconv_layer_calls(models[0.0], lambda: models[0.0].encode(batch), KPConv), 11,
        "one encode (11 calls)")
    kernels = [kpconv_entry, check_attention(batch, cfg, gen)]
    check_gradients(kernels, kp_shapes, batch, cfg, gen)
    del kp_shapes

    # ---- 3c. the 4DMatch shapes: KPConv per layer, attention at D = 132 ----
    t0 = time.perf_counter()
    batch4_cpu, meta4, spec4, pairs4 = deformable_data()
    log(f"4DMatch spec {spec4}; host data {time.perf_counter() - t0:.2f} s")
    batch4 = batch4_cpu.to("cuda")
    cfg4 = preset_4dmatch(sample_steps=STEPS)
    model4 = DiffusionMatchingModel(cfg4, device="cuda", seed=0)
    kp4, kp4_shapes = check_kpconv(kpconv_layer_calls(model4, lambda: model4.encode(batch4),
                                                      KPConv), 11, "one encode (11 calls)",
                                   tag=" (4DMatch)")
    del kp4_shapes, model4
    kernels[0]["shapes_4dmatch"] = kp4["shapes"]
    at4 = check_attention(batch4, cfg4, gen, tag=" (4DMatch)")
    grad4, back4 = attention_gradients(batch4, cfg4, gen)
    kernels[1]["d132"] = {k: at4[k] for k in ("max_abs_err", "ms", "plain_ms", "bound_ms",
                                               "bound_by", "library_ms", "per")}
    kernels[1]["d132"].update({"backward_ms": back4, "backward_max_rel_err": grad4})
    kernels[1]["shapes"] += at4["shapes"]
    kernels[1]["max_abs_err"] = max(kernels[1]["max_abs_err"], at4["max_abs_err"])
    del batch4

    # ---- 4. the DDIM path ----
    torch.cuda.reset_peak_memory_stats()      # the gradient checks above are not its peak
    results = {}
    launches = {"kpconv": 0, "masked_attention": 0, "masked_attention_d132": 0,
                "masked_attention_d64": 0, "masked_attention_d64_dino": 0, "kpconv_train_2d3d": 0,
                "masked_attention_train_2d3d": 0, "kpconv_bf16": 0,
                "masked_attention_bf16": 0}
    f32_ref = {}
    per_step = attention_calls(spec.n_src, spec.n_tgt, cfg.denoising_layer_types)
    for gate, model in models.items():
        register(model, batch, x_init, u)                      # warm-up
        times = []
        for _ in range(TIMED_RUNS):
            kpconv_cuda.launches = 0
            masked_attention_cuda.launches = 0
            out, seconds = wall(lambda: register(model, batch, x_init, u))
            n_kp, n_at = kpconv_cuda.launches, masked_attention_cuda.launches
            if n_kp != 11 or n_at != per_step * STEPS:
                raise AssertionError(f"gate {gate}: {n_kp} KPConv launches (want 11), "
                                     f"{n_at} attention launches (want {per_step * STEPS})")
            launches["kpconv"] += n_kp
            launches["masked_attention"] += n_at
            times.append(seconds)
        seconds = sorted(times)[TIMED_RUNS // 2]
        check_outputs(out, f"gate {gate}")
        f32_ref[gate] = {"pairs_per_s": BATCH_PAIRS / seconds,
                         **{k: out[k][:1] for k in ("conf_matrix_pred", "rotation_pred",
                                                    "translation_pred")}}
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

    # ---- 8b. the bf16 fast path: its kernels, the DDIM at gate 0 and 40, pair 0
    # on the CPU, main on configs/test/3dmatch_fast.yaml ----
    bf16_kernels, bf16_pairs = run_bf16(repo, batch, batch_cpu, spec, x_init, u, f32_ref,
                                        batch4_cpu, gen, launches)
    kernels += bf16_kernels
    for gate in GATES:
        kernels[3].setdefault("pairs_per_s", {})[str(gate)] = {
            "bf16": bf16_pairs[gate], "f32": f32_ref[gate]["pairs_per_s"]}
    del f32_ref

    # ---- 9-10. the 4DMatch path through FourDMatchTester; pair 0 on the CPU ----
    run_4dmatch(batch4_cpu, meta4, spec4, launches)

    # ---- 11. the entry point: 4DMatch test, 3DMatch test, 4DMatch train ----
    run_cli(repo, pairs4, meta4, launches)

    # ---- 12-17. 2D-3D: kernels at its shapes, the tester path, pair 0, the CLI,
    # training, the published model with its towers ----
    run_2d3d_phases(repo, kernels, launches, gen)

    kernels[0]["launches"] = launches["kpconv"] + launches["kpconv_train_2d3d"]
    kernels[0]["launches_train_2d3d"] = launches["kpconv_train_2d3d"]
    d64 = launches["masked_attention_d64"] + launches["masked_attention_train_2d3d"]
    kernels[1]["launches"] = (launches["masked_attention"] + launches["masked_attention_d132"]
                              + d64 + launches["masked_attention_d64_dino"])
    kernels[1]["launches_d132"] = launches["masked_attention_d132"]
    kernels[1]["launches_d64"] = d64
    kernels[1]["launches_d64_dino"] = launches["masked_attention_d64_dino"]
    kernels[1]["launches_train_2d3d"] = launches["masked_attention_train_2d3d"]
    kernels[2]["launches"] = launches["kpconv_bf16"]
    kernels[3]["launches"] = launches["masked_attention_bf16"]
    log(f"total {time.perf_counter() - t_start:.1f} s")
    log(json.dumps({"kernels": kernels}))
    log(card)
    log(json.dumps({"ok": True, "device": {"platform": "gpu",
                                           "kind": torch.cuda.get_device_name(0),
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
