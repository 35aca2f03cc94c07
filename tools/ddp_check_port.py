"""The PyTorch port's data-parallel training on four cards of one host.

    python3 tools/ddp_check_port.py      # on a machine with four CUDA cards

Builds the kernels, then checks, with one process a card joined over NCCL
(``diffreg_tpu_torch.parallel``):

  (i)   the full-width data-parallel train step, a pair a process (a global
        batch of 4), against process 0's single-card step on the same 4 pairs
        from the same weights and draws, at chip_smoke's phase-8 f32 limits:
        the loss, every gradient, the parameters after the SGD update, and the
        same parameters in every process. 3DMatch (preset_3dmatch(train=True):
        gate 200, chip_smoke's 4096-point pairs), 4DMatch (preset_4dmatch,
        gate 40, the motion term on, chip_smoke's 4DMatch pairs) and 2D-3D
        (configs/train/rgbdv2.yaml's model and losses, Adam, chip_smoke's
        RGB-D Scenes V2-like train split; Adam's first step is about lr times
        the gradient's sign, so there the parameters after it are not held);
  (ii)  kernel launches on a card that is not the current one: each kernel
        (f32 and bf16 instances) on cuda:1, cuda:2 and cuda:3 while cuda:0 is
        current, against its plain version at chip_smoke's limits;
  (iii) scaling at a fixed batch of 1 pair a process: 3DMatch steps/s on one
        card (process 0 alone, the plain step) and on four (the data-parallel
        step), with each step's forward, backward, all-reduce and optimizer
        seconds, the gradient bytes a step all-reduces and the all-reduce's
        device time (CUDA events);
  (iv)  the CLI under torchrun: ``diffreg_tpu_torch.main --config
        configs/train/3dmatch.yaml --demo --mode train`` (max_epoch cut to 1,
        8 demo pairs, 2 steps a process) on four processes: exactly one
        snapshot directory and one checkpoint.

Prints the card's name and power limit first; writes its JSON summary to
chiprun_out/ddp_check_port.json. Exits nonzero on any failure.
"""
from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import tempfile
import time

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORLD = 4
TIMED_STEPS = 10           # after WARMUP_STEPS, in (iii)
WARMUP_STEPS = 2
ALL_REDUCE_ITERS = 20
RANKS_TIMEOUT_S = 600
CLI_TIMEOUT_S = 300
OUT = os.path.join(REPO, "chiprun_out", "ddp_check_port.json")


def smoke():
    """chip_smoke.py as a module: its data, limits and step helpers."""
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    import chip_smoke

    return chip_smoke


def log(msg: str) -> None:
    print(msg, flush=True)


# ---------------------------------------------------------------- (ii)


def off_current_launches():
    """Each kernel on cuda:1-3 with cuda:0 current, against its plain version:
    max |kernel - plain| relative to max |plain| per (kernel, card)."""
    import torch

    from diffreg_tpu_torch.ops.attention import (masked_attention_bf16_plain,
                                                 masked_attention_cuda,
                                                 masked_attention_cuda_bf16,
                                                 masked_attention_plain)
    from diffreg_tpu_torch.ops.kpconv import (kpconv, kpconv_bf16_plain,
                                              kpconv_bf16_table_aligned, kpconv_cuda,
                                              kpconv_cuda_bf16)

    cs = smoke()
    gen = torch.Generator().manual_seed(0)
    b, h, l, s, d = 4, 4, 704, 704, 108          # chip_smoke's 3DMatch self shape
    q, k, v = (torch.randn(b, h, n, d, generator=gen) for n in (l, s, s))
    mask = torch.rand(b, s, generator=gen) < 0.9
    nq, ns, kk, cin, cout, p = 4096, 4096, 40, 64, 128, 15
    q_pts, s_pts = torch.rand(1, nq, 3, generator=gen), torch.rand(1, ns, 3, generator=gen)
    inds = torch.randint(0, ns + 1, (1, nq, kk), generator=gen, dtype=torch.int32)
    x = torch.randn(1, ns, cin, generator=gen)
    kp = torch.rand(p, 3, generator=gen) * 0.05
    w = torch.randn(p, cin, cout, generator=gen) * 0.1
    extent = 0.05
    cases = {
        "masked_attention_cuda": (lambda t: masked_attention_cuda(*t[:4], d ** -0.5),
                                  lambda t: masked_attention_plain(*t[:4], d ** -0.5),
                                  (q, k, v, mask), cs.ATTENTION_ABS_TOL, False),
        "masked_attention_cuda_bf16": (
            lambda t: masked_attention_cuda_bf16(*t[:4], d ** -0.5),
            lambda t: masked_attention_bf16_plain(*t[:4], d ** -0.5),
            (q.bfloat16(), k.bfloat16(), v.bfloat16(), mask), cs.ATTENTION_BF16_REL_TOL, True),
        "kpconv_cuda": (lambda t: kpconv_cuda(*t, extent), lambda t: kpconv(*t, extent),
                        (q_pts, s_pts, inds, x, kp, w), cs.KPCONV_REL_TOL, True),
        "kpconv_cuda_bf16": (
            lambda t: kpconv_cuda_bf16(t[0], kpconv_bf16_table_aligned(t[1], t[3]), t[2], t[4],
                                       t[5].bfloat16().contiguous(), extent),
            lambda t: kpconv_bf16_plain(*t, extent),
            (q_pts, s_pts, inds, x, kp, w), cs.KPCONV_BF16_REL_TOL, True),
    }
    errors = {}
    for card in range(1, torch.cuda.device_count()):
        dev = torch.device("cuda", card)
        for name, (kernel, plain, inputs, limit, relative) in cases.items():
            on_card = tuple(t.to(dev) for t in inputs)
            with torch.cuda.device(0):
                got = kernel(on_card)
                if torch.cuda.current_device() != 0:
                    raise AssertionError(f"{name}: the launch changed the current device")
            torch.cuda.synchronize(dev)
            ref = plain(on_card)
            if got.device != dev:
                raise AssertionError(f"{name} on {dev}: output on {got.device}")
            err = float((got.float() - ref.float()).abs().max())
            scale = float(ref.float().abs().max()) if relative else 1.0
            errors[f"{name} cuda:{card}"] = err / scale
            if not err <= limit * scale:
                raise AssertionError(f"{name} on {dev} with cuda:0 current: error {err:.3e} "
                                     f"(limit {limit * scale:.3e})")
    log("off-current-device launches (cuda:0 current), error against the plain version: "
        + ", ".join(f"{k} {v:.2e}" for k, v in errors.items()))
    return errors


# ---------------------------------------------------------------- data


def build_cases():
    """The three cases' configs and global batches of 4 pairs (CPU)."""
    import numpy as np

    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.data.pyramid import PyramidConfig
    from diffreg_tpu_torch.data.synthetic import make_pair, synthetic_batch
    from diffreg_tpu_torch.main import loss_2d3d_configs, pipeline_2d3d_config
    from diffreg_tpu_torch.models.presets import preset_3dmatch, preset_4dmatch
    from diffreg_tpu_torch.utils.config import load_yaml

    cs = smoke()
    t0 = time.perf_counter()
    pcfg = PyramidConfig(first_subsampling_dl=0.03, coarse_match_radius=0.1)
    cal = np.random.RandomState(0)
    spec = calibrate_spec([make_pair(cal, cs.N_POINTS)[:2] for _ in range(2)], pcfg, k_cap=40,
                          neighbor_percentile=90.0)
    batch3, _, _ = synthetic_batch(batch_size=WORLD, n_points=cs.N_POINTS, seed=0, spec=spec,
                                   cfg=pcfg)
    batch4 = cs.deformable_data()[0]
    split = tempfile.mkdtemp(prefix="ddp-2d3d-")
    cs.write_2d3d_split(split, subset="train", seed=8)
    batch2d3d = cs.data_2d3d(split, "train", augment=True)[0]
    raw = load_yaml(os.path.join(REPO, "configs", "train", "rgbdv2.yaml"))
    circle, fine = loss_2d3d_configs(raw)
    log(f"data: 3DMatch {spec}, 4DMatch and the 2D-3D train split in "
        f"{time.perf_counter() - t0:.1f} s")
    return {"3dmatch": {"cfg": preset_3dmatch(train=True), "batch": batch3},
            "4dmatch": {"cfg": preset_4dmatch(sample_steps=cs.STEPS), "batch": batch4,
                        "loss": cs.LOSS_4D},
            "2d3d": {"cfg": pipeline_2d3d_config(raw), "batch": batch2d3d,
                     "losses": (circle, fine)}}


# ---------------------------------------------------------------- the ranks


def _case_parts(name, case, device):
    """(model, train state, plain step, data-parallel step) of a case."""
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.engine.train2d3d import create_train_state_2d3d, make_train_step_2d3d
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.pipeline_2d3d import DiffReg2D3D
    from diffreg_tpu_torch.parallel.mesh import (make_parallel_train_step,
                                                 make_parallel_train_step_2d3d)

    if name == "2d3d":
        model = DiffReg2D3D(case["cfg"], device=device, seed=0)
        args = (case["losses"][0], LossConfig(), case["losses"][1])
        return (model, lambda m: create_train_state_2d3d(m, OptimConfig("adam", lr=1e-4)),
                make_train_step_2d3d(*args), make_parallel_train_step_2d3d(*args))
    model = DiffusionMatchingModel(case["cfg"], device=device, seed=0)
    loss = LossConfig(**case.get("loss", {}))
    return (model, lambda m: create_train_state(m, OptimConfig()), make_train_step(loss),
            make_parallel_train_step(loss))


def _gaps(got, ref, names):
    """``chip_smoke.step_gaps`` with the 2D-3D attention key biases (their
    gradient is rounding) held apart: their largest entry relative to the
    largest gradient entry."""
    import torch

    cs = smoke()
    rounding = [i for i, n in enumerate(names) if n.endswith(cs.KEY_BIAS)]
    largest = max(float(g.abs().max()) for g in ref["grads"])
    key_bias = max([float(torch.maximum(got["grads"][i].abs().max(), ref["grads"][i].abs().max()))
                    for i in rounding], default=0.0) / largest
    keep = [i for i in range(len(names)) if i not in rounding]
    pick = lambda r: {**r, "grads": [r["grads"][i] for i in keep],  # noqa: E731
                      "params": [r["params"][i] for i in keep],
                      "before": [r["before"][i] for i in keep]}
    gap = cs.step_gaps(pick(got), pick(ref), [names[i] for i in keep])
    gap["key_bias"] = key_bias
    return gap


def _check_case(rank, name, case, world):
    """(i) for one case in this process: the data-parallel step on its pair;
    on process 0 then the plain step on the 4 pairs, and the gaps."""
    import torch

    from diffreg_tpu_torch.ops.attention import masked_attention_cuda
    from diffreg_tpu_torch.ops.kpconv import kpconv_cuda
    from diffreg_tpu_torch.parallel.distributed import all_gather_rows, barrier
    from diffreg_tpu_torch.parallel.mesh import shard_rows

    cs = smoke()
    device = torch.device("cuda", torch.cuda.current_device())
    model, make_state, plain, parallel = _case_parts(name, case, device)
    weights = {k: v.clone() for k, v in model.state_dict().items()}
    batch = case["batch"]
    draws = model.draw_train_inputs(batch, torch.Generator().manual_seed(0))
    rows = shard_rows(batch.batch_size, rank, world)
    kpconv_cuda.launches = 0
    masked_attention_cuda.launches = 0
    got, dp_s = cs.wall(lambda: cs.capture_step(
        parallel, make_state(model), batch.select(rows).to(device),
        {k: v[rows].to(device) for k, v in draws.items()}))
    counts = [kpconv_cuda.launches, masked_attention_cuda.launches]
    fingerprint = torch.tensor([float(sum(p.double().sum() for p in got["params"]))],
                               dtype=torch.float64)
    out = {"launches": counts, "dp_s": dp_s, "loss": got["loss"],
           "fingerprints": all_gather_rows(fingerprint).tolist()}
    if rank == 0:
        model.load_state_dict(weights)
        ref, plain_s = cs.wall(lambda: cs.capture_step(
            plain, make_state(model), batch.to(device), {k: v.to(device)
                                                         for k, v in draws.items()}))
        names = [n for n, _ in model.named_trained_parameters()]
        gap = _gaps(got, ref, names)
        out.update(plain_loss=ref["loss"], plain_s=plain_s,
                   gap={k: v for k, v in gap.items() if k != "errs"}, worst=gap["errs"][:3])
    del model, got
    torch.cuda.empty_cache()
    barrier()
    return out


def _scaling(rank, world, case):
    """(iii): process 0 alone (the plain step, 1 pair), then every process
    (the data-parallel step, 1 pair each); each step's phases; the
    all-reduce of the gradients timed on its own."""
    import torch

    from diffreg_tpu_torch.parallel.distributed import barrier
    from diffreg_tpu_torch.parallel.mesh import all_reduce_gradients, gradient_bytes
    from diffreg_tpu_torch.utils.logging import Timers

    device = torch.device("cuda", torch.cuda.current_device())
    model, make_state, plain, parallel = _case_parts("3dmatch", case, device)
    batch = case["batch"].select(slice(rank, rank + 1)).to(device)
    draws = {k: v.to(device) for k, v in model.draw_train_inputs(
        batch, torch.Generator().manual_seed(rank)).items()}

    def timed(step):
        state = make_state(model)
        rows = []
        for i in range(WARMUP_STEPS + TIMED_STEPS):
            timers = Timers()
            torch.cuda.synchronize(device)
            t0 = time.perf_counter()
            state, info = step(state, batch, draws, timers)
            float(info["loss"])
            seconds = time.perf_counter() - t0
            if i >= WARMUP_STEPS:
                rows.append({"step": seconds, **timers.summary()})
        return {k: statistics.median(r[k] for r in rows) for k in rows[0]}

    out = {}
    if rank == 0:
        out["one_card"] = timed(plain)
    barrier()
    out["four_cards"] = timed(parallel)
    params = [p for _, p in model.named_trained_parameters()]
    grads = [torch.randn_like(p) for p in params]
    start, stop = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    all_reduce_gradients(grads, params)
    times = []
    for _ in range(ALL_REDUCE_ITERS):
        barrier()
        start.record()
        all_reduce_gradients(grads, params)
        stop.record()
        torch.cuda.synchronize(device)
        times.append(start.elapsed_time(stop))
    out["all_reduce_ms"] = statistics.median(times)
    out["gradient_bytes"] = gradient_bytes(params)
    return out


def _rank(rank, world, cases):
    """One process of the four: (i) for every case, then (iii)."""
    import torch

    out = {"card": torch.cuda.current_device(), "cases": {}}
    for name, case in cases.items():
        out["cases"][name] = _check_case(rank, name, case, world)
    out["scaling"] = _scaling(rank, world, cases["3dmatch"])
    return out


# ---------------------------------------------------------------- (iv)


def cli_under_torchrun():
    """``main`` on configs/train/3dmatch.yaml (max_epoch 1) with --demo
    under torchrun on four processes, in a fresh working directory."""
    import yaml

    from diffreg_tpu_torch.parallel.distributed import free_port
    from diffreg_tpu_torch.utils.config import load_yaml

    with tempfile.TemporaryDirectory(prefix="ddp-cli-") as tmp:
        raw = load_yaml(os.path.join(REPO, "configs", "train", "3dmatch.yaml"))
        raw["max_epoch"] = 1
        cfg = os.path.join(tmp, "train_3dmatch.yaml")
        with open(cfg, "w") as f:
            yaml.safe_dump(raw, f)
        cmd = [sys.executable, "-m", "torch.distributed.run", "--nnodes", "1",
               "--nproc_per_node", str(WORLD), "--master_addr", "127.0.0.1", "--master_port",
               str(free_port()), "-m", "diffreg_tpu_torch.main", "--config", cfg, "--demo",
               "--mode", "train", "--num-pairs", "8"]
        env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", "")}
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=tmp, env=env, capture_output=True, text=True,
                             timeout=CLI_TIMEOUT_S)
        seconds = time.perf_counter() - t0
        log(run.stdout[-4000:])
        if run.returncode != 0:
            log(run.stderr[-8000:])
            raise AssertionError(f"torchrun main: exit code {run.returncode}")
        snap = os.path.join(tmp, "snapshot")
        dirs = sorted(os.listdir(snap))
        ckpts = sorted(os.listdir(os.path.join(snap, dirs[0], "checkpoints"))) if dirs else []
        log(f"CLI under torchrun ({WORLD} processes, {seconds:.1f} s): snapshot {dirs}, "
            f"checkpoints {ckpts}")
        if dirs != [raw["exp_dir"]] or ckpts != ["1.pt", "best.json"]:
            raise AssertionError(f"torchrun main wrote snapshot {dirs}, checkpoints {ckpts}")
        if f"data parallel: {WORLD} processes" not in run.stdout:
            raise AssertionError("torchrun main did not log its world")
        return {"seconds": seconds, "snapshot": dirs, "checkpoints": ckpts}


# ---------------------------------------------------------------- main


def main() -> int:
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < WORLD:
        print(f"ddp_check_port: needs {WORLD} CUDA cards", file=sys.stderr)
        return 1
    cs = smoke()
    from diffreg_tpu_torch.parallel.distributed import run_ranks
    from diffreg_tpu_torch.utils.cuda import build_kernels

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True,
                          timeout=60).stdout.strip().splitlines()
    log("\n".join(card))
    log(f"torch {torch.__version__} cuda {torch.version.cuda} x{torch.cuda.device_count()}")
    t_start = time.perf_counter()
    t0 = time.perf_counter()
    build_kernels()
    log(f"kernel build: {time.perf_counter() - t0:.1f} s")
    summary = {"card": card, "off_current": off_current_launches()}
    cases = build_cases()
    t0 = time.perf_counter()
    ranks = run_ranks(_rank, WORLD, (cases,), cards=list(range(WORLD)),
                      timeout_s=RANKS_TIMEOUT_S)
    log(f"{WORLD} processes (NCCL): {time.perf_counter() - t0:.1f} s with the spawn")
    limits = {"loss": cs.LOSS_REL_TOL, "worst": cs.GRAD_WORST_TOL,
              "median": cs.GRAD_MEDIAN_TOL, "global": cs.GRAD_GLOBAL_TOL,
              "params": cs.PARAM_ABS_TOL, "key_bias": cs.KEY_BIAS_TOL}
    summary["cases"] = {}
    for name in cases:
        res = [r["cases"][name] for r in ranks]
        head = res[0]
        gap = head["gap"]
        log(f"(i) {name}: data-parallel step ({WORLD} processes, a pair each) loss "
            f"{head['loss']:.6f} vs the single-card step on {WORLD} pairs {head['plain_loss']:.6f} "
            f"(rel err {gap['loss']:.3e}); gradients worst {gap['worst']:.3e} median "
            f"{gap['median']:.3e} global {gap['global']:.3e}, key biases {gap['key_bias']:.2e}; "
            f"params after the update {gap['params']:.3e}; seconds data-parallel "
            f"{head['dp_s']:.3f}, single card {head['plain_s']:.3f}; launches a process "
            f"{[r['launches'] for r in res]}; worst tensors "
            + ", ".join(f"{n} {e:.2e}" for e, n in head["worst"]))
        if len(set(head["fingerprints"])) != 1:
            raise AssertionError(f"{name}: the processes' parameters differ after the step "
                                 f"({head['fingerprints']})")
        if not all(r["launches"][0] > 0 and r["launches"][1] > 0 for r in res):
            raise AssertionError(f"{name}: a process launched no kernel ({res})")
        held = dict(limits) if name != "2d3d" else \
            {k: v for k, v in limits.items() if k != "params"}   # Adam's step is sign-like
        for key, limit in held.items():
            if not gap[key] <= limit:
                raise AssertionError(f"{name}: {key} {gap[key]} (limit {limit})")
        summary["cases"][name] = {"gap": gap, "dp_s": head["dp_s"], "plain_s": head["plain_s"],
                                  "launches": [r["launches"] for r in res]}
    scale = [r["scaling"] for r in ranks]
    one, four = scale[0]["one_card"], scale[0]["four_cards"]
    slowest = max(s["four_cards"]["step"] for s in scale)
    summary["scaling"] = {
        "one_card_steps_per_s": 1 / one["step"], "four_cards_steps_per_s": 1 / slowest,
        "one_card_pairs_per_s": 1 / one["step"], "four_cards_pairs_per_s": WORLD / slowest,
        "one_card_phases_s": one, "four_cards_phases_s": [s["four_cards"] for s in scale],
        "gradient_bytes": scale[0]["gradient_bytes"],
        "all_reduce_ms": [s["all_reduce_ms"] for s in scale]}
    log(f"(iii) 3DMatch at 1 pair a process: one card {1 / one['step']:.3f} steps/s (median "
        f"step {one['step']:.4f} s: " + ", ".join(f"{k} {v:.4f}" for k, v in one.items()
                                                   if k != "step")
        + f"); four cards {1 / slowest:.3f} steps/s = {WORLD / slowest:.3f} pairs/s (slowest "
        f"process's median step {slowest:.4f} s; process 0: " + ", ".join(
            f"{k} {v:.4f}" for k, v in four.items() if k != "step")
        + f"); gradient all-reduce {scale[0]['gradient_bytes'] / 2**20:.1f} MiB a step, "
        f"{statistics.median(s['all_reduce_ms'] for s in scale):.3f} ms of device time "
        f"(median over the processes of each one's median of {ALL_REDUCE_ITERS})")
    summary["cli"] = cli_under_torchrun()
    summary["seconds"] = time.perf_counter() - t_start
    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    with open(OUT, "w") as f:
        json.dump(summary, f, indent=1, default=float)
    log(json.dumps(summary, default=float))
    log(f"ddp_check_port: all checks passed in {summary['seconds']:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
