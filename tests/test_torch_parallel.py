"""The port's data parallelism (``diffreg_tpu_torch.parallel``) on the CPU.

Two gloo processes (``parallel.run_ranks``; what they run is
``tests/torch_parallel_ranks.py``, which imports no JAX) take a global batch
of 4 pairs, 2 each, at ``preset_tiny`` widths:

  * the 3DMatch data-parallel step against the JAX package's
    ``make_parallel_train_step`` on 2 of conftest's 8 virtual CPU devices, on
    the same weights (the port's, converted) and draws (JAX's): the loss to
    rtol 1e-5 and each gradient to 5e-4 of its tensor's largest entry, as
    ``tests/test_torch_train.py`` holds the single-process step. JAX's
    gradient is read off its SGD step at lr 2**10 (no momentum or decay):
    (before - after) / lr, exact to f32 rounding of the parameters / lr;
  * the data-parallel step against the port's single-process step on the
    global batch, 3DMatch, 4DMatch (the motion term on) and 2D-3D: they
    differ only in the order of the sums, so every gradient to 1e-5 of its
    tensor's largest entry (the 2D-3D attention key biases, whose gradient is
    rounding, held below 1e-8 of the largest gradient entry);
  * the loss's global normalisers, the lockstep epoch, the eval split and the
    CLI's data-parallel training.

The processes start before the JAX compile (``group``) and run beside it;
``run_ranks`` kills them and fails after ``JOIN_TIMEOUT_S``. Cheap checks
(shards, the learning rate, the launch guard) need no process.
"""
import dataclasses
import os
import sys
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict, unflatten_dict

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
from diffreg_tpu.data.datasets import iterate_batches as jax_iterate_batches
from diffreg_tpu.data.pyramid import PyramidConfig as JaxPyramidConfig
from diffreg_tpu.data.synthetic import tiny_spec as jax_tiny_spec
from diffreg_tpu.engine.losses import LossConfig as JaxLossConfig
from diffreg_tpu.engine.train import OptimConfig as JaxOptimConfig
from diffreg_tpu.engine.train import TrainState as JaxTrainState
from diffreg_tpu.engine.train import make_optimizer as jax_make_optimizer
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny
from diffreg_tpu.parallel import distributed as jax_distributed
from diffreg_tpu.parallel.mesh import make_mesh, make_parallel_train_step, replicate, shard_batch
from diffreg_tpu.utils import config as jax_config
from diffreg_tpu_torch.convert import _translate
from diffreg_tpu_torch.data.datasets import iterate_batches
from diffreg_tpu_torch.data.pyramid import PyramidConfig
from diffreg_tpu_torch.data.synthetic import tiny_spec
from diffreg_tpu_torch.engine.losses import LossConfig, diffreg_loss
from diffreg_tpu_torch.parallel import distributed
from diffreg_tpu_torch.utils import config as port_config

sys.path.insert(0, os.path.dirname(__file__))
import torch_parallel_ranks as ranks_mod  # noqa: E402

T = torch.from_numpy
RANKS, B = 2, ranks_mod.B
JOIN_TIMEOUT_S = 240
# the JAX comparison: data, weights and draws (soft Procrustes' top-k cuts in
# gaps of at least 5.3e-6, the positioning and noisy-warp conditions at least
# 130 from the gate) and the SGD step that reveals JAX's gradient
JAX_DATA_SEED, JAX_WEIGHT_SEED, JAX_TRAIN_KEY, GATE, JAX_LR = 1, 0, 0, 200.0, 2.0 ** 10
LOSS_REL_TOL, JAX_GRAD_TOL, GRAD_TOL = 1e-5, 5e-4, 1e-5
KEY_BIAS_TOL = 1e-8
JOBS = ("jax3d", "3dmatch", "4dmatch", "2d3d", "loss4d", "eval", "lockstep", "cli")
SINGLE_RANK = {"3dmatch": 0, "4dmatch": 0, "2d3d": 1}
CLI_LR = 0.01


def _jax_draws(spec):
    """JAX train_forward's t, g and Euler angles for the global batch."""
    rng_t, rng_noise, rng_pos = jax.random.split(jax.random.PRNGKey(JAX_TRAIN_KEY), 3)
    return {"t": np.array(jax.random.randint(rng_t, (B,), 0, 1000)),
            "g": np.array(jax.random.normal(rng_noise, (B, spec.n_src, spec.n_tgt))),
            "euler": np.array(jax.random.uniform(rng_pos, (B, 3)) * 2.0 * jnp.pi)}


def _cli_yaml(path):
    """tests/test_torch_cli.py's test-width YAML, for one epoch of training."""
    tree = {
        "kpfcn_config": {"first_feats_dim": 16, "first_subsampling_dl": 0.08,
                         "coarse_feature_dim": 48, "fine_feature_dim": 16,
                         "coarse_match_radius": 0.12},
        "coarse_matching": {"feature_dim": 48},
        "coarse_transformer": {"feature_dim": 48, "n_head": 2, "voxel_size": 0.04,
                               "procrustes": {"max_condition_num": 40.0}},
        "batch_size": 2, "num_workers": 2, "calibration_pairs": 3, "SAMPLE_STEP": 2,
        "mode": "train", "max_epoch": 1, "lr": CLI_LR, "exp_dir": "dp",
    }
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return str(path)


def _motion_outputs(rng):
    """Loss inputs of 4 deformable pairs whose shards differ: pairs 0-1 hold
    few GT matches and predict none of them (recall 0 there), pairs 2-3 hold
    many and predict half, so the batch's recall clears the motion gate's
    0.01 while shard 0's does not."""
    b, s, t = B, 20, 24
    gt = np.zeros((b, s, t), np.float32)
    pred = rng.rand(b, s, t) > 0.97
    for i in range(b):
        n = 3 if i < 2 else 12
        rows, cols = rng.choice(s, n, replace=False), rng.choice(t, n, replace=False)
        gt[i, rows, cols] = 1.0
        if i >= 2:
            pred[i, rows[::2], cols[::2]] = True
    pred &= ~((gt > 0) & (np.arange(b) < 2)[:, None, None])
    return {"outputs": {"matrix_gt": gt, "match_mask_pred": pred,
                        "conf_matrix_pred": rng.rand(b, s, t).astype(np.float32),
                        "conf_matrix_gt_hat": rng.rand(b, s, t).astype(np.float32),
                        "s_pcd": rng.randn(b, s, 3).astype(np.float32),
                        "rotation_pred": np.stack([np.eye(3, dtype=np.float32)] * b),
                        "translation_pred": rng.randn(b, 3, 1).astype(np.float32) * 0.1},
            "batch": {"src_mask": np.arange(s)[None] < np.array([[s], [s - 4], [s], [s - 2]]),
                      "tgt_mask": np.arange(t)[None] < np.array([[t - 3], [t], [t], [t - 1]]),
                      "rot_gt": np.stack([np.eye(3, dtype=np.float32)] * b),
                      "trn_gt": rng.randn(b, 3, 1).astype(np.float32) * 0.1,
                      "coarse_flow": rng.randn(b, s, 3).astype(np.float32) * 0.05}}


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for this process's torch runs: the suite runs in
    several processes at once, and torch's default of a thread per core
    oversubscribes the CPU (``test_global_normaliser_matters`` took 59 s so,
    under a second alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    """Start the two gloo processes (in a thread: they run beside the JAX
    compile of ``jax_step``); ``ranks`` joins them."""
    tmp = tmp_path_factory.mktemp("parallel")
    os.makedirs(tmp / "cli")
    _, spec, _ = jax_synthetic_batch(batch_size=B, n_points=96, seed=JAX_DATA_SEED)
    payload = {"jobs": JOBS, "single_rank": SINGLE_RANK, "threads": 1,
               "jax3d": {"data_seed": JAX_DATA_SEED, "weight_seed": JAX_WEIGHT_SEED,
                         "gate": GATE, "lr": JAX_LR, "draws": _jax_draws(spec)},
               "loss4d": _motion_outputs(np.random.RandomState(11)),
               "lockstep_dir": str(tmp / "lockstep"), "cli_dir": str(tmp / "cli"),
               "cli_yaml": _cli_yaml(tmp / "dp.yaml")}
    box = {}

    def run():
        try:
            box["results"] = distributed.run_ranks(ranks_mod.rank_main, RANKS, (payload,),
                                                   timeout_s=JOIN_TIMEOUT_S)
        except BaseException as e:   # handed to the tests by ``ranks``
            box["error"] = e

    thread = threading.Thread(target=run, daemon=True)
    thread.start()
    return {"thread": thread, "box": box, "payload": payload, "tmp": tmp}


@pytest.fixture(scope="module")
def jax_step(group):
    """JAX's data-parallel train step (``make_parallel_train_step`` over 2
    virtual devices) on the port's weights: loss, info and the gradient
    (named by the port's parameters, in the port's layout)."""
    p = group["payload"]["jax3d"]
    jbatch, _, _ = jax_synthetic_batch(batch_size=B, n_points=96, seed=JAX_DATA_SEED)
    sd = ranks_mod.model_3d("3dmatch", JAX_WEIGHT_SEED, gate=GATE).state_dict()
    cfg = jax_preset_tiny("3dmatch", sample_steps=2)
    proc = dataclasses.replace(cfg.procrustes, max_condition_num=GATE)
    model = JaxModel(dataclasses.replace(cfg, procrustes=proc, coarse_transformer=dataclasses
                                         .replace(cfg.coarse_transformer, procrustes=proc)))
    key = jax.random.PRNGKey(JAX_TRAIN_KEY)
    shapes = jax.eval_shape(lambda: model.init({"params": key}, jbatch, key, mode="train"))
    leaves, names = {}, {}
    for path, leaf in flatten_dict(dict(shapes)).items():
        name, layout = _translate("/".join(path[1:]))
        value = sd[name].numpy()
        value = value.T if layout == "T" else value[:, :, 0].T if layout == "conv" else value
        assert value.shape == leaf.shape, path
        leaves[path] = jnp.asarray(value)
        if path[0] == "params":
            names[path[1:]] = (name, layout)
    variables = unflatten_dict(leaves)
    ocfg = JaxOptimConfig(optimizer="sgd", lr=p["lr"], momentum=0.0, weight_decay=0.0)
    state = JaxTrainState(variables["params"], variables["buffers"],
                          jax_make_optimizer(ocfg).init(variables["params"]),
                          jnp.zeros((), jnp.int32))
    mesh = make_mesh(jax.devices()[:RANKS])
    after, info = make_parallel_train_step(model, JaxLossConfig(), ocfg, mesh)(
        replicate(state, mesh), shard_batch(jbatch, mesh), key)
    before, stepped = flatten_dict(dict(variables["params"])), flatten_dict(dict(after.params))
    grads = {}
    for path, (name, layout) in names.items():
        g = (np.asarray(before[path]) - np.asarray(stepped[path])) / p["lr"]
        grads[name] = g.T if layout == "T" else g.T[:, :, None] if layout == "conv" else g
    return {"info": {k: float(v) for k, v in info.items()}, "grads": grads}


@pytest.fixture(scope="module")
def ranks(group):
    """Each process's results (``torch_parallel_ranks.rank_main``)."""
    group["thread"].join(JOIN_TIMEOUT_S + 30)
    if "error" in group["box"]:
        raise group["box"]["error"]
    assert "results" in group["box"], "the processes did not end"
    return group["box"]["results"]


def _rel(got, ref):
    return float(np.abs(got - ref).max()) / max(float(np.abs(ref).max()), 1e-30)


# ---------------------------------------------------------------- against JAX


def test_parallel_step_matches_jax_mesh(jax_step, ranks):
    """Two gloo processes, 2 pairs each, against JAX's step over 2 devices:
    the same global loss, info and gradient in both processes. The
    positioning layer's matcher feeds only the detached position code: zero
    in JAX, a zero gradient here (None before the all-reduce)."""
    ref = jax_step
    for rank, res in enumerate(ranks):
        got = res["jax3d"]
        for name in ("loss", "focal_coarse", "loss_matrix_gt_hat", "recall_coarse",
                     "precision_coarse", "grads_finite"):
            np.testing.assert_allclose(got["info"][name], ref["info"][name],
                                       rtol=LOSS_REL_TOL, atol=1e-7, err_msg=f"{rank} {name}")
        np.testing.assert_allclose(got["info"]["grad_norm"], ref["info"]["grad_norm"],
                                   rtol=JAX_GRAD_TOL)
        assert set(got["grads"]) == set(ref["grads"])
        for name, g_ref in ref["grads"].items():
            g = got["grads"][name]
            if name.startswith("coarse_transformer.layers.2.0."):
                assert not np.any(g) and np.all(np.abs(g_ref) < 1e-9), name
                continue
            assert np.abs(g_ref).max() > 0, name
            np.testing.assert_allclose(g, g_ref, rtol=0, atol=JAX_GRAD_TOL * np.abs(g_ref).max(),
                                       err_msg=f"rank {rank}: {name}")


# ---------------------------------------------------------------- against one process


@pytest.mark.parametrize("name", ["3dmatch", "4dmatch", "2d3d"])
def test_parallel_step_matches_single_process(ranks, name):
    """The data-parallel step against the single-process step on the global
    batch: the loss and its terms, every gradient, and in every process the
    same parameters after the update (bit for bit)."""
    single = ranks[SINGLE_RANK[name]][name]["single"]
    largest = max(float(np.abs(g).max()) for g in single["grads"].values() if g is not None)
    for rank, res in enumerate(ranks):
        got = res[name]["parallel"]
        assert set(got["info"]) == set(single["info"])
        for key, value in single["info"].items():
            np.testing.assert_allclose(got["info"][key], value, rtol=LOSS_REL_TOL, atol=1e-7,
                                       err_msg=f"rank {rank}: {key}")
        for pname, g_ref in single["grads"].items():
            g = got["grads"][pname]
            if g_ref is None:         # a parameter the loss does not reach
                assert not np.any(g), pname
            elif pname.endswith("k_token_layer.bias"):
                # softmax ignores a key bias: its gradient is rounding
                assert max(np.abs(g).max(), np.abs(g_ref).max()) < KEY_BIAS_TOL * largest, pname
            else:
                np.testing.assert_allclose(g, g_ref, rtol=0,
                                           atol=GRAD_TOL * np.abs(g_ref).max(),
                                           err_msg=f"rank {rank}: {pname}")
    for pname, p in ranks[0][name]["parallel"]["params"].items():
        np.testing.assert_array_equal(ranks[1][name]["parallel"]["params"][pname], p, pname)
    if name == "4dmatch":
        assert single["info"]["l1_motion"] > 0


def test_motion_gate_reads_the_global_recall(group, ranks):
    """diffreg_loss with the 4DMatch motion term on outputs whose shard 0
    alone would gate the motion term off: the loss, its terms and the
    gradients of the outputs are the global batch's in both processes."""
    single = ranks[0]["loss4d"]["single"]
    assert single["info"]["recall_coarse"] > 0.01 > ranks[0]["loss4d"]["shard_recall"]
    for rank, res in enumerate(ranks):
        got = res["loss4d"]["parallel"]
        for key, value in single["info"].items():
            np.testing.assert_allclose(got["info"][key], value, rtol=LOSS_REL_TOL, atol=1e-7,
                                       err_msg=f"rank {rank}: {key}")
    for key, g_ref in single["grads"].items():
        g = np.concatenate([res["loss4d"]["parallel"]["grads"][key] for res in ranks])
        np.testing.assert_allclose(g, g_ref, rtol=0, atol=GRAD_TOL * np.abs(g_ref).max(),
                                   err_msg=key)


def test_global_normaliser_matters():
    """On the JAX comparison's batch, whose shards hold different numbers of
    GT matches, averaging each shard's own loss (a per-process mean, what
    DistributedDataParallel would average) is not the global batch's loss:
    its gradient lies beyond the tolerances above."""
    from diffreg_tpu_torch.data.synthetic import synthetic_batch

    torch.manual_seed(0)
    batch, spec, _ = synthetic_batch(batch_size=B, n_points=96, seed=JAX_DATA_SEED)
    draws = {k: T(v) for k, v in _jax_draws(spec).items()}
    model = ranks_mod.model_3d("3dmatch", JAX_WEIGHT_SEED, gate=GATE)
    params = [p for _, p in model.named_trained_parameters()]

    def loss_grads(rows):
        b = batch.select(rows)
        out = model.train_forward(b, **{k: v[rows] for k, v in draws.items()})
        loss = diffreg_loss(out, b, LossConfig())[0]
        grads = torch.autograd.grad(loss, params, allow_unused=True)
        return float(loss.detach()), [None if g is None else g.numpy() for g in grads]

    loss, grads = loss_grads(slice(0, B))
    shards = [loss_grads(slice(r * 2, r * 2 + 2)) for r in range(RANKS)]
    positives = [float(batch.matrix_gt()[r * 2:r * 2 + 2].sum()) for r in range(RANKS)]
    assert positives[0] != positives[1]
    naive_loss = sum(s[0] for s in shards) / RANKS
    assert abs(naive_loss - loss) / loss > LOSS_REL_TOL
    worst = max(_rel(sum(s[1][i] for s in shards) / RANKS, g)
                for i, g in enumerate(grads) if g is not None)
    assert worst > JAX_GRAD_TOL


def test_parallel_eval_matches_single_process(ranks):
    """The 4DMatch stochastic DDIM split over the processes (start and noise
    drawn for the whole batch, each process its rows; the per-step
    conditions [steps, B] gathered along axis 1) equals the single-process
    DDIM on the global batch, in every process."""
    single = ranks[0]["eval"]["single"]
    for res in ranks:
        got = res["eval"]["parallel"]
        assert set(got) == set(single)
        for key, value in single.items():
            assert got[key].shape == value.shape, key
            np.testing.assert_allclose(got[key], value, rtol=1e-6, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------- the trainer and the CLI


def test_lockstep_epoch_and_master_checkpoint(ranks):
    """One process drops a pair too large for every bucket, so its shard holds
    a batch fewer: both still take the same number of steps, end with the
    same parameters, and only process 0 saves the checkpoint and logs to
    files."""
    got = [res["lockstep"] for res in ranks]
    assert [g["stats"]["pairs_dropped"] for g in got] == [1, 0]
    assert got[0]["steps"] == got[1]["steps"] == 2
    assert got[0]["seen"] == [0, 4] and got[1]["seen"] == [1, 3, 0]
    assert got[0]["saves"] == [1] and got[1]["saves"] == []
    assert got[0]["logger_dir"] is not None and got[1]["logger_dir"] is None
    for name, p in got[0]["params"].items():
        np.testing.assert_array_equal(got[1]["params"][name], p, name)


def test_cli_trains_one_model_over_the_world(group, ranks):
    """``main --mode train --demo`` in both processes: each trains on its own
    shard of the demo batches (together all of them), with the learning rate
    times the world and the epoch counted in its own steps; one snapshot
    directory, one checkpoint, one source backup."""
    got = [res["cli"] for res in ranks]
    assert got[0]["seeds"] == [0, 2] and got[1]["seeds"] == [1, 3]
    for g in got:
        assert g["optim"]["lr"] == pytest.approx(CLI_LR * RANKS)
        assert g["optim"]["steps_per_epoch"] == 2 and g["result"]["steps"] == 2
    assert got[0]["result"]["loss"] == got[1]["result"]["loss"]
    snap = group["tmp"] / "cli" / "snapshot"
    assert os.listdir(snap) == ["dp"]
    assert sorted(os.listdir(snap / "dp" / "checkpoints")) == ["1.pt", "best.json"]
    assert os.path.isdir(snap / "dp" / "source_backup")
    with open(snap / "dp" / "log.txt") as f:
        assert "data parallel: 2 processes" in f.read()


def test_processes_import_no_jax(ranks):
    assert not any(res["jax_imported"] for res in ranks)


def test_run_ranks_fails_fast():
    """A process that raises ends the group at once, while the other waits in
    a collective, and its traceback is reported."""
    with pytest.raises(RuntimeError, match=r"(?s)rank 1:.*ValueError: rank 1 fails"):
        distributed.run_ranks(ranks_mod.fail_on_rank_1, RANKS, timeout_s=60)


# ---------------------------------------------------------------- no processes


@pytest.mark.parametrize("world", [1, 2, 3, 4])
def test_shard_order_for_process_matches_jax(world):
    for n in range(14):
        order = np.random.RandomState(n).permutation(n)
        for rank in range(world):
            np.testing.assert_array_equal(
                distributed.shard_order_for_process(order, rank, world),
                jax_distributed.shard_order_for_process(order, rank, world))
    with pytest.raises(ValueError):
        distributed.shard_order_for_process(np.arange(5), 4, 4)


def test_iterate_batches_shards_match_jax():
    """The port's loader and the JAX package's give each process the same
    pairs in the same order, dropping the same one."""
    pairs = ranks_mod.tiny_pairs(7, big=3)
    cfg = dict(first_subsampling_dl=0.06, coarse_match_radius=0.15)
    for rank in range(3):
        stats, jstats = {}, {}
        got = [m[0]["idx"] for _, m in iterate_batches(
            pairs, tiny_spec(96), PyramidConfig(**cfg), 1, shuffle=True, seed=5, stats=stats,
            process_index=rank, process_count=3)]
        ref = [m[0]["idx"] for _, m in jax_iterate_batches(
            pairs, jax_tiny_spec(96), JaxPyramidConfig(**cfg), 1, shuffle=True, seed=5,
            stats=jstats, process_index=rank, process_count=3)]
        assert got == ref and stats == jstats


@pytest.mark.parametrize("raw", [{"optimizer": "SGD", "lr": 0.015},
                                 {"optimizer": "adam", "lr": 1e-4, "scale_lr_by_world": False}])
@pytest.mark.parametrize("world", [1, 4])
def test_build_optim_config_world_size_matches_jax(raw, world):
    got = port_config.build_optim_config(raw, steps_per_epoch=7, world_size=world)
    ref = jax_config.build_optim_config(raw, steps_per_epoch=7, world_size=world)
    assert dataclasses.asdict(got) == dataclasses.asdict(ref)
    scaled = world > 1 and raw.get("scale_lr_by_world", True)
    assert got.lr == pytest.approx(raw["lr"] * (world if scaled else 1))


def test_setup_distributed_alone_and_refusing(monkeypatch):
    """With nothing set, one process (the JAX function's dict); with a world
    asking for more cards than are visible, an error, not a run alone."""
    for name in ("WORLD_SIZE", "RANK", "LOCAL_RANK"):
        monkeypatch.delenv(name, raising=False)
    info = distributed.setup_distributed(device_type="cpu")
    assert info["process_index"] == 0 and info["process_count"] == 1
    assert set(jax_distributed.setup_distributed()) <= set(info) and not info["initialized"]
    monkeypatch.setenv("WORLD_SIZE", "2")
    monkeypatch.setenv("RANK", "1")
    monkeypatch.setenv("LOCAL_RANK", str(torch.cuda.device_count()))
    with pytest.raises(RuntimeError, match="CUDA device"):
        distributed.setup_distributed(device_type="cuda")
    assert not torch.distributed.is_initialized()


def test_kernel_launch_makes_the_tensors_device_current(monkeypatch):
    """A kernel's C entry point runs with the tensors' card current and gets
    that card's stream: here a stand-in CUDA runtime records the current
    device while the entry runs. Every wrapper launches through ``launch``."""
    import inspect

    from diffreg_tpu_torch.ops import attention, kpconv
    from diffreg_tpu_torch.utils import cuda

    current = [0]

    class Device:
        def __init__(self, device):
            self.index = torch.device(device).index

        def __enter__(self):
            self.prev, current[0] = current[0], self.index

        def __exit__(self, *exc):
            current[0] = self.prev

    seen = []

    class Lib:
        def entry(self, *args):
            seen.append((current[0], args))
            return 0

    monkeypatch.setattr(torch.cuda, "device", Device)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device: type("S", (), {"cuda_stream": 1000 + device.index}))
    cuda.launch(Lib(), "entry", torch.device("cuda", 1), 7, 8)
    assert seen == [(1, (7, 8, 1001))] and current[0] == 0
    for wrapper in (attention.masked_attention_cuda, attention.masked_attention_cuda_bf16,
                    kpconv.kpconv_cuda, kpconv.kpconv_cuda_bf16):
        source = inspect.getsource(wrapper)
        assert "launch(lib, " in source and "lib.masked" not in source \
            and "lib.kpconv" not in source, wrapper.__name__
