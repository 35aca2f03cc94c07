"""The port's synthetic training story (tools/train_synthetic_port.py) and its
committed artifact (snapshot/train-synthetic-torch/: metrics.json and the
selected weights, params.npz), on the CPU:

  * the artifact meets tests/test_synthetic_training_story.py's five
    thresholds, unlowered, and names the card it was trained on (a missing
    file fails: the artifact is part of the repo);
  * params.npz loads into ``build_model`` with no missing or unexpected key;
  * ``build_model``'s config is the JAX tool's, field by field where the port
    has the field;
  * the tool at a tiny size: a run, two resumed legs that keep the step
    numbering and the selected checkpoint, and ``finalize`` on a run whose
    last write was partial;
  * the trained weights in both packages (the npz mapped to flax by
    tools/convert_checkpoint.py), the DDIM of test pair 0 from JAX's start
    draw under ``precision: default``. Tolerance: the final Sinkhorn
    confidences within CONF_TOL = 1e-2 of the largest, the top-1 union mask
    equal outside rows and columns whose best two confidences lie within
    twice that of each other (near-ties), and at least TIE_FREE_MIN of the
    real source rows free of a near-tie. CONF_TOL is about twice JAX's own
    bf16 spread: JAX's DDIM of the same pair compiled at batch 1 and at batch
    2 differs by 4.3e-3 of the largest confidence (printed each run; the
    trained model's warps are live at gate 200, and soft Procrustes carries
    a rounding from one step into the next). Measured: the port 3.9e-3 from
    JAX's batch-1 run, no mask entry differing, 0.92 of the real rows free of
    a near-tie.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses
import json
import os
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import train_synthetic as jax_tool  # noqa: E402
import train_synthetic_port as tool  # noqa: E402
from convert_checkpoint import convert_state_dict, graft_into_variables  # noqa: E402

from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch  # noqa: E402
from diffreg_tpu.utils import precision as jax_precision  # noqa: E402
from diffreg_tpu_torch.data.synthetic import synthetic_batch  # noqa: E402
from diffreg_tpu_torch.models.presets import KPFCN_ARCHITECTURE  # noqa: E402

STORY = os.path.join(REPO, tool.STORY_DIR)
JAX_METRICS = os.path.join(REPO, "snapshot", "train-synthetic", "metrics.json")
PARAMS_MAX_BYTES = 12 * 2**20
CONF_TOL = 1e-2
TIE_FREE_MIN = 0.5


@pytest.fixture(scope="module")
def metrics():
    path = os.path.join(STORY, "metrics.json")
    assert os.path.exists(path), \
        f"{path} missing: run tools/train_synthetic_port.py on the card, then finalize"
    with open(path) as f:
        return json.load(f)


# ------------------------------------------- the artifact (test_synthetic_training_story.py)


def test_heldout_registration_improves(metrics):
    assert metrics["heldout_success_after"] >= 0.30, metrics["heldout_success_after"]
    assert metrics["heldout_success_after"] > metrics["heldout_success_before"]


def test_multi_epoch(metrics):
    assert metrics["epochs"] >= 10, "not a multi-epoch run"


def test_heldout_ir_improves(metrics):
    assert metrics["heldout_ir_after"] > metrics["heldout_ir_before"] + 0.05


def test_train_loss_falls(metrics):
    losses = [loss for _, loss in metrics["train_curve"]]
    assert len(losses) >= 10
    head, tail = np.mean(losses[:3]), np.mean(losses[-3:])
    assert tail < 0.7 * head, f"train loss did not fall: {head:.4f} -> {tail:.4f}"


def test_val_curve_trend(metrics):
    succ = [s for _, s, _ in metrics["val_curve"]]
    assert max(succ) >= 0.30
    assert np.mean(succ[len(succ) // 2:]) > succ[0]


def test_artifact_is_final_and_names_the_card(metrics):
    with open(JAX_METRICS) as f:
        assert set(json.load(f)) <= set(metrics)
    assert metrics["partial"] is False and metrics["test_pairs"] == 32
    assert metrics["device"].startswith("NVIDIA"), metrics["device"]


def test_params_load_into_build_model():
    path = os.path.join(STORY, "params.npz")
    assert os.path.getsize(path) <= PARAMS_MAX_BYTES
    model = tool.build_model(device="cpu")
    with np.load(path) as f:
        assert set(f.files) == set(model.state_dict())
        assert all(f[k].dtype == np.float32 for k in f.files)
    tool.load_params(model, path)           # strict: raises on a missing or unexpected key


# ---------------------------------------------------------------- the tool


def _fields(port, ref, path, seen):
    """Compare every field of the port's config that the JAX config has."""
    if dataclasses.is_dataclass(port):
        for f in dataclasses.fields(port):
            if hasattr(ref, f.name):
                _fields(getattr(port, f.name), getattr(ref, f.name), f"{path}.{f.name}", seen)
        return
    norm = lambda v: tuple(v) if isinstance(v, (list, tuple)) else v  # noqa: E731
    assert norm(port) == norm(ref), (path, port, ref)
    seen.append(path)


def test_build_model_config_matches_the_jax_tool():
    seen = []
    cfg = tool.build_model(device="cpu").cfg
    _fields(cfg, jax_tool.build_model().cfg, "cfg", seen)
    for name in ("cfg.kpfcn.first_feats_dim", "cfg.kpfcn.coarse_feature_dim",
                 "cfg.kpfcn.fine_feature_dim", "cfg.kpfcn.first_subsampling_dl",
                 "cfg.kpfcn.compute_dtype", "cfg.coarse_transformer.feature_dim",
                 "cfg.coarse_transformer.n_head", "cfg.coarse_transformer.compute_dtype",
                 "cfg.coarse_matching.feature_dim", "cfg.procrustes.max_condition_num",
                 "cfg.sample_steps"):
        assert name in seen, name
    assert cfg.procrustes.max_condition_num == 200.0 and cfg.sample_steps == 10
    assert cfg.coarse_matching.precision == "default"     # the JAX tool's set_precision


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tool_runs_resumes_and_finalizes(tmp_path, monkeypatch, two_threads):
    """3 steps at batch 2 with a val every 2 steps, then two resumed legs to
    steps 5 and 7, then finalize after a partial last write (a killed run).
    After every leg the selected checkpoint is the newest on disk, so that
    keeping the newest KEEP files never drops it."""
    for key, value in (("DIFFREG_POOL", "2"), ("DIFFREG_EVAL_EVERY", "2"),
                       ("DIFFREG_VAL_BATCHES", "1")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("DIFFREG_RESUME", raising=False)
    monkeypatch.setattr(tool, "TEST_BATCHES", 1)
    out = str(tmp_path)
    run = lambda steps: tool.train(5.0, 2, out, device="cpu", n_points=128,  # noqa: E731
                                   max_steps=steps)
    ckpts = lambda: sorted(int(n[:-3]) for n in os.listdir(os.path.join(out, "checkpoints"))  # noqa: E731
                           if n.endswith(".pt"))
    first = run(3)
    with open(JAX_METRICS) as f:
        assert set(json.load(f)) <= set(first)
    assert first["steps"] == 3 and first["partial"] is False and first["device"] == "cpu"
    assert [v[0] for v in first["val_curve"]] == [0, 2, 3]
    assert os.path.exists(os.path.join(out, "params.npz"))
    assert ckpts()[-1] == first["selected_step"]
    assert first["legs"] == [{"start_step": 0, "steps": 3, "total_steps": 2000,
                              "warmup_steps": 300, "rate_est": tool.RATE_EST, "minutes": 5.0,
                              "batch_size": 2, "seconds": first["legs"][0]["seconds"]}]
    with pytest.raises(SystemExit):
        run(3)                              # a fresh run over another run's checkpoints

    monkeypatch.setenv("DIFFREG_RESUME", "1")
    legs = [first]
    for target in (5, 7):
        prev, cur = legs[-1], run(target)
        start = prev["selected_step"]
        assert cur["steps"] == target
        steps = [v[0] for v in cur["val_curve"]]
        assert steps == sorted(steps) and steps[-1] == target and start in steps
        assert cur["val_curve"][:2] == [v for v in first["val_curve"] if v[0] <= start][:2]
        assert cur["heldout_success_before"] == first["heldout_success_before"]
        assert [leg["start_step"] for leg in cur["legs"]] == \
            [leg["start_step"] for leg in prev["legs"]] + [start]
        assert ckpts()[-1] == cur["selected_step"] and len(ckpts()) <= tool.KEEP
        legs.append(cur)

    path = os.path.join(out, "metrics.json")
    with open(path) as f:
        payload = json.load(f)
    payload["partial"] = True
    with open(path, "w") as f:
        json.dump(payload, f)
    done = tool.finalize(out, 2, device="cpu", n_points=128)
    assert done["partial"] is False and done["finalized_from_checkpoint"]
    assert done["selected_step"] == legs[-1]["selected_step"]
    assert done["heldout_success_after"] == legs[-1]["heldout_success_after"]
    assert done["legs"] == legs[-1]["legs"]


# ---------------------------------------------------------------- the weights against JAX


def _jax_ddim(model, variables, batch, x_init):
    before = jax_precision.get_precision()
    jax_precision.set_precision("default")
    try:
        return jax.jit(lambda v, b, x: model.apply(v, b, jax.random.PRNGKey(99), mode="ddim",
                                                   x_init=x))(variables, batch, x_init)
    finally:
        jax_precision._PRECISION = before


@pytest.fixture(scope="module")
def pair0():
    """params.npz in JAX's tree; JAX's DDIM of test pair 0 from its start draw
    (the tool's key 99) at batch 1, and of pairs 0-1 at batch 2."""
    with np.load(os.path.join(STORY, "params.npz")) as f:
        sd = {k: torch.from_numpy(f[k]) for k in f.files}
    model = jax_tool.build_model()
    jb1, jb2 = (jax_synthetic_batch(batch_size=b, n_points=tool.N_POINTS, seed=tool.TEST_SEED)[0]
                for b in (1, 2))
    spec = jax_synthetic_batch(batch_size=1, n_points=tool.N_POINTS, seed=tool.TEST_SEED)[1]
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key}, jb1, key, mode="train"))
    variables, _ = graft_into_variables(dict(shapes), *convert_state_dict(sd, KPFCN_ARCHITECTURE))
    rng_init, _ = jax.random.split(jax.random.PRNGKey(99))
    x2 = jax.random.normal(rng_init, (2, spec.n_src, spec.n_tgt))
    return {"sd": sd, "x_init": np.asarray(x2[:1]),
            "batch1": _jax_ddim(model, variables, jb1, x2[:1]),
            "batch2": _jax_ddim(model, variables, jb2, x2)}


def test_trained_weights_match_jax_on_test_pair0(pair0, two_threads):
    pbatch = synthetic_batch(batch_size=1, n_points=tool.N_POINTS, seed=tool.TEST_SEED)[0]
    model = tool.build_model(device="cpu")
    model.load_state_dict(pair0["sd"])
    got = model.ddim_sample(pbatch, torch.from_numpy(pair0["x_init"].copy()))
    sm, tm = pbatch.src_mask.numpy(), pbatch.tgt_mask.numpy()
    valid = sm[:, :, None] & tm[:, None, :]
    conf = np.asarray(pair0["batch1"]["conf_matrix_pred"])
    top = np.abs(conf[valid]).max()
    spread = np.abs(np.asarray(pair0["batch2"]["conf_matrix_pred"])[:1] - conf)[valid].max() / top
    tol = CONF_TOL
    err = np.abs(got["conf_matrix_pred"].numpy() - conf)[valid].max() / top
    masked = np.where(valid, conf, -1.0)
    rows = -np.partition(-masked, 1, axis=2)
    cols = -np.partition(-masked, 1, axis=1)
    row_tie = rows[:, :, 0] - rows[:, :, 1] <= 2 * tol * top
    col_tie = cols[:, 0, :] - cols[:, 1, :] <= 2 * tol * top
    differ = (got["corr_mask"].numpy() != np.asarray(pair0["batch1"]["corr_mask"])) & valid
    bb, ii, jj = np.nonzero(differ)
    tie_free = float((~row_tie & sm).sum()) / sm.sum()
    print(f"test pair 0, trained weights: port vs JAX {err:.3e} of the largest confidence "
          f"({top:.3e}); JAX batch 1 vs batch 2 {spread:.3e}; tolerance {tol:.3e}; "
          f"{differ.sum()} mask entries differ; real rows free of a near-tie {tie_free:.4f}")
    assert err <= tol, (err, tol)
    assert np.all(row_tie[bb, ii] | col_tie[bb, jj])
    assert tie_free >= TIE_FREE_MIN
