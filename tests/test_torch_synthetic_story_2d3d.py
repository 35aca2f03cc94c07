"""The port's 2D-3D synthetic training story (tools/train_synthetic_2d3d_port.py)
and its committed artifact (snapshot/train-synthetic-2d3d-torch/: metrics.json
and the selected weights, params.npz), on the CPU:

  * the artifact meets tests/test_synthetic_training_story_2d3d.py's
    thresholds on IR, RR against its start and the train loss, unlowered,
    and names the card it was trained on (a missing file fails: the artifact
    is part of the repo). It is not held to that test's RR >= 0.25: the JAX
    story's own finished run scored held-out RR 0.0, with a val RR of at most
    0.125 (ADVICE.md), so that is not a property the reference has shown;
    PERF.md gives the port's RR beside those numbers;
  * metrics.json's ``selected_step`` is the latest val result that is
    lexicographically best on (val RR, val IR);
  * params.npz loads into ``build_model`` with no missing or unexpected key;
  * ``build_model``'s config and ``make_batch``'s arrays are the JAX tool's;
  * the tool at a tiny size: a run, a resumed leg that keeps the step
    numbering and the selected checkpoint, and ``finalize`` on a run whose
    last write was partial;
  * the trained weights in both packages (the npz mapped to flax by
    tools/convert_checkpoint_2d3d.py), the DDIM of test pair 0 (10 steps)
    from one start draw, both in f32. Tolerance: the final Sinkhorn
    confidences within CONF_TOL of the largest, the top-1 union mask equal
    outside rows and columns whose best two confidences lie within twice
    that of each other (near-ties), and at least TIE_FREE_MIN of the real
    node rows free of a near-tie.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tools"))

import train_synthetic_2d3d as jax_tool  # noqa: E402
import train_synthetic_2d3d_port as tool  # noqa: E402
from convert_checkpoint_2d3d import convert_state_dict_2d3d, graft_2d3d  # noqa: E402

from diffreg_tpu.data.synthetic2d3d import synthetic_2d3d_batch as jax_batch  # noqa: E402

STORY = os.path.join(REPO, tool.STORY_DIR)
# the keys of the JAX tool's final metrics.json (tools/train_synthetic_2d3d.py:_dump)
JAX_KEYS = {"steps", "heldout_rr_before", "heldout_ir_before", "heldout_fmr_before", "epochs",
            "train_curve", "val_curve", "pool_pairs", "partial", "variant", "heldout_rr_after",
            "heldout_ir_after", "heldout_fmr_after", "selected_step", "fresh_batches",
            "test_pairs", "protocol"}
PARAMS_MAX_BYTES = 20 * 2**20
CONF_TOL = 5e-5
TIE_FREE_MIN = 0.5
TINY_HW, TINY_POINTS = (56, 70), 160


@pytest.fixture(scope="module")
def metrics():
    path = os.path.join(STORY, "metrics.json")
    assert os.path.exists(path), \
        f"{path} missing: run tools/train_synthetic_2d3d_port.py on the card, then finalize"
    with open(path) as f:
        return json.load(f)


# ------------------------------------- the artifact (test_synthetic_training_story_2d3d.py)


def test_artifact_is_final_and_names_the_card(metrics):
    assert JAX_KEYS <= set(metrics)
    assert metrics["partial"] is False and metrics["variant"] == "2d3d"
    assert metrics["test_pairs"] == tool.TEST_BATCHES * 4
    assert metrics["device"].startswith("NVIDIA"), metrics["device"]
    assert metrics["legs"] and all(leg["total_steps"] >= 1000 for leg in metrics["legs"])


def test_heldout_ir_improves(metrics):
    assert metrics["heldout_ir_after"] > metrics["heldout_ir_before"] + 0.10


def test_heldout_rr_does_not_fall(metrics):
    assert metrics["heldout_rr_after"] >= metrics["heldout_rr_before"]


def test_train_loss_falls(metrics):
    losses = [loss for _, loss in metrics["train_curve"]]
    assert len(losses) >= 10
    head, tail = np.mean(losses[:3]), np.mean(losses[-3:])
    assert tail < 0.8 * head, f"train loss did not fall: {head:.4f} -> {tail:.4f}"


def test_selected_step_is_the_best_val_result(metrics):
    steps = [v[0] for v in metrics["val_curve"]]
    assert steps == sorted(steps) and steps[0] == 0 and steps[-1] == metrics["steps"]
    best = max((v[1], v[2]) for v in metrics["val_curve"])
    assert metrics["selected_step"] == max(v[0] for v in metrics["val_curve"]
                                           if (v[1], v[2]) == best)


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
    for name in ("cfg.img_out_dim", "cfg.img_base_dim", "cfg.pcd_backbone.output_dim",
                 "cfg.pcd_backbone.init_dim", "cfg.pcd_backbone.init_radius",
                 "cfg.pcd_backbone.init_sigma", "cfg.hidden_dim", "cfg.output_dim",
                 "cfg.num_heads", "cfg.matching.feature_dim", "cfg.coarse_stride",
                 "cfg.sample_steps"):
        assert name in seen, name
    assert (cfg.coarse_stride, cfg.sample_steps, cfg.hidden_dim // cfg.num_heads) == (14, 10, 32)
    assert (tool.IMG_HW, tool.N_POINTS) == (jax_tool.IMG_HW, jax_tool.N_POINTS) == \
        ((112, 154), 1024)


def test_make_batch_matches_the_jax_tool():
    """Test batch 0 at a tiny size in both packages, array for array; its
    first pair is the batch of one at the same seed."""
    got = tool.make_batch(2, tool.TEST_SEED, TINY_HW, TINY_POINTS)
    ref = jax_batch(batch_size=2, img_hw=TINY_HW, n_points=TINY_POINTS, seed=tool.TEST_SEED,
                    coarse_stride=14, with_full_gt=True, n_overlap=256, n_fine_gt=128,
                    as_jnp=False)
    one = tool.make_batch(1, tool.TEST_SEED, TINY_HW, TINY_POINTS)
    for field in dataclasses.fields(got):
        a, b, c = (getattr(x, field.name, None) for x in (got, ref, one))
        assert (a is None) == (b is None), field.name
        if a is None:
            continue
        for t, r, o in zip(*((v if isinstance(v, tuple) else (v,)) for v in (a, b, c))):
            np.testing.assert_array_equal(t.numpy(), np.asarray(r), err_msg=field.name)
            np.testing.assert_array_equal(t[:1].numpy(), o.numpy(), err_msg=field.name)


def test_port_tools_import_without_jax():
    """The story tool, its spread tool and chip_smoke.py (which loads both on
    the card) import neither JAX nor the JAX package."""
    code = ("import sys\n"
            "sys.modules['jax'] = None\n"
            "sys.modules['flax'] = None\n"
            f"sys.path[:0] = [{REPO!r}, {os.path.join(REPO, 'tools')!r}]\n"
            "import chip_smoke, spread_port_story2d3d_pair0, train_synthetic_2d3d_port\n"
            "chip_smoke.story_tool(sys.path[0], 'train_synthetic_2d3d_port')\n"
            "bad = [m for m in sys.modules if m == 'diffreg_tpu' or m.startswith('diffreg_tpu.')]\n"
            "assert not bad, bad\n")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr


@pytest.fixture
def two_threads():
    before = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(before)


def test_tool_runs_resumes_and_finalizes(tmp_path, monkeypatch, two_threads):
    """3 steps at batch 2 with a val every 2 steps, a resumed leg to step 5,
    then finalize after a partial last write (a killed run). After each leg
    the selected checkpoint is the newest on disk, so that keeping the newest
    KEEP files never drops it."""
    for key, value in (("DIFFREG_POOL", "2"), ("DIFFREG_EVAL_EVERY", "2"),
                       ("DIFFREG_VAL_BATCHES", "1")):
        monkeypatch.setenv(key, value)
    monkeypatch.delenv("DIFFREG_RESUME", raising=False)
    monkeypatch.setattr(tool, "TEST_BATCHES", 1)
    out = str(tmp_path)
    run = lambda steps: tool.train(5.0, 2, out, device="cpu", img_hw=TINY_HW,  # noqa: E731
                                   n_points=TINY_POINTS, max_steps=steps)
    def ckpts():
        return sorted(int(n[:-3]) for n in os.listdir(os.path.join(out, "checkpoints"))
                      if n.endswith(".pt"))
    first = run(3)
    assert JAX_KEYS <= set(first)
    assert first["steps"] == 3 and first["partial"] is False and first["device"] == "cpu"
    assert [v[0] for v in first["val_curve"]] == [0, 2, 3]
    assert os.path.exists(os.path.join(out, "params.npz"))
    assert ckpts()[-1] == first["selected_step"]
    assert first["legs"] == [{"start_step": 0, "steps": 3, "total_steps": 1000,
                              "warmup_steps": 200, "rate_est": tool.RATE_EST, "minutes": 5.0,
                              "batch_size": 2, "seconds": first["legs"][0]["seconds"]}]
    with pytest.raises(SystemExit):
        run(3)                              # a fresh run over another run's checkpoints

    monkeypatch.setenv("DIFFREG_RESUME", "1")
    start = first["selected_step"]
    cur = run(5)
    steps = [v[0] for v in cur["val_curve"]]
    assert cur["steps"] == 5 and steps == sorted(steps) and steps[-1] == 5 and start in steps
    assert cur["val_curve"][:2] == [v for v in first["val_curve"] if v[0] <= start][:2]
    assert (cur["heldout_rr_before"], cur["heldout_ir_before"]) == \
        (first["heldout_rr_before"], first["heldout_ir_before"])
    assert [leg["start_step"] for leg in cur["legs"]] == [0, start]
    assert ckpts()[-1] == cur["selected_step"] and len(ckpts()) <= tool.KEEP

    path = os.path.join(out, "metrics.json")
    with open(path) as f:
        payload = json.load(f)
    payload["partial"] = True
    with open(path, "w") as f:
        json.dump(payload, f)
    done = tool.finalize(out, 2, device="cpu", img_hw=TINY_HW, n_points=TINY_POINTS)
    assert done["partial"] is False and done["finalized_from_checkpoint"]
    assert done["selected_step"] == cur["selected_step"]
    assert (done["heldout_rr_after"], done["heldout_ir_after"], done["heldout_fmr_after"]) == \
        (cur["heldout_rr_after"], cur["heldout_ir_after"], cur["heldout_fmr_after"])
    assert done["legs"] == cur["legs"]


# ---------------------------------------------------------------- the weights against JAX


def test_trained_weights_match_jax_on_test_pair0(two_threads):
    """params.npz in JAX's tree; both packages' DDIM of test pair 0 from JAX's
    start draw (key 1)."""
    with np.load(os.path.join(STORY, "params.npz")) as f:
        sd = {k: torch.from_numpy(f[k]) for k in f.files}
    jbatch = jax_tool.make_batch(1, tool.TEST_SEED)
    model = jax_tool.build_model()
    key = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda: model.init({"params": key}, jbatch, key, mode="train"))
    variables = graft_2d3d(dict(shapes), *convert_state_dict_2d3d(sd))
    pbatch = tool.make_batch(1, tool.TEST_SEED)
    n, (h, w) = pbatch.points[-1].shape[1], tool.IMG_HW
    x_init = np.asarray(jax.random.normal(jax.random.PRNGKey(1), (1, n, (h // 14) * (w // 14))))
    ref = jax.jit(lambda v, b, x: model.apply(v, b, key, mode="ddim", x_init=x))(
        variables, jbatch, x_init)
    port = tool.load_params(tool.build_model(device="cpu"), os.path.join(STORY, "params.npz"))
    with torch.no_grad():
        got = port(pbatch, mode="ddim", x_init=torch.from_numpy(x_init.copy()))

    nodes = got["node_masks"].numpy()
    np.testing.assert_array_equal(nodes, np.asarray(ref["node_masks"]))
    np.testing.assert_array_equal(got["img_valid_c"].numpy(), np.asarray(ref["img_valid_c"]))
    valid = nodes[:, :, None] & got["img_valid_c"].numpy()[:, None, :]
    conf = np.asarray(ref["conf_matrix_pred"])
    top = np.abs(conf[valid]).max()
    err = np.abs(got["conf_matrix_pred"].numpy() - conf)[valid].max() / top
    masked = np.where(valid, conf, -1.0)
    rows = -np.partition(-masked, 1, axis=2)
    cols = -np.partition(-masked, 1, axis=1)
    row_tie = rows[:, :, 0] - rows[:, :, 1] <= 2 * CONF_TOL * top
    col_tie = cols[:, 0, :] - cols[:, 1, :] <= 2 * CONF_TOL * top
    differ = (got["corr_mask"].numpy() != np.asarray(ref["corr_mask"])) & valid
    bb, ii, jj = np.nonzero(differ)
    tie_free = float((~row_tie & nodes).sum()) / nodes.sum()
    print(f"test pair 0, trained weights: port vs JAX {err:.3e} of the largest confidence "
          f"({top:.3e}); tolerance {CONF_TOL:.1e}; {differ.sum()} mask entries differ; real "
          f"node rows free of a near-tie {tie_free:.4f} of {nodes.sum()}")
    assert err <= CONF_TOL, (err, CONF_TOL)
    assert np.all(row_tie[bb, ii] | col_tie[bb, jj])
    assert tie_free >= TIE_FREE_MIN
