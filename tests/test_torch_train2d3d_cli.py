"""``diffreg_tpu_torch.main --mode train`` on a 2D-3D YAML against
``diffreg_tpu.main``, on the CPU: the demo pairs with the training GT, one
epoch of two Adam steps from the JAX main's initial weights (converted by
``convert.state_dict_2d3d_from_flax``), with JAX's per-step draws rebuilt
from its keys (``Trainer``: ``rng, r = split(rng)``; the model:
``split(r)`` into the timesteps and the normal draw).

Tolerances: each step's loss terms agree to 1e-5 relative at the first step
(``tests/test_torch_train2d3d.py``'s loss tolerance) and 1e-4 at the second,
taken from parameters that already differ (Adam's first step is lr times
the gradient's sign wherever the gradient is not tiny).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from diffreg_tpu_torch.convert import state_dict_2d3d_from_flax
from diffreg_tpu_torch.models import pipeline_2d3d as pp

T = torch.from_numpy
LR, LOSS_TOL = 1e-4, 1e-5


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads, as tests/test_torch_cli.py uses for its CLI runs."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _jax_draws(key, b, n, m):
    """JAX ``mode="train"``'s timesteps and normal draw from its rng."""
    rng_t, rng_n = jax.random.split(key)
    return {"t": T(np.array(jax.random.randint(rng_t, (b,), 0, 1000))),
            "noise": T(np.array(jax.random.normal(rng_n, (b, n, m))))}


def _tiny_yaml(path, max_epoch=1):
    tree = {"dataset": "rgbdv2", "mode": "train", "exp_dir": "train2d3d", "batch_size": 2,
            "SAMPLE_STEP": 2, "max_epoch": max_epoch, "lr": LR,
            "model_2d3d": {"img_out_dim": 32, "img_base_dim": 16, "pcd_init_dim": 16,
                           "pcd_output_dim": 32, "hidden_dim": 64, "output_dim": 64,
                           "num_heads": 2, "pcd_num_points_in_patch": 32, "use_dino": False,
                           "use_mono_depth": False}}
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return str(path)


def test_main_train_matches_jax(tmp_path, monkeypatch):
    """``main --mode train --demo`` against ``diffreg_tpu.main`` on the tiny
    2D-3D YAML: one epoch of two Adam steps from JAX's initial weights, with
    JAX's per-step draws; every step's loss terms, the epoch's metrics and
    the checkpoint."""
    import diffreg_tpu.main as jax_main
    from diffreg_tpu.engine import trainer as jtr
    from diffreg_tpu_torch.engine import trainer as ptr
    from diffreg_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    jax_steps, port_steps, run = [], [], {}

    def record(steps, step):
        def recording(*args):
            state, info = step(*args)
            steps.append({k: float(v) for k, v in info.items() if np.ndim(v) == 0})
            return state, info
        return recording

    def jax_init(self, step, state, *args, _orig=jtr.Trainer.__init__, **kwargs):
        run["init"] = state
        _orig(self, record(jax_steps, step), state, *args, **kwargs)
    monkeypatch.setattr(jtr.Trainer, "__init__", jax_init)
    argv = ["--demo", "--mode", "train", "--num-pairs", "4"]
    jax_main.main(["--config", _tiny_yaml(tmp_path / "jax.yaml"), *argv])

    sd = state_dict_2d3d_from_flax(_flat(run["init"].params), _flat(run["init"].buffers))
    keys = {"rng": jax.random.PRNGKey(0)}

    class WithJaxWeights(pp.DiffReg2D3D):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            self.load_state_dict(sd, strict=True)

        def draw_train_inputs(self, batch, generator):
            keys["rng"], step_rng = jax.random.split(keys["rng"])
            return _jax_draws(step_rng, batch.batch_size, batch.points[-1].shape[1],
                              (batch.image.shape[1] // 8) * (batch.image.shape[2] // 8))

    def port_init(self, step, *args, _orig=ptr.Trainer.__init__, **kwargs):
        _orig(self, record(port_steps, step), *args, **kwargs)
    monkeypatch.setattr(pp, "DiffReg2D3D", WithJaxWeights)
    monkeypatch.setattr(ptr.Trainer, "__init__", port_init)
    got = main(["--config", _tiny_yaml(tmp_path / "port.yaml"), *argv, "--device", "cpu"])
    assert len(jax_steps) == len(port_steps) == 2 and got["steps"] == 2
    for i, (g, r) in enumerate(zip(port_steps, jax_steps)):
        assert set(r) <= set(g) and g["grads_finite"] == r["grads_finite"] == 1.0
        for key in ("circle", "focal", "gt_hat", "fine", "loss"):
            np.testing.assert_allclose(g[key], r[key], rtol=LOSS_TOL if i == 0 else 1e-4,
                                       err_msg=f"step {i} {key}")
    assert (tmp_path / "snapshot" / "train2d3d" / "checkpoints" / "1.pt").is_file()


def test_main_train_2d3d_resumes(tmp_path, monkeypatch):
    """A second epoch with ``--resume`` picks up the first one's checkpoint."""
    from diffreg_tpu_torch.main import main

    monkeypatch.chdir(tmp_path)
    argv = ["--demo", "--mode", "train", "--num-pairs", "2", "--device", "cpu"]
    first = main(["--config", _tiny_yaml(tmp_path / "a.yaml"), *argv])
    resumed = main(["--config", _tiny_yaml(tmp_path / "b.yaml", max_epoch=2), *argv, "--resume"])
    run = tmp_path / "snapshot" / "train2d3d"
    assert first["steps"] == 1 and resumed["steps"] == 2
    assert np.isfinite(resumed["loss"]) and (run / "checkpoints" / "2.pt").is_file()
    assert (run / "source_backup" / "diffreg_tpu_torch" / "engine" / "train2d3d.py").is_file()
