"""The port stands alone: it imports neither JAX, Flax nor the JAX package,
and its entry points refuse to run without a device when CUDA is missing."""
import os
import pkgutil
import subprocess
import sys

import pytest
import torch

import diffreg_tpu_torch

PACKAGE_DIR = os.path.dirname(diffreg_tpu_torch.__file__)
REPO_DIR = os.path.dirname(PACKAGE_DIR)


def _modules():
    return sorted(m.name for m in pkgutil.walk_packages([PACKAGE_DIR], "diffreg_tpu_torch."))


# the CLI slice's modules, named so that a missing one fails the import guard
CLI_MODULES = ["diffreg_tpu_torch.main", "diffreg_tpu_torch.utils.config",
               "diffreg_tpu_torch.utils.snapshot", "diffreg_tpu_torch.engine.tester",
               "diffreg_tpu_torch.eval.metrics", "diffreg_tpu_torch.data.datasets",
               "diffreg_tpu_torch.data.loader"]


def test_every_module_imports_without_jax():
    code = (
        "import sys\n"
        "sys.modules['jax'] = None\n"
        "sys.modules['flax'] = None\n"
        "import importlib\n"
        f"for name in {_modules()!r}:\n"
        "    importlib.import_module(name)\n"
        "bad = [m for m in sys.modules if m == 'diffreg_tpu' or m.startswith('diffreg_tpu.')]\n"
        "assert not bad, bad\n"
    )
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO_DIR, capture_output=True,
                          text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert len(_modules()) > 20 and set(CLI_MODULES) <= set(_modules())


def test_no_module_names_the_jax_package():
    for root, _, files in os.walk(PACKAGE_DIR):
        for name in files:
            if name.endswith((".py", ".cu")):
                with open(os.path.join(root, name)) as f:
                    text = f.read()
                assert "diffreg_tpu." not in text, name
                for mod in ("jax", "flax"):
                    assert f"import {mod}" not in text and f"from {mod}" not in text, name


def test_entry_points_need_a_device(monkeypatch, tmp_path):
    from diffreg_tpu_torch.data.synthetic import synthetic_batch
    from diffreg_tpu_torch.engine.losses import LossConfig
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state, make_train_step
    from diffreg_tpu_torch.engine.trainer import IterBasedTrainer, Trainer, TrainerConfig
    from diffreg_tpu_torch.eval.register import register
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
    from diffreg_tpu_torch.models.presets import preset_tiny

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        DiffusionMatchingModel(preset_tiny())
    model = DiffusionMatchingModel(preset_tiny(), device="cpu")
    batch, spec, _ = synthetic_batch(batch_size=1, n_points=64, seed=0)
    x_init = torch.zeros(1, spec.n_src, spec.n_tgt)
    u = torch.rand(1, 16, 3)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        register(model, batch, x_init, u)
    out = register(model, batch, x_init, u, device="cpu")
    assert out["ransac_rotation"].shape == (1, 3, 3)
    assert torch.isfinite(out["conf_matrix_pred"]).all()

    state = create_train_state(model, OptimConfig())
    loader = lambda epoch: iter([(batch, None)])
    cfg = TrainerConfig(max_epoch=1, save_dir=str(tmp_path / "run"))
    for trainer_cls in (Trainer, IterBasedTrainer):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            trainer_cls(make_train_step(LossConfig()), state, loader, cfg)
    trained = Trainer(make_train_step(LossConfig()), state, loader, cfg, device="cpu").train()
    assert trained.step == 1 and trained.optimizer.count == 1


def test_cli_entry_points_need_a_device(monkeypatch, tmp_path):
    from diffreg_tpu_torch.engine.tester import (FourDMatchTester, TestConfig,
                                                 ThreeDMatchTester)
    from diffreg_tpu_torch.engine.trainer import BatchTester
    from diffreg_tpu_torch.main import main

    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    monkeypatch.chdir(tmp_path)
    for make in (lambda: ThreeDMatchTester(None), lambda: FourDMatchTester(None),
                 lambda: BatchTester(None, None),
                 lambda: main(["--config", os.path.join(REPO_DIR, "configs", "test",
                                                        "4dmatch.yaml"), "--demo"])):
        with pytest.raises(RuntimeError, match="CUDA is not available"):
            make()
    config = tmp_path / "open3d.yaml"
    config.write_text("dataset: 3dmatch\neval: {pose_backend: open3d}\n")
    with pytest.raises(NotImplementedError, match="host_estimators"):
        main(["--config", str(config), "--demo", "--device", "cpu"])
    assert not hasattr(TestConfig(), "pose_backend")
