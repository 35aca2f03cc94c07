"""The port's CLI layer against the JAX package, on the CPU: the config
builders for every 3D config under ``configs/``, both dataset readers and the
batch iterator on on-disk fixtures (the reference formats, as
``tests/test_real_data_smoke.py`` writes them), the source backup,
``BatchTester``, and ``diffreg_tpu_torch.main`` with ``--device cpu`` on tiny
YAMLs: 3DMatch and 4DMatch test, 4DMatch train and resume, each held against
``diffreg_tpu.main`` on the same YAML, data and weights (JAX's, carried by
``convert.state_dict_from_flax``), with JAX's draws rebuilt from its keys.

Tolerances: configs, readers and batches are the same numbers (exact). The
two mains' test summaries: the matches are the same (asserted away from the
4DMatch threshold), so IR, FMR, RR and NFMR agree to f32 rounding of the
coordinates (1e-5). The training run's epoch metrics agree to 1e-4 relative
(the loss to 1e-5). Each parameter's move over the two SGD steps, against
its largest entry: the worst tensor to 2e-2, the median tensor to 1e-3, and
the whole move's norm to 5e-3 (measured 8.9e-3 on the first attention
layer's key projection, 1.8e-4 and 8.7e-4): two momentum steps of gradients
that ``tests/test_torch_train.py`` holds to 5e-4 each, the second taken at
parameters that already differ.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import dataclasses
import glob
import math
import os
import pickle
import shutil
import warnings

import jax
import numpy as np
import pytest
import torch
import yaml
from flax.traverse_util import flatten_dict

from diffreg_tpu.data.datasets import FourDMatchPairDataset as JaxFourDMatchPairDataset
from diffreg_tpu.data.datasets import ThreeDMatchPairDataset as JaxThreeDMatchPairDataset
from diffreg_tpu.data.datasets import iterate_batches as jax_iterate_batches
from diffreg_tpu.data.pyramid import PyramidConfig as JaxPyramidConfig
from diffreg_tpu.data.synthetic import tiny_spec as jax_tiny_spec
from diffreg_tpu.utils import config as jc
from diffreg_tpu_torch.data.datasets import (FourDMatchPairDataset, ThreeDMatchPairDataset,
                                             iterate_batches)
from diffreg_tpu_torch.data.pyramid import PyramidConfig
from diffreg_tpu_torch.data.synthetic import synthetic_batch, tiny_spec
from diffreg_tpu_torch.engine.trainer import BatchTester
from diffreg_tpu_torch.main import main
from diffreg_tpu_torch.models.presets import KPFCN_ARCHITECTURE
from diffreg_tpu_torch.utils import config as pc
from diffreg_tpu_torch.utils.snapshot import backup_sources

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
THR_4D = 0.5063     # the main-against-JAX 4DMatch run: near the median candidate
KPFCN_DEFORMABLE = KPFCN_ARCHITECTURE[:8] + ("resnetb_deformable_strided", "resnetb_deformable",
                                             "resnetb_deformable") + KPFCN_ARCHITECTURE[11:]
CONFIGS = ["test/3dmatch.yaml", "test/3dlomatch.yaml", "test/3dmatch_fast.yaml",
           "test/4dmatch.yaml", "train/3dmatch.yaml", "train/4dmatch.yaml"]


@pytest.fixture(autouse=True, scope="module")
def _two_threads():
    """Two intra-op threads for the CLI runs: the suite runs in several
    processes at once, and torch's default of a thread per core oversubscribes
    the CPU (the 4DMatch train run took 195 s so, 2.5 s alone)."""
    n = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(n)


# the port's own fields: JAX keeps the precision policy in a global
# (diffreg_tpu/utils/precision.py), the port in the matcher's config
PORT_ONLY = {"precision"}


def _same_fields(got, ref, where=""):
    """Every field of the port's dataclass equals the JAX one's of that name
    (nested configs field by field), but for ``PORT_ONLY``."""
    for f in dataclasses.fields(got):
        if f.name in PORT_ONLY:
            continue
        g = getattr(got, f.name)
        r = getattr(ref, f.name)
        if dataclasses.is_dataclass(g):
            _same_fields(g, r, f"{where}{f.name}.")
        else:
            assert g == r, f"{where}{f.name}: {g!r} != {r!r}"


@pytest.mark.parametrize("name", CONFIGS)
def test_build_configs_match_jax(name):
    path = os.path.join(REPO, "configs", name)
    raw = pc.load_yaml(path)
    assert raw == jc.load_yaml(path)
    got = pc.build_pipeline_config(raw)
    ref = jc.build_pipeline_config(raw)
    _same_fields(got, ref)
    precision = raw.get("precision", "highest")     # what diffreg_tpu.main sets globally
    assert got.coarse_matching.precision == precision
    assert got.coarse_transformer.feature_matching.precision == precision
    assert got.kpfcn.compute_dtype == got.coarse_transformer.compute_dtype \
        == raw.get("compute_dtype")
    assert got.variant == raw["dataset"] and ref.stochastic_ddim == (got.variant == "4dmatch")
    _same_fields(pc.build_loss_config(raw), jc.build_loss_config(raw))
    _same_fields(pc.build_optim_config(raw, steps_per_epoch=7),
                 jc.build_optim_config(raw, steps_per_epoch=7))
    if raw["dataset"] == "4dmatch":
        head = got.coarse_transformer.feature_dim // got.coarse_transformer.n_head
        assert head == 132 and pc.build_loss_config(raw).motion_weight == 0.1


@pytest.mark.parametrize("change", [
    {"exact_topk": False},
    {"kpfcn_config": {"modulated": True}},
    {"architecture": ["simple", "resnetb_deformable"]},
    {"coarse_matching": {"match_type": "dual_softmax"}},
    {"kpfcn_config": {"KP_influence": "gaussian"}},
    {"kpfcn_config": {"KP_influence": "constant", "aggregation_mode": "closest"}},
    {"kpfcn_config": {"use_batch_norm": False, "batch_norm_momentum": 0.1}},
    {"kpfcn_config": {"fixed_kernel_points": "verticals"}},
    {"modulated": True, "architecture": list(KPFCN_DEFORMABLE)},
    {"coarse_transformer": {"pe_type": "sinusoidal"}},
    {"coarse_transformer": {"entangled": True}},
    {"coarse_matching": {"entangled": True, "match_type": "dual_softmax",
                         "dsmax_temperature": 0.05}},
    {"precision": "default"},
    {"exact_topk": True},
])
def test_config_rejects_what_the_port_lacks(change):
    """Every model setting the JAX builder takes builds the same config fields
    in the port: none of them is refused."""
    raw = pc.load_yaml(os.path.join(REPO, "configs", "test/4dmatch.yaml"))
    raw.update(change)
    with warnings.catch_warnings():
        # fixed_kernel_points is read by neither builder; the port says so
        warnings.simplefilter("ignore")
        got = pc.build_pipeline_config(raw)
    _same_fields(got, jc.build_pipeline_config(raw))
    assert got.kpfcn.fixed_kernel_points == "center"


@pytest.mark.parametrize("section,key,value", [
    ("kpfcn_config", "KP_influence", "cubic"), ("kpfcn_config", "aggregation_mode", "max"),
    ("coarse_matching", "match_type", "optimal"), ("coarse_transformer", "pe_type", "learned")])
def test_config_unknown_value_raises_in_both(section, key, value):
    """A value neither package knows: the port's builder raises ValueError;
    JAX's builds the config and its model raises when traced."""
    from diffreg_tpu.data import synthetic_batch as jax_synthetic_batch
    from diffreg_tpu.models import DiffusionMatchingModel as JaxModel

    raw = pc.load_yaml(os.path.join(REPO, "configs", "test/3dmatch.yaml"))
    raw.setdefault(section, {})[key] = value
    with pytest.raises(ValueError, match=value):
        pc.build_pipeline_config(raw)
    cfg = jc.build_pipeline_config(raw)
    tiny = dataclasses.replace(cfg, kpfcn=dataclasses.replace(
        cfg.kpfcn, first_feats_dim=16, coarse_feature_dim=48, first_subsampling_dl=0.06))
    tiny = dataclasses.replace(tiny, coarse_matching=dataclasses.replace(
        tiny.coarse_matching, feature_dim=48), coarse_transformer=dataclasses.replace(
        tiny.coarse_transformer, feature_dim=48, n_head=2, feature_matching=dataclasses.replace(
            tiny.coarse_matching, feature_dim=48)))
    batch, _, _ = jax_synthetic_batch(batch_size=1, n_points=64, seed=0)
    key = jax.random.PRNGKey(0)
    with pytest.raises((ValueError, KeyError, NotImplementedError)):
        jax.eval_shape(lambda: JaxModel(tiny).init({"params": key}, batch, key, mode="train"))


def test_load_yaml_join_tag(tmp_path):
    path = tmp_path / "join.yaml"
    path.write_text("exp_dir: !join [run, 4dmatch, 2]\n")
    assert pc.load_yaml(str(path)) == jc.load_yaml(str(path)) == {"exp_dir": "run_4dmatch_2"}


def _cloud(rng, n):
    return (rng.rand(n, 3).astype(np.float32) - 0.5) * 1.2


def _rigid(rng):
    from scipy.spatial.transform import Rotation

    rot = Rotation.from_euler("zyx", rng.rand(3) * 0.5).as_matrix().astype(np.float32)
    return rot, (rng.rand(3, 1).astype(np.float32) - 0.5) * 0.2


def _write_3dmatch(root, rng, n_pairs=4):
    """A Predator-style info pkl and .pth clouds (tests/test_real_data_smoke.py)."""
    os.makedirs(root / "clouds")
    infos = {"rot": [], "trans": [], "src": [], "tgt": [], "gt_cov": []}
    for i in range(n_pairs):
        src = _cloud(rng, 300 + 40 * i)
        rot, trn = _rigid(rng)
        torch.save(torch.from_numpy(src), root / "clouds" / f"src{i}.pth")
        torch.save(torch.from_numpy((src @ rot.T + trn.T).astype(np.float32)),
                   root / "clouds" / f"tgt{i}.pth")
        infos["rot"].append(rot)
        infos["trans"].append(trn)
        infos["src"].append(f"clouds/src{i}.pth")
        infos["tgt"].append(f"clouds/tgt{i}.pth")
        infos["gt_cov"].append(np.eye(6, dtype=np.float32) * (i + 1))
    with open(root / "info.pkl", "wb") as f:
        pickle.dump(infos, f)
    return str(root / "info.pkl")


def _write_4dmatch(split_dir, rng, n_pairs=4, scale=1.0):
    """4DMatch .npz entries with s2t_flow and metric_index; ``scale`` shrinks
    the scene."""
    os.makedirs(split_dir)
    for i in range(n_pairs):
        src = _cloud(rng, 300 + 30 * i) * np.float32(scale)
        rot, trn = _rigid(rng)
        trn *= np.float32(scale)
        flow = (rng.rand(*src.shape).astype(np.float32) - 0.5) * np.float32(0.02 * scale)
        np.savez(split_dir / f"pair{i}.npz", src_pcd=src,
                 tgt_pcd=((src + flow) @ rot.T + trn.T).astype(np.float32), s2t_flow=flow,
                 rot=rot, trans=trn, metric_index=np.arange(0, len(src), 3)[:, None])
    return str(split_dir)


@pytest.mark.parametrize("augment", [False, True])
@pytest.mark.parametrize("kind", ["3dmatch", "4dmatch"])
def test_dataset_readers_match_jax(tmp_path, rng, kind, augment):
    if kind == "3dmatch":
        info = _write_3dmatch(tmp_path / "indoor", rng)
        got = ThreeDMatchPairDataset(info, str(tmp_path / "indoor"), augment=augment, seed=3,
                                     max_points=320)
        ref = JaxThreeDMatchPairDataset(info, str(tmp_path / "indoor"), augment=augment, seed=3,
                                        max_points=320)
    else:
        split = _write_4dmatch(tmp_path / "4d", rng)
        got = FourDMatchPairDataset(split, augment=augment, seed=3, max_points=320)
        ref = JaxFourDMatchPairDataset(split, augment=augment, seed=3, max_points=320)
    assert len(got) == len(ref) == 4
    for i in range(4):
        g, r = got[i], ref[i]
        assert set(g) == set(r)
        for key in g:
            if r[key] is None:
                assert g[key] is None, key
            else:
                np.testing.assert_array_equal(g[key], r[key], err_msg=key)
    if kind == "4dmatch":
        assert got[0]["metric_index"].ndim == 1 and got[0]["scene_flow"] is not None


def test_iterate_batches_match_jax(tmp_path, rng):
    """Buckets (a small one that the largest pair overflows, and a larger
    one), the thread pool and the pair counts, batch by batch."""
    split = _write_4dmatch(tmp_path / "4d", rng, n_pairs=5)
    cfg = dict(first_subsampling_dl=0.08, coarse_match_radius=0.12)
    specs = [tiny_spec(350), tiny_spec(512)]
    jspecs = [jax_tiny_spec(350), jax_tiny_spec(512)]
    stats, jstats = {}, {}
    got = list(iterate_batches(FourDMatchPairDataset(split), specs, PyramidConfig(**cfg), 2,
                               shuffle=True, seed=1, num_workers=3, stats=stats))
    ref = list(jax_iterate_batches(JaxFourDMatchPairDataset(split), jspecs,
                                   JaxPyramidConfig(**cfg), 2, shuffle=True, seed=1,
                                   num_workers=3, stats=jstats))
    assert stats == jstats and stats["pairs_used"] == 5
    assert len(got) == len(ref) >= 3
    assert {int(b.src_mask.shape[1]) for b, _ in got} == {350, 512}
    for (gb, gm), (rb, rm) in zip(got, ref):
        assert len(gm) == len(rm)
        for field in ("coarse_flow", "gt_src", "gt_valid", "src_mask", "rot_gt"):
            np.testing.assert_array_equal(getattr(gb, field).numpy(),
                                          np.asarray(getattr(rb, field)))
        np.testing.assert_array_equal(gb.neighbors[1].numpy(), np.asarray(rb.neighbors[1]))
        for a, b in zip(gm, rm):
            np.testing.assert_array_equal(a["src_pcd"], b["src_pcd"])


def test_backup_sources(tmp_path):
    cfg = os.path.join(REPO, "configs", "test/4dmatch.yaml")
    dst = backup_sources(str(tmp_path / "run"), cfg)
    assert os.path.isfile(os.path.join(dst, "diffreg_tpu_torch", "main.py"))
    assert os.path.isfile(os.path.join(dst, "configs", "test", "4dmatch.yaml"))
    assert os.path.isfile(os.path.join(dst, "4dmatch.yaml"))
    assert not glob.glob(os.path.join(dst, "**", "*.so"), recursive=True)
    assert backup_sources(str(tmp_path / "run"), cfg) == dst        # kept on resume


def test_batch_tester():
    batch, _, _ = synthetic_batch(batch_size=3, n_points=64, seed=1)
    seen = []

    def forward(b, generator):
        seen.append(generator.initial_seed())
        return {"noise": torch.rand(b.batch_size, generator=generator)}

    tester = BatchTester(forward, lambda i, b, out, meta: {"x": out["noise"][i], "i": meta},
                         device="cpu")
    summary = tester.test(lambda: iter([(batch, [0, 1, 2]), (batch, [3, 4, 5])]),
                          torch.Generator().manual_seed(5))
    noise = torch.rand(6, generator=torch.Generator().manual_seed(5))
    assert seen == [5, 5] and summary["samples"] == 6
    assert summary["i"] == pytest.approx(2.5)
    assert summary["x"] == pytest.approx(float(noise.mean()), rel=1e-6)
    assert BatchTester(forward, None, device="cpu").test(lambda: iter([]))["samples"] == 0


def _tiny_yaml(path, **extra):
    """A reference-schema YAML at test width (tests/test_real_data_smoke.py)."""
    tree = {
        "kpfcn_config": {"first_feats_dim": 16, "first_subsampling_dl": 0.08,
                         "coarse_feature_dim": 48, "fine_feature_dim": 16,
                         "coarse_match_radius": 0.12},
        "coarse_matching": {"feature_dim": 48},
        "coarse_transformer": {"feature_dim": 48, "n_head": 2, "voxel_size": 0.04,
                               "procrustes": {"max_condition_num": 40.0}},
        "batch_size": 2, "num_workers": 2, "calibration_pairs": 3, "SAMPLE_STEP": 2,
        "mode": "test", "eval": {"ransac_hypotheses": 256},
    }
    tree.update(extra)
    with open(path, "w") as f:
        yaml.safe_dump(tree, f)
    return str(path)


def _finite(summary, keys):
    assert all(math.isfinite(summary[k]) for k in keys), summary


@pytest.mark.parametrize("dataset", ["3dmatch", "4dmatch"])
def test_main_test_demo(tmp_path, monkeypatch, dataset):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_yaml(tmp_path / "t.yaml", dataset=dataset, exp_dir="demo")
    summary = main(["--config", cfg, "--demo", "--num-pairs", "4", "--device", "cpu",
                    "--thr", "0.1"])
    assert summary["pairs"] == 4
    _finite(summary, ["IR", "FMR", "RR"] if dataset == "3dmatch" else ["IR"])
    assert os.path.isfile(tmp_path / "snapshot" / "demo" / "log.txt")


def test_main_test_4dmatch_on_disk(tmp_path, monkeypatch, rng):
    """Real-data path: calibration, the threaded loader, the weights guard, a
    checkpoint restored into the model, IR and NFMR; the same numbers as the
    port's tester driven by hand on the same pairs and weights."""
    from diffreg_tpu_torch.data.calibrate import calibrate_spec
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.tester import (FourDMatchTester, TestConfig,
                                                 make_metric_points_fn)
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    monkeypatch.chdir(tmp_path)
    split = _write_4dmatch(tmp_path / "4d", rng)
    args = dict(dataset="4dmatch", data_root=str(tmp_path), split={"test": split},
                exp_dir="disk4d")
    cfg = _tiny_yaml(tmp_path / "t.yaml", **args)
    with pytest.raises(SystemExit, match="random weights"):
        main(["--config", cfg, "--device", "cpu"])

    raw = pc.load_yaml(cfg)
    model = DiffusionMatchingModel(pc.build_pipeline_config(raw), device="cpu", seed=7)
    CheckpointManager(str(tmp_path / "ckpt")).save(1, create_train_state(model, OptimConfig()))
    cfg = _tiny_yaml(tmp_path / "t.yaml", pretrain=str(tmp_path / "ckpt"), **args)
    summary = main(["--config", cfg, "--device", "cpu", "--thr", "0.05"])
    _finite(summary, ["IR", "NFMR"])
    assert summary["pairs"] == 4

    ds = FourDMatchPairDataset(split)
    pcfg = PyramidConfig(first_subsampling_dl=0.08, coarse_match_radius=0.12)
    spec = calibrate_spec([(ds[i]["src_pcd"], ds[i]["tgt_pcd"]) for i in (0, 1, 3)], pcfg)
    ref = FourDMatchTester(model, TestConfig(inlier_thr=0.04, match_thr=0.05,
                                             ransac_hypotheses=256), device="cpu").test(
        lambda: iterate_batches(ds, spec, pcfg, 2), generator=torch.Generator().manual_seed(0),
        metric_points_fn=make_metric_points_fn())
    assert summary == ref


def test_main_fast_path_on_disk(tmp_path, monkeypatch, rng):
    """configs/test/3dmatch_fast.yaml's keys (compute_dtype bfloat16,
    precision default) on an on-disk 3DMatch split: the reader, calibration,
    the loader, the weights guard and a restored checkpoint on the bf16 path."""
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    monkeypatch.chdir(tmp_path)
    fast = pc.load_yaml(os.path.join(REPO, "configs", "test", "3dmatch_fast.yaml"))
    info = _write_3dmatch(tmp_path / "indoor", rng)
    args = dict(dataset="3dmatch", data_root=str(tmp_path / "indoor"), split={"test": info},
                exp_dir="fast", compute_dtype=fast["compute_dtype"], precision=fast["precision"])
    cfg = _tiny_yaml(tmp_path / "t.yaml", **args)
    with pytest.raises(SystemExit, match="random weights"):
        main(["--config", cfg, "--device", "cpu"])
    pipeline = pc.build_pipeline_config(pc.load_yaml(cfg))
    assert pipeline.kpfcn.compute_dtype == "bfloat16"
    assert pipeline.coarse_matching.precision == "default"
    model = DiffusionMatchingModel(pipeline, device="cpu", seed=7)
    CheckpointManager(str(tmp_path / "ckpt")).save(1, create_train_state(model, OptimConfig()))
    summary = main(["--config", _tiny_yaml(tmp_path / "t.yaml", pretrain=str(tmp_path / "ckpt"),
                                           **args), "--device", "cpu"])
    assert summary["pairs"] == 4
    _finite(summary, ["IR", "FMR", "RR"])


def test_main_train_bf16_4dmatch(tmp_path, monkeypatch):
    """bf16 training through the CLI (a copy of the 4DMatch YAML with
    compute_dtype bfloat16 and precision default): two steps with finite
    losses, then the checkpoint restored into the bf16 test path."""
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    monkeypatch.chdir(tmp_path)
    keys = dict(dataset="4dmatch", compute_dtype="bfloat16", precision="default",
                train_loss={"motion_weight": 0.1})
    cfg = _tiny_yaml(tmp_path / "t.yaml", exp_dir="bf16", max_epoch=1, lr=0.001, **keys)
    pipeline = pc.build_pipeline_config({**pc.load_yaml(cfg), "mode": "train"})
    assert pipeline.kpfcn.compute_dtype == pipeline.coarse_transformer.compute_dtype \
        == "bfloat16" and pipeline.coarse_matching.precision == "default"
    metrics = main(["--config", cfg, "--demo", "--mode", "train", "--num-pairs", "4",
                    "--device", "cpu"])
    assert metrics["steps"] == 2
    _finite(metrics, ["loss", "l1_motion", "loss_matrix_gt_hat", "grad_norm"])
    ckpt = tmp_path / "snapshot" / "bf16" / "checkpoints"
    assert os.path.isfile(ckpt / "1.pt")
    trained = DiffusionMatchingModel(pipeline, device="cpu", seed=3)
    assert CheckpointManager(str(ckpt)).restore(create_train_state(trained, OptimConfig())) \
        is not None
    fresh = DiffusionMatchingModel(pipeline, device="cpu", seed=0)   # main's seed
    assert not all(torch.equal(a, b) for a, b in zip(trained.parameters(), fresh.parameters()))
    test = _tiny_yaml(tmp_path / "test.yaml", exp_dir="bf16test", pretrain=str(ckpt), **keys)
    summary = main(["--config", test, "--demo", "--num-pairs", "4", "--device", "cpu",
                    "--thr", "0.1"])
    assert summary["pairs"] == 4
    _finite(summary, ["IR"])
    log = (tmp_path / "snapshot" / "bf16test" / "log.txt").read_text()
    assert f"restored weights from {ckpt}" in log


def test_main_train_4dmatch_and_resume(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    cfg = _tiny_yaml(tmp_path / "t.yaml", dataset="4dmatch", exp_dir="train4d", max_epoch=1,
                     train_loss={"motion_weight": 0.1}, lr=0.001)
    metrics = main(["--config", cfg, "--demo", "--mode", "train", "--num-pairs", "4",
                    "--device", "cpu"])
    assert metrics["steps"] == 2
    _finite(metrics, ["loss", "l1_motion", "grad_norm"])
    run = tmp_path / "snapshot" / "train4d"
    assert os.path.isfile(run / "checkpoints" / "1.pt")
    assert os.path.isfile(run / "source_backup" / "t.yaml")
    cfg = _tiny_yaml(tmp_path / "t.yaml", dataset="4dmatch", exp_dir="train4d", max_epoch=2,
                     train_loss={"motion_weight": 0.1}, lr=0.001)
    resumed = main(["--config", cfg, "--demo", "--mode", "train", "--num-pairs", "4",
                    "--device", "cpu", "--resume"])
    assert resumed["steps"] == 4 and os.path.isfile(run / "checkpoints" / "2.pt")


def test_main_rejects_what_the_port_lacks(tmp_path, monkeypatch):
    """The host pose estimator where open3d imports (patched in: it does not
    here). The 2D-3D tower variant on an on-disk split whose tower
    checkpoints are missing, in test and in train mode: the port's main exits
    with the JAX package's SystemExit."""
    import diffreg_tpu.main as jax_main
    from diffreg_tpu_torch.eval import host_estimators
    from test_torch_2d3d_cli import _write_split

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(host_estimators, "has_module", lambda name: True)
    for change in ({"parity_eval": True}, {"eval": {"pose_backend": "open3d"}}):
        with pytest.raises(NotImplementedError, match="host_estimators"):
            main(["--config", _tiny_yaml(tmp_path / "b.yaml", dataset="3dmatch", **change),
                  "--demo", "--device", "cpu"])
    root = _write_split(tmp_path / "rgbdv2", np.random.RandomState(0))
    shutil.copy(os.path.join(root, "metadata", "test.pkl"),
                os.path.join(root, "metadata", "train.pkl"))
    cfg = _tiny_yaml(tmp_path / "a.yaml", dataset="rgbdv2", data_root=root,
                     model_2d3d={"use_dino": True, "use_mono_depth": True},
                     towers={"dinov2": str(tmp_path / "dinov2.pth")})
    for mode in ("test", "train"):
        exits = []
        for run in (jax_main.main, lambda argv: main([*argv, "--device", "cpu"])):
            with pytest.raises(SystemExit) as info:
                run(["--config", cfg, "--mode", mode])
            exits.append(str(info.value))
        assert exits[0] == exits[1] == (
            "use_dino/use_mono_depth need converted tower checkpoints: towers={'dinov2': "
            f"'{tmp_path / 'dinov2.pth'}'}} (run tools/convert_towers.py)"), mode


def test_main_falls_back_without_open3d(tmp_path, monkeypatch):
    """``parity_eval`` asks for Open3D's RANSAC; without open3d the 3DMatch
    test runs the device RANSAC with the JAX package's warning."""
    from diffreg_tpu_torch.eval import host_estimators

    monkeypatch.chdir(tmp_path)
    monkeypatch.setattr(host_estimators, "has_module", lambda name: False)
    summary = main(["--config", _tiny_yaml(tmp_path / "p.yaml", dataset="3dmatch",
                                           exp_dir="parity", parity_eval=True),
                    "--demo", "--num-pairs", "2", "--device", "cpu"])
    _finite(summary, ("IR", "FMR", "RR"))
    log = (tmp_path / "snapshot" / "parity" / "log.txt").read_text()
    assert "eval.pose_backend=open3d but open3d is not installed — falling back to the " \
        "device RANSAC" in log


# ---------------------------------------------------------------- main() against diffreg_tpu.main


class _JaxDraws:
    """The draws of the JAX package's testers and trainer, rebuilt from its
    keys in the order it splits them; the port's draw methods are pointed here.
    Per test batch ``rng, r1 = split(rng)``: the DDIM start from
    ``split(r1)[0]``, step i's noise from ``fold_in(split(r1)[1], i)``; per
    RANSAC repeat ``rng, r2 = split(rng)`` and pair b's hypotheses from
    ``split(r2, B)[b]``; per train step ``rng, r = split(rng)`` and (t, g,
    euler) from ``split(r, 3)``."""

    def __init__(self, seed=0):
        self.rng = jax.random.PRNGKey(seed)
        self.loop = None

    def _next(self):
        self.rng, key = jax.random.split(self.rng)
        return key

    def start(self, tester, batch, generator):
        init, self.loop = jax.random.split(self._next())
        shape = (batch.batch_size, batch.src_mask.shape[1], batch.tgt_mask.shape[1])
        return torch.from_numpy(np.array(jax.random.normal(init, shape)))

    def noise(self, tester, batch, generator):
        shape = (batch.batch_size, batch.src_mask.shape[1], batch.tgt_mask.shape[1])
        return torch.from_numpy(np.stack([
            np.array(jax.random.normal(jax.random.fold_in(self.loop, i), shape))
            for i in range(tester.model.cfg.sample_steps)]))

    def ransac(self, tester, batch, generator):
        keys = jax.random.split(self._next(), batch.batch_size)
        return torch.from_numpy(np.stack([
            np.array(jax.random.uniform(k, (tester.cfg.ransac_hypotheses, 3))) for k in keys]))

    def train(self, model, batch, generator):
        rng_t, rng_noise, rng_pos = jax.random.split(self._next(), 3)
        b, s = batch.src_mask.shape
        return {"t": torch.from_numpy(np.array(jax.random.randint(rng_t, (b,), 0, 1000))),
                "g": torch.from_numpy(np.array(jax.random.normal(
                    rng_noise, (b, s, batch.tgt_mask.shape[1])))),
                "euler": torch.from_numpy(np.array(
                    jax.random.uniform(rng_pos, (b, 3)) * 2.0 * np.pi, np.float32))}


def _flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def _port_state_dict(variables):
    from diffreg_tpu_torch.convert import state_dict_from_flax

    return state_dict_from_flax(_flat(variables["params"]), _flat(variables["buffers"]))


def _point_port_at_jax(monkeypatch, draws):
    from diffreg_tpu_torch.engine import tester as pt
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    monkeypatch.setattr(pt._Tester, "draw_start", lambda t, b, g: draws.start(t, b, g))
    monkeypatch.setattr(pt.FourDMatchTester, "draw_noise", lambda t, b, g: draws.noise(t, b, g))
    monkeypatch.setattr(pt.ThreeDMatchTester, "draw_ransac",
                        lambda t, b, g: draws.ransac(t, b, g))
    monkeypatch.setattr(DiffusionMatchingModel, "draw_train_inputs",
                        lambda m, b, g: draws.train(m, b, g))


def _record_jax_testers(monkeypatch):
    """Each JAX tester's weights and test summary, as the JAX main ran them."""
    from diffreg_tpu.engine import tester as jt

    runs = []
    for cls in (jt.ThreeDMatchTester, jt.FourDMatchTester):
        def init(self, model, variables, *args, _orig=cls.__init__, **kwargs):
            _orig(self, model, variables, *args, **kwargs)
            runs.append({"variables": variables})

        def test(self, *args, _orig=cls.test, **kwargs):
            runs[-1]["summary"] = _orig(self, *args, **kwargs)
            return runs[-1]["summary"]
        monkeypatch.setattr(cls, "__init__", init)
        monkeypatch.setattr(cls, "test", test)
    return runs


def _port_checkpoint(directory, raw, variables):
    """The JAX weights, converted, in a checkpoint of the port's."""
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import OptimConfig, create_train_state
    from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

    model = DiffusionMatchingModel(pc.build_pipeline_config(raw), device="cpu", seed=99)
    _, unexpected = model.load_state_dict(_port_state_dict(variables), strict=False)
    assert not unexpected
    CheckpointManager(str(directory)).save(1, create_train_state(model, OptimConfig()))
    return str(directory)


@pytest.mark.parametrize("case", ["3dmatch-demo", "3dmatch_fast-demo", "4dmatch-disk"])
def test_main_test_matches_jax(tmp_path, monkeypatch, rng, case):
    """``main`` in test mode against ``diffreg_tpu.main`` on one YAML: 3DMatch
    on the demo pairs (IR, FMR, RR: the DDIM, extraction and device RANSAC),
    the same with configs/test/3dmatch_fast.yaml's fast path (compute_dtype
    bfloat16, precision default), and 4DMatch on an on-disk split
    (calibration, loader, thresholded extraction, IR under the flow, NFMR on
    the metric_index points), two batches each."""
    import diffreg_tpu.main as jax_main
    from diffreg_tpu.utils import precision as jax_precision

    monkeypatch.chdir(tmp_path)
    # the JAX main sets its precision policy process-wide: restored after the test
    monkeypatch.setattr(jax_precision, "_PRECISION", jax_precision.get_precision())
    dataset = case.split("-")[0].replace("_fast", "")
    extra = {"dataset": dataset, "exp_dir": "parity", "batch_size": 2}
    if case == "3dmatch_fast-demo":
        fast = pc.load_yaml(os.path.join(REPO, "configs", "test", "3dmatch_fast.yaml"))
        gate = fast["coarse_transformer"]["procrustes"]["max_condition_num"]
        extra.update(compute_dtype=fast["compute_dtype"], precision=fast["precision"],
                     coarse_transformer={"feature_dim": 48, "n_head": 2, "voxel_size": 0.04,
                                         "procrustes": {"max_condition_num": gate}})
    argv = ["--device", "cpu"]
    if dataset == "3dmatch":
        argv += ["--demo", "--num-pairs", "4"]
    else:
        # a scene of 0.18 m with a 0.012 m first voxel, so that some of the
        # random weights' matches fall within the 0.04 m inlier threshold and
        # IR and NFMR are not 0
        split = _write_4dmatch(tmp_path / "4d", rng, scale=0.15)
        extra.update(data_root=str(tmp_path), split={"test": split}, kpfcn_config={
            "first_feats_dim": 16, "first_subsampling_dl": 0.012, "coarse_feature_dim": 48,
            "fine_feature_dim": 16, "coarse_match_radius": 0.018})
        argv += ["--thr", str(THR_4D)]
    # the JAX run restores no checkpoint (an empty directory) and so keeps the
    # weights it initialises from the config's seed; the port restores those
    runs = _record_jax_testers(monkeypatch)
    if case == "3dmatch_fast-demo":
        from diffreg_tpu.engine import tester as jt
        from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel

        outputs = {"jax": [], "port": []}

        def init(self, *args, _orig=jt.ThreeDMatchTester.__init__, **kwargs):
            _orig(self, *args, **kwargs)
            forward = self._forward

            def recording(*a):
                out = forward(*a)
                outputs["jax"].append({k: np.asarray(out[k])
                                       for k in ("conf_matrix_pred", "corr_mask")})
                return out
            self._forward = recording
        monkeypatch.setattr(jt.ThreeDMatchTester, "__init__", init)

        def ddim_sample(self, *a, _orig=DiffusionMatchingModel.ddim_sample, **kw):
            out = _orig(self, *a, **kw)
            outputs["port"].append({k: out[k].numpy() for k in ("conf_matrix_pred", "corr_mask")})
            return out
        monkeypatch.setattr(DiffusionMatchingModel, "ddim_sample", ddim_sample)

        # the port's calls of each kernel's plain versions, bf16 and f32 (the
        # CPU counterparts of the kernels' bf16 and f32 instances)
        import diffreg_tpu_torch.ops.attention as port_attention
        import diffreg_tpu_torch.ops.kpconv as port_kpconv
        calls = {}

        def counted(module, name):
            fn = getattr(module, name)

            def wrapper(*a, **kw):
                calls[name] = calls.get(name, 0) + 1
                return fn(*a, **kw)
            monkeypatch.setattr(module, name, wrapper)
        for module, name in ((port_kpconv, "kpconv_bf16_plain"), (port_kpconv, "kpconv"),
                             (port_attention, "masked_attention_bf16_plain"),
                             (port_attention, "masked_attention_plain")):
            counted(module, name)
    os.makedirs(tmp_path / "empty")
    jax_main.main(["--config", _tiny_yaml(tmp_path / "jax.yaml", pretrain=str(tmp_path / "empty"),
                                          **extra), *argv[2:]])
    (run,) = runs
    ref = run["summary"]
    port_ckpt = _port_checkpoint(tmp_path / "port_ckpt", pc.load_yaml(str(tmp_path / "jax.yaml")),
                                 run["variables"])

    _point_port_at_jax(monkeypatch, _JaxDraws())
    margins = []
    if dataset == "4dmatch":
        from diffreg_tpu_torch.engine import tester as pt

        # the candidates (the mutual argmaxes) stay clear of the threshold and
        # of their rows' and columns' runners-up, so both extract the same
        # matches: the packages' confidences differ by 1.2e-7 at this width
        # (test_torch_4dmatch.py's DDIM case)
        def forward(self, batch, generator, _orig=pt.FourDMatchTester.forward):
            out = _orig(self, batch, generator)
            conf = out["conf_matrix_pred"]
            cand = pt.match_mask_4dmatch(out, batch, dataclasses.replace(self.cfg, match_thr=-1))
            assert float((conf[cand] - THR_4D).abs().min()) > 1e-6
            b, r, c = torch.nonzero(cand, as_tuple=True)
            for top in (conf.topk(2, dim=2).values[b, r], conf.topk(2, dim=1).values[b, :, c]):
                assert float((top[:, 0] - top[:, 1]).min()) > 1e-6
            margins.append(int(((conf[cand] > THR_4D) != cand[cand]).sum()))
            return out
        monkeypatch.setattr(pt.FourDMatchTester, "forward", forward)
    got = main(["--config", _tiny_yaml(tmp_path / "port.yaml", pretrain=port_ckpt, **extra),
                *argv])
    assert set(ref) <= set(got) and got["pairs"] == ref["pairs"] == 4
    if dataset == "4dmatch":
        # the threshold cut some candidates, and IR and NFMR are not 0
        assert sum(margins) > 0 and got["matches"] > 0 and ref["IR"] > 0 and ref["NFMR"] > 0
    if case == "3dmatch_fast-demo":
        # the port ran the bf16 path only: bf16 KPConv and attention, no f32
        assert calls.get("kpconv_bf16_plain", 0) > 0 and calls.get("kpconv", 0) == 0, calls
        assert calls.get("masked_attention_bf16_plain", 0) > 0, calls
        assert calls.get("masked_attention_plain", 0) == 0, calls
        # bf16: roundings flip where the packages' f32 sums differ, so the
        # confidences agree to 2e-3 of their largest (measured 1.0e-3 and
        # 5.2e-4 on the two batches; the f32 path lies 5.4e-3 away in
        # tests/test_torch_bf16.py's DDIM), the union masks up to near-ties,
        # and IR up to what the differing mask entries can move it
        assert len(outputs["jax"]) == len(outputs["port"]) == 2
        ir_bound = 0.0
        for r, g in zip(outputs["jax"], outputs["port"]):
            conf = r["conf_matrix_pred"]
            limit = 2e-3 * np.abs(conf).max()
            assert np.abs(g["conf_matrix_pred"] - conf).max() <= limit
            rows, cols = -np.partition(-conf, 1, axis=2), -np.partition(-conf, 1, axis=1)
            tie = ((rows[:, :, 0] - rows[:, :, 1] <= 2 * limit)[:, :, None]
                   | (cols[:, 0, :] - cols[:, 1, :] <= 2 * limit)[:, None, :])
            differ = g["corr_mask"] != r["corr_mask"]
            assert not (differ & ~tie).any()
            ir_bound += float((differ.sum(axis=(1, 2)) / r["corr_mask"].sum(axis=(1, 2))).sum())
        assert got["IR"] == pytest.approx(ref["IR"], abs=ir_bound / got["pairs"] + 1e-5)
        ref = {k: v for k, v in ref.items() if k != "IR"}
    for key in ref:
        assert got[key] == pytest.approx(ref[key], rel=1e-5, abs=1e-5), key


def test_main_train_matches_jax(tmp_path, monkeypatch):
    """``main --mode train`` against ``diffreg_tpu.main``: 4DMatch demo pairs,
    one epoch of two SGD steps (configs/train/4dmatch.yaml's optimizer) from
    JAX's initial weights with JAX's draws: the epoch's metrics and the
    parameters of the last checkpoint."""
    import diffreg_tpu.main as jax_main
    from diffreg_tpu.engine import trainer as jtr
    from diffreg_tpu_torch.convert import _translate
    from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
    from diffreg_tpu_torch.engine.train import create_train_state
    from diffreg_tpu_torch.models import diffusion_matching as dm

    monkeypatch.chdir(tmp_path)
    train = dict(dataset="4dmatch", max_epoch=1, train_loss={"motion_weight": 0.1},
                 optimizer="SGD", lr=0.015, momentum=0.93, weight_decay=1e-6,
                 scheduler="ExpLR", scheduler_gamma=0.95, batch_size=2)
    argv = ["--demo", "--mode", "train", "--num-pairs", "4"]
    runs = []

    def init(self, step, state, *args, _orig=jtr.Trainer.__init__, **kwargs):
        _orig(self, step, state, *args, **kwargs)
        runs.append({"init": state})
        save = self.ckpt.save

        def recording_save(epoch, state, metrics=None):
            runs[-1].update(state=state, metrics=metrics)
            return save(epoch, state, metrics)
        self.ckpt.save = recording_save
    monkeypatch.setattr(jtr.Trainer, "init", init, raising=False)
    monkeypatch.setattr(jtr.Trainer, "__init__", init)
    jax_main.main(["--config", _tiny_yaml(tmp_path / "jax.yaml", exp_dir="jax", **train), *argv])
    (run,) = runs

    sd = _port_state_dict({"params": run["init"].params, "buffers": run["init"].buffers})

    class WithJaxWeights(dm.DiffusionMatchingModel):
        def __init__(self, *args, **kwargs):
            super().__init__(*args, **kwargs)
            _, unexpected = self.load_state_dict(sd, strict=False)
            assert not unexpected
    monkeypatch.setattr(dm, "DiffusionMatchingModel", WithJaxWeights)
    _point_port_at_jax(monkeypatch, _JaxDraws())
    got = main(["--config", _tiny_yaml(tmp_path / "port.yaml", exp_dir="port", **train), *argv,
                "--device", "cpu"])

    ref = run["metrics"]
    assert got["steps"] == 2 and set(ref) <= set(got)
    assert got["loss"] == pytest.approx(float(ref["loss"]), rel=1e-5)
    for key in ref:
        assert got[key] == pytest.approx(float(ref[key]), rel=1e-4, abs=1e-6), key
    model = WithJaxWeights(pc.build_pipeline_config(pc.load_yaml(str(tmp_path / "port.yaml"))),
                           device="cpu")
    state = create_train_state(model, pc.build_optim_config(train, steps_per_epoch=2))
    assert CheckpointManager(str(tmp_path / "snapshot" / "port" / "checkpoints")).restore(state)
    params = dict(model.named_parameters())
    errs, diff2, step2 = [], 0.0, 0.0
    for path, after in _flat(run["state"].params).items():
        name, layout = _translate(path)
        after = after.T if layout == "T" else after.T[:, :, None] if layout == "conv" else after
        step = after - sd[name].numpy()
        if not step.any():               # the positioning layer's matcher: no gradient
            continue
        diff = params[name].detach().numpy() - after
        errs.append(np.abs(diff).max() / np.abs(step).max())
        diff2, step2 = diff2 + float((diff ** 2).sum()), step2 + float((step ** 2).sum())
    assert len(errs) > 100
    assert max(errs) <= 2e-2 and np.median(errs) <= 1e-3 and (diff2 / step2) ** 0.5 <= 5e-3, \
        (max(errs), np.median(errs), (diff2 / step2) ** 0.5)
