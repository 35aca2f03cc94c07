"""The port's training engine on the CPU: the optimizer against the JAX
package's optax chain, both kernels' autograd Functions (with the kernel
launch replaced by the plain forward) against plain autograd and JAX's VJPs,
the train and eval steps, and the trainers with their checkpoints.

Tolerances: the optimizer runs the same float32 formulas as optax, so
parameters and state agree to f32 round-off (rtol 1e-6); the Functions'
backward recomputes the plain version, so it matches plain autograd to the
same; against JAX's VJPs, 1e-5 (sums in another order).
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import importlib
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from torch import nn

from diffreg_tpu.engine.train import OptimConfig as JaxOptimConfig
from diffreg_tpu.engine.train import make_optimizer, warmup_annealing_schedule
from diffreg_tpu.ops.pallas.attention_kernel import masked_attention_pallas
from diffreg_tpu_torch.data.synthetic import synthetic_batch
from diffreg_tpu_torch.engine.checkpoint import CheckpointManager
from diffreg_tpu_torch.engine.losses import LossConfig
from diffreg_tpu_torch.engine.train import (OptimConfig, Optimizer, apply_gradients,
                                            create_train_state, make_eval_step, make_schedule,
                                            make_train_step)
from diffreg_tpu_torch.engine.trainer import (CycleIterator, IterBasedTrainer, Trainer,
                                              TrainerConfig)
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel
from diffreg_tpu_torch.models.presets import preset_tiny, with_condition_gate
from diffreg_tpu_torch.ops import attention as attention_ops
from diffreg_tpu_torch.ops import kpconv as kpconv_ops
from diffreg_tpu_torch.ops.kernel_points import load_kernel_points

T = torch.from_numpy
jax_kpconv = importlib.import_module("diffreg_tpu.ops.kpconv")

OPTIMIZER_CASES = {
    # the reference SGD config, with a visible decay and a 2-update staircase
    "sgd_explr": dict(optimizer="sgd", lr=0.015, momentum=0.93, weight_decay=1e-2,
                      scheduler_gamma=0.5, steps_per_epoch=2),
    "adamw_warmup_cosine_clip": dict(optimizer="adam", lr=1e-2, weight_decay=1e-2,
                                     scheduler="warmup_cosine", warmup_steps=2, total_steps=5,
                                     max_grad_norm=1.0),
    "sgd_accumulate_2": dict(optimizer="sgd", grad_accum_steps=2, steps_per_epoch=1,
                             scheduler_gamma=0.5, max_grad_norm=2.0),
    "sgd_nonfinite_skip": dict(optimizer="sgd", weight_decay=1e-2),
    "sgd_nonfinite_applied": dict(optimizer="sgd", skip_nonfinite_updates=False),
}
SHAPES = {"a": (4, 3), "b": (5,), "c": (2, 2, 2)}


def _state_fields(state, name):
    """Every field called ``name`` in a nested optax state."""
    found = []

    def walk(x):
        if hasattr(x, "_fields"):
            for field in x._fields:
                (found.append if field == name else walk)(getattr(x, field))
        elif isinstance(x, (tuple, list)):
            for v in x:
                walk(v)
    walk(state)
    return found


@pytest.mark.parametrize("case", sorted(OPTIMIZER_CASES))
def test_optimizer_matches_optax(case):
    """Eight steps of the port's optimizer against the JAX package's optax
    chain and its train step's skip (params and optimizer state restored on a
    non-finite gradient), on the same gradients."""
    kw = OPTIMIZER_CASES[case]
    rng = np.random.RandomState(4)
    init = {k: rng.randn(*s).astype(np.float32) for k, s in SHAPES.items()}
    steps = [{k: (rng.randn(*s) * 0.8).astype(np.float32) for k, s in SHAPES.items()}
             for _ in range(8)]
    if "nonfinite" in case:
        steps[2]["b"][1] = np.nan
        if "skip" in case:
            steps[5]["a"][0, 2] = np.inf
    cfg = JaxOptimConfig(**kw)
    tx = make_optimizer(cfg)
    params = {k: jnp.asarray(v) for k, v in init.items()}
    opt_state = tx.init(params)
    port_params = {k: nn.Parameter(T(v.copy())) for k, v in init.items()}
    opt = Optimizer(list(port_params.items()), OptimConfig(**kw))
    for grads in steps:
        g = {k: jnp.asarray(v) for k, v in grads.items()}
        finite = all(bool(jnp.all(jnp.isfinite(v))) for v in g.values())
        updates, new_state = tx.update(g, opt_state, params)
        if finite or not cfg.skip_nonfinite_updates:
            params, opt_state = optax.apply_updates(params, updates), new_state
        got_finite, got_norm = apply_gradients(opt, [T(grads[k]) for k in port_params])
        assert bool(got_finite) == finite
        np.testing.assert_allclose(float(got_norm), float(optax.global_norm(g)), rtol=1e-6)
        for k, p in port_params.items():
            np.testing.assert_allclose(p.detach().numpy(), np.asarray(params[k]), rtol=1e-6,
                                       atol=1e-7, err_msg=k)
        for name, kind in (("trace", "momentum"), ("mu", "mu"), ("nu", "nu"),
                           ("acc_grads", "acc")):
            for tree in _state_fields(opt_state, name):
                for k, v in tree.items():
                    np.testing.assert_allclose(opt.buffers[kind][k].numpy(), np.asarray(v),
                                               rtol=1e-6, atol=1e-7, err_msg=f"{name} {k}")
        counts = [int(c) for c in _state_fields(opt_state, "count")]
        assert counts and all(c == opt.count for c in counts)
        for mini_step in _state_fields(opt_state, "mini_step"):
            assert int(mini_step) == opt.mini_step
    assert opt.count == (4 if "accumulate" in case else 6 if "skip" in case else 8)


@pytest.mark.parametrize("kind", ["exponential", "warmup_exponential", "warmup_cosine",
                                  "warmup_linear"])
def test_schedules_match_jax(kind):
    cfg = OptimConfig(scheduler=kind, lr=0.01, warmup_steps=3, total_steps=9,
                      steps_per_epoch=2, scheduler_gamma=0.8, eta_min=0.2)
    if kind == "exponential":
        ref = optax.exponential_decay(cfg.lr, cfg.steps_per_epoch, cfg.scheduler_gamma,
                                      staircase=True)
    else:
        ref = warmup_annealing_schedule(kind, cfg.lr, cfg.warmup_steps, cfg.total_steps,
                                        gamma=cfg.scheduler_gamma, step_size=cfg.steps_per_epoch,
                                        eta_init=cfg.eta_init, eta_min=cfg.eta_min)
    got = make_schedule(cfg)
    for count in range(12):
        np.testing.assert_allclose(got(count), float(ref(jnp.int32(count))), rtol=1e-6,
                                   err_msg=str(count))


def _kpconv_inputs(seed=0, b=2, nq=40, ns=48, k=10, cin=8, cout=12):
    rng = np.random.RandomState(seed)
    s = rng.rand(b, ns, 3).astype(np.float32) * 0.3
    q = s[:, :nq] + rng.randn(b, nq, 3).astype(np.float32) * 0.01
    idx = rng.randint(0, ns, (b, nq, k)).astype(np.int32)
    idx[rng.rand(b, nq, k) < 0.3] = ns
    x = rng.randn(b, ns, cin).astype(np.float32)
    x[:, -4:] = 0.0
    w = (rng.randn(15, cin, cout) * 0.1).astype(np.float32)
    return q, s, idx, x, load_kernel_points(0.1), w, rng.randn(b, nq, cout).astype(np.float32)


def _plain_launch(monkeypatch, module, name, plain):
    """Replace the wrapper's kernel launch with the plain forward; count calls."""
    calls = []

    def launch(*args):
        calls.append(1)
        return plain(*args)
    monkeypatch.setattr(module, name, launch)
    return calls


@pytest.mark.parametrize("needs", ["features_and_weights", "features_only"])
def test_kpconv_function_backward(monkeypatch, needs):
    """KPConvFunction with a plain forward: its output carries a grad_fn, its
    backward launches nothing and gives plain autograd's dx/dW, and JAX's."""
    calls = _plain_launch(monkeypatch, kpconv_ops, "kpconv_cuda", kpconv_ops.kpconv)
    q, s, idx, x, kp, w, proj = _kpconv_inputs()
    ext = 0.08
    want_w = needs == "features_and_weights"
    xs, ws = T(x).requires_grad_(), T(w).requires_grad_(want_w)
    out = kpconv_ops.KPConvFunction.apply(T(q), T(s), T(idx), xs, T(kp), ws, ext)
    assert out.grad_fn is not None and len(calls) == 1
    wanted = [xs, ws] if want_w else [xs]
    got = torch.autograd.grad((out * T(proj)).sum(), wanted)
    assert len(calls) == 1
    x2, w2 = T(x).requires_grad_(), T(w).requires_grad_(want_w)
    plain = kpconv_ops.kpconv(T(q), T(s), T(idx), x2, T(kp), w2, ext)
    ref = torch.autograd.grad((plain * T(proj)).sum(), [x2, w2] if want_w else [x2])
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    _, vjp = jax.vjp(lambda xx, ww: jax_kpconv.kpconv_batched(
        jnp.asarray(q), jnp.asarray(s), jnp.asarray(idx), xx, jnp.asarray(kp), ww, ext,
        use_pallas=False), jnp.asarray(x), jnp.asarray(w))
    for g, r in zip(got, vjp(jnp.asarray(proj))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


def test_attention_function_backward(monkeypatch, rng):
    """MaskedAttentionFunction with a plain forward against plain autograd and
    the JAX kernel's custom_vjp backward (Pallas in interpret mode)."""
    calls = _plain_launch(monkeypatch, attention_ops, "masked_attention_cuda",
                          attention_ops.masked_attention_plain)
    b, h, l, s, d = 2, 2, 24, 40, 12
    q, k, v = (rng.randn(b, h, n, d).astype(np.float32) for n in (l, s, s))
    kv_mask = rng.rand(b, s) > 0.3
    proj = rng.randn(b, h, l, d).astype(np.float32)
    scale = 1.0 / np.sqrt(d)
    inputs = [T(a).requires_grad_() for a in (q, k, v)]
    out = attention_ops.MaskedAttentionFunction.apply(*inputs, T(kv_mask), scale)
    assert out.grad_fn is not None and len(calls) == 1
    got = torch.autograd.grad((out * T(proj)).sum(), inputs)
    assert len(calls) == 1
    plain_inputs = [T(a).requires_grad_() for a in (q, k, v)]
    plain = attention_ops.masked_attention_plain(*plain_inputs, T(kv_mask), scale)
    ref = torch.autograd.grad((plain * T(proj)).sum(), plain_inputs)
    for g, r in zip(got, ref):
        torch.testing.assert_close(g, r, rtol=1e-6, atol=1e-7)
    _, vjp = jax.vjp(lambda qq, kk, vv: masked_attention_pallas(
        qq, kk, vv, jnp.asarray(kv_mask), 8, 16, True, scale=scale),
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    for g, r in zip(got, vjp(jnp.asarray(proj))):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def tiny():
    batches, spec = [], None
    for seed in (0, 1):
        batch, spec, _ = synthetic_batch(batch_size=1, n_points=64, seed=seed, spec=spec)
        batches.append(batch)
    return batches


def _state(seed=0, **optim):
    model = DiffusionMatchingModel(with_condition_gate(preset_tiny(1), 200.0), device="cpu",
                                   seed=seed)
    return create_train_state(model, OptimConfig(lr=1e-3, steps_per_epoch=2, **optim))


def _params(state):
    return {n: p.detach().clone() for n, p in state.model.named_parameters()}


def test_train_step_skips_a_nonfinite_gradient(tiny):
    """A NaN input gives non-finite gradients: params and optimizer state stay
    (the reference's validate_gradient); a clean batch then updates."""
    state = _state()
    step = make_train_step(LossConfig())
    before = _params(state)
    bad = tiny[0].map(lambda t: t.clone())
    bad.features[0, 0, 0] = float("nan")
    gen = torch.Generator().manual_seed(0)
    state, info = step(state, bad, state.model.draw_train_inputs(bad, gen))
    assert not bool(info["grads_finite"]) and state.optimizer.count == 0 and state.step == 1
    assert all(torch.equal(before[n], p) for n, p in state.model.named_parameters())
    state, info = step(state, tiny[0], state.model.draw_train_inputs(tiny[0], gen))
    assert bool(info["grads_finite"]) and state.optimizer.count == 1
    assert np.isfinite(float(info["loss"])) and float(info["grad_norm"]) > 0
    trained = dict(state.model.named_trained_parameters())
    assert any(not torch.equal(before[n], p) for n, p in trained.items())
    assert all(torch.equal(before[n], p) for n, p in state.model.named_parameters()
               if n not in trained)


def test_eval_step_does_not_update(tiny):
    state = _state()
    before = _params(state)
    info = make_eval_step(LossConfig())(
        state, tiny[0], state.model.draw_train_inputs(tiny[0], torch.Generator().manual_seed(1)))
    assert np.isfinite(float(info["loss"])) and info["loss"].grad_fn is None
    assert all(torch.equal(before[n], p) for n, p in state.model.named_parameters())
    assert state.optimizer.count == 0


def test_trainer_checkpoints_and_resume(tiny, tmp_path):
    """Two epochs of two batches with validation; per-epoch checkpoints, the
    best.json sidecar and the logs; then ``resume`` into a fresh state
    restores the parameters, the optimizer state and the epoch, and training
    goes on from there (keeping the newest two checkpoints)."""
    loader = lambda epoch: iter([(b, None) for b in tiny])
    cfg = TrainerConfig(max_epoch=2, log_every=1, save_dir=str(tmp_path / "run"),
                        keep_checkpoints=2)
    state = _state()
    trainer = Trainer(make_train_step(LossConfig()), state, loader, cfg, make_val_iter=loader,
                      val_step=make_eval_step(LossConfig()), device="cpu", seed=0)
    trained = trainer.train()
    assert trained.step == 4 and trained.optimizer.count == 4
    ckpt_dir = tmp_path / "run" / "checkpoints"
    assert sorted(os.listdir(ckpt_dir)) == ["1.pt", "2.pt", "best.json"]
    best = json.loads((ckpt_dir / "best.json").read_text())
    assert {"loss", "val_loss", "recall_coarse", "grad_norm"} <= set(best)
    assert all(entry["step"] in (1, 2) for entry in best.values())
    assert trainer.ckpt.best_step("loss") == best["loss"]["step"]
    logged = [json.loads(line) for line in (tmp_path / "run" / "log.jsonl").read_text().splitlines()]
    assert {row["prefix"] for row in logged} == {"train/", "val/"}
    assert {"forward", "backward", "optimizer"} <= set(trainer.timers.summary())

    fresh = _state(seed=1)
    resumed = Trainer(make_train_step(LossConfig()), fresh, loader,
                      TrainerConfig(max_epoch=3, log_every=10, save_dir=str(tmp_path / "run"),
                                    keep_checkpoints=2), device="cpu")
    resumed.resume()
    assert resumed.start_epoch == 2 and resumed.state.step == 4
    assert resumed.state.optimizer.count == 4
    for (n, p), (_, q) in zip(trained.model.named_parameters(),
                              resumed.state.model.named_parameters()):
        assert torch.equal(p, q), n
    for n, buf in trained.optimizer.buffers["momentum"].items():
        assert torch.equal(buf, resumed.state.optimizer.buffers["momentum"][n]), n
    resumed.train()
    assert resumed.state.step == 6
    assert sorted(os.listdir(ckpt_dir)) == ["2.pt", "3.pt", "best.json"]


def test_iter_based_trainer_cycles_the_loader(tiny, tmp_path):
    """Pseudo-epochs of 3 steps over a 2-batch loader: the loader restarts with
    the next epoch index."""
    seen = []

    def loader(epoch):
        seen.append(epoch)
        return iter([(b, None) for b in tiny])
    trainer = IterBasedTrainer(make_train_step(LossConfig()), _state(), loader,
                               TrainerConfig(max_epoch=2, log_every=2,
                                             save_dir=str(tmp_path / "run")),
                               num_iters_per_epoch=3, device="cpu")
    state = trainer.train()
    assert seen == [0, 1, 2] and state.step == 6
    assert CheckpointManager(str(tmp_path / "run" / "checkpoints")).latest_step() == 2
    cycle = CycleIterator(lambda epoch: iter([epoch]), epoch=5)
    assert [next(cycle) for _ in range(3)] == [5, 6, 7]
