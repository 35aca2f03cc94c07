"""Weight bridge round trip: the port's state_dict -> the reference-checkpoint
converter in tools/convert_checkpoint.py -> flax variables of the JAX model
-> diffreg_tpu_torch.convert -> the same state_dict, bit for bit.

This checks at once that the port's module names are the reference torch
names and that the bridge inverts the converter.
"""
import torch_native_guard  # noqa: F401  (makes the JAX native library whole first)
import os
import sys

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "tools"))

from convert_checkpoint import convert_state_dict, graft_into_variables  # noqa: E402

from diffreg_tpu.data import synthetic_batch  # noqa: E402
from diffreg_tpu.models import DiffusionMatchingModel as JaxModel  # noqa: E402
from diffreg_tpu.models.presets import preset_4dmatch as jax_preset_4dmatch  # noqa: E402
from diffreg_tpu.models.presets import preset_tiny as jax_preset_tiny  # noqa: E402
from diffreg_tpu_torch.convert import state_dict_from_flax  # noqa: E402
from diffreg_tpu_torch.models.diffusion_matching import DiffusionMatchingModel  # noqa: E402
from diffreg_tpu_torch.models.presets import (KPFCN_ARCHITECTURE, preset_4dmatch,  # noqa: E402
                                              preset_tiny)

# reference parameters the JAX coarse path never creates (see
# tools/convert_checkpoint.py KNOWN_DEAD_PREFIXES)
DEAD = ("backbone.decoder_blocks.3.", "backbone.decoder_blocks.5.", "backbone.coarse_in.",
        "backbone.fine_out.")


def _round_trip(port, variables):
    """port state_dict -> flax variables shaped like ``variables`` -> back."""
    sd = {k: v.detach().clone() for k, v in port.state_dict().items()}
    params_flat, buffers_flat = convert_state_dict(sd, KPFCN_ARCHITECTURE)
    # raises on any flax slot without a source or with a mismatched shape
    grafted, dropped = graft_into_variables(variables, params_flat, buffers_flat)
    assert dropped and all(k.startswith(("backbone/dec3_", "backbone/dec5_", "backbone/coarse_in/",
                                         "backbone/fine_out/")) for k in dropped)

    flat = lambda col: {"/".join(k): np.asarray(v)
                        for k, v in flatten_dict(dict(grafted[col])).items()}
    back = state_dict_from_flax(flat("params"), flat("buffers"))
    assert set(back) == {k for k in sd if not k.startswith(DEAD)}
    for key, value in back.items():
        assert value.shape == sd[key].shape, key
        assert torch.equal(value, sd[key]), key


def test_state_dict_round_trip():
    port = DiffusionMatchingModel(preset_tiny(2), device="cpu", seed=3)
    batch, _, _ = synthetic_batch(batch_size=1, n_points=96, seed=0)
    jax_model = JaxModel(jax_preset_tiny("3dmatch", sample_steps=2))
    rng = jax.random.PRNGKey(0)
    variables = jax.jit(lambda b, r: jax_model.init({"params": r}, b, r, mode="train"))(batch, rng)
    _round_trip(port, variables)


def test_4dmatch_weights_round_trip():
    """The full-width 4DMatch model (528-dim, 4 heads of 132): every weight maps
    to the JAX tree's slot of the same shape and back unchanged (shapes from
    ``jax.eval_shape``: nothing is computed at full width)."""
    port = DiffusionMatchingModel(preset_4dmatch(), device="cpu", seed=5)
    assert port.denoising_transformer.layers[0].q_proj.weight.shape == (528, 528)
    batch, _, _ = synthetic_batch(batch_size=1, n_points=96, seed=0, deformable=True)
    jax_model = JaxModel(jax_preset_4dmatch())
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b, r: jax_model.init({"params": r}, b, r, mode="train"),
                            batch, rng)
    _round_trip(port, shapes)


def test_variant_weights_load_through_the_bridge():
    """A flax variable tree of a model variant (``preset_3dmatch`` at full
    width with the coarsest level's three blocks deformable and modulated,
    batch norm off, gaussian influence, sinusoidal PE, dual-softmax matching;
    shapes from ``jax.eval_shape``) loads into the port through
    ``state_dict_from_flax``: every flax slot has its port tensor of the same
    shape (the offset convs, their dispositions and biases, the norms'
    biases), and the port's only other tensors are the fine phase's and the
    denoising matcher's ``bin_score``, which the port keeps for its DDIM
    projection where JAX's dual-softmax matcher has none."""
    import dataclasses

    from diffreg_tpu.models.presets import preset_3dmatch as jax_preset_3dmatch
    from diffreg_tpu_torch.models.presets import preset_3dmatch

    arch = KPFCN_ARCHITECTURE[:8] + ("resnetb_deformable_strided", "resnetb_deformable",
                                     "resnetb_deformable") + KPFCN_ARCHITECTURE[11:]

    def variant(cfg):
        matching = dataclasses.replace(cfg.coarse_matching, match_type="dual_softmax")
        return dataclasses.replace(
            cfg, kpfcn=dataclasses.replace(cfg.kpfcn, architecture=arch, modulated=True,
                                           use_batch_norm=False, kp_influence="gaussian"),
            coarse_matching=matching, coarse_transformer=dataclasses.replace(
                cfg.coarse_transformer, pe_type="sinusoidal", feature_matching=matching))

    batch, _, _ = synthetic_batch(batch_size=1, n_points=96, seed=0)
    rng = jax.random.PRNGKey(0)
    shapes = jax.eval_shape(lambda b, r: JaxModel(variant(jax_preset_3dmatch())).init(
        {"params": r}, b, r, mode="train"), batch, rng)
    gen = np.random.RandomState(0)
    flat = {col: {"/".join(k): gen.randn(*v.shape).astype(np.float32)
                  for k, v in flatten_dict(dict(shapes[col])).items()}
            for col in ("params", "buffers")}
    sd = state_dict_from_flax(flat["params"], flat["buffers"])
    assert any(k.endswith("KPConv.offset_conv.weights") for k in sd)
    assert any(k.endswith("KPConv.offset_conv.kernel_points") for k in sd)
    assert any(k.endswith("batch_norm_conv.bias") for k in sd)
    port = DiffusionMatchingModel(variant(preset_3dmatch()), device="cpu", seed=1)
    missing, unexpected = port.load_state_dict(sd, strict=False)
    assert not unexpected
    assert set(missing) == {k for k in port.state_dict()
                            if k.startswith(DEAD)} | {"denoising_coarse_matching.bin_score"}
    state = port.state_dict()
    for key, value in sd.items():
        assert torch.equal(state[key], value), key
    blocks = port.backbone.encoder_blocks
    assert blocks[8].KPConv.offset_conv.weights.shape == (15, 256, 60)
    assert blocks[8].KPConv.offset_bias.shape == (60,)
