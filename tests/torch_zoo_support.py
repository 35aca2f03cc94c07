"""Helpers of the zoo's CPU tests (``tests/test_torch_zoo*.py``): carrying a
JAX module's variables into its port counterpart and comparing outputs."""
from __future__ import annotations

import jax
import numpy as np
import torch
from flax.traverse_util import flatten_dict

from diffreg_tpu_torch.convert import zoo_state_dict_from_flax

F32_REL = 1e-5          # f32, one module: of the largest entry


def T(x):
    return torch.from_numpy(np.array(x))


def flat(tree):
    return {"/".join(k): np.asarray(v) for k, v in flatten_dict(dict(tree)).items()}


def np_(x):
    if isinstance(x, torch.Tensor):
        return x.detach().numpy()
    return np.asarray(x)


def close(got, ref, rel=F32_REL, what=""):
    """max |got - ref| <= rel * max |ref|."""
    got, ref = np_(got), np_(ref)
    assert got.shape == ref.shape, (what, got.shape, ref.shape)
    scale = max(float(np.abs(ref).max()), 1e-30)
    err = float(np.abs(got.astype(np.float64) - ref).max()) / scale
    assert err <= rel, f"{what}: {err:.3e} of the scale {scale:.3e} (limit {rel:.0e})"


def carry(port, variables):
    """``port`` with the JAX module's ``variables`` loaded through the weight
    bridge; the strict load asserts that no port key is left unset (and the
    bridge raises on a flax path with no counterpart)."""
    sd = zoo_state_dict_from_flax(port, flat(variables.get("params", {})),
                                  flat(variables.get("batch_stats", {})),
                                  flat(variables.get("buffers", {})))
    port.load_state_dict(sd, strict=True)
    return port.eval()


def init_apply(module, *args, seed=0, **kw):
    """(variables, output) of a JAX module initialised from PRNGKey(seed);
    both compiled whole (one XLA compile each, not one an op), the keyword
    arguments static."""
    variables = jax.jit(lambda key, *a: module.init(key, *a, **kw))(
        jax.random.PRNGKey(seed), *args)
    return variables, apply(module, variables, *args, **kw)


def apply(module, variables, *args, **kw):
    """``module.apply`` compiled whole, the keyword arguments static."""
    return jax.jit(lambda v, *a: module.apply(v, *a, **kw))(variables, *args)


def jit(fn, *args, **kw):
    """``fn(*args, **kw)`` compiled whole: array arguments positional, the
    rest (sizes, configs, flags) keyword and static."""
    return jax.jit(lambda *a: fn(*a, **kw))(*args)
