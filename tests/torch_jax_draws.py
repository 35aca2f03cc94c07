"""A draw source for the port's library functions that replays JAX's draws.

The port's functions that draw take ``rng`` (``diffreg_tpu_torch/utils/draws.py``)
and split it where the JAX package's functions split their keys. ``JaxDraws``
answers each method from a JAX key and dtype, as the JAX function draws with
them (float64 where JAX runs with x64 enabled), so a
port function given ``JaxDraws(key)`` draws what the JAX function given
``key`` draws. The tensors land on the CPU.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import torch


class JaxDraws:
    def __init__(self, key):
        self.key = key

    def split(self, num: int = 2):
        return [JaxDraws(k) for k in jax.random.split(self.key, num)]

    def fold_in(self, data: int):
        return JaxDraws(jax.random.fold_in(self.key, data))

    def uniform(self, shape, dtype=torch.float32, minval=0.0, maxval=1.0):
        return _t(jax.random.uniform(self.key, tuple(shape), _jdt(dtype), minval, maxval))

    def normal(self, shape, dtype=torch.float32):
        return _t(jax.random.normal(self.key, tuple(shape), _jdt(dtype)))

    def gamma(self, alpha, shape, dtype=torch.float32):
        return _t(jax.random.gamma(self.key, alpha, tuple(shape), _jdt(dtype)))

    def gumbel(self, shape, dtype=torch.float32):
        return _t(jax.random.gumbel(self.key, tuple(shape), _jdt(dtype)))

    def permutation(self, n):
        return _t(jax.random.permutation(self.key, n)).long()

    def randint(self, shape, low, high):
        return _t(jax.random.randint(self.key, tuple(shape), low, high)).long()


def _jdt(dtype):
    return jnp.float64 if dtype == torch.float64 else jnp.float32


def _t(x):
    return torch.from_numpy(np.array(x))
