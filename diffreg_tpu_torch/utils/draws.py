"""Random draws of the library functions, shaped like the JAX package's key use.

Where a JAX function takes a PRNG key, its counterpart here takes ``rng``: a
``torch.Generator`` on the device of the call's tensors, or any object with
the methods of ``Draws``. The functions split and fold ``rng`` where the JAX
functions split and fold their keys, so an object that answers each method
from a JAX key (a test's) replays JAX's own draws; ``Draws`` over one
generator answers every leaf from that generator's one stream. With
``device``, the draws are made on the generator's device and copied there,
so that a CPU generator gives the card and the CPU the same draws.
"""
from __future__ import annotations

from typing import List, Sequence

import torch


class Draws:
    """Draws from one ``torch.Generator``; tensors land on ``device``, by
    default the generator's."""

    def __init__(self, generator: torch.Generator, device=None):
        self.generator = generator
        self.device = torch.device(device) if device is not None else generator.device

    def split(self, num: int = 2) -> List["Draws"]:
        return [self] * num

    def fold_in(self, data: int) -> "Draws":
        return self

    def uniform(self, shape: Sequence[int], dtype=torch.float32, minval=0.0, maxval=1.0):
        return self._place(self._uniform(shape, dtype) * (maxval - minval) + minval)

    def normal(self, shape: Sequence[int], dtype=torch.float32):
        return self._place(torch.randn(tuple(shape), generator=self.generator, dtype=dtype,
                                       device=self.generator.device))

    def gamma(self, alpha: float, shape: Sequence[int], dtype=torch.float32):
        a = torch.full(tuple(shape), alpha, dtype=dtype, device=self.generator.device)
        return self._place(torch._standard_gamma(a, generator=self.generator))

    def gumbel(self, shape: Sequence[int], dtype=torch.float32):
        u = self._uniform(shape, dtype).clamp_min(torch.finfo(dtype).tiny)
        return self._place(-torch.log(-torch.log(u)))

    def permutation(self, n: int):
        return self._place(torch.randperm(n, generator=self.generator,
                                          device=self.generator.device))

    def randint(self, shape: Sequence[int], low: int, high: int):
        return self._place(torch.randint(low, high, tuple(shape), generator=self.generator,
                                         dtype=torch.int64, device=self.generator.device))

    def _uniform(self, shape, dtype):
        return torch.rand(tuple(shape), generator=self.generator, dtype=dtype,
                          device=self.generator.device)

    def _place(self, t):
        """The finished draw, moved: every transform of it is done where it
        was drawn, so that the card and the CPU receive the same numbers."""
        return t.to(self.device)


def as_draws(rng):
    """A ``Draws`` over ``rng`` when it is a generator, else ``rng`` itself."""
    return Draws(rng) if isinstance(rng, torch.Generator) else rng
