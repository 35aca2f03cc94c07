"""The accuracy budget of the kernels' 3xTF32 tensor-core products, on the CPU.

The Hopper kernels (``csrc/attention.cu``, ``csrc/kpconv.cu``) run their
matrix products on tensor cores in TF32, which keeps 10 mantissa bits. To keep
f32 accuracy they split each f32 operand a into hi = tf32(a), rounded to
nearest with ties away from zero (as ``cvt.rna.tf32.f32`` rounds), and
lo = a - hi, and take a.b as hi.hi + hi.lo + lo.hi with f32 sums
(``csrc/tf32.cuh``). The kernels themselves run only on the card; here that
split is emulated in plain PyTorch (products of TF32 values are exact in f32,
so an f32 matmul of the parts is the tensor core's product) and held against
the JAX package's f32 results, at the main path's per-row sizes: the
attention's D = 108 and S = 704, and KPConv's P * Cin = 15 * 512 = 7680.
3xTF32 stays well inside ``chip_smoke.py``'s tolerances; a single TF32
product does not, which is why the kernels split.
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import ATTENTION_ABS_TOL, KPCONV_REL_TOL
from diffreg_tpu.ops.pallas.attention_kernel import masked_attention_pallas
from diffreg_tpu_torch.ops.kernel_points import load_kernel_points
from diffreg_tpu_torch.ops.kpconv import kpconv_aggregate
from diffreg_tpu_torch.ops.masked import NEG_INF

jax_kpconv = importlib.import_module("diffreg_tpu.ops.kpconv")
MARGIN = 10.0  # 3xTF32 must stay this far inside a tolerance


def tf32(x):
    """Round f32 to TF32 (10 mantissa bits), to nearest, ties away from zero:
    add half of the 13 dropped bits' range to the magnitude bits, then clear
    them, as csrc/tf32.cuh does."""
    bits = x.contiguous().view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    bits = (bits + 0x1000) & 0xFFFFE000
    return torch.where(bits >= 2 ** 31, bits - 2 ** 32, bits).to(torch.int32).view(torch.float32)


def split(x):
    hi = tf32(x)
    return hi, tf32(x - hi)


def matmul_3xtf32(a, b):
    ah, al = split(a)
    bh, bl = split(b)
    return ah @ bh + (ah @ bl + al @ bh)


def matmul_tf32(a, b):
    return tf32(a) @ tf32(b)


def test_tf32_rounds_to_nearest_ties_away():
    rng = np.random.RandomState(0)
    x = (rng.randn(4096) * np.exp(rng.uniform(-20, 20, 4096))).astype(np.float32)
    # exact ties: 11 significant bits and then a 1 in the 12th
    ties = ((rng.randint(1024, 2048, 256) * 2 + 1) * 2.0 ** rng.randint(-30, 10, 256))
    ties = (ties * rng.choice([-1.0, 1.0], 256)).astype(np.float32)
    x = np.concatenate([x, ties, np.float32([0.0, -0.0, 1.0, -1.5])])
    mant, expo = np.frexp(x.astype(np.float64))           # |mant| in [0.5, 1)
    scaled = mant * 2.0 ** 11                              # 11 significant bits
    want = np.sign(scaled) * np.floor(np.abs(scaled) + 0.5) * 2.0 ** (expo - 11)
    got = tf32(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want.astype(np.float32))
    assert np.all(np.abs(ties) < np.abs(tf32(torch.from_numpy(ties)).numpy()))


def test_split_is_exact_and_small():
    x = torch.from_numpy(np.random.RandomState(1).randn(10000).astype(np.float32))
    hi, lo = split(x)
    assert torch.equal(tf32(hi), hi) and torch.equal(tf32(lo), lo)
    assert torch.all(lo.abs() <= x.abs() * 2.0 ** -11)
    # what the TF32 lo drops is below f32 rounding of x
    assert torch.all((x - hi - lo).abs() <= x.abs() * 2.0 ** -22)


def _attention(q, k, v, kv_mask, scale, matmul):
    """masked_attention_plain with its two products replaced by ``matmul``."""
    logits = matmul(q * scale, k.transpose(-1, -2))
    logits = torch.where(kv_mask[:, None, None, :], logits, torch.full_like(logits, NEG_INF))
    return matmul(torch.softmax(logits, dim=-1), v)


@pytest.mark.parametrize("n_valid", [704, 523])
def test_attention_3xtf32_inside_budget(n_valid):
    """Against the Pallas kernel in interpret mode, [1, 2, 704, 108]."""
    rng = np.random.RandomState(n_valid)
    b, h, length, d = 1, 2, 704, 108
    q, k, v = (rng.randn(b, h, length, d).astype(np.float32) for _ in range(3))
    kv_mask = np.zeros((b, length), bool)
    kv_mask[:, :n_valid] = True
    scale = 1.0 / np.sqrt(d)
    ref = np.asarray(masked_attention_pallas(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                                             jnp.asarray(kv_mask), 128, 128, True, scale=scale))
    args = [torch.from_numpy(a) for a in (q, k, v, kv_mask)] + [scale]
    err3 = np.abs(_attention(*args, matmul_3xtf32).numpy() - ref).max()
    err1 = np.abs(_attention(*args, matmul_tf32).numpy() - ref).max()
    assert err3 <= ATTENTION_ABS_TOL / MARGIN, err3
    assert err1 > ATTENTION_ABS_TOL, err1


def test_kpconv_3xtf32_inside_budget():
    """The [P Cin] x Cout contraction at Cin = Cout = 512 against the JAX
    package's f32 KPConv (its XLA path)."""
    rng = np.random.RandomState(0)
    b, nq, ns, k, cin, cout = 1, 128, 256, 40, 512, 512
    s = rng.rand(b, ns, 3).astype(np.float32) * 0.3
    q = s[:, :nq] + rng.randn(b, nq, 3).astype(np.float32) * 0.01
    idx = rng.randint(0, ns, (b, nq, k)).astype(np.int32)
    idx[rng.rand(b, nq, k) < 0.2] = ns                     # sentinel shadow rows
    x = np.maximum(rng.randn(b, ns, cin), 0.0).astype(np.float32)
    kp = load_kernel_points(0.1)
    w = (rng.randn(15, cin, cout) * 0.05).astype(np.float32)
    extent = 0.08
    ref = np.asarray(jax_kpconv.kpconv_batched(*map(jnp.asarray, (q, s, idx, x, kp, w)), extent,
                                               use_pallas=False))
    weighted, count = kpconv_aggregate(*map(torch.from_numpy, (q, s, idx, x, kp)), extent)
    a = weighted.reshape(b * nq, 15 * cin)
    wm = torch.from_numpy(w).reshape(15 * cin, cout)
    scale = np.abs(ref).max()

    def rel_err(matmul):
        out = matmul(a, wm).reshape(b, nq, cout) / count[..., None].float()
        return np.abs(out.numpy() - ref).max() / scale

    assert rel_err(matmul_3xtf32) <= KPCONV_REL_TOL / MARGIN
    assert rel_err(matmul_tf32) > KPCONV_REL_TOL
