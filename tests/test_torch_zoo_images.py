"""The port's zoo against the JAX package on the CPU (part 3 of 3): the image
models (Pri3D's ResNet blocks, encoders and ResUNets, the residual conv
block, VGG19-bn and CNNandDinov2) and the weight bridge's coverage. The port
is NCHW, JAX NHWC: inputs and outputs are transposed for the comparison.
Tolerances: 1e-5 of the largest output for one block, 1e-4 for the deep
stacks (a ResUNet's 20-60 convolutions and GroupNorms, the VGG's 16 layers),
whose sums run in other orders in each package.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
from flax.traverse_util import flatten_dict
from torch_zoo_support import T, apply, carry, close, init_apply, np_

from diffreg_tpu import zoo as jzoo
from diffreg_tpu.nn import dinov2 as jdino
from diffreg_tpu.nn import encoders as jenc
from diffreg_tpu_torch import zoo as pzoo
from diffreg_tpu_torch.convert import zoo_state_dict_from_flax
from diffreg_tpu_torch.nn import dinov2 as pdino
from diffreg_tpu_torch.nn import encoders as penc

DEEP_REL = 1e-4


def _image(seed, b, h, w, c=3):
    """(NHWC for JAX, NCHW for the port)."""
    x = np.random.RandomState(seed).randn(b, h, w, c).astype(np.float32)
    return x, T(x.transpose(0, 3, 1, 2))


def _nhwc(t):
    return np_(t).transpose(0, 2, 3, 1)


@pytest.mark.parametrize("block,stride,planes", [("BasicBlock", 1, 8), ("BasicBlock", 2, 16),
                                                 ("Bottleneck", 2, 4), ("Bottleneck", 1, 2)])
def test_resnet_blocks(block, stride, planes):
    x, xt = _image(0, 2, 12, 10, 8)
    jm = getattr(jzoo, block)(planes, stride)
    var, ref = init_apply(jm, x)
    got = carry(getattr(pzoo, block)(8, planes, stride), var)(xt)
    close(_nhwc(got), ref)


def test_residual_conv_block():
    x, xt = _image(1, 1, 16, 16, 6)
    for out, stride in ((12, 2), (6, 1)):
        jm = jzoo.BasicConvResBlock(out, stride=stride)
        var, ref = init_apply(jm, x)
        close(_nhwc(carry(pzoo.BasicConvResBlock(6, out, stride=stride), var)(xt)), ref)


def test_up_projection():
    x, xt = _image(2, 1, 6, 7, 16)
    jm = jzoo.UpProjection(8)
    var, ref = init_apply(jm, x, size=(11, 13))
    close(_nhwc(carry(pzoo.UpProjection(16, 8), var)(xt, (11, 13))), ref)


@pytest.mark.parametrize("make", ["create_resnet10", "create_resnet18", "create_resnet34",
                                  "create_resnet50",
                                  "create_resnet101", "ResUNet50"])
def test_deep_models_map_whole(make):
    """Every flax path of the encoders and of ResUNet 50 (traced, not
    compiled; ResUNet 10 and 18 run below) maps onto a port key of its shape,
    and every port key is set."""
    if make == "ResUNet50":
        jm, port = jzoo.ResUNet(4, depth=50), pzoo.ResUNet(4, 50)
    else:
        jm, port = getattr(jzoo, make)(), getattr(pzoo, make)()
    shapes = jax.eval_shape(jm.init, jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)))
    zeros = {"/".join(k): np.zeros(v.shape, np.float32)
             for k, v in flatten_dict(dict(shapes["params"])).items()}
    sd = zoo_state_dict_from_flax(port, zeros)
    own = port.state_dict()
    assert set(sd) == set(own), make
    for key, value in sd.items():
        assert value.shape == own[key].shape, key


@pytest.mark.parametrize("depth,multires", [(10, False), (18, True)])
def test_resunet(depth, multires):
    img, imgt = _image(4, 1, 64, 64)
    jm = jzoo.ResUNet(output_channel=4, depth=depth, multires=multires)
    var, ref = init_apply(jm, img)
    got = carry(pzoo.ResUNet(4, depth, multires), var)(imgt)
    if multires:
        for g, r in zip(got, ref):
            close(_nhwc(g), r, rel=DEEP_REL)
    else:
        close(_nhwc(got), ref, rel=DEEP_REL)


def _random_batch_stats(variables, seed):
    """The VGG's BatchNorm statistics and affine drawn at random (init leaves
    them at 0 / 1), so that the running statistics are seen to land."""
    rs = np.random.RandomState(seed)
    stats = jax.tree_util.tree_map(
        lambda a: jnp.asarray(rs.rand(*a.shape).astype(np.float32) + 0.5), variables["batch_stats"])
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(a + rs.randn(*a.shape).astype(np.float32) * 0.1), variables["params"])
    return {"params": params, "batch_stats": stats}


def test_vgg19bn():
    img, imgt = _image(5, 1, 40, 48)
    jm = jenc.VGG19BN()
    var, _ = init_apply(jm, img)
    var = _random_batch_stats(var, 6)
    ref = apply(jm, var, img)
    port = carry(penc.VGG19BN(), var)
    assert float(port.bn3.running_var.min()) >= 0.5          # the statistics are buffers
    port.train()                                               # frozen: running statistics even so
    got = port(imgt)
    assert sorted(got) == [1, 2, 4, 8]
    for s in (1, 2, 4, 8):
        close(_nhwc(got[s]), ref[s], rel=DEEP_REL)


def test_cnn_and_dinov2():
    jcfg = jdino.DinoV2Config(patch_size=14, embed_dim=32, depth=2, num_heads=2, img_size=28,
                              layerscale_init=0.5)
    img, imgt = _image(7, 1, 42, 56)
    jm = jenc.CNNandDinov2(jcfg)
    var, _ = init_apply(jm, img)
    var = _random_batch_stats(var, 8)
    ref = apply(jm, var, img)
    port = carry(penc.CNNandDinov2(pdino.DinoV2Config(**vars(jcfg))), var)
    got = port(imgt)
    assert sorted(got) == [1, 2, 4, 8, 16]
    for s in (1, 2, 4, 8, 16):
        close(_nhwc(got[s]), ref[s], rel=DEEP_REL)


def test_weight_bridge_refuses_unknown_paths():
    port = pzoo.TNet(3, (4,), (4,))
    with pytest.raises(KeyError):
        zoo_state_dict_from_flax(port, {"local9/kernel": np.zeros((3, 4), np.float32)})
    with pytest.raises(KeyError):
        zoo_state_dict_from_flax(port, {"local0/unknown": np.zeros((3, 4), np.float32)})
