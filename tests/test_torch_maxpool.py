"""Kernel K7 (the ResNet stem's 3x3 / stride 2 / pad 1 max pool): the
port's plain version against the JAX package's Pallas kernel in interpret
mode on inputs with ties, both against the default pools, and the ResNet18
encoder with the kernel pool switched on in both packages."""

import numpy as np
import pytest
import jax
import jax.numpy as jnp
import torch
from torch.nn import functional as F

from alignsdf_tpu.models import resnet as jax_resnet
from alignsdf_tpu.models.torch_import import convert_resnet_encoder
from alignsdf_tpu.ops.maxpool import maxpool_k3s2p1 as jax_k7
from alignsdf_torch.kernels.maxpool import maxpool_k3s2p1
from alignsdf_torch.models import resnet

import torch_parity


@pytest.fixture(autouse=True, scope="module")
def _one_thread():
    with torch_parity.torch_threads(1):
        yield


def _tied(shape, seed):
    """NHWC post-ReLU data with ties: zeros (ReLU), a flat positive block
    and a zero run of rows."""
    rng = np.random.default_rng(seed)
    x = np.maximum(rng.normal(size=shape), 0).astype(np.float32)
    n, h, w, _ = shape
    x[:, h // 8:h // 2, w // 4:3 * w // 4, :] = 0.7
    x[:, h - 2:, :, :] = 0.0
    dy = rng.normal(size=(n, h // 2, w // 2, shape[3])).astype(np.float32)
    return x, dy


def _nchw(a):
    return torch.from_numpy(np.ascontiguousarray(a.transpose(0, 3, 1, 2)))


def _nhwc(t):
    return t.detach().numpy().transpose(0, 2, 3, 1)


def _jax_vjp(pool, x, dy):
    y, pullback = jax.vjp(pool, jnp.asarray(x))
    return np.asarray(y), np.asarray(pullback(jnp.asarray(dy))[0])


def _port_vjp(pool, x, dy):
    xt = _nchw(x).requires_grad_()
    y = pool(xt)
    y.backward(_nchw(dy))
    return _nhwc(y), _nhwc(xt.grad)


@pytest.mark.parametrize("shape", [(2, 16, 16, 8), (3, 32, 32, 16), (5, 12, 20, 4)])
def test_plain_k7_matches_jax_k7(shape):
    """Forward exact; gradient within 1e-6 (each position sums at most two
    nonzero terms a pass, so the order of the additions changes nothing)."""
    x, dy = _tied(shape, seed=sum(shape))
    jy, jdx = _jax_vjp(lambda a: jax_k7(a, True), x, dy)
    py, pdx = _port_vjp(maxpool_k3s2p1, x, dy)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_allclose(pdx, jdx, atol=1e-6, rtol=0)


def test_k7_gradient_differs_from_the_default_pools():
    """On tied input both K7s route a window's gradient to every tied
    position, while F.max_pool2d and JAX's _max_pool_3x3s2 (XLA's
    select-and-scatter) route it to the first: the same forward, gradients
    that differ, and K7's carries more mass than dy."""
    x, dy = _tied((2, 16, 16, 4), seed=3)
    _, jdx = _jax_vjp(lambda a: jax_k7(a, True), x, dy)
    _, pdx = _port_vjp(maxpool_k3s2p1, x, dy)
    _, ddx = _port_vjp(lambda t: F.max_pool2d(t, 3, 2, 1), x, dy)
    _, xdx = _jax_vjp(jax_resnet._max_pool_3x3s2, x, dy)
    for k7_grad in (jdx, pdx):
        for default in (ddx, xdx):
            assert np.abs(k7_grad - default).max() > 1.0
    # the default pools pass each window's gradient on once, K7 once per tie
    np.testing.assert_allclose(ddx.sum(), dy.sum(), rtol=1e-4)
    assert abs(pdx.sum() - dy.sum()) > 1.0


def test_default_pool_tie_routing_matches_jax_default():
    """The port's default stem pool (F.max_pool2d) and JAX's default
    (_max_pool_3x3s2) on tied input: the same forward and the same gradient,
    each window's to its first maximum."""
    x, dy = _tied((2, 16, 16, 8), seed=5)
    jy, jdx = _jax_vjp(jax_resnet._max_pool_3x3s2, x, dy)
    py, pdx = _port_vjp(resnet.stem_pool, x, dy)
    np.testing.assert_array_equal(py, jy)
    np.testing.assert_array_equal(pdx, jdx)


def _encoder_run_port(encoder, image, cot):
    encoder.train()
    encoder.zero_grad()
    sdf_feat, mano_feat, _ = encoder(_nchw(image))
    ((sdf_feat * torch.from_numpy(cot[0])).sum() + (mano_feat * torch.from_numpy(cot[1])).sum()
     ).backward()
    grads = {k: (p.grad if p.grad is not None else torch.zeros_like(p))
             for k, p in encoder.named_parameters()}
    return sdf_feat.detach().numpy(), mano_feat.detach().numpy(), grads


def test_encoder_with_kernel_pool_matches_jax():
    """The ResNet18 encoder in train mode (batch statistics) on two 128x128
    images with a constant border, the stem pool switched to K7 in both
    packages (``KERNEL_POOL``, JAX's ``PALLAS_POOL``): outputs within 1e-4
    abs (the encoder tolerance of tests/test_torch_model.py), every
    parameter gradient within 1e-4 of its largest entry (seen: 8e-6; the
    largest entries reach 90).  At 64x64 the last stages normalize over 8-32
    values a channel, and the two frameworks' gradients differ by 2% of the
    largest entry with either pool.  With the switch off, the port's conv1
    gradient moves by far more: the border's ties reach it."""
    latent = 16
    torch.manual_seed(0)
    encoder = resnet.ResNetEncoder("resnet18", latent_size=latent, mano_features=True)
    params, stats = convert_resnet_encoder(encoder.state_dict(), (2, 2, 2, 2))
    jenc = jax_resnet.ResNetEncoder(block="basic", layers=(2, 2, 2, 2), latent_size=latent,
                                    mano_features=True)
    rng = np.random.default_rng(11)
    image = rng.normal(size=(2, 128, 128, 3)).astype(np.float32)
    image[:, :12] = image[:, -12:] = -2.0
    image[:, :, :12] = image[:, :, -12:] = -2.0
    cot = (rng.normal(size=(2, latent)).astype(np.float32),
           rng.normal(size=(2, 512)).astype(np.float32))

    def loss(p, img):
        (sdf_feat, mano_feat, _), _ = jenc.apply({"params": p, "batch_stats": stats}, img,
                                                 train=True, mutable=["batch_stats"])
        return jnp.vdot(sdf_feat, cot[0]) + jnp.vdot(mano_feat, cot[1]), (sdf_feat, mano_feat)

    try:
        jax_resnet.PALLAS_POOL = True
        (_, (j_sdf, j_mano)), j_grads = jax.value_and_grad(loss, has_aux=True)(
            params, jnp.asarray(image))
    finally:
        jax_resnet.PALLAS_POOL = False
    try:
        resnet.KERNEL_POOL = True
        p_sdf, p_mano, p_grads = _encoder_run_port(encoder, image, cot)
    finally:
        resnet.KERNEL_POOL = False
    np.testing.assert_allclose(p_sdf, np.asarray(j_sdf), atol=1e-4, rtol=0)
    np.testing.assert_allclose(p_mano, np.asarray(j_mano), atol=1e-4, rtol=0)
    grad_sd = dict(encoder.state_dict(), **p_grads)
    g_params, _ = convert_resnet_encoder(grad_sd, (2, 2, 2, 2))
    flat_j = jax.tree_util.tree_leaves_with_path(j_grads)
    flat_p = dict(jax.tree_util.tree_leaves_with_path(g_params))
    assert len(flat_j) == len(flat_p) > 60
    for path, g in flat_j:
        g = np.asarray(g)
        np.testing.assert_allclose(flat_p[path], g, atol=1e-4 * float(np.abs(g).max()), rtol=0,
                                   err_msg=jax.tree_util.keystr(path))
    _, _, default_grads = _encoder_run_port(encoder, image, cot)
    moved = float((default_grads["conv1.weight"] - p_grads["conv1.weight"]).abs().max())
    assert moved > 1e-2 * float(p_grads["conv1.weight"].abs().max())
