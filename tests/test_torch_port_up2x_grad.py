"""The adjoint of the exact 2x upsample (plain version) vs the JAX package.

The JAX package differentiates its Pallas kernel through the XLA resize's
transpose (pallas_resize.py:151-173) and trains with ``_up2x_conv``
(models/layers.py:184-213); both adjoints are held against the port's plain
adjoint here, on the same numpy cotangent, NHWC on the JAX side.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.models.layers import _up2x_conv
from omnifusion_tpu.ops.pallas_resize import upsample2x_bilinear
from omnifusion_torch.ops.upsample import up2x, up2x_adjoint, up2x_adjoint_plain

SHAPES = [(2, 3, 1, 1), (1, 2, 1, 4), (2, 4, 3, 5), (3, 8, 4, 4), (1, 32, 16, 16)]


def _jax_adjoint(fn, g_nchw):
    n, c, h2, w2 = g_nchw.shape
    g = jnp.asarray(g_nchw.transpose(0, 2, 3, 1))
    (gx,) = jax.vjp(fn, jnp.zeros((n, h2 // 2, w2 // 2, c), jnp.float32))[1](g)
    return np.asarray(gx).transpose(0, 3, 1, 2)


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_adjoint_matches_jax(shape):
    n, c, h, w = shape
    g = np.random.default_rng(h * 10 + w).random((n, c, 2 * h, 2 * w), dtype=np.float32)
    got = up2x_adjoint_plain(torch.from_numpy(g)).numpy()
    assert got.shape == shape
    # f32 rounding of a 16-tap sum of inputs in [0, 1)
    np.testing.assert_allclose(got, _jax_adjoint(lambda x: upsample2x_bilinear(x, True), g), atol=1e-6)
    np.testing.assert_allclose(got, _jax_adjoint(_up2x_conv, g), atol=1e-6)


def test_autograd_goes_through_the_adjoint():
    # the gradient of up2x comes from its Function's backward, never from
    # autograd differentiating the plain forward
    x = torch.rand(2, 3, 4, 6, requires_grad=True)
    y = up2x(x)
    assert type(y.grad_fn).__name__ == "_Up2xBackward"
    g = torch.rand(y.shape)
    before = up2x.launches, up2x_adjoint.launches
    y.backward(g)
    assert (up2x.launches, up2x_adjoint.launches) == before  # no kernel on the CPU
    torch.testing.assert_close(x.grad, up2x_adjoint_plain(g), rtol=0, atol=0)


def test_adjoint_wrapper_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        up2x_adjoint(torch.empty(1, 1, 2, 2, device="meta"))
