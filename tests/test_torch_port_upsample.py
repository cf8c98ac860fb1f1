"""The port's exact 2x upsample (plain version) vs the JAX package.

Held against the Pallas kernel in interpret mode and the JAX default
(``layers._up2x_conv``) on the same numpy inputs. The JAX functions are NHWC,
the port's NCHW; inputs are transposed between the two.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

from omnifusion_tpu.models.layers import _up2x_conv
from omnifusion_tpu.models.layers import resize_bilinear as jax_resize_bilinear
from omnifusion_tpu.ops.pallas_resize import upsample2x_bilinear
from omnifusion_torch.models.layers import resize_bilinear
from omnifusion_torch.ops.upsample import up2x, up2x_plain

SHAPES = [  # NCHW
    (3, 8, 4, 4),  # the flagship's first decoder stage, narrowed
    (2, 32, 16, 16),
    (1, 3, 7, 5),  # non-square, odd sides
    (2, 4, 2, 6),
    (2, 3, 1, 1),  # patch-32 configs reach 1x1 -> 2x2
    (1, 2, 1, 4),
    (5, 3, 7, 33),  # odd sides, and not a power of two
    (2, 4, 1, 9),
]


@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_up2x_matches_jax(shape):
    x = np.random.default_rng(0).random(shape, dtype=np.float32)
    x_nhwc = jnp.asarray(x.transpose(0, 2, 3, 1))
    got = up2x_plain(torch.from_numpy(x)).numpy().transpose(0, 2, 3, 1)
    assert got.shape == (shape[0], 2 * shape[2], 2 * shape[3], shape[1])
    np.testing.assert_allclose(got, np.asarray(upsample2x_bilinear(x_nhwc, True)), atol=1e-6)
    np.testing.assert_allclose(got, np.asarray(_up2x_conv(x_nhwc)), atol=1e-6)
    np.testing.assert_allclose(
        got, np.asarray(jax.image.resize(x_nhwc, got.shape, method="bilinear")), atol=1e-6
    )
    # the library call the port never makes, as a third witness
    lib = F.interpolate(torch.from_numpy(x), scale_factor=2, mode="bilinear", align_corners=False)
    np.testing.assert_allclose(got, lib.numpy().transpose(0, 2, 3, 1), atol=1e-6)


def test_resize_bilinear_routes_only_exact_2x_to_up2x():
    x = torch.from_numpy(np.random.default_rng(1).random((2, 4, 8, 8), dtype=np.float32))
    before = up2x.launches
    torch.testing.assert_close(resize_bilinear(x, (16, 16)), up2x_plain(x), rtol=0, atol=0)
    # any other size: F.interpolate, as the JAX code takes jax.image.resize
    got = resize_bilinear(x, (12, 20)).numpy().transpose(0, 2, 3, 1)
    want = jax_resize_bilinear(jnp.asarray(x.numpy().transpose(0, 2, 3, 1)), (12, 20))
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-6)
    assert up2x.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="cuda or cpu"):
        up2x(torch.empty(1, 1, 2, 2, device="meta"))
