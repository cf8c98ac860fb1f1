"""The port's exact 2x upsample (plain version) vs the JAX package.

Held against the Pallas kernel in interpret mode and the JAX default
(``layers._up2x_conv``) on the same numpy inputs. The JAX functions are NHWC,
the port's NCHW; inputs are transposed between the two. On channels-last
inputs the plain version gives the NCHW bits in the input's layout,
``resize_bilinear`` keeps that layout only on the card (its dispatch run
here with ``_build.on_cuda`` patched) where autograd records nothing, and
the wrapper launches the kernel's form of the input's layout (against a
library that records its calls; the kernels themselves are held to the
plain version on the card).
"""

import types

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
from omnifusion_torch.ops import _build
from omnifusion_torch.ops import upsample as ups
from omnifusion_torch.ops.upsample import up2x, up2x_plain
from omnifusion_torch.utils.profiling import recording

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


DTYPES = [torch.float32, torch.bfloat16]


@pytest.mark.parametrize("dtype", DTYPES, ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", SHAPES, ids=lambda s: "x".join(map(str, s)))
def test_up2x_plain_channels_last_gives_the_nchw_bits(shape, dtype):
    x = torch.from_numpy(np.random.default_rng(2).random(shape, dtype=np.float32)).to(dtype)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got, want = up2x_plain(x_cl), up2x_plain(x)
    assert torch.equal(got, want) and got.dtype == dtype
    # the input's layout: channels-last, but where the input is one pixel
    # (either layout then) contiguous, as the kernels' dispatch reads it
    assert _build.channels_last(got) == _build.channels_last(x_cl) == (shape[2] * shape[3] > 1)
    assert want.is_contiguous()


GRAD_MODES = ["inference_mode", "no_grad", "grad"]


@pytest.mark.parametrize("where", ["cpu", "card"])
@pytest.mark.parametrize("mode", GRAD_MODES)
@pytest.mark.parametrize("layout", ["contiguous", "channels_last"])
def test_resize_bilinear_keeps_channels_last_only_on_the_card_without_autograd(
        monkeypatch, layout, mode, where):
    x = torch.from_numpy(np.random.default_rng(3).random((2, 8, 5, 7), dtype=np.float32))
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    if where == "card":  # the card's dispatch, the kernel's arithmetic by its plain version
        monkeypatch.setattr(_build, "on_cuda", lambda t, what: True)
        monkeypatch.setattr(ups, "_up2x_kernel", up2x_plain)
    ctx = torch.enable_grad() if mode == "grad" else getattr(torch, mode)()
    with ctx:
        y = resize_bilinear(x, (10, 14))
    assert torch.equal(y, up2x_plain(x.contiguous()))
    keeps = layout == "channels_last" and mode != "grad" and where == "card"
    assert _build.channels_last(y) == keeps and y.is_contiguous() == (not keeps)


class _FakeLibrary:
    """The kernel library's up2x entries, recording each call's sizes."""

    def __init__(self):
        self.calls = []

    def omnifusion_up2x(self, x, y, dtype, planes, h, w, stream):
        self.calls.append(("nchw", planes, h, w))
        return 0

    def omnifusion_up2x_nhwc(self, x, y, dtype, n, h, w, c, stream):
        self.calls.append(("nhwc", n, h, w, c))
        return 0


@pytest.fixture
def fake_kernels(monkeypatch):
    """The wrapper's kernel path on CPU tensors, against a library that
    records its calls and launches nothing."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream", lambda device=None: types.SimpleNamespace(
        cuda_stream=0))
    return lib


# (layout of a (2, 16, 6, 10) input, form launched, the call's sizes)
DISPATCH = [
    ("contiguous", ("nchw", 32, 6, 10)),
    ("channels_last", ("nhwc", 2, 6, 10, 16)),
]


@pytest.mark.parametrize("layout,call", DISPATCH)
def test_up2x_wrapper_launches_the_form_of_the_input_layout(fake_kernels, layout, call):
    x = torch.zeros(2, 16, 6, 10)
    if layout == "channels_last":
        x = x.contiguous(memory_format=torch.channels_last)
    before = up2x.launches
    with recording() as rec:
        y = up2x(x)
    assert fake_kernels.calls == [call] and up2x.launches == before + 1
    assert rec.counters.get("up2x.channels_last", 0) == (layout == "channels_last")
    assert y.shape == (2, 16, 12, 20) and _build.channels_last(y) == (layout == "channels_last")


@pytest.mark.parametrize("view", [lambda t: t[..., ::2], lambda t: t.permute(0, 1, 3, 2)],
                         ids=["strided", "transposed"])
def test_up2x_wrapper_refuses_a_map_in_neither_layout(fake_kernels, view):
    with pytest.raises(ValueError, match="contiguous or channels-last"):
        up2x(view(torch.zeros(2, 4, 6, 8)))
    assert fake_kernels.calls == []
