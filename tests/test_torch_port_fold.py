"""The folded trunk (``models/layers.py: folded``, ``conv_bn_relu``) on the CPU.

- The fold: the convolution on the folded weight, times the folded scale,
  plus the folded bias, gives the convolution then the eval-mode BatchNorm,
  in f64 to 1e-10, at the trunk's kinds of convolution with running
  statistics away from (0, 1); in bf16 the weight is the unfolded call's
  bf16 cast, in the input's layout.
- The cache: a second forward folds nothing; a ``load_state_dict``, an
  in-place update of a parameter and a train-mode forward between two eval
  forwards make the next one fold again, with the new values; a cache built
  under ``inference_mode`` serves a ``no_grad`` forward; a folded forward
  leaves the state dict's keys and bits as they were; a forward that records
  gradients, or one in train mode, never reads the cache.
- The epilogue (``ops/epilogue.py``): the plain version is relu(y scale +
  bias), or with a residual relu(T(y scale + bias) + r), r = z or T(z
  z_scale + z_bias), T() the rounding to the map's dtype (the unfolded
  trunk's roundings), in f32; on the card's dispatch the wrapper
  hands the kernel f32 and bf16 maps in NCHW or channels-last memory order
  (a map that is both, as a 1x1 one, as channels-last) with a residual of
  the map's dtype and order, and raises for anything else.
- The models: on the card's dispatch (``_build.on_cuda`` patched, the
  kernels by their plain versions) a forward of
  the one-shot, iterative and segmentation models without autograd, their
  BatchNorms calibrated (``verify_kernels.calibrate_norms``), runs 47,
  94 and 47 convolutions folded and 44, 88 and 44 epilogues, each on
  operands the kernel takes, folds each once, and gives the unfolded
  forward's outputs within f32 rounding; on the CPU's own dispatch it folds
  nothing and gives the unfolded forward's bits.

The card runs the epilogue kernel itself (``tests/test_torch_port_cuda.py``,
``chip_smoke.py``).
"""

import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import omnifusion_torch.ops.epilogue as ep
from omnifusion_torch.models import (
    SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
)
from omnifusion_torch.models.layers import TorchBatchNorm, folded, torch_conv
from omnifusion_torch.models.resnet import BasicBlock
from omnifusion_torch.ops import _build
from omnifusion_torch.ops.epilogue import conv_epilogue
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.tools.verify_kernels import FOLD_F32_GAP, calibrate_norms, plain_versions
from omnifusion_torch.utils.profiling import count, recording

ERP, PATCH = (64, 128), 32
SPEC = ProjectionSpec.create(ERP, (PATCH, PATCH), (80.0, 80.0), 4)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


@pytest.fixture
def card(monkeypatch):
    """The card's dispatch on the CPU: the kernels by their plain
    versions."""
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
    with plain_versions():
        yield


def randomize_norms(module: torch.nn.Module, seed: int) -> None:
    """Scales, shifts and running statistics away from (1, 0, 0, 1)."""
    g = torch.Generator().manual_seed(seed)
    with torch.no_grad():
        for m in module.modules():
            if isinstance(m, torch.nn.BatchNorm2d):
                c = m.num_features
                m.weight.copy_(0.5 + torch.rand(c, generator=g))
                m.bias.copy_(0.3 * torch.randn(c, generator=g))
                m.running_mean.copy_(0.5 * torch.randn(c, generator=g))
                m.running_var.copy_(0.2 + 2 * torch.rand(c, generator=g))


# (in, out, kernel, stride, padding, input side): the stem, a 3x3/1, a
# 3x3/2, a downsample and the geometric embedding's first convolution
FOLD_CASES = {
    "stem_7x7_s2": (3, 64, 7, 2, 3, 32),
    "conv_3x3_s1": (64, 64, 3, 1, 1, 8),
    "conv_3x3_s2": (64, 128, 3, 2, 1, 8),
    "downsample_1x1_s2": (64, 128, 1, 2, 0, 8),
    "mlp_points_1x1": (5, 16, 1, 1, 0, 8),
}


@pytest.mark.parametrize("case", list(FOLD_CASES))
def test_fold_equals_conv_then_batchnorm_f64(case):
    cin, cout, k, stride, pad, side = FOLD_CASES[case]
    torch.manual_seed(3)
    conv = torch_conv(cin, cout, k, stride, pad).double()
    bn = TorchBatchNorm(cout).double().eval()
    randomize_norms(bn, 5)
    x = torch.randn(2, cin, side, side, dtype=torch.float64)
    with torch.no_grad():
        want = bn(conv(x))
        w, scale, bias = folded(conv, bn, torch.float64, torch.contiguous_format)
        got = F.conv2d(x, w, None, stride, pad) * scale.reshape(1, -1, 1, 1) + bias.reshape(
            1, -1, 1, 1)
    assert scale.dtype == bias.dtype == torch.float64 and torch.equal(w, conv.weight)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)


def _block(dtype=None) -> BasicBlock:
    torch.manual_seed(4)
    block = BasicBlock(16, 32, stride=2, dtype=dtype, device="cpu")
    randomize_norms(block, 6)
    return block.eval()


def _x(dtype=torch.float32) -> torch.Tensor:
    g = torch.Generator().manual_seed(7)
    return torch.rand(2, 16, 8, 8, generator=g).to(dtype).contiguous(
        memory_format=torch.channels_last)


def _unfolded(block: BasicBlock, x: torch.Tensor) -> torch.Tensor:
    with torch.enable_grad():  # autograd records: the modules one after the other
        return block(x).detach()


def _forward(block, x, mode=torch.no_grad):
    with mode(), recording() as rec:
        y = block(x)
    return y, {k: rec.counters.get(k, 0) for k in ("conv_fold.convs", "conv_fold.folds")}


def _bump(block: BasicBlock, event: str, x: torch.Tensor) -> int:
    """Change what the block's folds are computed from; returns how many of
    its three convolutions fold again."""
    if event == "load_state_dict":
        state = {k: v.clone() for k, v in block.state_dict().items()}
        state["bn2.weight"] *= 1.5
        block.load_state_dict(state)
        return 3
    if event == "inplace_update":
        with torch.no_grad():
            block.conv1.weight.mul_(0.9)
        return 1
    if event == "train_forward_eval":
        block.train()
        with torch.no_grad():
            block(x)  # the running statistics move
        block.eval()
        return 3
    return 0


@pytest.mark.parametrize("event", ["reused", "load_state_dict", "inplace_update",
                                   "train_forward_eval"])
def test_fold_cache_reused_until_its_sources_change(card, event):
    block, x = _block(), _x()
    y, n = _forward(block, x)
    assert n == {"conv_fold.convs": 3, "conv_fold.folds": 3}
    torch.testing.assert_close(y, _unfolded(block, x), rtol=1e-5, atol=1e-5)
    refolds = _bump(block, event, x)
    y, n = _forward(block, x)
    assert n == {"conv_fold.convs": 3, "conv_fold.folds": refolds}
    torch.testing.assert_close(y, _unfolded(block, x), rtol=1e-5, atol=1e-5)


def test_fold_in_the_compute_dtype_channels_last(card):
    block, x = _block(torch.bfloat16), _x(torch.bfloat16)
    y, n = _forward(block, x)
    assert n["conv_fold.convs"] == 3 and y.dtype == torch.bfloat16
    _, w, scale, bias = block.conv2.__dict__["_folded"]
    # the weight rounded as the unfolded call rounds it, in the input's layout
    assert torch.equal(w, block.conv2.weight.to(torch.bfloat16))
    assert w.is_contiguous(memory_format=torch.channels_last)
    assert scale.dtype == bias.dtype == torch.float32
    assert block.conv2.weight.dtype == torch.float32  # the parameters stay f32


def test_cache_built_under_inference_mode_serves_no_grad(card):
    block, x = _block(), _x()
    y_inf, n = _forward(block, x, torch.inference_mode)
    assert n["conv_fold.folds"] == 3
    y, n = _forward(block, x, torch.no_grad)
    assert n == {"conv_fold.convs": 3, "conv_fold.folds": 0}
    assert torch.equal(y, y_inf)


def test_state_dict_unchanged_by_a_folded_forward(card):
    block, x = _block(), _x()
    before = {k: v.clone() for k, v in block.state_dict().items()}
    _forward(block, x)
    after = block.state_dict()
    assert list(after) == list(before)
    assert all(torch.equal(after[k], v) for k, v in before.items())
    assert "_folded" not in dict(block.named_parameters()) and len(list(block.buffers())) == 9


@pytest.mark.parametrize("how", ["grad", "train"])
def test_grad_or_train_forward_never_reads_the_cache(card, how):
    block, x = _block(), _x()
    want = _unfolded(block, x)
    _forward(block, x)
    for conv in (block.conv1, block.conv2, block.downsample[0]):
        key, w, scale, bias = conv.__dict__["_folded"]
        conv.__dict__["_folded"] = (key, torch.zeros_like(w), scale, bias)  # a poisoned cache
    if how == "grad":
        with torch.enable_grad(), recording() as rec:
            y = block(x).detach()
        assert torch.equal(y, want)
    else:
        block.train()
        with torch.no_grad(), recording() as rec:
            y = block(x)
        block.eval()
        assert y.abs().sum() > 0  # normalized by the batch's statistics, not read from zeros
    assert rec.counters.get("conv_fold.convs", 0) == 0
    assert rec.counters.get("conv_fold.folds", 0) == 0


def _epilogue_operands(shape, dtype, fmt):
    g = torch.Generator().manual_seed(11)
    y = (torch.randn(shape, generator=g) * 3).to(dtype).contiguous(memory_format=fmt)
    z = torch.randn(shape, generator=g).to(dtype).contiguous(memory_format=fmt)
    c = shape[1]
    return (y, torch.rand(c, generator=g) * 2 + 0.1, torch.randn(c, generator=g), z,
            torch.rand(c, generator=g) + 0.5, torch.randn(c, generator=g))


@pytest.mark.parametrize("residual", ["none", "identity", "shortcut"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_epilogue_plain_is_the_folded_batchnorm_residual_and_relu(dtype, residual):
    y, scale, bias, z, z_scale, z_bias = _epilogue_operands((2, 16, 5, 6), dtype,
                                                            torch.channels_last)
    z = None if residual == "none" else z
    z_scale, z_bias = (z_scale, z_bias) if residual == "shortcut" else (None, None)

    def ch(t):
        return t.reshape(1, -1, 1, 1)

    # f32 sums, each product and sum on its own; a BatchNorm's output and the
    # sum rounded to the map's dtype, as the unfolded trunk rounds them
    a = y.float() * ch(scale) + ch(bias)
    if z is not None:
        r = z.float() if z_scale is None else (z.float() * ch(z_scale) + ch(z_bias)).to(dtype)
        a = a.to(dtype).float() + r.float()
    got = conv_epilogue(y.clone(), scale, bias, z, z_scale, z_bias)  # the CPU: the plain version
    assert got.dtype == dtype and got.is_contiguous(memory_format=torch.channels_last)
    assert torch.equal(got, a.clamp_min(0).to(dtype))
    # within the roundings' bound of the exact value (f64): each of at most
    # three roundings errs by half a unit in the last place of its operands
    ys = y.double() * ch(scale).double()
    exact, mag = ys + ch(bias).double(), ys.abs() + ch(bias).double().abs()
    if z is not None:
        zs = z.double() if z_scale is None else z.double() * ch(z_scale).double()
        rz = zs if z_scale is None else zs + ch(z_bias).double()
        exact = exact + rz
        mag = mag + zs.abs() + (0 if z_scale is None else ch(z_bias).double().abs())
    eps = 2.0**-8 if dtype == torch.bfloat16 else 2.0**-23
    assert ((got.double() - exact.clamp_min(0)).abs() <= 3 * eps * mag + 1e-30).all()


class _FakeLibrary:
    """Records each ``omnifusion_conv_epilogue`` call's sizes and layout."""

    def __init__(self):
        self.calls = []

    def omnifusion_conv_epilogue(self, y, z, dtype, scale, bias, z_scale, z_bias, n, c, hw, nhwc,
                                 stream):
        self.calls.append((z is not None, z_scale is not None, z_bias is not None, n, c, hw,
                           nhwc))
        return 0


def _fake_card(monkeypatch):
    """The card's dispatch on the CPU: a fake library that records each call."""
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    return lib


# (shape, memory format, dtype, the NHWC flag it is launched with)
DISPATCH = {
    "channels_last_bf16": ((2, 64, 4, 6), torch.channels_last, torch.bfloat16, 1),
    "nchw_bf16": ((2, 16, 4, 8), torch.contiguous_format, torch.bfloat16, 0),
    "channels_last_f32_12ch": ((2, 12, 3, 5), torch.channels_last, torch.float32, 1),
    "channels_last_bf16_12ch": ((2, 12, 3, 5), torch.channels_last, torch.bfloat16, 1),
    "nchw_odd_plane": ((2, 16, 3, 5), torch.contiguous_format, torch.bfloat16, 0),
    "one_pixel": ((2, 16, 1, 1), torch.contiguous_format, torch.bfloat16, 1),
}


@pytest.mark.parametrize("case", list(DISPATCH))
def test_conv_epilogue_hands_the_kernel_what_it_takes(monkeypatch, case):
    shape, fmt, dtype, nhwc = DISPATCH[case]
    lib = _fake_card(monkeypatch)
    y, scale, bias, z, z_scale, z_bias = _epilogue_operands(shape, dtype, fmt)
    with recording() as rec:
        conv_epilogue(y, scale, bias, z, z_scale, z_bias)
    n, c, h, w = shape
    assert lib.calls == [(True, True, True, n * c * h * w, c, h * w, nhwc)]
    assert rec.counters == {"conv_epilogue.launches": 1}


# operands the kernel does not take: on the card the wrapper raises
REFUSALS = ["f16", "f64", "strided", "residual_dtype", "residual_order", "residual_shape",
            "scale_f64", "scale_size", "z_scale_without_z", "z_scale_without_z_bias"]


@pytest.mark.parametrize("case", REFUSALS)
def test_conv_epilogue_refuses_on_the_card_what_the_kernel_does_not_take(monkeypatch, case):
    dtype = {"f16": torch.float16, "f64": torch.float64}.get(case, torch.bfloat16)
    y, scale, bias, z, z_scale, z_bias = _epilogue_operands((2, 16, 4, 8), dtype,
                                                            torch.channels_last)
    if case == "strided":
        y = y[..., ::2]
    elif case == "residual_dtype":
        z = z.float()
    elif case == "residual_order":
        z = z.contiguous()
    elif case == "residual_shape":
        z = z[:1]
    elif case == "scale_f64":
        scale = scale.double()
    elif case == "scale_size":
        scale = scale[:8]
    elif case == "z_scale_without_z":
        z = None
    elif case == "z_scale_without_z_bias":
        z_bias = None
    if not case.startswith(("residual", "z_scale")):
        z = z_scale = z_bias = None
    lib = _fake_card(monkeypatch)
    with recording() as rec, pytest.raises((TypeError, ValueError)):
        conv_epilogue(y, scale, bias, z, z_scale, z_bias)
    assert lib.calls == [] and rec.counters == {}
    # the CPU's own dispatch runs the plain version on what it is given
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: False)
    if case in ("f16", "f64", "strided", "residual_dtype", "residual_order"):
        conv_epilogue(y, scale, bias, z, z_scale, z_bias)


def _model(kind: str):
    kw = dict(depth=1, device="cpu")
    if kind == "iterative":
        model = SphericalFusionIterative(SPEC, **kw)
    elif kind == "seg":
        model = SphericalFusionSeg(SPEC, num_classes=13, **kw)
    else:
        model = SphericalFusion(SPEC, **kw)
    with torch.no_grad():
        return calibrate_norms(init_weights(model, 0), _rgb())


def _rgb() -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((1, *ERP, 3), dtype=np.float32))


FOLDED = {"oneshot": (47, 47), "iterative": (94, 49), "seg": (47, 47)}


@pytest.mark.parametrize("where", ["card", "cpu"])
@pytest.mark.parametrize("kind", list(FOLDED))
def test_model_forward_folds_every_conv_bn_once(monkeypatch, kind, where):
    """47 convolutions a one-shot or segmentation forward and 94 an
    iterative one (its two passes share the trunk, so 49 folds: the trunk's
    45 and the two embeddings' 2 each), and 44 (88) epilogues, the three
    downsamples joining their blocks'; none on the CPU's own dispatch."""
    model = _model(kind)
    convs, folds = FOLDED[kind] if where == "card" else (0, 0)
    with plain_versions():
        with torch.enable_grad():
            want = model(_rgb())
        if where == "card":
            monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
        plain = ep._epilogue_kernel
        # counted: each launch on operands the wrapper has checked (_check)
        ep._epilogue_kernel = lambda *a: (count("conv_epilogue.launches"), plain(*a))[1]
        try:
            for n_folds in (folds, 0):
                with torch.inference_mode(), recording() as rec:
                    got = model(_rgb())
                assert rec.counters.get("conv_fold.convs", 0) == convs
                assert rec.counters.get("conv_epilogue.launches", 0) == 44 * convs // 47
                assert rec.counters.get("conv_fold.folds", 0) == n_folds
        finally:
            ep._epilogue_kernel = plain
    for g, w in zip(*(o if isinstance(o, list) else [o] for o in (got, want))):
        w = w.detach()
        if where == "cpu":
            assert torch.equal(g, w)
        else:  # the folded sums in another order
            gap = float((g - w).norm() / w.norm())
            assert gap < FOLD_F32_GAP, gap
