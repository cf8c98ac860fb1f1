"""The fused heads (``ops/heads.py``) on the CPU, at 64x128, patch 32, with
one-block encoders and a one-layer transformer.

- The wrapper's plain path is the heads' ``F.conv2d`` formulation: f32 and
  bf16 maps, 2 and 14 outputs, a ReLU on pred or none.
- ``trunk_rows`` gives the same pred and conf with autograd recording and
  without.
- The dispatch rule: the models call the wrapper only where autograd
  records nothing, once a pass, and only for an output count the kernel is
  built for; a train step never calls it.
- The kernel's wrapper refuses what the kernel does not take (checked with
  ``_build.on_cuda`` patched, before any launch), and hands the kernel the
  map in channels-last memory order whatever its layout: a channels-last
  map as it is, any other after one copy (against a library that records
  what it is handed).
- Channels-last maps: the plain path gives the NCHW values within
  rounding's bound. On the card's dispatch (``_build.on_cuda`` patched, the
  kernels' arithmetic by their plain versions) the models' decoder runs
  channels-last from the first resize to the heads where autograd records
  nothing (at patch 64: layer4 is 2x2; a 1x1 layer4 is either layout and
  stays NCHW), with the NCHW path's outputs (its BatchNorms unfolded,
  ``layers._folds`` patched: the fold has its own tests); where it records, in a train
  step, and on the CPU's own dispatch it runs contiguous NCHW, as before.
- ``tools/verify_kernels.py: heads_gap``, the bound the card's checks hold
  the kernel to, admits the kernel's arithmetic (operands as the map's
  dtype rounds them, an f32 sum with its bias, one rounding at the end)
  against the plain version, and refuses the heads without their bias.

The kernel itself is held to the plain version on the card
(``tests/test_torch_port_cuda.py``, ``chip_smoke.py``).
"""

import ctypes
import types

import numpy as np
import pytest
import torch
import torch.nn.functional as F

import omnifusion_torch.models.layers as ly
import omnifusion_torch.models.spherical_fusion as sf
from omnifusion_torch.models import (
    SphericalFusion, SphericalFusionIterative, SphericalFusionSeg, init_weights,
)
from omnifusion_torch.ops import _build
from omnifusion_torch.ops import heads as hd
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.tools.verify_kernels import heads_gap, plain_versions
from omnifusion_torch.training import create_train_state, train_step
from omnifusion_torch.utils.profiling import recording

ERP, PATCH = (64, 128), 32
ONE_BLOCK = ((64, 1, 1), (128, 1, 2), (256, 1, 2), (512, 1, 2))
SPEC = ProjectionSpec.create(ERP, (PATCH, PATCH), (80.0, 80.0), 4)


@pytest.fixture(scope="module", autouse=True)
def _few_threads():
    saved = torch.get_num_threads()
    torch.set_num_threads(min(saved, 2))
    yield
    torch.set_num_threads(saved)


def _params(n_out: int, seed: int = 0):
    g = torch.Generator().manual_seed(seed)
    return (torch.randn(n_out - 1, 32, 3, 3, generator=g) * 0.1,
            torch.randn(n_out - 1, generator=g),
            torch.randn(1, 32, 3, 3, generator=g) * 0.1,
            torch.randn(1, generator=g))


def _conv_heads(x, pw, pb, cw, cb, activation):
    """The heads as the one-shot trunk computed them before the kernel."""
    y = F.conv2d(x, torch.cat([pw, cw]).to(x.dtype), torch.cat([pb, cb]).to(x.dtype), padding=1)
    k = pw.shape[0]
    pred = F.relu(y[:, :k]) if activation == "relu" else y[:, :k]
    return pred, torch.sigmoid(y[:, k:])


@pytest.mark.parametrize("activation", ["relu", "none"])
@pytest.mark.parametrize("n_out", [2, 14])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_is_the_conv_formulation(dtype, n_out, activation):
    x = torch.randn(3, 32, 9, 11, generator=torch.Generator().manual_seed(1)).to(dtype)
    params = _params(n_out)
    before = hd.fused_heads.launches
    pred, conf = hd.fused_heads(x, *params, activation)
    want_pred, want_conf = _conv_heads(x, *params, activation)
    assert hd.fused_heads.launches == before  # no kernel on the CPU
    assert pred.shape == (3, n_out - 1, 9, 11) and conf.shape == (3, 1, 9, 11)
    assert pred.dtype == conf.dtype == dtype
    assert torch.equal(pred, want_pred) and torch.equal(conf, want_conf)
    if activation == "relu":
        assert (pred >= 0).all()
    else:
        assert (pred < 0).any()


def _model(kind: str, spec: ProjectionSpec = SPEC):
    kw = dict(depth=1, encoder_stages=ONE_BLOCK, device="cpu")
    if kind == "iterative":
        return init_weights(SphericalFusionIterative(spec, **kw), 0)
    if kind.startswith("seg"):
        return init_weights(SphericalFusionSeg(spec, num_classes=int(kind[3:]), **kw), 0)
    return init_weights(SphericalFusion(spec, dtype=torch.bfloat16 if kind == "bf16" else None,
                                        **kw), 0)


def _rgb(b: int = 1) -> torch.Tensor:
    rng = np.random.default_rng(0)
    return torch.from_numpy(rng.random((b, *ERP, 3), dtype=np.float32))


@pytest.mark.parametrize("kind", ["oneshot", "bf16", "seg13"])
def test_trunk_rows_same_heads_with_and_without_grad(kind):
    model = _model(kind).eval()
    p = SPEC.n_patches
    g = torch.Generator().manual_seed(2)
    x = torch.rand(p, 3, PATCH, PATCH, generator=g)
    pf = torch.rand(p, 64, PATCH // 4, PATCH // 4, generator=g)
    with torch.no_grad():
        pred0, conf0 = model.trunk_rows(x, pf, 1)
    pred1, conf1 = model.trunk_rows(x, pf, 1)
    assert pred1.requires_grad and conf1.requires_grad
    assert pred0.shape == pred1.shape and conf0.shape == conf1.shape == (p, 1, PATCH, PATCH)
    assert torch.equal(pred0, pred1.detach()) and torch.equal(conf0, conf1.detach())


@pytest.fixture
def heads_calls(monkeypatch):
    """The wrapper as the models see it, counting its calls."""
    calls = []

    def spy(*args):
        calls.append(args[0].shape)
        return hd.fused_heads(*args)

    monkeypatch.setattr(sf, "fused_heads", spy)
    return calls


# (model, autograd records, wrapper calls a forward): one a pass without
# autograd, none with it; none for 4 classes (5 outputs), which the kernel is
# not built for
DISPATCH = [("oneshot", False, 1), ("oneshot", True, 0), ("bf16", False, 1),
            ("iterative", False, 2), ("iterative", True, 0), ("seg13", False, 1),
            ("seg13", True, 0), ("seg4", False, 0)]


@pytest.mark.parametrize("kind,grad,calls", DISPATCH)
def test_dispatch_rule(heads_calls, kind, grad, calls):
    model = _model(kind).eval()
    with torch.set_grad_enabled(grad):
        out = model(_rgb())
    assert len(heads_calls) == calls
    outs = out if isinstance(out, list) else [out]
    assert all(o.requires_grad == grad for o in outs)


@pytest.mark.parametrize("mode", ["no_grad", "inference_mode"])
def test_dispatch_rule_under_each_grad_free_mode(heads_calls, mode):
    model = _model("oneshot").eval()
    with getattr(torch, mode)():
        model(_rgb())
    assert len(heads_calls) == 1


@pytest.mark.parametrize("kind", ["oneshot", "iterative"])
def test_train_step_never_calls_the_wrapper(heads_calls, kind):
    rng = np.random.default_rng(3)
    batch = {"rgb": _rgb(2),
             "depth": torch.from_numpy(rng.random((2, *ERP, 1), dtype=np.float32) * 7 + 0.3),
             "mask": torch.ones(2, *ERP, 1)}
    out = train_step(create_train_state(_model(kind)), batch, kind == "oneshot")
    assert np.isfinite(float(out["loss"])) and heads_calls == []


def _refused(n_out=2, dtype=torch.float32, shape=(2, 32, 8, 8), param=None):
    x = torch.zeros(shape, dtype=dtype)
    params = list(_params(n_out))
    if param is not None:
        i, fn = param
        params[i] = fn(params[i])
    return x, params


REFUSALS = [
    ("outputs", ValueError, dict(n_out=3)),
    ("outputs", ValueError, dict(n_out=5)),
    ("outputs", ValueError, dict(n_out=15)),
    ("dtype", TypeError, dict(dtype=torch.float16)),
    ("dtype", TypeError, dict(dtype=torch.float64)),
    ("width of 32 channels", ValueError, dict(shape=(2, 16, 8, 8))),
    ("parameters", ValueError, dict(param=(0, lambda p: p.double()))),
    ("parameters", ValueError, dict(param=(2, lambda p: p[:, :16]))),
]


@pytest.mark.parametrize("match,error,case", REFUSALS)
def test_kernel_wrapper_refuses_what_the_kernel_does_not_take(monkeypatch, match, error, case):
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)

    def no_library():
        raise AssertionError("launched")

    monkeypatch.setattr(_build, "library", no_library)
    x, params = _refused(**case)
    with pytest.raises(error, match=match):
        hd.fused_heads(x, *params)


def _kernel_arithmetic(x, pw, pb, cw, cb, activation, bias=True):
    """csrc/heads.cu's arithmetic in plain PyTorch: the parameters rounded to
    the map's dtype, the products summed with the bias in f32, the
    activation, one rounding to the map's dtype."""
    w = torch.cat([pw, cw]).to(x.dtype).float()
    b = torch.cat([pb, cb]).to(x.dtype).float() if bias else None
    y = F.conv2d(x.float(), w, b, padding=1)
    k = pw.shape[0]
    pred = F.relu(y[:, :k]) if activation == "relu" else y[:, :k]
    return pred.to(x.dtype), torch.sigmoid(y[:, k:]).to(x.dtype)


@pytest.mark.parametrize("n_out,activation", [(2, "relu"), (14, "none")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_heads_gap_bounds_the_kernel_arithmetic(dtype, n_out, activation):
    x = torch.randn(4, 32, 12, 20, generator=torch.Generator().manual_seed(4)).to(dtype)
    params = _params(n_out, seed=5)
    plain = hd.fused_heads_plain(x, *params, activation)
    assert heads_gap(plain, plain, x, *params) == {"bound_ratio": 0.0, "max_abs_err": 0.0}
    ours = _kernel_arithmetic(x, *params, activation)
    assert heads_gap(ours, plain, x, *params)["bound_ratio"] <= 1
    no_bias = _kernel_arithmetic(x, *params, activation, bias=False)
    assert heads_gap(no_bias, plain, x, *params)["bound_ratio"] > 1


@pytest.mark.parametrize("shape", [(3, 32, 9, 11), (4, 32, 12, 20)], ids=["9x11", "12x20"])
@pytest.mark.parametrize("n_out,activation", [(2, "relu"), (14, "none")])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_plain_path_on_channels_last_maps_gives_the_nchw_values(dtype, n_out, activation, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(6)).to(dtype)
    params = _params(n_out, seed=7)
    x_cl = x.contiguous(memory_format=torch.channels_last)
    got, want = hd.fused_heads(x_cl, *params, activation), hd.fused_heads(x, *params, activation)
    assert [t.shape for t in got] == [t.shape for t in want]
    assert got[0].dtype == got[1].dtype == dtype
    assert heads_gap(got, want, x, *params)["bound_ratio"] <= 1


class _FakeLibrary:
    """The kernel library's heads entry, recording each call's sizes, the
    map's address and the bf16 map as the kernel reads it (rows x h x w
    pixels of 32 channels, as 16-bit words)."""

    def __init__(self):
        self.calls = []

    def omnifusion_fused_heads(self, x, dtype, pw, pb, cw, cb, pred, conf, n_out, rows, h, w,
                               relu, stream):
        assert dtype == _build.DTYPE_CODES[torch.bfloat16]
        read = (ctypes.c_int16 * (rows * h * w * hd.CHANNELS)).from_address(x)
        self.calls.append((n_out, rows, h, w, x, torch.frombuffer(read, dtype=torch.int16).clone()))
        return 0


LAYOUTS = {
    "contiguous": lambda x: x,
    "channels_last": lambda x: x.contiguous(memory_format=torch.channels_last),
    "strided": lambda x: torch.stack([x, torch.zeros_like(x)], dim=4).flatten(3)[..., ::2],
}


@pytest.mark.parametrize("n_out", [2, 14])
@pytest.mark.parametrize("layout", list(LAYOUTS))
def test_kernel_wrapper_launches_the_form_of_the_map_layout(monkeypatch, layout, n_out):
    lib = _FakeLibrary()
    monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
    monkeypatch.setattr(_build, "library", lambda: lib)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: types.SimpleNamespace(cuda_stream=0))
    x = torch.randn(2, 32, 6, 10, generator=torch.Generator().manual_seed(9)).to(torch.bfloat16)
    x_in = LAYOUTS[layout](x)
    before = hd.fused_heads.launches
    with recording() as rec:
        pred, conf = hd.fused_heads(x_in, *_params(n_out))
    assert hd.fused_heads.launches == before + 1 and rec.counters == {"fused_heads.launches": 1}
    [(n, rows, h, w, address, seen)] = lib.calls
    assert (n, rows, h, w) == (n_out, 2, 6, 10)
    # the kernel reads the map channels-last: a channels-last map in place,
    # any other layout after one copy
    assert (address == x_in.data_ptr()) == (layout == "channels_last")
    assert torch.equal(seen, x.permute(0, 2, 3, 1).reshape(-1).view(torch.int16))
    # the outputs are contiguous NCHW whatever the map's layout: the merge reads them so
    assert pred.shape == (2, n_out - 1, 6, 10) and conf.shape == (2, 1, 6, 10)
    assert pred.is_contiguous() and conf.is_contiguous()


SPEC64 = ProjectionSpec.create(ERP, (64, 64), (80.0, 80.0), 4)


def _layout(t: torch.Tensor) -> str:
    if _build.channels_last(t):
        return "channels_last"
    return "contiguous" if t.is_contiguous() else "other"


def _watched(kind: str, monkeypatch, where: str):
    """The model of ``kind`` at patch 64, and the list its decoder's
    convolutions (input and output) and the heads wrapper (input) append
    their layouts to. ``where`` "card": the card's dispatch
    (``_build.on_cuda`` patched), each kernel's arithmetic by its plain
    version (``verify_kernels.plain_versions``, entered by the caller)."""
    model = _model(kind, SPEC64).eval()
    seen = []
    for name, m in model.named_children():
        if name.startswith("de_conv"):
            m.register_forward_hook(
                lambda mod, args, out, name=name: seen.append((name, _layout(args[0]), _layout(out))))

    def spy(x, *args):
        seen.append(("heads", _layout(x), None))
        return hd.fused_heads(x, *args)

    monkeypatch.setattr(sf, "fused_heads", spy)
    if where == "card":
        monkeypatch.setattr(_build, "on_cuda", lambda x, what: True)
    return model, seen


@pytest.mark.parametrize("where", ["cpu", "card"])
@pytest.mark.parametrize("kind", ["oneshot", "bf16", "iterative", "seg13"])
def test_decoder_runs_channels_last_only_on_the_card_without_autograd(monkeypatch, kind, where):
    model, seen = _watched(kind, monkeypatch, where)
    passes = 2 if kind == "iterative" else 1
    # the BatchNorms unfolded (tests/test_torch_port_fold.py holds the fold)
    monkeypatch.setattr(ly, "_folds", lambda bn, x: False)
    with plain_versions():
        with torch.inference_mode():
            out = model(_rgb())
        layouts = {(a, b) for _, a, b in seen}
        assert len(seen) == passes * 10  # 9 convolutions and the heads a pass
        if where == "card":
            assert layouts <= {("channels_last", "channels_last"), ("channels_last", None)}
        else:  # the CPU's forward as before: NCHW from the first resize on
            assert layouts <= {("contiguous", "contiguous"), ("contiguous", None)}
        seen.clear()
        ref = model(_rgb())  # autograd records: the decoder as before, NCHW
    assert len(seen) == passes * 9 and {(a, b) for _, a, b in seen} == {("contiguous", "contiguous")}
    outs = out if isinstance(out, list) else [out]
    refs = ref if isinstance(ref, list) else [ref]
    for o, r in zip(outs, refs):
        r = r.detach()
        if kind == "bf16" or where == "cpu":
            assert torch.equal(o, r)
        else:  # f32: the CPU's channels-last convolutions sum in another order
            gap = float((o - r).norm() / r.norm())
            assert gap < 1e-5, gap


@pytest.mark.parametrize("where", ["cpu", "card"])
@pytest.mark.parametrize("kind", ["oneshot", "iterative"])
def test_train_step_decoder_stays_nchw(monkeypatch, kind, where):
    model, seen = _watched(kind, monkeypatch, where)
    rng = np.random.default_rng(8)
    batch = {"rgb": _rgb(2),
             "depth": torch.from_numpy(rng.random((2, *ERP, 1), dtype=np.float32) * 7 + 0.3),
             "mask": torch.ones(2, *ERP, 1)}
    with plain_versions():
        out = train_step(create_train_state(model), batch, kind == "oneshot")
    assert np.isfinite(float(out["loss"]))
    passes = 2 if kind == "iterative" else 1
    assert len(seen) == passes * 9 and {(a, b) for _, a, b in seen} == {("contiguous", "contiguous")}
