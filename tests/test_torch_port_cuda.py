"""The CUDA kernels against their plain versions, on the card.

Skipped where there is no CUDA device. Run on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

chip_smoke.py holds the same kernels to the same tolerances at the
flagship's shapes.
"""

import numpy as np
import pytest
import torch

from omnifusion_torch.ops.quad_blend import (
    HEAVY_THRESHOLD,
    BlendTables,
    SpreadTables,
    quad_blend,
    quad_blend_plain,
    quad_spread,
    quad_spread_plain,
)
from omnifusion_torch.ops.probe import probe, probe_plain
from omnifusion_torch.ops.upsample import up2x, up2x_adjoint, up2x_adjoint_plain, up2x_plain
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import TransposedTables, build_vjp_tables

pytestmark = pytest.mark.cuda

SPEC = ProjectionSpec.create((64, 128), (16, 16), (80, 80), 4)


def straddling_tables(threshold: int, row_stride: int = 64, rows: int = 128, n_out: int = 4096):
    """Transposed tables (K_T = 1) whose overflow loads straddle
    ``threshold``: isolated segments of threshold - 1, threshold, threshold
    + 1 and 5,000 entries (each the whole load of its quad's four pixels),
    two neighbouring segments that only their common pixels' sum puts above
    it, one on the last pixel (its corners wrap onto the first pixels), and
    short segments scattered over the first half. Returns the tables and
    {pixel: load} for the placed segments' pixels."""
    rng = np.random.default_rng(7)
    n_in = row_stride * rows
    seg = np.zeros(n_in, np.int64)
    small = rng.choice(n_in // 2, size=n_in // 8, replace=False)
    seg[small] = rng.integers(1, 4, size=small.size)
    loads = {}
    for k, n in enumerate((threshold - 1, threshold, threshold + 1, 5000)):
        j = n_in // 2 + (4 * k + 1) * row_stride + 5
        seg[j] = n
        loads.update({j + off: n for off in (0, 1, row_stride, row_stride + 1)})
    j = n_in // 2 + 20 * row_stride + 9
    seg[j], seg[j + 1] = threshold // 2, threshold // 2 + 1
    loads.update({j: seg[j], j + 1: seg[j] + seg[j + 1], j + 2: seg[j + 1]})
    seg[n_in - 1] = 2 * threshold
    m = int(seg.sum())
    over_w = rng.random((m, 4), dtype=np.float32)
    over_w[rng.random((m, 4)) < 0.25] = 0.0
    w_t = rng.random((n_in, 1, 4), dtype=np.float32)
    w_t[rng.random(n_in) < 0.3] = 0.0
    t = TransposedTables(
        idx_t=rng.integers(0, n_out, size=(n_in, 1)).astype(np.int32),
        w_t=w_t,
        over_src=rng.integers(0, n_out, size=m).astype(np.int32),
        over_dst=np.repeat(np.arange(n_in), seg).astype(np.int32),
        over_w=over_w,
        over_ptr=np.concatenate([[0], np.cumsum(seg)]).astype(np.int32),
    )
    return t, loads


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_merge_kernel_matches_plain(cuda, dtype):
    tables = pers2equi_tables(SPEC, cuda)
    assert tables.n_tail > 0
    x = torch.rand(5, 2, tables.n_in, generator=torch.Generator().manual_seed(0)).to(cuda, dtype)
    before = quad_blend.launches
    got = quad_blend(x, tables)
    torch.cuda.synchronize()
    assert quad_blend.launches == before + 1
    assert got.dtype == torch.float32
    # same f32 arithmetic on the same decoded inputs; the order of the four
    # corner products and the FMA contraction differ
    torch.testing.assert_close(got, quad_blend_plain(x, tables), rtol=0, atol=2e-6)


def test_e2p_kernel_matches_plain(cuda):
    tables = equi2pers_tables(SPEC, cuda)
    x = torch.rand(43, tables.n_in, 3, generator=torch.Generator().manual_seed(1)).to(cuda)
    got = quad_blend(x, tables, channel_last=True)
    torch.testing.assert_close(
        got, quad_blend_plain(x, tables, channel_last=True), rtol=0, atol=2e-6
    )


def test_kernel_wraps_corners_modulo_n_in(cuda):
    rng = np.random.default_rng(2)
    n_in, w, n_out = 96, 8, 40
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, 2)).astype(np.int32)
    w4 = rng.random((n_out, 2, 4)).astype(np.float32)
    tables = BlendTables.create(idx, w4, w, n_in, cuda)
    x = torch.rand(3, 5, n_in, generator=torch.Generator().manual_seed(2)).to(cuda)
    got = quad_blend(x, tables)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, quad_blend_plain(x, tables), rtol=0, atol=2e-6)


UP2X_SHAPES = [(3, 8, 4, 4), (2, 32, 16, 16), (1, 3, 7, 5), (2, 3, 1, 1), (1, 2, 1, 4),
               (5, 3, 7, 33), (2, 4, 1, 9)]  # odd sides, not powers of two


@pytest.mark.parametrize("shape", UP2X_SHAPES)
def test_up2x_kernel_matches_plain(cuda, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    before = up2x.launches
    got = up2x(x)
    torch.cuda.synchronize()
    assert up2x.launches == before + 1
    torch.testing.assert_close(got, up2x_plain(x), rtol=0, atol=1e-6)


@pytest.mark.parametrize("shape", UP2X_SHAPES)
def test_up2x_kernel_matches_plain_bf16(cuda, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3)).to(cuda, torch.bfloat16)
    got = up2x(x)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16
    # both compute in f32 and round once to bf16: at most one bf16 ulp apart
    torch.testing.assert_close(got.float(), up2x_plain(x).float(), rtol=2**-7, atol=1e-6)


def test_up2x_kernel_matches_plain_past_32_bit_indices(cuda):
    # the last decoder upsample of a batch-256 bf16 forward: 2.4e9 outputs,
    # past a 32-bit output index (csrc/up2x.cu offsets each plane in 64 bits)
    x = torch.rand(4608, 32, 64, 64, generator=torch.Generator().manual_seed(9))
    x = x.to(cuda, torch.bfloat16)
    got = up2x(x)
    torch.cuda.synchronize()
    assert got.numel() > 2**31
    for i in range(0, x.shape[0], 512):  # the plain version a slice at a time
        want = up2x_plain(x[i : i + 512]).float()
        torch.testing.assert_close(got[i : i + 512].float(), want, rtol=2**-7, atol=1e-6)


@pytest.mark.parametrize("shape", [(256, 128), (7,), (3, 1000, 5)])
def test_probe_kernel_equals_plain(cuda, shape):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(8)).to(cuda) * 1e3
    before = probe.launches
    got = probe(x)
    torch.cuda.synchronize()
    assert probe.launches == before + 1
    assert torch.equal(got, probe_plain(x))


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        up2x(torch.rand(2, 4, 4, 3, device=cuda).permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match="dtype"):
        up2x(torch.zeros(1, 1, 2, 2, dtype=torch.float64, device=cuda))
    tables = pers2equi_tables(SPEC, cuda)
    with pytest.raises(ValueError, match="pixels"):
        quad_blend(torch.rand(1, 2, tables.n_in - 1, device=cuda), tables)
    with pytest.raises(ValueError, match="pixels"):
        quad_spread(torch.rand(1, 2, tables.n_out - 1, device=cuda), tables.vjp)
    with pytest.raises(TypeError, match="dtype"):
        up2x_adjoint(torch.zeros(1, 1, 2, 2, dtype=torch.float64, device=cuda))
    with pytest.raises(TypeError, match="dtype"):
        probe(torch.zeros(4, dtype=torch.float16, device=cuda))
    with pytest.raises(ValueError, match="contiguous"):
        probe(torch.zeros(4, 4, device=cuda).t())


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_spread_kernel_matches_plain(cuda, dtype):
    # the merge's backward: channel-first, K_T = 4 plus the overflow, with
    # heavy pixels
    tables = pers2equi_tables(SPEC, cuda).vjp
    assert tables.n_over > 0 and tables.heavy.numel() > 0
    cot = torch.rand(5, 2, tables.n_out, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    before = quad_spread.launches
    got = quad_spread(cot, tables)
    torch.cuda.synchronize()
    assert quad_spread.launches == before + 1 and got.dtype == torch.float32
    # the same f32 products summed in another order (the plain version sums
    # each corner plane with index_add_, whose order changes from run to
    # run, then the four rolled planes): rtol ~ (terms per sum) * 2^-24
    torch.testing.assert_close(got, quad_spread_plain(cot, tables), rtol=1e-5, atol=1e-5)


def test_spread_kernel_e2p_and_wrapped_corners(cuda):
    tables = equi2pers_tables(SPEC, cuda).vjp
    cot = torch.rand(43, tables.n_out, 3, generator=torch.Generator().manual_seed(5)).to(cuda)
    torch.testing.assert_close(
        quad_spread(cot, tables, channel_last=True),
        quad_spread_plain(cot, tables, channel_last=True), rtol=0, atol=1e-5,
    )
    rng = np.random.default_rng(6)
    n_in, w, n_out = 96, 8, 40
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, 2)).astype(np.int32)
    w4 = rng.random((n_out, 2, 4)).astype(np.float32)
    wrap = BlendTables.create(idx, w4, w, n_in, cuda, vjp=build_vjp_tables(idx, w4, n_in)).vjp
    cot = torch.rand(3, 5, n_out, generator=torch.Generator().manual_seed(6)).to(cuda)
    got = quad_spread(cot, wrap)
    torch.cuda.synchronize()
    assert got[..., : w + 1].abs().sum() > 0
    torch.testing.assert_close(got, quad_spread_plain(cot, wrap), rtol=0, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_spread_kernel_straddling_the_threshold(cuda, dtype):
    # loads T - 1, T, T + 1 and 5,000 (longer than any block's stride): the
    # light and the heavy kernel split the overflow between them
    t, loads = straddling_tables(HEAVY_THRESHOLD)
    tables = SpreadTables.create(t, 64, 4096, cuda)
    assert tables.heavy.numel() > 0 and max(loads.values()) == 5000
    cot = torch.rand(3, 5, 4096, generator=torch.Generator().manual_seed(10)).to(cuda, dtype)
    before = quad_spread.launches
    got = quad_spread(cot, tables)
    again = quad_spread(cot, tables)
    torch.cuda.synchronize()
    assert quad_spread.launches == before + 2  # one count per call, two launches each
    assert torch.equal(got, again)  # fixed-order sums, no atomics: the same bits
    # against the float64 plain version: f32 sums of up to 5,000 products
    want = quad_spread_plain(cot.double(), tables)
    torch.testing.assert_close(got.double(), want, rtol=1.3e-4, atol=1e-5)


def test_blend_backward_runs_the_spread_kernel(cuda):
    tables = pers2equi_tables(SPEC, cuda)
    x = torch.rand(2, 2, tables.n_in, device=cuda, dtype=torch.float16, requires_grad=True)
    g = torch.rand(2, 2, tables.n_out, device=cuda)
    before = quad_spread.launches
    quad_blend(x, tables).backward(g)
    torch.cuda.synchronize()
    assert quad_spread.launches == before + 1 and x.grad.dtype == torch.float16
    torch.testing.assert_close(x.grad, quad_spread_plain(g, tables.vjp).half())


@pytest.mark.parametrize(
    "shape", [(3, 8, 4, 4), (2, 32, 16, 16), (1, 3, 7, 5), (2, 3, 1, 1), (1, 2, 1, 4)]
)
def test_up2x_adjoint_kernel_matches_plain(cuda, shape):
    n, c, h, w = shape
    g = torch.rand(n, c, 2 * h, 2 * w, generator=torch.Generator().manual_seed(7)).to(cuda)
    x = torch.rand(shape, device=cuda, requires_grad=True)
    before = up2x_adjoint.launches
    up2x(x).backward(g)
    torch.cuda.synchronize()
    assert up2x_adjoint.launches == before + 1
    # a 16-tap sum of inputs in [0, 1) in another order
    torch.testing.assert_close(x.grad, up2x_adjoint_plain(g), rtol=0, atol=1e-6)
