"""The CUDA kernels against their plain versions, on the card.

Skipped where there is no CUDA device. Run on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

chip_smoke.py holds the same kernels to the same tolerances at the
flagship's shapes.
"""

import numpy as np
import pytest
import torch

from omnifusion_torch.ops import quad_blend as qb
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
from omnifusion_torch.projection import ProjectionSpec, equi2pers
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import (
    TransposedTables, build_equi2pers_grids, build_vjp_tables,
)

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


def many_entries_tables(device, n_out: int = 1000, heavy: int = 18, seed: int = 4) -> BlendTables:
    """Random quads, K = 2 slots and a tail of 0 to 3 entries per pixel, but
    ``heavy`` on pixel 5 and on the last pixel (a ragged tile: rows of 50),
    so that those pixels hold 2 + ``heavy`` quads (20 by default); the tail's
    quads lie on the last two source rows, so their corners wrap past N_in."""
    rng = np.random.default_rng(seed)
    n_in, w = 2048, 64
    counts = rng.integers(0, 4, size=n_out)
    counts[[5, n_out - 1]] = heavy
    m = int(counts.sum())
    return BlendTables.create(
        rng.integers(0, n_in, size=(n_out, 2)).astype(np.int32),
        rng.random((n_out, 2, 4), dtype=np.float32) / 24, w, n_in, device,
        tail_ptr=np.concatenate([[0], np.cumsum(counts)]).astype(np.int32),
        tail_pix=np.repeat(np.arange(n_out), counts).astype(np.int32),
        tail_idx=rng.integers(n_in - 2 * w, n_in, size=m).astype(np.int32),
        tail_w=rng.random((m, 4), dtype=np.float32) / 24, out_w=50,
    )


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
    # with a tail at the last pixel and ragged tiles (1,000 outputs in rows
    # of 50), in every dtype
    n_out = 1000
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, 2)).astype(np.int32)
    tables = BlendTables.create(
        idx, rng.random((n_out, 2, 4)).astype(np.float32) / 8, w, n_in, cuda,
        tail_ptr=np.arange(n_out + 1, dtype=np.int32), tail_pix=np.arange(n_out, dtype=np.int32),
        tail_idx=np.full(n_out, n_in - 1, np.int32),
        tail_w=rng.random((n_out, 4)).astype(np.float32) / 8, out_w=50,
    )
    for dtype in (torch.float32, torch.float16, torch.bfloat16):
        x = torch.rand(3, 5, n_in, generator=torch.Generator().manual_seed(3)).to(cuda, dtype)
        torch.testing.assert_close(quad_blend(x, tables), quad_blend_plain(x, tables),
                                   rtol=0, atol=2e-6)


def _blend_source(tables, rows: int, channel_last: bool, dtype, seed: int = 11):
    """A source of ``rows`` rows: (rows, N_in, 3) channel-last batches of 3
    rows each, or (1, rows, N_in) channel-first."""
    shape = (rows, tables.n_in, 3) if channel_last else (1, rows, tables.n_in)
    return torch.rand(shape, generator=torch.Generator().manual_seed(seed)).to("cuda", dtype)


@pytest.mark.parametrize("rows", [1, 3, 130])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("layout", ["merge", "e2p"])
def test_blend_kernel_rows_past_the_chunk(cuda, layout, dtype, rows):
    # row counts that no chunk of staged rows divides: the last chunk is short
    cl = layout == "e2p"
    tables = equi2pers_tables(SPEC, cuda) if cl else pers2equi_tables(SPEC, cuda)
    x = _blend_source(tables, rows, cl, dtype)
    before = quad_blend.launches
    got = quad_blend(x, tables, channel_last=cl)
    torch.cuda.synchronize()
    assert quad_blend.launches == before + 1 and got.dtype == torch.float32
    torch.testing.assert_close(got, quad_blend_plain(x, tables, channel_last=cl), rtol=0, atol=2e-6)


@pytest.mark.parametrize("staged", [True, False])
def test_blend_kernel_five_quads_per_pixel(cuda, staged):
    # nrows 5 (a golden configuration): capped K = 3 plus up to 2 tail
    # entries, past the 4 quads a pixel of the flagship keeps in registers
    tables = pers2equi_tables(ProjectionSpec.create((128, 256), (32, 32), (80, 80), 5), cuda)
    assert tables.tiles.entries == 5
    x = _blend_source(tables, 40, False, torch.float16)
    torch.testing.assert_close(qb._blend_kernel(x, tables, False, staged=staged),
                               quad_blend_plain(x, tables), rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
@pytest.mark.parametrize("staged", [True, False])
def test_blend_kernel_nine_quads_per_pixel(cuda, staged, dtype):
    # nrows 6, fov 90 at 512x1024, patch 128: capped K = 6 plus up to 3 tail
    # entries, one past the 8 quads a pixel keeps in registers; the merge's
    # 2 rows of batch 2, and 40 rows
    spec = ProjectionSpec.create((512, 1024), 128, (90, 90), 6)
    tables = pers2equi_tables(spec, cuda)
    assert tables.tiles.entries == 9 > qb.MAX_ENTRIES
    for rows in (4, 40):
        x = _blend_source(tables, rows, False, dtype)
        got = qb._blend_kernel(x, tables, False, staged=staged)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, quad_blend_plain(x, tables), rtol=0, atol=2e-6)
    # the wrapper's own plan, through the model's merge
    before = quad_blend.launches
    quad_blend(x, tables)
    assert quad_blend.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("staged", [True, False])
@pytest.mark.parametrize("layout", ["merge", "e2p", "e2p_c1"])
def test_blend_kernel_twenty_quads_in_one_pixel(cuda, layout, staged, dtype):
    # 12 quads past the register budget, on a pixel of a full tile and on
    # the last pixel of a ragged one, corners wrapping; channel-last too,
    # with 3 channels and with 1 (the iterative model's feedback)
    tables = many_entries_tables(cuda)
    assert tables.tiles.entries == 20
    cl = layout != "merge"
    x = _blend_source(tables, 7, cl, dtype)
    if layout == "e2p_c1":
        x = x[..., :1].contiguous()
    got = qb._blend_kernel(x, tables, cl, staged=staged)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, quad_blend_plain(x, tables, channel_last=cl), rtol=0,
                               atol=2e-6)


@pytest.mark.parametrize("batch", [2, 8, 64])
def test_quarter_res_equi2pers(cuda, batch):
    # the iterative model's feedback: a 1-channel f32 depth at the quarter
    # patch resolution (patch 32 at the flagship), through equi2pers (its
    # tables weight no wrapped corner: test_blend_kernel_twenty_quads_in_one_pixel
    # has them with one channel)
    spec = ProjectionSpec.create((512, 1024), 128, (80, 80), 4).with_patch_scale(4)
    tables = equi2pers_tables(spec, cuda)
    assert not tables.tiles.footprint <= qb.STAGE_MAX_FOOTPRINT  # gathered from global memory
    depth = torch.rand(batch, 512, 1024, 1, generator=torch.Generator().manual_seed(8)).to(cuda)
    depth = depth * 7 + 0.3
    got = equi2pers(depth, build_equi2pers_grids(spec))
    torch.cuda.synchronize()
    assert got.shape == (batch, spec.n_patches, 32, 32, 1) and got.dtype == torch.float32
    want = quad_blend_plain(depth.reshape(batch, -1, 1), tables, channel_last=True)
    torch.testing.assert_close(got.reshape(batch, -1, 1), want, rtol=2e-6, atol=2e-6)


@pytest.mark.parametrize("batch", [2, 8])
def test_spread_kernel_on_quarter_res_e2p_tables(cuda, batch):
    # the feedback's backward: channel-last quad_spread, C = 1, on the
    # quarter-resolution equi2pers's transposed tables (with an overflow)
    spec = ProjectionSpec.create((512, 1024), 128, (80, 80), 4).with_patch_scale(4)
    tables = equi2pers_tables(spec, cuda).vjp
    assert tables.n_over > 0
    cot = torch.rand(batch, tables.n_out, 1, generator=torch.Generator().manual_seed(9)).to(cuda)
    got = quad_spread(cot, tables, channel_last=True)
    torch.cuda.synchronize()
    torch.testing.assert_close(got, quad_spread_plain(cot, tables, channel_last=True),
                               rtol=1.3e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["merge", "e2p"])
def test_blend_kernel_768_rows(cuda, layout):
    # bench.py's widest call: 768 rows (e2p, bf16) and the merge's 512 and more
    cl = layout == "e2p"
    tables = equi2pers_tables(SPEC, cuda) if cl else pers2equi_tables(SPEC, cuda)
    dtype = torch.bfloat16 if cl else torch.float16
    x = _blend_source(tables, 256 if cl else 768, cl, dtype)
    torch.testing.assert_close(quad_blend(x, tables, channel_last=cl),
                               quad_blend_plain(x, tables, channel_last=cl), rtol=0, atol=2e-6)


@pytest.mark.parametrize("dtype", [torch.float16, torch.bfloat16])
def test_blend_kernel_stores_the_source_dtype(cuda, dtype):
    # equi2pers's store: the f32 sums rounded once, bit for bit the cast of
    # the f32 result; and two calls give the same bits
    tables = equi2pers_tables(SPEC, cuda)
    x = _blend_source(tables, 5, True, dtype)
    got = quad_blend(x, tables, channel_last=True, out_dtype=dtype)
    again = quad_blend(x, tables, channel_last=True, out_dtype=dtype)
    f32 = quad_blend(x, tables, channel_last=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    assert torch.equal(got, f32.to(dtype)) and torch.equal(got, again)
    erp = torch.rand(2, SPEC.erp_h, SPEC.erp_w, 3, device=cuda).to(dtype)
    out = equi2pers(erp, build_equi2pers_grids(SPEC))
    assert out.dtype == dtype
    assert torch.equal(out.reshape(2, -1, 3),
                       quad_blend(erp.reshape(2, -1, 3), tables, channel_last=True).to(dtype))


@pytest.mark.parametrize("layout", ["merge", "e2p"])
def test_blend_kernel_same_bits_every_call(cuda, layout):
    cl = layout == "e2p"
    tables = equi2pers_tables(SPEC, cuda) if cl else pers2equi_tables(SPEC, cuda)
    x = _blend_source(tables, 9, cl, torch.float32)
    first, second = (quad_blend(x, tables, channel_last=cl) for _ in range(2))
    torch.cuda.synchronize()
    assert torch.equal(first, second)


def test_blend_kernel_gathers_from_global_memory_too(cuda):
    # the unstaged variant (measurement only) computes the same function
    for cl, tables in ((False, pers2equi_tables(SPEC, cuda)), (True, equi2pers_tables(SPEC, cuda))):
        x = _blend_source(tables, 7, cl, torch.bfloat16)
        got = qb._blend_kernel(x, tables, cl, staged=False)
        torch.testing.assert_close(got, quad_blend_plain(x, tables, channel_last=cl),
                                   rtol=0, atol=2e-6)


def test_blend_kernel_reads_zero_weight_corners(cuda):
    # a NaN read with weight 0 gives NaN, in the kernel as in the plain version
    tables = pers2equi_tables(SPEC, cuda)
    x = _blend_source(tables, 2, False, torch.float32)
    w4 = tables.w4.cpu()
    n, k, q = [int(v[0]) for v in torch.nonzero(w4 == 0, as_tuple=True)]
    j = (int(tables.idx[n, k]) + (0, 1, SPEC.patch_w, SPEC.patch_w + 1)[q]) % tables.n_in
    x[0, 0, j] = float("nan")
    got, want = quad_blend(x, tables), quad_blend_plain(x, tables)
    torch.cuda.synchronize()
    assert bool(torch.isnan(got[0, 0, n])) and bool(torch.isnan(want[0, 0, n]))
    assert torch.equal(torch.isnan(got), torch.isnan(want))


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


ADJOINT_SHAPES = [(3, 8, 4, 4), (2, 32, 16, 16), (1, 3, 7, 5), (2, 3, 1, 1), (1, 2, 1, 4),
                  (5, 3, 7, 33), (2, 3, 5, 12)]  # odd, ragged and 4k-wide sides


@pytest.mark.parametrize("shape", ADJOINT_SHAPES)
def test_up2x_adjoint_kernel_matches_plain(cuda, shape):
    n, c, h, w = shape
    g = torch.rand(n, c, 2 * h, 2 * w, generator=torch.Generator().manual_seed(7)).to(cuda)
    x = torch.rand(shape, device=cuda, requires_grad=True)
    before = up2x_adjoint.launches
    up2x(x).backward(g)
    torch.cuda.synchronize()
    assert up2x_adjoint.launches == before + 1
    # the plain version's sums in its order and roundings: its bits
    assert torch.equal(x.grad, up2x_adjoint_plain(g))


@pytest.mark.parametrize("shape", ADJOINT_SHAPES)
def test_up2x_adjoint_kernel_matches_plain_bf16(cuda, shape):
    n, c, h, w = shape
    g = torch.rand(n, c, 2 * h, 2 * w, generator=torch.Generator().manual_seed(7))
    g = g.to(cuda, torch.bfloat16)
    got = up2x_adjoint(g)
    torch.cuda.synchronize()
    assert got.dtype == torch.bfloat16 and torch.equal(got, up2x_adjoint_plain(g))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_up2x_adjoint_kernel_on_an_unaligned_view(cuda, dtype):
    # a contiguous view one element into its storage: the kernel cannot load
    # it in 16-byte vectors and reads it element by element, same bits
    flat = torch.rand(1 + 2 * 16 * 16 * 32, generator=torch.Generator().manual_seed(5))
    g = flat.to(cuda, dtype)[1:].view(2, 16, 16, 32)
    assert g.data_ptr() % 16 != 0
    assert torch.equal(up2x_adjoint(g), up2x_adjoint_plain(g))


def test_up2x_adjoint_kernel_matches_plain_past_32_bit_indices(cuda):
    # the last decoder adjoint of a batch-256 bf16 step: 2.4e9 cotangents,
    # past a 32-bit index (csrc/up2x.cu offsets each plane in 64 bits)
    g = torch.rand(4608, 32, 128, 128, generator=torch.Generator(cuda).manual_seed(9),
                   device=cuda, dtype=torch.bfloat16)
    got = up2x_adjoint(g)
    torch.cuda.synchronize()
    assert g.numel() > 2**31
    for i in range(0, g.shape[0], 512):  # the plain version a slice at a time
        assert torch.equal(got[i : i + 512], up2x_adjoint_plain(g[i : i + 512]))


# ---- the segmentation path and the rest of the projection layer ----

@pytest.mark.parametrize("batch", [2, 8])
def test_segmentation_merge_fourteen_rows(cuda, batch):
    # the merge of 13 classes' logits and the confidence: C + 1 = 14
    # channel-first rows per panorama, f32, and its 14-channel backward
    tables = pers2equi_tables(SPEC, cuda)
    gen = torch.Generator().manual_seed(9)
    x = torch.rand(batch, 14, tables.n_in, generator=gen).to(cuda).requires_grad_()
    before = quad_blend.launches, quad_spread.launches
    got = quad_blend(x, tables)
    g = torch.rand(batch, 14, tables.n_out, generator=gen).to(cuda)
    got.backward(g)
    torch.cuda.synchronize()
    assert (quad_blend.launches, quad_spread.launches) == (before[0] + 1, before[1] + 1)
    torch.testing.assert_close(got, quad_blend_plain(x.detach(), tables), rtol=0, atol=2e-6)
    torch.testing.assert_close(x.grad, quad_spread_plain(g, tables.vjp), rtol=1.3e-4, atol=1e-5)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3])
def test_perspective_views_kernel_matches_plain(cuda, dtype, channels):
    from omnifusion_torch.projection import extract_views, insert_views

    centers, fov = ((0.5, 10.0), (30.0, 88.0), (359.5, -60.0)), (100.0, 100.0)
    erp = torch.rand(2, 64, 128, channels, generator=torch.Generator().manual_seed(3))
    erp = erp.to(cuda, dtype).requires_grad_()
    before = quad_blend.launches, quad_spread.launches
    views = extract_views(erp, centers, fov, (24, 40))
    equi, mask = insert_views(views, centers, fov, (64, 128))
    g = torch.rand(equi.shape, generator=torch.Generator().manual_seed(4)).to(cuda, dtype)
    equi.backward(g)
    torch.cuda.synchronize()
    assert (quad_blend.launches, quad_spread.launches) == (before[0] + 2, before[1] + 2)
    assert views.dtype == equi.dtype == erp.grad.dtype == dtype and mask.device == erp.device
    cpu_views = extract_views(erp.detach().cpu(), centers, fov, (24, 40))
    cpu_equi, cpu_mask = insert_views(views.detach().cpu(), centers, fov, (64, 128))
    # f32: the plain version's sums in another order; bf16: the same f32
    # sums rounded once, so at most one bf16 ulp apart
    tol = dict(rtol=0, atol=2e-6) if dtype == torch.float32 else dict(rtol=2.0**-7, atol=1e-6)
    torch.testing.assert_close(views.cpu(), cpu_views, **tol)
    torch.testing.assert_close(equi.detach().cpu(), cpu_equi, **tol)
    assert torch.equal(mask.cpu(), cpu_mask)


def test_channel_last_pers2equi_kernel_matches_plain(cuda):
    from omnifusion_torch.projection import build_pers2equi_grids, pers2equi

    pers = torch.rand(3, SPEC.n_patches, 16, 16, 5, generator=torch.Generator().manual_seed(5))
    before = quad_blend.launches
    got = pers2equi(pers.to(cuda), build_pers2equi_grids(SPEC))
    torch.cuda.synchronize()
    assert quad_blend.launches == before + 1
    torch.testing.assert_close(got.cpu(), pers2equi(pers, build_pers2equi_grids(SPEC)),
                               rtol=0, atol=2e-6)


def test_perspective_views_of_many_channels_gather_from_global_memory(cuda):
    # 32 f32 channels: the views' staged footprints do not fit a block's
    # shared memory twice, so the blend gathers from global memory
    from omnifusion_torch.projection import extract_views, insert_views

    centers, fov = ((0.5, 10.0), (90.0, 45.0), (200.0, -60.0)), (90.0, 90.0)
    erp = torch.rand(2, 64, 128, 32, generator=torch.Generator().manual_seed(8))
    views = extract_views(erp.to(cuda), centers, fov, (48, 64))
    equi, _ = insert_views(views, centers, fov, (64, 128))
    torch.cuda.synchronize()
    torch.testing.assert_close(views.cpu(), extract_views(erp, centers, fov, (48, 64)),
                               rtol=0, atol=2e-6)
    torch.testing.assert_close(equi.cpu(), insert_views(views.cpu(), centers, fov, (64, 128))[0],
                               rtol=0, atol=2e-6)


def test_two_gloo_ranks_on_the_card_match_one_process(cuda):
    # tests/test_torch_port_parallel.py's (a) and (d) on the card: two gloo
    # ranks share it (nccl refuses two ranks on one device); the one-shot
    # step on 2 x 1 panoramas against the one-process step, in float64 on
    # the plain versions, and in f32 through the kernels (at the bounds of
    # tests/test_torch_port_train.py's f32 step against JAX)
    import torch_parallel_ranks as R
    from omnifusion_torch.models import init_weights
    from omnifusion_torch.parallel.launch import spawn

    sd = {k: v.cpu() for k, v in init_weights(R.build("oneshot", cuda), 4).state_dict().items()}
    for head in ("pred", "weight_pred"):
        sd[f"{head}.weight"] = sd[f"{head}.weight"] * 0.05
    sd["pred.bias"] = sd["pred.bias"] + 2.0
    ranks = spawn(R.card_checks, 2, (sd,), lambda r: "cuda:0", "gloo", 240)
    ref = R.card_steps(sd, cuda)

    def rels(got, want):
        return [float((g - want["grads"][n]).norm() / want["grads"][n].norm())
                for n, g in got["grads"].items() if want["grads"][n].norm() > 0]

    for r in ranks:
        for errs in r["batchnorm"].values():
            errs = dict(errs)
            assert errs.pop("scale") > 0.1 and max(errs.values()) < 1e-10, errs
        got = r["f64"]
        assert abs(got["loss"] / ref["f64"]["loss"] - 1) < 1e-10
        assert max(rels(got, ref["f64"])) < 1e-8
        for k, v in ref["f64"]["state"].items():
            if v.is_floating_point():
                assert float((got["state"][k] - v).abs().max()) < 1e-8, k
        got = r["f32"]
        assert abs(got["loss"] / ref["f32"]["loss"] - 1) < 1e-5
        assert max(rels(got, ref["f32"])) < 5e-2 and np.median(rels(got, ref["f32"])) < 1e-2
        # per rank and step: 2 blends, 1 spread, 5 upsamples and 5 adjoints
        assert r["launches"] == {"quad_blend": 2, "quad_spread": 1, "up2x": 5,
                                 "up2x_adjoint": 5}, r["launches"]


# ---- the extras: pano_stretch on the blend and spread kernels ----

@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("channels", [1, 3])
def test_pano_stretch_kernels_match_plain(cuda, dtype, channels):
    # forward through the blend kernel, backward through the spread kernel,
    # each held to its plain version on the same tables
    from omnifusion_torch.ops.pano_stretch import pano_stretch, stretch_tables

    h, w = 64, 128
    gen = torch.Generator().manual_seed(11)
    img = torch.rand(2, h, w, channels, generator=gen).to(cuda, dtype).requires_grad_()
    cot = torch.rand(2, h, w, channels, generator=gen).to(cuda, dtype)
    tables = stretch_tables(h, w, 1.3, 0.8, img.device)
    before = quad_blend.launches, quad_spread.launches
    out = pano_stretch(img, 1.3, 0.8)
    out.backward(cot)
    torch.cuda.synchronize()
    assert (quad_blend.launches, quad_spread.launches) == (before[0] + 1, before[1] + 1)
    assert out.dtype == img.grad.dtype == dtype
    rows = (2, h * w, channels)
    # f32: the plain version's sums in another order; bf16: the same f32
    # sums rounded once, so at most one bf16 ulp apart
    tol = dict(rtol=0, atol=2e-6) if dtype == torch.float32 else dict(rtol=2.0**-7, atol=1e-6)
    torch.testing.assert_close(out.detach().reshape(rows),
                               quad_blend_plain(img.detach().reshape(rows), tables, True, dtype),
                               **tol)
    s_tol = dict(rtol=1.3e-4, atol=1e-5) if dtype == torch.float32 else dict(rtol=8e-3, atol=1e-5)
    torch.testing.assert_close(img.grad.reshape(rows),
                               quad_spread_plain(cot.reshape(rows), tables.vjp, True).to(dtype),
                               **s_tol)


# ---- the uniform patch layout ("uniform:RxC") ----

UNIFORM_6X12 = ProjectionSpec.create((512, 1024), 128, (80, 80), 4, layout="uniform:6x12")


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
@pytest.mark.parametrize("staged", [True, False])
def test_blend_kernel_uniform_6x12_merge(cuda, staged, dtype):
    # the 6x12 grid at 512x1024, patch 128: 72 patches, capped K = 12 plus up
    # to 5 tail entries, 17 quads on the most covered pixels; more than the
    # 8 a pixel keeps in registers on half the ERP. The merge's 2 rows of
    # batch 2, and 16 rows
    tables = pers2equi_tables(UNIFORM_6X12, cuda)
    assert tables.tiles.entries == 17 > qb.MAX_ENTRIES
    for rows in (4, 16):
        x = _blend_source(tables, rows, False, dtype)
        got = qb._blend_kernel(x, tables, False, staged=staged)
        torch.cuda.synchronize()
        torch.testing.assert_close(got, quad_blend_plain(x, tables), rtol=0, atol=2e-6)
    # the wrapper's own plan
    before = quad_blend.launches
    quad_blend(x, tables)
    assert quad_blend.launches == before + 1


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16, torch.bfloat16])
def test_spread_kernel_on_uniform_6x12_merge(cuda, dtype):
    # the 6x12 merge's backward: K_T = 4 plus an overflow with heavy pixels;
    # the same bits from two calls
    tables = pers2equi_tables(UNIFORM_6X12, cuda).vjp
    assert tables.n_over > 0 and tables.heavy.numel() > 0
    cot = torch.rand(8, 2, tables.n_out, generator=torch.Generator().manual_seed(14)).to(cuda, dtype)
    got = quad_spread(cot, tables)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and torch.equal(got, quad_spread(cot, tables))
    torch.testing.assert_close(got, quad_spread_plain(cot, tables), rtol=1.3e-4, atol=1e-5)


@pytest.mark.parametrize("layout", ["uniform:4x6", "uniform:6x12"])
def test_uniform_layout_projections_match_plain(cuda, layout):
    # equi2pers and pers2equi through the public ops on a uniform spec,
    # forward and backward, against the plain versions on the same tables
    from omnifusion_torch.projection import build_pers2equi_grids, pers2equi

    spec = ProjectionSpec.create((64, 128), (16, 16), (80, 80), 4, layout=layout)
    t_e2p, t_p2e = equi2pers_tables(spec, cuda), pers2equi_tables(spec, cuda)
    gen = torch.Generator().manual_seed(15)
    erp = torch.rand(2, 64, 128, 3, generator=gen).to(cuda).requires_grad_()
    pers = equi2pers(erp, build_equi2pers_grids(spec))
    back = pers2equi(pers, build_pers2equi_grids(spec))
    cot = torch.rand(back.shape, generator=gen).to(cuda)
    back.backward(cot)
    torch.cuda.synchronize()
    assert pers.shape == (2, spec.n_patches, 16, 16, 3)
    want_p = quad_blend_plain(erp.detach().reshape(2, -1, 3), t_e2p, True)
    torch.testing.assert_close(pers.detach().reshape(want_p.shape), want_p, rtol=0, atol=2e-6)
    want_b = quad_blend_plain(pers.detach().reshape(2, -1, 3), t_p2e, True)
    torch.testing.assert_close(back.detach().reshape(want_b.shape), want_b, rtol=0, atol=2e-6)
    g_pers = quad_spread_plain(cot.reshape(2, -1, 3), t_p2e.vjp, True)
    g_erp = quad_spread_plain(g_pers, t_e2p.vjp, True)
    torch.testing.assert_close(erp.grad.reshape(g_erp.shape), g_erp, rtol=1.3e-4, atol=1e-5)
