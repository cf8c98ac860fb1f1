"""The port's transposed quad blend (plain version) and the projections'
gradients vs the JAX package.

``quad_spread_plain`` is what the backward runs on a CPU tensor and what the
CUDA kernel (csrc/quad_spread.cu) is held against on the card
(chip_smoke.py). Here it is held against the XLA path
(``transposed_quad_gather_blend``, whose contraction runs at HIGHEST
precision) and the Pallas kernel in interpret mode, on the same tables and
the same numpy cotangents in [0, 1): atol 1e-5, f32 rounding of sums of up
to ~1000 terms. The projections' gradients are held against ``jax.grad``
through ``impl="pallas_full"``, the JAX package's route through the Pallas
backward.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.ops.pallas_blend import transposed_quad_gather_blend_pallas
from omnifusion_tpu.ops.sparse_blend import transposed_quad_gather_blend
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import ops as jax_ops
from omnifusion_tpu.projection.spec import build_equi2pers_grids as jax_e2p
from omnifusion_tpu.projection.spec import build_pers2equi_grids as jax_p2e
from omnifusion_torch.ops.quad_blend import (
    HEAVY_THRESHOLD,
    WIDE_LOAD,
    BlendTables,
    SpreadTables,
    quad_blend,
    quad_blend_plain,
    quad_spread,
    quad_spread_plain,
)
from omnifusion_torch.projection import ProjectionSpec, equi2pers, pers2equi_cf
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from test_torch_port_cuda import straddling_tables  # no JAX there: the card runs that file
from omnifusion_torch.projection.spec import (
    build_equi2pers_grids,
    build_pers2equi_grids,
    build_vjp_tables,
)

SMALL = ((64, 128), (16, 16), (80, 80), 4)
CPU = torch.device("cpu")


@pytest.fixture(scope="module")
def specs():
    return JaxSpec.create(*SMALL), ProjectionSpec.create(*SMALL)


def _cases(specs):
    """(name, port tables, JAX vjp tuple, row stride, channel_last, cot shape)."""
    jspec, spec = specs
    n_erp, n_pers = spec.erp_h * spec.erp_w, spec.n_patches * spec.patch_h * spec.patch_w
    return {
        # the merge's backward: channel-first, K_T = 4 plus an overflow
        "merge": (pers2equi_tables(spec, CPU), jax_p2e(jspec).vjp, spec.patch_w, False,
                  (64, 2, n_erp)),
        # equi2pers's backward: channel-last, K_T = 1 plus an overflow
        "e2p": (equi2pers_tables(spec, CPU), jax_e2p(jspec).vjp, spec.erp_w, True,
                (43, n_pers, 3)),
    }


@pytest.mark.parametrize("case", ["merge", "e2p"])
def test_spread_matches_xla_and_pallas(specs, case):
    tables, vjp, w, channel_last, shape = _cases(specs)[case]
    assert tables.vjp.n_over > 0
    cot = np.random.default_rng(0).random(shape, dtype=np.float32)
    n_in = tables.n_in
    xla = transposed_quad_gather_blend(
        jnp.asarray(cot), *(jnp.asarray(a) for a in vjp), n_in, w, channel_first=not channel_last
    )
    pallas = transposed_quad_gather_blend_pallas(
        jnp.asarray(cot), *vjp, n_in, w, channel_first=not channel_last, interpret=True
    )
    got = quad_spread_plain(torch.from_numpy(cot), tables.vjp, channel_last)
    assert got.dtype == torch.float32 and got.shape == xla.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=1e-5)


def test_spread_wraps_corners_like_the_roll():
    # quads of the last source row, with weight on every corner: corners
    # 01, 10, 11 land past N_in and wrap onto the first pixels
    rng = np.random.default_rng(2)
    n_in, w, n_out, k = 96, 8, 40, 2
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, k)).astype(np.int32)
    w4 = rng.random((n_out, k, 4)).astype(np.float32)
    vjp = build_vjp_tables(idx, w4, n_in)  # K_T = 1: the rest overflows
    assert len(vjp.over_src) > 0
    tables = BlendTables.create(idx, w4, w, n_in, CPU, vjp=vjp)
    cot = rng.random((3, 5, n_out), dtype=np.float32)
    want = transposed_quad_gather_blend(
        jnp.asarray(cot), *(jnp.asarray(getattr(vjp, f)) for f in
                            ("idx_t", "w_t", "over_src", "over_dst", "over_w")),
        n_in, w, channel_first=True,
    )
    got = quad_spread_plain(torch.from_numpy(cot), tables.vjp)
    assert got[..., : w + 1].abs().sum() > 0
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


@pytest.mark.parametrize("case", ["merge", "e2p"])
def test_spread_is_the_adjoint(specs, case):
    # <W x, y> = <x, W^T y>
    tables, _, _, channel_last, shape = _cases(specs)[case]
    g = torch.Generator().manual_seed(1)
    b, c = shape[0] // 8, shape[2] if channel_last else shape[1]
    x_shape = (b, tables.n_in, c) if channel_last else (b, c, tables.n_in)
    y_shape = (b, tables.n_out, c) if channel_last else (b, c, tables.n_out)
    x, y = torch.rand(x_shape, generator=g, dtype=torch.float64), torch.rand(y_shape, generator=g)
    lhs = (quad_blend_plain(x, tables, channel_last).double() * y).sum()
    rhs = (x * quad_spread_plain(y, tables.vjp, channel_last).double()).sum()
    torch.testing.assert_close(lhs, rhs, rtol=1e-6, atol=0)


def _jax_grad(fn, x, r):
    return np.asarray(jax.grad(lambda v: jnp.sum(fn(v).astype(jnp.float32) * r))(jnp.asarray(x)))


def graph_ops(t: torch.Tensor) -> set:
    """Names of the autograd nodes behind ``t``."""
    seen, stack = set(), [t.grad_fn]
    while stack:
        f = stack.pop()
        if f is not None and f not in seen:
            seen.add(f)
            stack.extend(n for n, _ in f.next_functions)
    return {type(f).__name__ for f in seen}


def _port_grad(fn, x, r):
    xt = torch.from_numpy(x).requires_grad_()
    out = fn(xt)
    # the gradient comes from the Function's backward, never from autograd
    # differentiating the plain version's gathers and index_add_
    ops = graph_ops(out)
    assert "_QuadBlendBackward" in ops and not ops & {"IndexBackward0", "IndexAddBackward0"}, ops
    before = quad_spread.launches
    (out.float() * torch.from_numpy(r)).sum().backward()
    assert quad_spread.launches == before  # the plain version on the CPU
    return xt.grad


def test_equi2pers_grad_matches_jax_pallas_full(specs):
    jspec, spec = specs
    rng = np.random.default_rng(3)
    erp = rng.random((43, spec.erp_h, spec.erp_w, 3), dtype=np.float32)  # D = 129: the Pallas path
    r = rng.random((43, spec.n_patches, 16, 16, 3), dtype=np.float32)
    want = _jax_grad(lambda v: jax_ops.equi2pers(v, jax_e2p(jspec), impl="pallas_full"), erp, r)
    got = _port_grad(lambda v: equi2pers(v, build_equi2pers_grids(spec)), erp, r)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)


@pytest.mark.parametrize("dtype", [np.float32, np.float16])
def test_pers2equi_grad_matches_jax_pallas_full(specs, dtype):
    jspec, spec = specs
    rng = np.random.default_rng(4)
    pers = rng.random((64, 2, spec.n_patches * 256), dtype=np.float32).astype(dtype)  # D = 128
    r = rng.random((64, 2, spec.erp_h, spec.erp_w), dtype=np.float32)
    want = _jax_grad(lambda v: jax_ops.pers2equi_cf(v, jax_p2e(jspec), impl="pallas_full"), pers, r)
    got = _port_grad(lambda v: pers2equi_cf(v, build_pers2equi_grids(spec)), pers, r)
    # the gradient comes back in the source's dtype, as _with_table_vjp casts it
    assert got.dtype == torch.from_numpy(pers).dtype and want.dtype == pers.dtype
    tol = 1e-5 if dtype == np.float32 else 2e-3  # f16: one rounding of values up to ~4
    np.testing.assert_allclose(got.float().numpy(), want.astype(np.float32), atol=tol, rtol=tol)


def test_backward_needs_transposed_tables():
    rng = np.random.default_rng(5)
    idx = rng.integers(0, 90, size=(12, 1)).astype(np.int32)
    tables = BlendTables.create(idx, rng.random((12, 1, 4)).astype(np.float32), 8, 96, CPU)
    x = torch.rand(1, 2, 96, requires_grad=True)
    with pytest.raises(RuntimeError, match="transposed"):
        quad_blend(x, tables).sum().backward()


def test_spread_wrapper_refuses_other_devices(specs):
    tables = _cases(specs)["merge"][0]
    with pytest.raises(ValueError, match="cuda or cpu"):
        quad_spread(torch.empty(1, 2, tables.n_out, device="meta"), tables.vjp)


def _walk_visits(t, heavy: np.ndarray, row_stride: int, threshold: int):
    """How often csrc/quad_spread.cu's two kernels read each (overflow entry,
    corner): corner q of entry m (keyed at j) is read by the thread of pixel
    i = (j + off_q) mod N_in, in the light kernel when i's four segments
    (from over_ptr, as the kernel reads them) hold at most ``threshold``
    entries, and in the heavy kernel when i is on the heavy list."""
    n_in = len(t.over_ptr) - 1
    ptr = t.over_ptr.astype(np.int64)
    load = sum(ptr[(np.arange(n_in) - off) % n_in + 1] - ptr[(np.arange(n_in) - off) % n_in]
               for off in (0, 1, row_stride, row_stride + 1))
    on_heavy = np.zeros(n_in, bool)
    on_heavy[heavy] = True
    dst = t.over_dst.astype(np.int64)
    visits = np.zeros((len(dst), 4), np.int64)
    for q, off in enumerate((0, 1, row_stride, row_stride + 1)):
        i = (dst + off) % n_in
        visits[:, q] = (load[i] <= threshold).astype(np.int64) + on_heavy[i]
    return visits


@pytest.mark.parametrize("case", ["merge_small", "straddling"])
def test_heavy_list_is_the_pixels_above_the_threshold(specs, case):
    if case == "merge_small":
        spec = specs[1]
        t, w = build_pers2equi_grids(spec).vjp, spec.patch_w
        loads = {}
    else:
        w = 64
        t, loads = straddling_tables(HEAVY_THRESHOLD, w)
    tables = SpreadTables.create(t, w, 4096, CPU)
    # each pixel's load counted from the overflow's destinations, not over_ptr
    n_in = t.idx_t.shape[0]
    per_dst = np.bincount(t.over_dst, minlength=n_in)
    load = sum(np.roll(per_dst, off) for off in (0, 1, w, w + 1))
    for i, n in loads.items():
        assert load[i] == n, (i, load[i], n)
    heavy = tables.heavy.numpy()
    assert heavy.dtype == np.int32 and tables.threshold == HEAVY_THRESHOLD
    # the pixels above the threshold, heaviest first; the first n_wide above
    # WIDE_LOAD
    np.testing.assert_array_equal(np.sort(heavy), np.flatnonzero(load > HEAVY_THRESHOLD))
    assert (np.diff(load[heavy]) <= 0).all()
    assert tables.n_wide == (load > WIDE_LOAD).sum()
    assert (load[heavy[: tables.n_wide]] > WIDE_LOAD).all()
    assert 0 < len(heavy) < n_in
    if case == "straddling":
        assert {i for i, n in loads.items() if n > HEAVY_THRESHOLD} <= set(heavy.tolist())
        assert not {i for i, n in loads.items() if n <= HEAVY_THRESHOLD} & set(heavy.tolist())
        assert {0, w - 1, w} <= set(heavy.tolist())  # the wrapped corners of the last pixel
    # the light and the heavy walk read every (entry, corner) once between them
    visits = _walk_visits(t, heavy, w, HEAVY_THRESHOLD)
    assert visits.shape == (len(t.over_src), 4) and (visits == 1).all()


def test_spread_tables_without_overflow_have_an_empty_heavy_list(specs):
    rng = np.random.default_rng(8)
    idx = rng.permutation(90)[:12, None].astype(np.int32)  # one quad per source pixel
    w4 = rng.random((12, 1, 4)).astype(np.float32)
    t = build_vjp_tables(idx, w4, 96)
    assert len(t.over_src) == 0
    tables = SpreadTables.create(t, 8, 12, CPU)
    assert tables.heavy.numel() == 0 and tables.over_ptr is None
    # the direct constructor (no overflow) still builds
    assert SpreadTables(tables.idx_t, tables.w_t, 8, 12).heavy is None


def test_spread_straddling_tables_match_xla():
    t, _ = straddling_tables(HEAVY_THRESHOLD)
    tables = SpreadTables.create(t, 64, 4096, CPU)
    cot = np.random.default_rng(9).random((2, 3, 4096), dtype=np.float32)
    want = transposed_quad_gather_blend(
        jnp.asarray(cot), *(jnp.asarray(getattr(t, f)) for f in
                            ("idx_t", "w_t", "over_src", "over_dst", "over_w")),
        tables.n_in, 64, channel_first=True,
    )
    got = quad_spread_plain(torch.from_numpy(cot), tables)
    # sums of up to 5,000 products of values in [0, 1): f32 rounding
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-5)
