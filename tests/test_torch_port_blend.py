"""The port's quad gather-blend (plain version) vs the JAX package.

The plain version is what the wrapper runs on a CPU tensor and what the CUDA
kernel is held against on the card (chip_smoke.py). Here it is held against
the Pallas kernel in interpret mode and the XLA paths, on the same tables
and the same numpy inputs, as tests/test_pallas_blend.py holds the kernel.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.ops.pallas_blend import quad_gather_blend_pallas, quad_gather_blend_pallas_cl
from omnifusion_tpu.ops.sparse_blend import capped_quad_gather_blend, quad_gather_blend
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import ops as jax_ops
from omnifusion_tpu.projection.spec import build_equi2pers_grids as jax_e2p
from omnifusion_tpu.projection.spec import build_pers2equi_grids as jax_p2e
from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend, quad_blend_plain
from omnifusion_torch.projection import ProjectionSpec, equi2pers, pers2equi_cf
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import build_equi2pers_grids, build_pers2equi_grids

SMALL = ((64, 128), (16, 16), (80, 80), 4)


@pytest.fixture(scope="module")
def specs():
    return JaxSpec.create(*SMALL), ProjectionSpec.create(*SMALL)


def test_merge_f32_matches_pallas_and_xla(specs):
    jspec, spec = specs
    ic, wc, tp, ti, tw = jax_p2e(jspec).capped
    n_in = spec.n_patches * spec.patch_h * spec.patch_w
    x = np.random.default_rng(0).random((64, 2, n_in), dtype=np.float32)  # D = 64*2
    pallas = quad_gather_blend_pallas(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w, interpret=True)
    xla = capped_quad_gather_blend(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w, channel_first=True)
    got = quad_blend_plain(torch.from_numpy(x), pers2equi_tables(spec, torch.device("cpu")))
    assert got.dtype == torch.float32 and got.shape == pallas.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=2e-6)


def test_merge_f16_matches_pallas(specs):
    # f16 source, f32 accumulator out (the Pallas convention). The tolerance
    # is the one tests/test_pallas_blend.py:76-86 gives the kernel: the XLA
    # reference rounds its accumulation through f16.
    jspec, spec = specs
    ic, wc, tp, ti, tw = jax_p2e(jspec).capped
    n_in = spec.n_patches * spec.patch_h * spec.patch_w
    rng = np.random.default_rng(5)
    vals = (rng.random((64, 2, n_in)) - 0.25) * 8.0
    vals[0, 0, : n_in // 4] = rng.random(n_in // 4) * 5e-5  # f16 subnormals
    x = vals.astype(np.float16)
    pallas = quad_gather_blend_pallas(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w, interpret=True)
    xla = capped_quad_gather_blend(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w, channel_first=True)
    got = quad_blend_plain(torch.from_numpy(x), pers2equi_tables(spec, torch.device("cpu")))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(
        got.numpy(), np.asarray(xla, dtype=np.float32), rtol=2e-3, atol=2e-3
    )


def test_e2p_channel_last_matches_pallas_and_xla(specs):
    jspec, spec = specs
    g = jax_e2p(jspec)
    n_erp = spec.erp_h * spec.erp_w
    x = np.random.default_rng(1).random((43, n_erp, 3), dtype=np.float32)  # D = 43*3
    pallas = quad_gather_blend_pallas_cl(jnp.asarray(x), g.idx, g.w4, spec.erp_w, interpret=True)
    xla = quad_gather_blend(jnp.asarray(x), g.idx, g.w4, spec.erp_w)
    got = quad_blend_plain(
        torch.from_numpy(x), equi2pers_tables(spec, torch.device("cpu")), channel_last=True
    )
    assert got.shape == pallas.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(pallas), atol=2e-6)
    np.testing.assert_allclose(got.numpy(), np.asarray(xla), atol=2e-6)


def test_wrapped_corners_match_the_roll():
    # Corners idx+1, idx+W, idx+W+1 of the last source row point past N_in.
    # The JAX path reads them through jnp.roll, i.e. modulo N_in; give them
    # nonzero weight so that any other reading shows.
    rng = np.random.default_rng(2)
    n_in, w, n_out, k = 96, 8, 40, 2
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, k)).astype(np.int32)
    w4 = rng.random((n_out, k, 4)).astype(np.float32)
    x = rng.random((3, 5, n_in), dtype=np.float32)
    want = quad_gather_blend(jnp.asarray(x), idx, w4, w, channel_first=True)
    got = quad_blend_plain(torch.from_numpy(x), BlendTables.create(idx, w4, w, n_in, "cpu"))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_public_ops_match_jax(specs):
    jspec, spec = specs
    rng = np.random.default_rng(4)
    erp = rng.random((2, spec.erp_h, spec.erp_w, 3), dtype=np.float32)
    want = jax_ops.equi2pers(jnp.asarray(erp), jax_e2p(jspec), impl="pallas")
    got = equi2pers(torch.from_numpy(erp), build_equi2pers_grids(spec))
    assert tuple(got.shape) == want.shape == (2, spec.n_patches, 16, 16, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)

    pers = rng.random((2, 2, spec.n_patches * 16 * 16), dtype=np.float32)
    want = jax_ops.pers2equi_cf(jnp.asarray(pers), jax_p2e(jspec), impl="pallas")
    got = pers2equi_cf(torch.from_numpy(pers), build_pers2equi_grids(spec))
    assert tuple(got.shape) == want.shape == (2, 2, spec.erp_h, spec.erp_w)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-6)


def test_wrapper_takes_the_plain_version_only_on_cpu(specs):
    _, spec = specs
    tables = pers2equi_tables(spec, torch.device("cpu"))
    x = torch.rand(2, 2, tables.n_in)
    before = quad_blend.launches
    torch.testing.assert_close(quad_blend(x, tables), quad_blend_plain(x, tables), rtol=0, atol=0)
    assert quad_blend.launches == before  # no kernel launched on the CPU
    with pytest.raises(ValueError, match="cuda or cpu"):
        quad_blend(torch.empty(2, 2, tables.n_in, device="meta"), tables)
