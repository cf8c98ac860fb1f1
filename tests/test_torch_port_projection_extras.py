"""The rest of the projection layer against the JAX package on the CPU:
geometry/sphere.py, the perspective views (extract_views, insert_views:
their tables, forward and VJP), channel-last pers2equi, equi2pers_full,
project and unproject.

Both packages build the same tables in float64 numpy, so the tables must be
equal bit for bit; the blends then differ by f32 summation order only (the
port's plain version sums the four corners in f32, XLA's einsum in its own
order): 4 products of inputs in [0, 1) with weights summing to at most 1,
so atol 1e-6. A VJP sums up to several hundred such products per source
pixel at the poles' borders: atol 1e-5 there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import omnifusion_tpu.geometry.sphere as jax_sphere
import omnifusion_tpu.projection.perspective as jax_perspective
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import ops as jax_ops
from omnifusion_torch.geometry import sphere
from omnifusion_torch.ops import quad_blend as qb
from omnifusion_torch.ops.quad_blend import BlendTables, tile_tables
from omnifusion_torch.projection import (
    PatchProjection,
    ProjectionSpec,
    build_equi2pers_grids,
    build_pers2equi_grids,
    equi2pers,
    equi2pers_full,
    extract_views,
    insert_views,
    pers2equi,
    pers2equi_cf,
    project,
    unproject,
)
from omnifusion_torch.projection import perspective

ERP = (64, 128)
BLEND_ATOL, VJP_ATOL = 1e-6, 1e-5
# centres (theta, phi) in degrees: the seam from both sides, both poles, the
# origin, and a few views at once
CENTERS = {
    "seam": ((0.5, 10.0), (359.5, -20.0)),
    "poles": ((30.0, 89.0), (200.0, -88.5)),
    "origin": ((0.0, 0.0),),
    "mixed": ((90.0, 45.0), (180.0, 0.0), (270.0, -60.0)),
}
FOVS = {"fov90": (90.0, 90.0), "fov60x100": (60.0, 100.0)}


def test_sphere_matches_jax():
    rng = np.random.default_rng(0)
    coords = rng.random((5, 7, 2)) * np.array([128.0, 64.0])
    np.testing.assert_array_equal(sphere.coords2uv_np(coords, 128, 64),
                                  jax_sphere.coords2uv_np(coords, 128, 64))
    uv = sphere.coords2uv_np(coords, 128, 64)
    np.testing.assert_array_equal(sphere.uv2xyz_np(uv), jax_sphere.uv2xyz_np(uv))
    np.testing.assert_array_equal(sphere.create_image_grid(16, 8), jax_sphere.create_image_grid(16, 8))
    sgrid = sphere.create_spherical_grid(16)
    np.testing.assert_array_equal(sgrid, jax_sphere.create_spherical_grid(16))
    xyz = rng.standard_normal((4, 9, 3)).astype(np.float32)
    xyz[0, 0] = 0.0  # degenerate: the NaN is zeroed on both sides
    xyz[1, :3, :2] = 0.0  # on the axis
    depth = rng.random((8, 16)).astype(np.float32)
    t = lambda a: torch.from_numpy(np.asarray(a, np.float32))  # noqa: E731
    j = lambda a: jnp.asarray(np.asarray(a, np.float32))  # noqa: E731
    pairs = [
        (sphere.coords2uv(t(coords), 128, 64), jax_sphere.coords2uv(j(coords), 128, 64)),
        (sphere.uv2xyz(t(uv)), jax_sphere.uv2xyz(j(uv))),
        (sphere.xyz2uv(t(xyz)), jax_sphere.xyz2uv(j(xyz))),
        (sphere.uv2coords(t(uv), 128, 64), jax_sphere.uv2coords(j(uv), 128, 64)),
        (sphere.spherical_confidence(t(sgrid), 0.1, 0.9),
         jax_sphere.spherical_confidence(j(sgrid), 0.1, 0.9)),
        (sphere.coords_3d(t(sgrid), t(depth)), jax_sphere.coords_3d(j(sgrid), j(depth))),
    ]
    for ours, theirs in pairs:
        assert ours.dtype == torch.float32 and torch.isfinite(ours).all()
        # f32 transcendental functions of two libraries: a few ulps
        np.testing.assert_allclose(ours.numpy(), np.asarray(theirs), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("fov", list(FOVS.values()), ids=list(FOVS))
@pytest.mark.parametrize("centers", list(CENTERS.values()), ids=list(CENTERS))
def test_perspective_views_match_jax(centers, fov):
    size = (12, 20)
    rng = np.random.default_rng(0)
    erp = rng.random((2, *ERP, 3), dtype=np.float32)
    # the tables, bit for bit
    idx, w4 = perspective.perspective_arrays(centers, fov, size, ERP)
    jidx, jw4 = jax_perspective._perspective_tables(centers, fov, size, ERP)
    np.testing.assert_array_equal(idx, jidx)
    np.testing.assert_array_equal(w4, jw4)
    iidx, iw4, mask = perspective.inverse_perspective_arrays(centers, fov, size, ERP)
    for ours, theirs in zip((iidx, iw4, mask),
                            jax_perspective._inverse_perspective_tables(centers, fov, size, ERP)):
        np.testing.assert_array_equal(ours, theirs)

    # extract_views: forward and VJP
    x = torch.from_numpy(erp).requires_grad_()
    views = extract_views(x, centers, fov, size)
    jviews, jvjp = jax.vjp(lambda e: jax_perspective.extract_views(e, centers, fov, size),
                           jnp.asarray(erp))
    assert views.shape == jviews.shape == (2, len(centers), *size, 3)
    np.testing.assert_allclose(views.detach().numpy(), np.asarray(jviews), atol=BLEND_ATOL)
    cot = rng.random(views.shape, dtype=np.float32)
    views.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(x.grad.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]),
                               atol=VJP_ATOL)

    # insert_views: forward, mask and VJP, on the views just extracted
    v = views.detach().clone().requires_grad_()
    equi, m = insert_views(v, centers, fov, ERP)
    (jequi, jmask), jvjp = jax.vjp(
        lambda s: jax_perspective.insert_views(s, centers, fov, ERP), jnp.asarray(v.detach()))
    assert equi.shape == jequi.shape == (2, len(centers), *ERP, 3)
    assert m.shape == (len(centers), *ERP, 1) and m.dtype == torch.float32
    np.testing.assert_array_equal(m.numpy(), np.asarray(jmask))
    assert 0 < m.mean() < 1
    np.testing.assert_allclose(equi.detach().numpy(), np.asarray(jequi), atol=BLEND_ATOL)
    cot = rng.random(equi.shape, dtype=np.float32)
    equi.backward(torch.from_numpy(cot))
    jg = jvjp((jnp.asarray(cot), jnp.zeros_like(jmask)))[0]
    np.testing.assert_allclose(v.grad.numpy(), np.asarray(jg), atol=VJP_ATOL)


def test_views_keep_a_16_bit_dtype():
    # the blend's f32 sums rounded once to the source's dtype (the kernel's
    # store), as equi2pers stores the ERP's dtype
    erp = torch.from_numpy(np.random.default_rng(1).random((1, *ERP, 3), dtype=np.float32))
    centers, fov = CENTERS["mixed"], FOVS["fov90"]
    views = extract_views(erp.bfloat16(), centers, fov, (12, 20))
    assert views.dtype == torch.bfloat16
    want = extract_views(erp.bfloat16().float(), centers, fov, (12, 20)).bfloat16()
    assert torch.equal(views, want)
    equi, _ = insert_views(views.half(), centers, fov, ERP)
    assert equi.dtype == torch.float16


@pytest.mark.parametrize("centers", [((0.0, 89.5),), ((180.0, -89.5),), ((359.9, 0.0),),
                                     ((0.0, 60.0), (90.0, 0.0), (180.0, -45.0), (270.0, 80.0))],
                         ids=["north", "south", "seam", "four"])
def test_wide_views_build_their_tile_tables(centers):
    # 256x256 views at a 120 degree field of view from 512x1024, near a pole
    # and on the seam: every tile's staged footprint fits the kernel's int16
    # corner offsets, forward and inverse, and the transposed tables build
    fov, size, erp = (120.0, 120.0), (256, 256), (512, 1024)
    idx, w4 = perspective.perspective_arrays(centers, fov, size, erp)
    t = BlendTables.create(idx, w4, erp[1], erp[0] * erp[1], "cpu",
                           vjp=perspective.build_vjp_tables(idx, w4, erp[0] * erp[1]),
                           out_w=size[1])
    assert t.tiles.n_tiles > 0 and t.vjp is not None and t.tiles.pitch < 2**15
    iidx, iw4, _ = perspective.inverse_perspective_arrays(centers, fov, size, erp)
    n_in = len(centers) * size[0] * size[1]
    tiles = tile_tables(iidx, size[1], n_in, out_w=erp[1])
    assert tiles["pitch"] < 2**15 and tiles["entries"] == 1


def test_blend_plan_gathers_where_a_staged_unit_cannot_fit():
    # insert_views' tables stage their dense footprint for a few channels;
    # 32 f32 channels do not fit a block's shared memory twice, so the rule
    # gathers from global memory there, and only a call that asks to stage
    # raises (the JAX package's insert_views takes any channel count)
    tables, _ = perspective.inverse_perspective_tables(
        CENTERS["mixed"], FOVS["fov90"], (48, 64), ERP, torch.device("cpu"))
    tiles = tables.tiles
    assert tiles.footprint <= qb.STAGE_MAX_FOOTPRINT
    assert qb.blend_plan(tiles, 2, 3, 4)[0]
    assert 2 * tiles.pitch * 32 * 4 > qb.SMEM_BYTES
    assert qb.blend_plan(tiles, 2, 32, 4) == (False, 1, 1)
    with pytest.raises(ValueError, match="footprint"):
        qb.blend_plan(tiles, 2, 32, 4, staged=True)


def test_channel_last_merge_and_full_projection_match_jax():
    spec, jspec = (cls.create(ERP, 32, (80, 80), 4) for cls in (ProjectionSpec, JaxSpec))
    rng = np.random.default_rng(3)
    erp = rng.random((2, *ERP, 3), dtype=np.float32)

    proj = project(torch.from_numpy(erp), spec)
    jproj = jax_ops.project(jnp.asarray(erp), jspec)
    assert isinstance(proj, PatchProjection)
    for name in PatchProjection._fields:
        ours, theirs = getattr(proj, name), np.asarray(getattr(jproj, name))
        assert ours.shape == theirs.shape and ours.dtype == torch.float32, name
        np.testing.assert_allclose(ours.numpy(), theirs, atol=BLEND_ATOL, err_msg=name)
    full = equi2pers_full(torch.from_numpy(erp), build_equi2pers_grids(spec))
    assert torch.equal(full.pers, equi2pers(torch.from_numpy(erp), build_equi2pers_grids(spec)))

    # channel-last pers2equi and unproject: forward and VJP, and the same
    # map as the channel-first merge
    pers = torch.from_numpy(rng.random((2, spec.n_patches, 32, 32, 5), dtype=np.float32))
    pers.requires_grad_()
    out = pers2equi(pers, build_pers2equi_grids(spec))
    jout, jvjp = jax.vjp(lambda p: jax_ops.pers2equi(p, jax_ops.build_pers2equi_grids(jspec)),
                         jnp.asarray(pers.detach()))
    assert out.shape == jout.shape == (2, *ERP, 5) and out.dtype == torch.float32
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=BLEND_ATOL)
    np.testing.assert_allclose(unproject(pers.detach(), spec).numpy(), np.asarray(jout),
                               atol=BLEND_ATOL)
    cf = pers2equi_cf(pers.detach().permute(0, 4, 1, 2, 3).reshape(2, 5, -1),
                      build_pers2equi_grids(spec))
    torch.testing.assert_close(cf.permute(0, 2, 3, 1), out.detach(), rtol=0, atol=BLEND_ATOL)
    cot = rng.random(out.shape, dtype=np.float32)
    out.backward(torch.from_numpy(cot))
    np.testing.assert_allclose(pers.grad.numpy(), np.asarray(jvjp(jnp.asarray(cot))[0]),
                               atol=VJP_ATOL)
