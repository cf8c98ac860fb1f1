"""The port's projection tables equal the JAX package's array for array.

Configs: the seven of tests/goldens/ (the 512x1024 flagship marked slow).
The port's tables are built fresh here (no cache); the JAX ones may come from
the JAX package's own cache, which its tests hold bit-identical to a build.
"""

import os

import numpy as np
import pytest

from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import spec as jax_spec
from omnifusion_torch.projection import spec as port_spec
from omnifusion_torch.projection import table_cache

CONFIGS = [
    pytest.param((128, 256), 32, 52, 4, id="128x256_p32_f52_n4"),
    pytest.param((128, 256), 32, 80, 3, id="128x256_p32_f80_n3"),
    pytest.param((128, 256), 32, 80, 4, id="128x256_p32_f80_n4"),
    pytest.param((128, 256), 32, 80, 5, id="128x256_p32_f80_n5"),
    pytest.param((128, 256), 32, 80, 6, id="128x256_p32_f80_n6"),
    pytest.param((256, 512), 64, 80, 4, id="256x512_p64_f80_n4"),
    pytest.param((512, 1024), 128, 80, 4, id="512x1024_p128_f80_n4", marks=pytest.mark.slow),
]


@pytest.mark.parametrize("erp,patch,fov,nrows", CONFIGS)
def test_tables_equal_jax(erp, patch, fov, nrows):
    spec = port_spec.ProjectionSpec.create(erp, patch, (fov, fov), nrows)
    jspec = JaxSpec.create(erp, patch, (fov, fov), nrows)
    assert repr(spec) == repr(jspec)

    je = jax_spec.build_equi2pers_grids(jspec)
    pe = port_spec._build_equi2pers_grids(spec)
    for name in ("idx", "w4", "xyz", "uv", "centers"):
        np.testing.assert_array_equal(getattr(pe, name), np.asarray(getattr(je, name)), err_msg=name)
        assert getattr(pe, name).dtype == np.asarray(getattr(je, name)).dtype, name
    np.testing.assert_array_equal(pe.centers, spec.centers_normalized().astype(np.float32))

    jp = jax_spec.build_pers2equi_grids(jspec)
    pp = port_spec._build_pers2equi_grids(spec)
    np.testing.assert_array_equal(pp.idx, np.asarray(jp.idx))
    np.testing.assert_array_equal(pp.w4, np.asarray(jp.w4))
    assert (pp.capped is None) == (jp.capped is None)
    if pp.capped is None:
        return
    c = pp.capped
    for name, want in zip(("idx", "w4", "tail_pix", "tail_idx", "tail_w"), jp.capped):
        np.testing.assert_array_equal(getattr(c, name), np.asarray(want), err_msg=name)
        assert getattr(c, name).dtype == np.asarray(want).dtype, name
    # CSR pointers over the sorted tail: entry m belongs to pixel n exactly
    # when tail_ptr[n] <= m < tail_ptr[n+1]
    n_out = spec.erp_h * spec.erp_w
    assert c.tail_ptr.shape == (n_out + 1,) and c.tail_ptr[0] == 0
    assert c.tail_ptr[-1] == len(c.tail_pix)
    assert np.all(np.diff(c.tail_pix) >= 0)
    np.testing.assert_array_equal(
        np.repeat(np.arange(n_out), np.diff(c.tail_ptr)), c.tail_pix
    )


def test_table_cache_roundtrip(tmp_path, monkeypatch):
    # a cached load equals a fresh build, in the port's own cache directory
    monkeypatch.setenv("OMNIFUSION_TORCH_TABLE_CACHE", str(tmp_path))
    spec = port_spec.ProjectionSpec.create((64, 128), 16, (80, 80), 4)
    fresh_e = port_spec._build_equi2pers_grids(spec)
    fresh_p = port_spec._build_pers2equi_grids(spec)
    port_spec.build_equi2pers_grids.cache_clear()
    port_spec.build_pers2equi_grids.cache_clear()
    try:
        port_spec.build_equi2pers_grids(spec)  # builds and saves
        port_spec.build_pers2equi_grids(spec)
        assert len(list(tmp_path.glob("*.npz"))) == 2
        port_spec.build_equi2pers_grids.cache_clear()
        port_spec.build_pers2equi_grids.cache_clear()
        assert table_cache.load("e2p", spec) is not None
        e = port_spec.build_equi2pers_grids(spec)  # loads
        p = port_spec.build_pers2equi_grids(spec)
    finally:
        port_spec.build_equi2pers_grids.cache_clear()
        port_spec.build_pers2equi_grids.cache_clear()
    for name in ("idx", "w4", "xyz", "uv", "centers"):
        np.testing.assert_array_equal(getattr(e, name), getattr(fresh_e, name))
    np.testing.assert_array_equal(p.idx, fresh_p.idx)
    np.testing.assert_array_equal(p.w4, fresh_p.w4)
    for name in ("idx", "w4", "tail_pix", "tail_idx", "tail_w", "tail_ptr"):
        np.testing.assert_array_equal(getattr(p.capped, name), getattr(fresh_p.capped, name))


def test_spec_refuses_unported_layouts():
    # both layouts of the JAX spec are ported: what it refuses is a uniform
    # layout it cannot build, and the rings spec's repr (the cache key) is
    # the one it had before the uniform layout came
    spec = port_spec.ProjectionSpec.create((64, 128), 16, (80, 80), 4)
    assert spec.layout == "rings"
    assert repr(spec) == (
        "ProjectionSpec(erp_h=64, erp_w=128, patch_h=16, patch_w=16, fov_h=80.0, "
        "fov_w=80.0, nrows=4, layout='rings')"
    )
    assert port_spec.ProjectionSpec(64, 128, 16, 16, 80.0, 80.0, 4, layout="uniform:3x6").n_patches == 18
    for layout in ("uniform:3", "uniform", "uniform:3x6x2", "uniform:ax6", "uniform:0x6"):
        with pytest.raises(ValueError, match="uniform"):
            port_spec.ProjectionSpec(64, 128, 16, 16, 80.0, 80.0, 4, layout=layout)


def test_cache_dir_is_the_ports_own(monkeypatch):
    # sharing the JAX package's directory would let one package load the
    # other's tables, and test_tables_equal_jax compare a package with itself
    from omnifusion_tpu.projection import table_cache as jax_table_cache

    monkeypatch.delenv("OMNIFUSION_TORCH_TABLE_CACHE", raising=False)
    monkeypatch.delenv("OMNIFUSION_TABLE_CACHE", raising=False)
    assert os.path.basename(table_cache.cache_dir()) == ".table_cache_torch"
    assert table_cache.cache_dir() != jax_table_cache.cache_dir()
