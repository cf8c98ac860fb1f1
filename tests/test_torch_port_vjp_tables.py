"""The port's transposed (backward) tables equal the JAX builder's arrays.

Configs: the seven of tests/goldens/ (the 512x1024 flagship marked slow), as
tests/test_torch_port_tables.py holds the forward tables. The port also
carries CSR row pointers over the overflow, which the JAX package does not.
"""

import numpy as np
import pytest

from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection import spec as jax_spec
from omnifusion_torch.projection import spec as port_spec

from test_torch_port_tables import CONFIGS

FIELDS = ("idx_t", "w_t", "over_src", "over_dst", "over_w")  # the JAX tuple's order


def _check_ptr(t, n_in):
    # entry m is source pixel j's exactly when over_ptr[j] <= m < over_ptr[j+1]
    assert t.over_ptr.shape == (n_in + 1,) and t.over_ptr.dtype == np.int32
    assert t.over_ptr[0] == 0 and t.over_ptr[-1] == len(t.over_dst)
    assert np.all(np.diff(t.over_dst) >= 0)
    np.testing.assert_array_equal(np.repeat(np.arange(n_in), np.diff(t.over_ptr)), t.over_dst)


@pytest.mark.parametrize("erp,patch,fov,nrows", CONFIGS)
def test_vjp_tables_equal_jax(erp, patch, fov, nrows):
    spec = port_spec.ProjectionSpec.create(erp, patch, (fov, fov), nrows)
    jspec = JaxSpec.create(erp, patch, (fov, fov), nrows)
    n_erp = spec.erp_h * spec.erp_w
    n_pers = spec.n_patches * spec.patch_h * spec.patch_w
    for ours, theirs, n_in in (
        (port_spec._build_equi2pers_grids(spec).vjp, jax_spec.build_equi2pers_grids(jspec).vjp, n_erp),
        (port_spec._build_pers2equi_grids(spec).vjp, jax_spec.build_pers2equi_grids(jspec).vjp, n_pers),
    ):
        for name, want in zip(FIELDS, theirs):
            want = np.asarray(want)
            np.testing.assert_array_equal(getattr(ours, name), want, err_msg=name)
            assert getattr(ours, name).dtype == want.dtype, name
        _check_ptr(ours, n_in)


def test_vjp_tables_survive_the_cache(tmp_path, monkeypatch):
    monkeypatch.setenv("OMNIFUSION_TORCH_TABLE_CACHE", str(tmp_path))
    spec = port_spec.ProjectionSpec.create((64, 128), 16, (80, 80), 4)
    fresh = port_spec._build_pers2equi_grids(spec).vjp, port_spec._build_equi2pers_grids(spec).vjp
    builders = port_spec.build_pers2equi_grids, port_spec.build_equi2pers_grids
    for b in builders:
        b.cache_clear()
    try:
        for b in builders:
            b(spec)  # builds and saves
            b.cache_clear()
        loaded = tuple(b(spec).vjp for b in builders)  # loads
    finally:
        for b in builders:
            b.cache_clear()
    assert len(list(tmp_path.glob("*.npz"))) == 2
    for ours, want in zip(loaded, fresh):
        for name in FIELDS + ("over_ptr",):
            np.testing.assert_array_equal(getattr(ours, name), getattr(want, name), err_msg=name)
