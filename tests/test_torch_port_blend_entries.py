"""Pixels that hold more quads than the blend kernel keeps in registers.

csrc/quad_blend.cu keeps a pixel's first MAX_ENTRIES quads (K slots, then
its CSR tail) in registers and walks the rest from global memory. The
merge at 512x1024, patch 128, nrows 6, fov 90 holds 9 on some pixels (the
JAX package serves that configuration from the same capped tables). Here,
on the CPU: the port's tables there, and a synthetic table with 20 quads
in one pixel, through quad_blend_plain and the torch emulation of the
staged kernel (tests/test_torch_port_blend_tiles.py), held against the JAX
package's XLA blend on the same tables. The kernel itself is held to
quad_blend_plain on the card (tests/test_torch_port_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.ops.sparse_blend import capped_quad_gather_blend
from omnifusion_torch.ops import quad_blend as qb
from omnifusion_torch.ops.quad_blend import quad_blend_plain, tile_tables
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import pers2equi_tables

from test_torch_port_blend_tiles import TOL, arrays, check_tiles, staged_blend
from test_torch_port_cuda import many_entries_tables

CPU = torch.device("cpu")


def jax_blend(x: np.ndarray, t) -> np.ndarray:
    """The JAX package's XLA blend of a channel-first source through the
    port's tables."""
    a = {k: v.numpy() for k, v in (("idx", t.idx), ("w4", t.w4), ("tail_pix", t.tail_pix),
                                   ("tail_idx", t.tail_idx), ("tail_w", t.tail_w))}
    return np.asarray(capped_quad_gather_blend(
        jnp.asarray(x), a["idx"], a["w4"], a["tail_pix"], a["tail_idx"], a["tail_w"],
        t.row_stride, channel_first=True))


def test_nine_quads_per_pixel_at_nrows_6_fov_90():
    spec = ProjectionSpec.create((512, 1024), 128, (90, 90), 6)
    t = pers2equi_tables(spec, CPU)
    assert t.tiles.entries == 9 > qb.MAX_ENTRIES
    # the plan gathers from global memory there (footprint above 2 staged
    # pixels per output); the staged path is the sweep's
    assert t.tiles.footprint > qb.STAGE_MAX_FOOTPRINT
    assert not qb.blend_plan(t.tiles, 4, 1, 2)[0]
    x = np.random.default_rng(0).random((2, 2, t.n_in), dtype=np.float32)
    got = quad_blend_plain(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), jax_blend(x, t), rtol=0, atol=TOL)
    # the staged kernel's reading of its tile tables, 9-quad pixels included
    emu = staged_blend(torch.from_numpy(x[:1]), t, False, 2)
    np.testing.assert_allclose(emu.numpy(), got[:1].numpy(), rtol=0, atol=TOL)


def test_twenty_quads_in_one_pixel():
    t = many_entries_tables(CPU)
    a = arrays(t)
    for shape in ((8, 32), (4, 32)):
        tt = tile_tables(**a, out_w=50, shape=shape)
        assert tt["entries"] == 20
        check_tiles(a, tt, 50, shape)
    rng = np.random.default_rng(1)
    x = rng.random((3, 2, t.n_in), dtype=np.float32)
    got = quad_blend_plain(torch.from_numpy(x), t)
    np.testing.assert_allclose(got.numpy(), jax_blend(x, t), rtol=0, atol=TOL)
    for chunk in (1, 4):
        np.testing.assert_allclose(staged_blend(torch.from_numpy(x), t, False, chunk).numpy(),
                                   got.numpy(), rtol=0, atol=TOL)
    # channel-last with one channel, the iterative model's feedback layout
    x1 = torch.from_numpy(rng.random((5, t.n_in, 1), dtype=np.float32))
    want = quad_blend_plain(x1.permute(0, 2, 1).contiguous(), t).permute(0, 2, 1)
    torch.testing.assert_close(quad_blend_plain(x1, t, channel_last=True), want, rtol=0, atol=0)
    torch.testing.assert_close(staged_blend(x1, t, True, 2), want, rtol=0, atol=TOL)


class _Launch(Exception):
    pass


@pytest.mark.parametrize("entries", [8, 9, 16, 17])
def test_kernel_takes_any_count_of_quads(monkeypatch, entries):
    # the wrapper refuses no table for its quads per pixel: every check
    # before the launch passes, staged or not
    def launch():
        raise _Launch

    monkeypatch.setattr(qb._build, "library", launch)
    t = many_entries_tables(CPU, heavy=entries - 2)
    assert t.tiles.entries == entries
    for staged in (True, False):
        with pytest.raises(_Launch):
            qb._blend_kernel(torch.rand(1, 2, t.n_in), t, False, staged=staged)
