"""The tile tables of the quad gather-blend kernel, on the CPU.

csrc/quad_blend.cu blends one tile of output pixels per block, staging the
tile's source footprint (the GROUP-pixel groups its corners touch) in shared
memory and reading every corner at its local place there. The tables that
say where are built on the host (ops/quad_blend.py: tile_tables). Here they
are checked against an independent numpy computation of every corner's
pixel, and a torch emulation of the staged blend (the footprints gathered
into buffers, the corners read from the buffers, a chunk of rows at a time)
is held against quad_blend_plain and the JAX package's Pallas kernel
(interpret mode) and XLA paths.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from omnifusion_tpu.ops.pallas_blend import quad_gather_blend_pallas, quad_gather_blend_pallas_cl
from omnifusion_tpu.ops.sparse_blend import capped_quad_gather_blend, quad_gather_blend
from omnifusion_tpu.projection import ProjectionSpec as JaxSpec
from omnifusion_tpu.projection.spec import build_equi2pers_grids as jax_e2p
from omnifusion_tpu.projection.spec import build_pers2equi_grids as jax_p2e
from omnifusion_torch.ops import quad_blend as qb
from omnifusion_torch.ops.quad_blend import (
    GROUP,
    MAX_ENTRIES,
    BlendTables,
    blend_plan,
    quad_blend,
    quad_blend_plain,
    tile_tables,
)
from omnifusion_torch.projection import ProjectionSpec, equi2pers
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables
from omnifusion_torch.projection.spec import build_equi2pers_grids

CPU = torch.device("cpu")
SMALL = ((64, 128), (16, 16), (80, 80), 4)
# the f32 sums of the emulation and the plain version: the same products in
# another order (4K + 4 * tail terms of inputs in [0, 1), weights <= 1)
TOL = 2e-6


def wrap_tables(n_out: int = 1000, seed: int = 2) -> BlendTables:
    """Random quads whose corners wrap past N_in (idx in the last two source
    rows), with a one-entry tail on every pixel at the last source pixel;
    n_out is no multiple of the tile, so the last tiles are ragged."""
    rng = np.random.default_rng(seed)
    n_in, w = 96, 8
    idx = rng.integers(n_in - 2 * w, n_in, size=(n_out, 2)).astype(np.int32)
    return BlendTables.create(
        idx, rng.random((n_out, 2, 4), dtype=np.float32) / 8, w, n_in, CPU,
        tail_ptr=np.arange(n_out + 1, dtype=np.int32), tail_pix=np.arange(n_out, dtype=np.int32),
        tail_idx=np.full(n_out, n_in - 1, np.int32),
        tail_w=rng.random((n_out, 4), dtype=np.float32) / 8, out_w=50,
    )


def small_tables(kind: str) -> BlendTables:
    spec = ProjectionSpec.create(*SMALL)
    return pers2equi_tables(spec, CPU) if kind == "merge" else equi2pers_tables(spec, CPU)


def arrays(t: BlendTables) -> dict:
    np_ = lambda x: None if x is None else x.numpy()  # noqa: E731
    return {"idx": np_(t.idx), "row_stride": t.row_stride, "n_in": t.n_in,
            "tail_ptr": np_(t.tail_ptr), "tail_pix": np_(t.tail_pix), "tail_idx": np_(t.tail_idx)}


def check_tiles(a: dict, tt: dict, out_w: int, shape) -> None:
    """Every corner of every output lies in its tile's footprint, at the
    local place the tables give; footprints are ascending, minimal, and no
    larger than the pitch."""
    th, tw = shape
    idx = a["idx"].astype(np.int64)
    n_out, k = idx.shape
    n_in, w = a["n_in"], a["row_stride"]
    offs = np.array([0, 1, w, w + 1])
    # the independent reading: pixel n lies in row n // out_w, column n % out_w
    tiles_x = -(-out_w // tw)
    pix = np.arange(n_out)
    tile = (pix // out_w // th) * tiles_x + (pix % out_w) // tw
    want = [(np.mod(idx[:, :, None] + offs, n_in), np.broadcast_to(tile[:, None, None], (n_out, k, 4)),
             tt["off"].astype(np.int64))]
    if a["tail_idx"] is not None and len(a["tail_idx"]):
        tidx = a["tail_idx"].astype(np.int64)
        want.append((np.mod(tidx[:, None] + offs, n_in),
                     np.broadcast_to(tile[a["tail_pix"]][:, None], (len(tidx), 4)),
                     tt["tail_off"].astype(np.int64)))
    grp, ptr = tt["grp"].astype(np.int64), tt["grp_ptr"].astype(np.int64)
    assert tt["n_tiles"] == len(ptr) - 1 and tt["n_tiles"] >= tile.max() + 1
    used = np.zeros(len(grp), bool)
    for glob, t, off in want:
        assert (off >= 0).all() and (off < tt["pitch"]).all()
        assert (off // GROUP < (ptr[t + 1] - ptr[t])).all()  # inside its own tile's list
        slot = ptr[t] + off // GROUP
        np.testing.assert_array_equal(grp[slot] * GROUP + off % GROUP, glob)
        used[slot.ravel()] = True
    assert used.all()  # no group is staged that no corner reads
    for i in range(tt["n_tiles"]):
        g = grp[ptr[i]:ptr[i + 1]]
        assert (np.diff(g) > 0).all()
    assert tt["pitch"] == GROUP * max(1, np.diff(ptr).max()) and tt["pitch"] % GROUP == 0
    assert tt["footprint"] == pytest.approx(GROUP * len(grp) / n_out)


def staged_blend(src: torch.Tensor, t: BlendTables, channel_last: bool, chunk: int) -> torch.Tensor:
    """The kernel's arithmetic in torch, through its tables: per chunk of
    ``chunk`` units, every tile's footprint is gathered into its buffer, and
    each output pixel reads its corners at their local places there, slots
    then tail, in f32."""
    tt = t.tiles
    if channel_last:
        b, n_in, c = src.shape
        units = src.float().reshape(b, n_in * c)
        cpu = c
    else:
        b, c, n_in = src.shape
        units = src.float().reshape(b * c, n_in)
        cpu = 1
    th, tw = tt.shape
    grp, ptr = tt.grp.long(), tt.grp_ptr.long()
    n_out = t.n_out
    pix = torch.arange(n_out)
    tile = (pix // tt.out_w // th) * tt.tiles_x + (pix % tt.out_w) // tw
    # buffers of all tiles side by side, each GROUP * cpu elements per group
    lanes = (grp[:, None] * GROUP + torch.arange(GROUP)).reshape(-1)  # staged source pixels
    elems = (lanes[:, None] * cpu + torch.arange(cpu)).reshape(-1)
    start = ptr[tile] * GROUP  # each pixel's buffer, in staged pixels
    outs = []
    for u0 in range(0, units.shape[0], chunk):
        buf = units[u0:u0 + chunk, elems]  # (chunk, staged pixels * cpu)
        acc = torch.zeros(buf.shape[0], n_out, cpu)
        entries = [(t.w4[:, k], tt.off[:, k].long(), start) for k in range(t.k)]
        if t.n_tail:
            # the tail as extra entries of their pixels, in CSR order
            entries.append((t.tail_w, tt.tail_off.long(), start[t.tail_pix.long()]))
        for e, (w, off, st) in enumerate(entries):
            local = ((st[:, None] + off)[..., None] * cpu + torch.arange(cpu))  # (n, 4, cpu)
            vals = (buf[:, local] * w[None, :, :, None]).sum(2)  # (chunk, n, cpu)
            if e < t.k:
                acc += vals
            else:
                acc.index_add_(1, t.tail_pix.long(), vals)
        outs.append(acc)
    out = torch.cat(outs)  # (units, n_out, cpu)
    if channel_last:
        return out.reshape(b, n_out, c)
    return out[..., 0].reshape(b, c, n_out)


CASES = {
    "merge": (lambda: small_tables("merge"), SMALL[0][1], False),
    "e2p": (lambda: small_tables("e2p"), SMALL[1][1], True),
    "wrapped_ragged": (wrap_tables, 50, False),
}


@pytest.mark.parametrize("shape", [(8, 32), (4, 64), (16, 32), (3, 32)])
@pytest.mark.parametrize("case", sorted(CASES))
def test_tile_tables_place_every_corner(case, shape):
    make, out_w, _ = CASES[case]
    a = arrays(make())
    tt = tile_tables(**a, out_w=out_w, shape=shape)
    assert tt["entries"] == a["idx"].shape[1] + (
        int(np.diff(a["tail_ptr"]).max()) if a["tail_ptr"] is not None else 0)
    check_tiles(a, tt, out_w, shape)


def test_tile_tables_default_width_and_with_tiles():
    # without out_w a tile is a run of consecutive pixels; with_tiles
    # rebuilds the same tables with another tile
    t = wrap_tables(n_out=777)
    a = arrays(t)
    tt = tile_tables(**a, shape=(2, 32))
    assert tt["out_w"] == 32 and tt["n_tiles"] == -(-777 // 64)
    check_tiles(a, tt, 32, (2, 32))
    t4 = t.with_tiles((4, 64))
    assert t4.tiles.shape == (4, 64) and t4.tiles.out_w == 50 and t4.idx is t.idx
    check_tiles(a, {k: v.numpy() if torch.is_tensor(v) else v
                    for k, v in vars(t4.tiles).items()}, 50, (4, 64))


@pytest.mark.slow
def test_tile_tables_at_the_flagship():
    spec = ProjectionSpec.create((512, 1024), 128, (80, 80), 4)
    for t, out_w in ((pers2equi_tables(spec, CPU), spec.erp_w),
                     (equi2pers_tables(spec, CPU), spec.patch_w)):
        tt = {k: v.numpy() if torch.is_tensor(v) else v for k, v in vars(t.tiles).items()}
        check_tiles(arrays(t), tt, out_w, tt["shape"])


@pytest.mark.parametrize("chunk", [1, 3, 8])
@pytest.mark.parametrize("case", sorted(CASES))
def test_staged_emulation_matches_plain(case, chunk):
    make, _, cl = CASES[case]
    t = make()
    rng = np.random.default_rng(3)
    # 7 units: no multiple of the chunks 3 and 8
    shape = (7, t.n_in, 3) if cl else (7, 2, t.n_in)
    x = torch.from_numpy(rng.random(shape, dtype=np.float32))
    got = staged_blend(x, t, cl, chunk)
    torch.testing.assert_close(got, quad_blend_plain(x, t, channel_last=cl), rtol=0, atol=TOL)


def test_staged_emulation_matches_jax():
    jspec, spec = JaxSpec.create(*SMALL), ProjectionSpec.create(*SMALL)
    rng = np.random.default_rng(4)
    # the merge: channel-first, capped K = 2 plus the tail
    ic, wc, tp, ti, tw = jax_p2e(jspec).capped
    x = rng.random((16, 2, spec.n_patches * 16 * 16), dtype=np.float32)
    got = staged_blend(torch.from_numpy(x), pers2equi_tables(spec, CPU), False, 8)
    for want in (quad_gather_blend_pallas(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w,
                                          interpret=True),
                 capped_quad_gather_blend(jnp.asarray(x), ic, wc, tp, ti, tw, spec.patch_w,
                                          channel_first=True)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)
    # equi2pers: channel-last, K = 1
    g = jax_e2p(jspec)
    x = rng.random((5, spec.erp_h * spec.erp_w, 3), dtype=np.float32)
    got = staged_blend(torch.from_numpy(x), equi2pers_tables(spec, CPU), True, 2)
    for want in (quad_gather_blend_pallas_cl(jnp.asarray(x), g.idx, g.w4, spec.erp_w,
                                             interpret=True),
                 quad_gather_blend(jnp.asarray(x), g.idx, g.w4, spec.erp_w)):
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=TOL)


def test_out_dtype_rounds_the_f32_sums_once():
    t = small_tables("e2p")
    x = torch.rand(3, t.n_in, 3, generator=torch.Generator().manual_seed(5)).bfloat16()
    got = quad_blend(x, t, channel_last=True, out_dtype=torch.bfloat16)
    assert got.dtype == torch.bfloat16
    assert torch.equal(got, quad_blend(x, t, channel_last=True).to(torch.bfloat16))
    # equi2pers returns the ERP's dtype, the same bits as the cast it replaced
    spec = ProjectionSpec.create(*SMALL)
    erp = torch.rand(2, *SMALL[0], 3, generator=torch.Generator().manual_seed(6)).bfloat16()
    out = equi2pers(erp, build_equi2pers_grids(spec))
    src = erp.reshape(2, -1, 3)
    assert out.dtype == torch.bfloat16
    assert torch.equal(out.reshape(2, -1, 3), quad_blend(src, t, channel_last=True).bfloat16())


def test_kernel_wrapper_refuses_what_the_kernel_cannot_hold():
    # checked before any launch, so a CPU tensor shows it
    rng = np.random.default_rng(7)
    # a source whose pixel count is not the tables' (the kernel takes any
    # count of quads per pixel: tests/test_torch_port_blend_entries.py)
    n_out, k = 64, MAX_ENTRIES + 1
    many = BlendTables.create(rng.integers(0, 90, (n_out, k)), np.full((n_out, k, 4), 0.01),
                              8, 96, CPU)
    with pytest.raises(ValueError, match="source has 95 pixels"):
        qb._blend_kernel(torch.rand(1, 1, 95), many, False)
    # 256 pixels whose corners spread over 2^20 source pixels: a footprint
    # of thousands of groups, 8 channels of f32 each, fits no block twice
    n_in = 2**20
    wide = BlendTables.create(rng.integers(0, n_in - 2048, (256, 1)), np.ones((256, 1, 4)),
                              1024, n_in, CPU)
    assert wide.tiles.pitch * 8 * 4 * 2 > qb.SMEM_BYTES
    with pytest.raises(ValueError, match="footprint"):
        qb._blend_kernel(torch.rand(1, n_in, 8), wide, True, staged=True)
    with pytest.raises(TypeError, match="stores f32"):
        qb._blend_kernel(torch.rand(1, 1, 96), wrap_tables(), False, torch.float16)


def test_blend_plan_stages_dense_footprints_of_many_rows():
    # the merge (about 1.4 staged pixels per output pixel) stages its
    # footprint at every batch; equi2pers (above 4: it samples the ERP at
    # about one pixel in three) gathers from global memory, a block taking
    # 8 batches of 3 rows
    merge, e2p = small_tables("merge").tiles, small_tables("e2p").tiles
    assert merge.footprint < qb.STAGE_MAX_FOOTPRINT < e2p.footprint
    assert blend_plan(merge, 4, 1, 2) == (True, 4, 4)
    staged, chunk, unit_block = blend_plan(merge, 128, 1, 2)
    assert staged and unit_block == 128 and chunk == min(qb.CHUNK_ROWS, 128)
    assert blend_plan(merge, 128, 1, 2, staged=False) == (False, qb.CHUNK_ROWS, 24)
    assert blend_plan(e2p, 256, 3, 2) == (False, 5, 8)
    # chunks shrink to keep a block's buffers within BLOCK_SMEM; grid.y
    # holds at most 65535 unit blocks
    staged, chunk, _ = blend_plan(merge, 512, 1, 4, staged=True, chunk_rows=64)
    assert 2 * chunk * merge.pitch * 4 <= qb.BLOCK_SMEM
    assert blend_plan(e2p, 10**6, 3, 2)[2] == -(-10**6 // 65535)
