"""csrc/up2x.cu's adjoint, one thread block at a time, emulated in torch on
the CPU and held bit for bit to ``up2x_adjoint_plain``.

A thread of the kernel makes a ROWS x COLS block of outputs from its
cotangent band: rows 2iy-1 .. 2iy+2R and columns 2ix-1 .. 2ix+2C, each index
clamped to the plane (the vector path loads the 2C interior columns without
a clamp: it runs only where the width is a multiple of COLS). It sums along
H, then along W, each tap 0.75 * (e + o) + 0.25 * (l + r) in f32, rounds once
to the working dtype, and stores only its outputs inside the plane. The
emulation does the same for every thread (all threads at once, one per row
of its tensors), so an order, halo or clamp mistake shows here before the
card runs the kernel. ``test_torch_port_up2x_grad.py`` holds the plain
version to the JAX adjoint.
"""

import numpy as np
import pytest
import torch

from omnifusion_torch.ops.upsample import ADJOINT_BLOCK, up2x_adjoint_plain


def _tap(l, e, o, r):
    return 0.75 * (e + o) + 0.25 * (l + r)


def emulate(g: torch.Tensor, block=ADJOINT_BLOCK, vector: bool | None = None) -> torch.Tensor:
    """The kernel's result on ``g`` (N, C, 2H, 2W), thread by thread; its
    vector path where the kernel takes it (``vector`` None) or as asked."""
    n, c, h2, w2 = g.shape
    h, w = h2 // 2, w2 // 2
    rows, cols = block
    if vector is None:
        vector = cols % 4 == 0 and w % cols == 0
    planes = g.reshape(n * c, h2, w2).float()  # each load, to f32
    row_groups, col_groups = -(-h // rows), -(-w // cols)
    # thread t -> (plane, row group, column group), in output order
    t = torch.arange(n * c * row_groups * col_groups)
    ix = (t % col_groups) * cols
    plane = t // col_groups // row_groups
    iy = (t // col_groups % row_groups) * rows
    band_rows = (2 * iy[:, None] - 1 + torch.arange(2 * rows + 2)).clamp(0, h2 - 1)
    interior = 2 * ix[:, None] + torch.arange(2 * cols)
    if vector:
        assert bool((interior < w2).all()), "the vector path's interior left the row"
    else:
        interior = interior.clamp(max=w2 - 1)
    band_cols = torch.cat([(2 * ix - 1).clamp(min=0)[:, None], interior,
                           (2 * ix + 2 * cols).clamp(max=w2 - 1)[:, None]], 1)
    band = planes[plane[:, None, None], band_rows[:, :, None], band_cols[:, None, :]]
    out = torch.full((n * c, h, w), float("nan"))
    stores = torch.zeros((n * c, h, w), dtype=torch.int64)
    for r in range(rows):
        hz = _tap(band[:, 2 * r], band[:, 2 * r + 1], band[:, 2 * r + 2], band[:, 2 * r + 3])
        block_row = _tap(hz[:, 0:2 * cols:2], hz[:, 1:2 * cols + 1:2],
                         hz[:, 2:2 * cols + 2:2], hz[:, 3:2 * cols + 3:2])
        oy = (iy + r)[:, None].expand(-1, cols)
        ox = ix[:, None] + torch.arange(cols)
        keep = (oy < h) & (ox < w)  # the block's outputs inside the plane
        where = (plane[:, None].expand(-1, cols)[keep], oy[keep], ox[keep])
        out[where] = block_row[keep]
        stores.index_put_(where, torch.ones_like(oy[keep]), accumulate=True)
    assert bool((stores == 1).all()), "an output stored twice or never"
    return out.to(g.dtype).reshape(n, c, h, w)


STAGES = [(1, 512, 4, 4), (1, 128, 8, 8), (1, 64, 16, 16), (1, 64, 32, 32), (1, 32, 64, 64)]
ODD = [(1, 3, 7, 5), (1, 2, 1, 4), (2, 3, 1, 1), (5, 3, 7, 33)]
# widths on either side of a multiple of the block's columns: the vector
# path at 12 and the element path at 11 and 13
MEET = [(2, 3, 5, 11), (2, 3, 5, 12), (2, 3, 5, 13)]
DTYPES = [torch.float32, torch.bfloat16]


def _cotangent(shape, dtype, seed: int = 0) -> torch.Tensor:
    n, c, h, w = shape
    g = np.random.default_rng(seed + h * 100 + w).standard_normal((n, c, 2 * h, 2 * w))
    return torch.from_numpy(g.astype(np.float32)).to(dtype)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", STAGES + ODD + MEET, ids=lambda s: "x".join(map(str, s)))
def test_blocks_give_the_plain_bits(shape, dtype):
    g = _cotangent(shape, dtype)
    want = up2x_adjoint_plain(g)
    got = emulate(g)
    assert got.dtype == dtype and got.shape == shape
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", DTYPES, ids=str)
@pytest.mark.parametrize("shape", [(1, 64, 16, 16), (2, 3, 5, 12), (1, 2, 1, 4)],
                         ids=lambda s: "x".join(map(str, s)))
def test_element_path_where_the_vector_path_could_run(shape, dtype):
    # an unaligned view of a width that is a multiple of the block's columns
    # takes the element path: the same bits
    g = _cotangent(shape, dtype, seed=1)
    assert torch.equal(emulate(g, vector=False), up2x_adjoint_plain(g))


@pytest.mark.parametrize("block", [(1, 1), (2, 4), (4, 4), (1, 8)], ids=lambda b: f"{b[0]}x{b[1]}")
@pytest.mark.parametrize("shape", [(1, 64, 16, 16), (2, 3, 7, 33), (1, 2, 3, 8)],
                         ids=lambda s: "x".join(map(str, s)))
def test_other_block_shapes_give_the_plain_bits(shape, block):
    # the block shapes tools/adjoint_variants.py builds
    g = _cotangent(shape, torch.bfloat16, seed=2)
    assert torch.equal(emulate(g, block), up2x_adjoint_plain(g))
