"""The CUDA kernels against their plain versions, on the card.

Skipped where there is no CUDA device. Run on a machine with an H100:

    python -m pytest tests/test_torch_port_cuda.py -m cuda

chip_smoke.py holds the same kernels to the same tolerances at the
flagship's shapes.
"""

import numpy as np
import pytest
import torch

from omnifusion_torch.ops.quad_blend import BlendTables, quad_blend, quad_blend_plain
from omnifusion_torch.ops.upsample import up2x, up2x_plain
from omnifusion_torch.projection import ProjectionSpec
from omnifusion_torch.projection.ops import equi2pers_tables, pers2equi_tables

pytestmark = pytest.mark.cuda

SPEC = ProjectionSpec.create((64, 128), (16, 16), (80, 80), 4)


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


@pytest.mark.parametrize(
    "shape", [(3, 8, 4, 4), (2, 32, 16, 16), (1, 3, 7, 5), (2, 3, 1, 1), (1, 2, 1, 4)]
)
def test_up2x_kernel_matches_plain(cuda, shape):
    x = torch.rand(shape, generator=torch.Generator().manual_seed(3)).to(cuda)
    before = up2x.launches
    got = up2x(x)
    torch.cuda.synchronize()
    assert up2x.launches == before + 1
    torch.testing.assert_close(got, up2x_plain(x), rtol=0, atol=1e-6)


def test_kernels_refuse_what_they_do_not_take(cuda):
    with pytest.raises(ValueError, match="contiguous"):
        up2x(torch.rand(2, 4, 4, 3, device=cuda).permute(0, 3, 1, 2))
    with pytest.raises(TypeError, match="dtype"):
        up2x(torch.zeros(1, 1, 2, 2, dtype=torch.float64, device=cuda))
    tables = pers2equi_tables(SPEC, cuda)
    with pytest.raises(ValueError, match="pixels"):
        quad_blend(torch.rand(1, 2, tables.n_in - 1, device=cuda), tables)
