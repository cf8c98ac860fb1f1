"""The toolchain probe: the port's plain ``2 * x`` against the Pallas probe
of tools/bench_pallas_merge.py:57-63, run in interpret mode on the CPU.

The kernel itself (csrc/probe.cu) runs only on the card:
tests/test_torch_port_cuda.py and chip_smoke.py hold it bit for bit against
the plain version there.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from omnifusion_torch.ops import probe as probe_mod
from omnifusion_torch.ops.probe import probe, probe_plain


def _jax_probe(x: np.ndarray) -> np.ndarray:
    # the shootout's probe as it writes it, interpreted here
    out = pl.pallas_call(
        lambda x_ref, o_ref: o_ref.__setitem__(slice(None), x_ref[:] * 2.0),
        out_shape=jax.ShapeDtypeStruct((256, 128), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)],
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True,
    )(jnp.asarray(x))
    return np.asarray(out)


@pytest.mark.parametrize("fill", ["ones", "random"])
def test_probe_plain_equals_pallas_probe(fill):
    rng = np.random.default_rng(0)
    x = np.ones((256, 128), np.float32) if fill == "ones" else (
        rng.standard_normal((256, 128)).astype(np.float32) * 1e3)
    want = _jax_probe(x)
    got = probe_plain(torch.from_numpy(x)).numpy()
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    if fill == "ones":
        assert float(got.sum()) == 2.0 * 256 * 128  # the shootout's own check


def test_probe_takes_the_plain_path_on_cpu(monkeypatch):
    def no_kernel(x):
        raise AssertionError("the kernel was launched for a CPU tensor")

    monkeypatch.setattr(probe_mod, "_probe_kernel", no_kernel)
    x = torch.from_numpy(np.random.default_rng(1).random((256, 128), dtype=np.float32))
    before = probe.launches
    got = probe(x)
    assert probe.launches == before
    assert torch.equal(got, x * 2.0) and got.dtype == torch.float32


def test_probe_refuses_other_devices():
    with pytest.raises(ValueError, match="cuda or cpu"):
        probe(torch.zeros(4, device="meta"))
