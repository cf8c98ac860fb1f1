"""The port imports neither JAX, flax nor anything of the JAX package, and
no image or plotting library (cv2, PIL, matplotlib) when it is imported: the
card's host may lack them; the modules that use them import them inside
the function that needs them."""

import json
import os
import pathlib
import subprocess
import sys

REPO = pathlib.Path(__file__).resolve().parent.parent

_PROBE = """
import importlib, json, pkgutil, sys
import omnifusion_torch
names = sorted(m.name for m in pkgutil.walk_packages(omnifusion_torch.__path__, "omnifusion_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules if m.split(".")[0] in ("jax", "jaxlib", "flax", "omnifusion_tpu"))
imaging = sorted(m for m in sys.modules if m.split(".")[0] in ("cv2", "PIL", "matplotlib"))
print(json.dumps({"modules": names, "bad": bad, "imaging": imaging}))
"""


def test_port_imports_no_jax():
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(filter(None, [str(REPO), env.get("PYTHONPATH")]))
    proc = subprocess.run(
        [sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True, text=True,
        timeout=300,
    )
    assert proc.returncode == 0, proc.stderr
    result = json.loads(proc.stdout.strip().splitlines()[-1])
    assert "omnifusion_torch.models.spherical_fusion" in result["modules"]
    assert "omnifusion_torch.models.iterative" in result["modules"]
    assert "omnifusion_torch.cli.infer" in result["modules"]
    assert {"omnifusion_torch.cli.train", "omnifusion_torch.training.trainer",
            "omnifusion_torch.data.loader", "omnifusion_torch.evaluation.metrics",
            "omnifusion_torch.losses.direct"} <= set(result["modules"])
    assert {"omnifusion_torch.bench", "omnifusion_torch.ops.probe",
            "omnifusion_torch.utils.profiling", "omnifusion_torch.tools.bench_components",
            "omnifusion_torch.tools.bench_merge",
            "omnifusion_torch.tools.profile_forward"} <= set(result["modules"])
    assert {"omnifusion_torch.cli.common", "omnifusion_torch.cli.test",
            "omnifusion_torch.data.datasets", "omnifusion_torch.models.torch_import",
            "omnifusion_torch.native", "omnifusion_torch.utils.colorize",
            "omnifusion_torch.utils.ply"} <= set(result["modules"])
    assert result["bad"] == []
    assert result["imaging"] == []


def test_port_sources_name_no_jax():
    # also what is imported only inside a function
    for path in (REPO / "omnifusion_torch").rglob("*.py"):
        for line in path.read_text().splitlines():
            words = line.split()
            if words[:1] in (["import"], ["from"]) and len(words) > 1:
                assert words[1].split(".")[0] not in ("jax", "jaxlib", "flax", "omnifusion_tpu"), (
                    f"{path}: {line}"
                )
