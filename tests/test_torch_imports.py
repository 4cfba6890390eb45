"""The PyTorch package stands alone: importing it and every submodule
loads neither jax nor any module of the JAX package ``repro``."""

import json
import os
import subprocess
import sys

_PROBE = r"""
import importlib, json, pkgutil, sys
import repro_torch
names = sorted(m.name for m in pkgutil.walk_packages(repro_torch.__path__,
                                                     "repro_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m in ("jax", "repro") or m.startswith(("jax.", "repro.")))
print(json.dumps({"modules": names, "bad": bad}))
"""


def test_port_imports_neither_jax_nor_repro():
    src = os.path.join(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))), "src")
    env = dict(os.environ)
    env["PYTHONPATH"] = src + os.pathsep + env.get("PYTHONPATH", "")
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    got = json.loads(out.stdout.strip().splitlines()[-1])
    # every submodule was walked and imported, the kernels' included
    assert "repro_torch.core.cuda_oracle" in got["modules"]
    assert "repro_torch.kernels.wami_steep.kernel" in got["modules"]
    assert "repro_torch.kernels.flash_attention.kernel" in got["modules"]
    assert "repro_torch.kernels.ssd_scan.kernel" in got["modules"]
    assert "repro_torch.apps.fleet.pipeline" in got["modules"]
    assert "repro_torch.core.xlatool" in got["modules"]
    assert got["bad"] == [], f"modules loaded by the port: {got['bad']}"
