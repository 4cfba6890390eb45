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
    # the registry and the memory side of COSMOS
    assert "repro_torch.core.registry" in got["modules"]
    assert "repro_torch.core.plm.planner" in got["modules"]
    assert "repro_torch.core.analysis.verify" in got["modules"]
    # the service path: pricing, the surrogate, tracing, the store and
    # the service itself
    for name in ("core.pricing", "core.surrogate", "core.obs.trace",
                 "core.obs.schema", "checkpoint.store", "serve.dse_service"):
        assert f"repro_torch.{name}" in got["modules"], name
    # the SoC composition layer and the static lint
    for name in ("core.soc", "core.soc.budget", "core.soc.workload",
                 "core.soc.compose", "core.soc.verify",
                 "core.analysis.lint"):
        assert f"repro_torch.{name}" in got["modules"], name
    # the LM serving path
    for name in ("configs.qwen2_0_5b", "configs.starcoder2_7b",
                 "configs.nemotron4_15b", "configs.kimi_k2",
                 "configs.phi35_moe", "configs.qwen2_vl_72b",
                 "configs.zamba2_2_7b", "configs.whisper_large_v3",
                 "data", "data.synthetic", "data.pipeline", "dist",
                 "dist.sharding", "train", "train.remat", "models",
                 "models.blocks", "models.transformer", "models.ssm",
                 "models.ssm_lm", "models.hybrid", "models.encdec",
                 "models.api", "models.convert", "serve.engine", "launch",
                 "launch.serve"):
        assert f"repro_torch.{name}" in got["modules"], name
    # the LM training path
    for name in ("optim", "optim.adamw", "optim.quantized",
                 "optim.schedule", "dist.compression", "train.step",
                 "checkpoint", "checkpoint.async_ckpt", "ft", "ft.elastic",
                 "ft.straggler", "ft.watchdog", "launch.train"):
        assert f"repro_torch.{name}" in got["modules"], name
    # the sharded dry run and the knob walk
    for name in ("dist.sharding", "launch.mesh", "launch.graph_analysis",
                 "launch.dryrun", "launch.roofline", "core.autotune"):
        assert f"repro_torch.{name}" in got["modules"], name
    # the front doors: one module per script of the JAX package's examples
    for name in ("examples", "examples._cli", "examples.wami_cuda",
                 "examples.fleet_cuda", "examples.wami_plm",
                 "examples.wami_dse", "examples.autoshard",
                 "examples.quickstart", "examples.serve_lm",
                 "examples.train_lm"):
        assert f"repro_torch.{name}" in got["modules"], name
    assert got["bad"] == [], f"modules loaded by the port: {got['bad']}"
