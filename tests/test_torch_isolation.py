"""The port stands alone: every module of ``commefficient_torch``,
imported in a fresh interpreter, brings in neither JAX nor the JAX
package."""

import os
import pkgutil
import subprocess
import sys

import commefficient_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, pkgutil, sys
import commefficient_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    commefficient_torch.__path__, "commefficient_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "commefficient_tpu"))
print(len(names), bad)
assert not bad, bad
"""


def test_no_port_module_imports_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(
        commefficient_torch.__path__, "commefficient_torch.")]
    assert {"commefficient_torch.ops.wire",
            "commefficient_torch.models.stream_mlp"} <= set(names)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", CHECK], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == str(len(names))
