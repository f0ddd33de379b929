"""The port stands alone: every module of ``commefficient_torch``,
imported in a fresh interpreter, brings in neither JAX nor the JAX
package, nor any module whose file lies under the repository's
``scripts/`` directory."""

import os
import pkgutil
import subprocess
import sys

import commefficient_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

CHECK = """
import importlib, os, pkgutil, sys
import commefficient_torch
names = sorted(m.name for m in pkgutil.walk_packages(
    commefficient_torch.__path__, "commefficient_torch."))
for name in names:
    importlib.import_module(name)
bad = sorted(m for m in sys.modules
             if m.split(".")[0] in ("jax", "jaxlib", "flax",
                                    "commefficient_tpu"))
scripts = os.path.join(sys.argv[1], "scripts") + os.sep
bad += sorted(m for m, mod in list(sys.modules.items())
              if os.path.abspath(getattr(mod, "__file__", None) or "")
              .startswith(scripts))
print(len(names), bad)
assert not bad, bad
"""


def test_no_port_module_imports_jax_or_the_jax_package():
    names = [m.name for m in pkgutil.walk_packages(
        commefficient_torch.__path__, "commefficient_torch.")]
    assert {"commefficient_torch.ops.wire",
            "commefficient_torch.models.stream_mlp",
            "commefficient_torch.scripts.teleview",
            "commefficient_torch.scripts.crash_matrix",
            "commefficient_torch.scripts.curves",
            "commefficient_torch.parallel",
            "commefficient_torch.parallel.mesh"} <= set(names)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = ROOT
    out = subprocess.run([sys.executable, "-c", CHECK, ROOT], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.split()[0] == str(len(names))
