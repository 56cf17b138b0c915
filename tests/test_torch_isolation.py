"""The PyTorch port stands alone: importing every module of avlen_tpu_torch
loads no jax, jaxlib, flax or optax module and nothing of the JAX package
avlen_tpu (whose name avlen_tpu_torch merely starts with); nor msgpack,
tensorboardX, tensorboard or imageio, which the card's machine does not
have (the port writes its checkpoints and event files itself)."""

import os
import subprocess
import sys

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = r"""
import importlib, pkgutil, sys
import avlen_tpu_torch
names = [m.name for m in pkgutil.walk_packages(avlen_tpu_torch.__path__, "avlen_tpu_torch.")]
for name in names:
    importlib.import_module(name)
bad = sorted(
    m for m in sys.modules
    if m.split(".")[0] in ("jax", "jaxlib", "flax", "optax", "avlen_tpu",
                           "msgpack", "tensorboardX", "tensorboard", "imageio")
)
print(len(names))
print(" ".join(bad))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout.splitlines()
    assert int(out[0]) >= 25  # every module of the package was imported
    assert out[1:] in ([], [""]), f"the port imported {out[1]}"
