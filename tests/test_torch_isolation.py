"""The PyTorch port stands alone: importing every module of avlen_tpu_torch
(the subpackages pretraining/, dialog/ and dialog/speaker/ among them)
loads no jax, jaxlib, flax or optax module and nothing of the JAX package
avlen_tpu (whose name avlen_tpu_torch merely starts with); nor msgpack,
tensorboardX, tensorboard, imageio or networkx, which the card's machine
does not have (the port writes its checkpoints and event files itself and
reads pickled networkx graphs without it), nor ``regex`` (the CLIP
tokenizer's split runs on the standard ``re``), nor ``grpc``, which only the
challenge protocol's server and remote client import, inside the call."""

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
                           "msgpack", "tensorboardX", "tensorboard", "imageio", "regex",
                           "networkx", "grpc")
)
print(len(names))
print(" ".join(bad))
print(" ".join(names))
"""


def test_port_imports_no_jax_and_no_jax_package():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", _PROBE], cwd=REPO, env=env, capture_output=True,
                         text=True, timeout=300, check=True).stdout.splitlines()
    assert int(out[0]) >= 25  # every module of the package was imported
    assert out[1] == "", f"the port imported {out[1]}"
    names = set(out[2].split())
    for sub in ("pretraining.audiogoal_predictor", "dialog.instruction_bank", "dialog.instruction_source",
                "dialog.speaker.speaker", "dialog.speaker.templates", "dialog.speaker.vocab",
                "models.clip_bpe", "models.clip_text", "models.dialog_policy", "models.option_policy",
                "rl.rollout_interactive", "rl.trainers.interactive", "models.rnn_state_encoder",
                "models.avwan_policy", "ops.mapping", "sim.mapnav", "rl.trainers.avnav", "rl.trainers.avwan",
                "dialog.speaker.model", "dialog.speaker.pano_features", "dialog.speaker.train_speaker",
                "dialog.speaker.eval_speaker", "utils.maps", "utils.video", "data.reference", "sim.mp3d_utils",
                "sim.graph", "models.layers", "native.build", "native.frame_server", "native.graph_engine",
                "data.vln", "scripts.cache_observations", "scripts.generate_vln_episodes",
                "core.vector_env", "core.challenge", "sim.simple_agents", "utils.obs_transformers",
                "dialog.ques_gen", "utils.platform", "scripts.ambisonic_to_binaural", "scripts.generate_metadata",
                "scripts.interactive_demo", "scripts.eval_speaker"):
        assert f"avlen_tpu_torch.{sub}" in names, sub


def test_native_libraries_are_the_ports_own():
    """The port compiles its own copies of the native sources
    (avlen_tpu_torch/native/*.cpp) into build/native/ and loads those; no
    module or source of the port names the JAX package's native layer."""
    from avlen_tpu_torch.native import build, load_library

    assert str(build.SRC_DIR) == os.path.join(REPO, "avlen_tpu_torch", "native")
    assert str(build.BUILD_DIR) == os.path.join(REPO, "build", "native")
    for name, src in build.SOURCES.items():
        assert os.path.isfile(os.path.join(REPO, "avlen_tpu_torch", "native", src))
        path = build.native_lib_path(name)
        assert os.path.dirname(path) == os.path.join(REPO, "build", "native")
        assert load_library(name)._name == path
    for base, _, files in os.walk(os.path.join(REPO, "avlen_tpu_torch")):
        for f in files:
            if f.endswith((".py", ".cpp", ".cu", ".cuh")):
                text = open(os.path.join(base, f), encoding="utf-8").read()
                assert "avlen_tpu/native" not in text and "avlen_tpu.native" not in text, f
