"""``DATASET.FRAME_CACHE_DIR`` in the port against the JAX package on the CPU:
``construct_batched_env`` on tests/test_frame_cache_path.py's world with
per-scene banks served by each package's native frame server. The banks'
frames (rgb bytes, depth as uint16 / 65535 in f32) and every rgb and depth
observation of a reset and 10 steps are exact; a missing bank raises as
JAX's does; ``cache_observations`` writes JAX's script's bytes."""

import os
import runpy
import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.sim import builder as jbuilder
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.native.frame_server import write_frame_bank
from avlen_tpu_torch.scripts import cache_observations
from avlen_tpu_torch.sim import builder
from tests.test_torch_native import build_jax_native

torch.set_num_threads(1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OPTS = [
    "NUM_PROCESSES", "2",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SCENES", "1",
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "200",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "2000",
]
ACTIONS = [[1, 2], [1, 1], [3, 1], [0, 2], [2, 1], [1, 3], [1, 1], [2, 0], [1, 1], [3, 2]]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    build_jax_native()


def _write_banks(cache: str, n: int, res: int, seed: int = 3):
    """Banks with contents distinct from the generator's (as
    tests/test_frame_cache_path.py writes them), two spare rows."""
    rng = np.random.RandomState(seed)
    rgb = rng.randint(0, 255, (n + 2, 4, res, res, 3), np.uint8)
    depth = (rng.rand(n + 2, 4, res, res, 1) * 65535).astype(np.uint16)
    write_frame_bank(os.path.join(cache, "scene000_rgb.avlf"), rgb)
    write_frame_bank(os.path.join(cache, "scene000_depth.avlf"), depth)
    return rgb, depth


@pytest.mark.parametrize("res,with_rgb", [(16, True), (8, False)], ids=["generator_res", "bank_res_no_rgb"])
def test_env_frames_from_the_cache_match_jax(tmp_path, res, with_rgb):
    """The banks replace the generator's frames at the banks' H×W whatever
    ``with_rgb`` says; rows past the scene's nodes are zero."""
    _, tables, _ = builder.build_world_from_config(get_config(opts=OPTS), with_depth=True, device="cpu")
    n = tables[0].num_nodes
    rgb, depth = _write_banks(str(tmp_path), n, res)
    opts = OPTS + ["TASK_CONFIG.DATASET.FRAME_CACHE_DIR", str(tmp_path)]
    jenv = jbuilder.construct_batched_env(jax_get_config(opts=opts), with_rgb=with_rgb, with_depth=True)
    env = builder.construct_batched_env(get_config(opts=opts), with_rgb=with_rgb, with_depth=True, device="cpu")

    for name, want in (("rgb", rgb), ("depth", depth.astype(np.float32) / 65535.0)):
        got, ref = getattr(env.bank, name), np.asarray(getattr(jenv.bank, name))
        assert got.dtype == (torch.uint8 if name == "rgb" else torch.float32)
        assert tuple(got.shape) == ref.shape == (1, env.bank.max_nodes, 4, res, res, want.shape[-1])
        np.testing.assert_array_equal(got.numpy(), ref, err_msg=name)
        np.testing.assert_array_equal(got.numpy()[0, :n], want[:n], err_msg=name)
        assert not got.numpy()[0, n:].any()
    assert env.config.sensors == jenv.config.sensors
    assert ("rgb" in env.config.sensors) == with_rgb

    jstate, jobs = jenv.reset()
    state, obs = env.reset()
    frames = [(state, obs, jobs)]
    for a in ACTIONS:
        jstate, jout = jenv.step(jstate, jnp.asarray(a, jnp.int32))
        state, out = env.step(state, torch.as_tensor(a))
        frames.append((state, out.obs, jout.obs))
    for t, (st, o, jo) in enumerate(frames):
        node, rot = st.node.numpy(), st.rot.numpy()
        for name in env.config.sensors:
            if name in ("rgb", "depth"):
                np.testing.assert_array_equal(o[name].numpy(), np.asarray(jo[name]), err_msg=f"{name} {t}")
                np.testing.assert_array_equal(o[name].numpy(), getattr(env.bank, name).numpy()[0, node, rot])


def test_missing_bank_raises_as_jax(tmp_path):
    _write_banks(str(tmp_path), 4, 16)
    os.remove(tmp_path / "scene000_depth.avlf")
    opts = OPTS + ["TASK_CONFIG.DATASET.FRAME_CACHE_DIR", str(tmp_path)]
    with pytest.raises(FileNotFoundError) as jerr:
        jbuilder.build_world_from_config(jax_get_config(opts=opts), with_rgb=True, with_depth=True)
    with pytest.raises(FileNotFoundError) as err:
        builder.build_world_from_config(get_config(opts=opts), with_rgb=True, with_depth=True, device="cpu")
    assert str(err.value) == str(jerr.value)


def test_bank_shorter_than_its_scene_is_refused(tmp_path):
    """The server copies without bounds checks; the port refuses a bank
    with fewer nodes than the scene instead of reading past the file."""
    _, tables, _ = builder.build_world_from_config(get_config(opts=OPTS), device="cpu")
    rng = np.random.RandomState(0)
    write_frame_bank(str(tmp_path / "scene000_rgb.avlf"), rng.randint(0, 255, (2, 4, 8, 8, 3), np.uint8))
    write_frame_bank(str(tmp_path / "scene000_depth.avlf"), np.zeros((2, 4, 8, 8, 1), np.uint16))
    opts = OPTS + ["TASK_CONFIG.DATASET.FRAME_CACHE_DIR", str(tmp_path)]
    with pytest.raises(IndexError, match=f"frame bank of 2 nodes x 4 rotations: no frame at nodes "
                                         f"0..{tables[0].num_nodes - 1}"):
        builder.build_world_from_config(get_config(opts=opts), device="cpu")


def test_cache_observations_writes_the_jax_scripts_bytes(tmp_path, monkeypatch, capsys):
    """``python -m avlen_tpu_torch.scripts.cache_observations`` and the
    repo's scripts/cache_observations.py, same arguments: the same output
    and files, byte for byte (and the same again from ``main(argv)``)."""
    args = ["--scenes", "2", "--side", "4", "--res", "16", "--seed", "5"]
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-m", "avlen_tpu_torch.scripts.cache_observations", "--output",
                          str(tmp_path / "port"), *args], cwd=REPO, env=env, capture_output=True, text=True,
                         timeout=120, check=True).stdout
    monkeypatch.setattr(sys, "argv", ["cache_observations.py", "--output", str(tmp_path / "jax"), *args])
    runpy.run_path(os.path.join(REPO, "scripts", "cache_observations.py"), run_name="__main__")
    assert out == capsys.readouterr().out
    names = sorted(os.listdir(tmp_path / "jax"))
    assert names == sorted(os.listdir(tmp_path / "port")) == [
        f"scene{i:03d}_{k}.avlf" for i in range(2) for k in ("depth", "rgb")]
    for name in names:
        assert (tmp_path / "port" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
    cache_observations.main(["--output", str(tmp_path / "again"), *args])
    for name in names:
        assert (tmp_path / "again" / name).read_bytes() == (tmp_path / "jax" / name).read_bytes(), name
