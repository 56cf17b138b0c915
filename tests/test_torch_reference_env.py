"""The port's env over reference-format data against the JAX package's on
the CPU: ``construct_batched_env`` on a copy of the fixture tree
tests/data/reference_tree (``DATASET.SOURCE reference``), with the RIRs
dense on the device and served from the host store, the spectrogram bank
on and off, and with a distractor: after a reset and fixed actions the
observations (``semantic_object`` and ``mpcat40_index`` among them),
rewards, dones and metrics match JAX's (spectrogram 2e-3, or the bf16
bank's rounding when banked; others 1e-5; ints exact). ``PACK_HOST_RIRS``
packs a tiny synthetic world as JAX does, and its host-served env sees
what the procedural env sees. The semantic sensors on a synthetic world
equal JAX's pixel for pixel, and ``HouseReader`` equals JAX's."""

import os
import shutil

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.data.reference import HostRIRStore as JaxHostRIRStore
from avlen_tpu.sim import builder as jbuilder
from avlen_tpu.sim import mp3d_utils as jmp3d
from avlen_tpu.sim import synthetic as jsyn
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.data.reference import HostRIRStore
from avlen_tpu_torch.sim import builder, mp3d_utils
from avlen_tpu_torch.sim.scene import DenseRIRBank
from avlen_tpu_torch.utils.flax_bridge import scene_bank_from_jax
from tests.test_torch_env import _compare, port_env_from_jax

torch.set_num_threads(1)

FIXTURE = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "reference_tree")
SAVI = "configs/semantic_audionav/savi/savi.yaml"
EXTRA = ("category_belief", "location_belief", "category")
SENSORS = ("['SPECTROGRAM_SENSOR','CATEGORY','POSE_SENSOR','COLLISION','ORACLE_ACTION_SENSOR',"
           "'POINTGOAL_WITH_GPS_COMPASS_SENSOR','SEMANTIC_OBJECT_SENSOR','MPCAT40_INDEX_SENSOR']")
ACTIONS = [[1, 2], [1, 1], [3, 1], [0, 2], [2, 1], [1, 3], [1, 1], [2, 0], [1, 1], [3, 2]]


def reference_opts(root: str, extra=()):
    """The data-path keys of a reference tree at ``root`` (4 kHz, its rate),
    2 envs, episodes of at most 6 steps."""
    return [
        "TASK_CONFIG.DATASET.SOURCE", "reference",
        "TASK_CONFIG.DATASET.DATA_PATH",
        os.path.join(root, "datasets", "semantic_audionav", "v1", "train", "train.json.gz"),
        "TASK_CONFIG.SIMULATOR.SCENE_DATASET", "mp3d",
        "TASK_CONFIG.SIMULATOR.AUDIO.METADATA_DIR", os.path.join(root, "metadata"),
        "TASK_CONFIG.SIMULATOR.AUDIO.BINAURAL_RIR_DIR", os.path.join(root, "binaural_rirs"),
        "TASK_CONFIG.SIMULATOR.AUDIO.SOURCE_SOUND_DIR", os.path.join(root, "sounds", "1s_all"),
        "TASK_CONFIG.SIMULATOR.SCENE_OBSERVATION_DIR", os.path.join(root, "scene_observations"),
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
        "NUM_PROCESSES", "2",
    ] + list(extra)


def copy_fixture(dest) -> str:
    """A copy of the fixture tree without any pack, so that a pack is
    written beside the copy and never under tests/data."""
    root = os.path.join(str(dest), "reference_tree")
    shutil.copytree(FIXTURE, root, ignore=shutil.ignore_patterns("_packed"))
    return root


CASES = {  # (DENSE_RIR_MAX_BYTES, CACHE_SPECTROGRAMS, HAS_DISTRACTOR_SOUND)
    "dense": ("2147483648", "False", "False"),
    "host": ("0", "False", "False"),
    "dense_banked": ("2147483648", "True", "False"),
    "host_banked": ("0", "True", "False"),
    "host_distractor": ("0", "False", "True"),
}


@pytest.fixture(scope="module", params=list(CASES))
def envs(request, tmp_path_factory):
    dense, cache, distractor = CASES[request.param]
    knobs = ["TASK_CONFIG.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES", dense,
             "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", cache,
             "TASK_CONFIG.SIMULATOR.AUDIO.HAS_DISTRACTOR_SOUND", distractor,
             "TASK_CONFIG.TASK.SENSORS", SENSORS]
    tmp = tmp_path_factory.mktemp(request.param)
    jroot, troot = copy_fixture(tmp / "jax"), copy_fixture(tmp / "port")
    jenv = jbuilder.construct_batched_env(jax_get_config(SAVI, opts=reference_opts(jroot, knobs)),
                                          with_depth=True, with_rgb=True, extra_sensors=EXTRA)
    env = builder.construct_batched_env(get_config(SAVI, opts=reference_opts(troot, knobs)), with_depth=True,
                                        with_rgb=True, extra_sensors=EXTRA, device="cpu")
    return request.param, jenv, env, troot


def test_reference_env_matches_jax(envs):
    case, jenv, env, root = envs
    host = case.startswith("host")
    assert isinstance(env.bank.rir, HostRIRStore if host else DenseRIRBank)
    assert isinstance(jenv.bank.rir, JaxHostRIRStore) == host
    if host:  # packed beside the copied tree
        assert env.bank.rir.index_path == os.path.join(root, "binaural_rirs", "mp3d", "_packed", "rirs.npz")
    banked = case.endswith("banked")
    assert (env.bank.spec_bank is not None) == (jenv.bank.spec_bank is not None) == banked
    if banked:
        np.testing.assert_allclose(env.bank.spec_bank.float().numpy(), np.asarray(jenv.bank.spec_bank, np.float32),
                                   rtol=2 ** -7, atol=1e-3)
    assert env.config.sensors == jenv.config.sensors
    assert {"semantic_object", "mpcat40_index", "rgb", "depth"} <= set(env.config.sensors)
    assert env.config.has_distractor == (case == "host_distractor")
    for k, v in jenv.eps.items():
        np.testing.assert_array_equal(env.eps[k].numpy(), np.asarray(v), err_msg=k)

    # the banked spectra round to bf16 apart: half an ulp of the larger value
    spec_atol = 2e-3 if not banked else max(2e-3, 2 ** -8 * float(np.abs(np.asarray(jenv.bank.spec_bank)).max()))
    jstate, jobs = jenv.reset()
    state, obs = env.reset()
    _compare(obs, jobs, "reset", spec_atol)
    ends = 0
    for t, a in enumerate(ACTIONS):
        jstate, jout = jenv.step(jstate, jnp.asarray(a, jnp.int32))
        state, out = env.step(state, torch.as_tensor(a))
        _compare(out.obs, jout.obs, f"obs{t}", spec_atol)
        _compare(out.metrics, jout.metrics, f"metrics{t}")
        np.testing.assert_allclose(out.reward.numpy(), np.asarray(jout.reward), atol=1e-5)
        np.testing.assert_array_equal(out.done.numpy(), np.asarray(jout.done))
        for k in ("semantic_object", "mpcat40_index"):
            assert out.obs[k].dtype == torch.int32
            np.testing.assert_array_equal(out.obs[k].numpy(), np.asarray(jout.obs[k]), err_msg=k)
        for k in ("rgb", "depth"):
            np.testing.assert_array_equal(out.obs[k].numpy(), np.asarray(jout.obs[k]), err_msg=k)
        ends += int(out.done.sum())
    assert ends > 0  # auto-reset exercised
    assert float(np.abs(out.obs["spectrogram"].numpy()).sum()) > 0  # measured RIRs reach the sensor


TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SCENES", "1",
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "3",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "12",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "2",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "3",
]


def test_pack_host_rirs_matches_jax(tmp_path):
    """The port packs the JAX world's procedural RIRs into the files JAX
    writes for them: the index exactly, the RIRs within float rounding."""
    jbank, _ = jsyn.make_scene_bank(np.random.RandomState(3), num_scenes=1, side=3, sampling_rate=4000,
                                    rir_length=400, num_sounds=2, frame_res=16, with_frames=False)
    bank = scene_bank_from_jax(jbank, "cpu")
    jbuilder._pack_synthetic_host_rirs(jbank, 4000)
    idx = builder.pack_synthetic_host_rirs(bank, 4000, pack_dir=str(tmp_path), chunk=50)
    assert isinstance(bank.rir, HostRIRStore) and isinstance(jbank.rir, JaxHostRIRStore)
    want_idx = np.load(jbank.rir._data.filename[: -len(".bin")] + ".npz")
    got_idx = np.load(idx)
    for k in want_idx.files:
        assert got_idx[k].dtype == want_idx[k].dtype, k
        np.testing.assert_array_equal(got_idx[k], want_idx[k], err_msg=k)
    got, want = np.asarray(bank.rir._data), np.asarray(jbank.rir._data)
    n = bank.max_nodes
    assert got.shape == want.shape == (1 * 4 * n * n * 400, 2)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6 * np.abs(want).max())


def test_pack_host_rirs_env_sees_the_procedural_world():
    """PACK_HOST_RIRS through the builder: the store serves the procedural
    bank's own RIRs exactly, and the env's observations equal the
    procedural env's (the analytic spectra against the time-domain path,
    2e-3 on the spectrogram) step after step."""
    opts = TINY + ["TASK_CONFIG.DATASET.SYNTHETIC.PACK_HOST_RIRS", "True"]
    env = builder.construct_batched_env(get_config(SAVI, opts=opts), extra_sensors=EXTRA, device="cpu")
    ref = builder.construct_batched_env(get_config(SAVI, opts=TINY), extra_sensors=EXTRA, device="cpu")
    assert isinstance(env.bank.rir, HostRIRStore) and ref.bank.rir.tail_fft is not None
    g = torch.Generator().manual_seed(0)
    n = env.bank.max_nodes
    idx = [torch.randint(0, m, (64,), generator=g) for m in (1, 4, n, n)]
    np.testing.assert_array_equal(env.bank.rir.gather(*idx).numpy(), ref.bank.rir.gather(*idx).numpy())
    state, obs = env.reset()
    rstate, robs = ref.reset()
    _compare(obs, {k: v.numpy() for k, v in robs.items()}, "reset")
    rng = np.random.RandomState(0)
    for t in range(8):
        a = torch.as_tensor(rng.randint(0, 4, 3))
        state, out = env.step(state, a)
        rstate, rout = ref.step(rstate, a)
        _compare(out.obs, {k: v.numpy() for k, v in rout.obs.items()}, f"obs{t}")
        assert torch.equal(out.reward, rout.reward) and torch.equal(out.done, rout.done)


def test_semantic_sensors_on_a_synthetic_world_match_jax():
    """The JAX env's synthetic world carried across: semantic_object and
    mpcat40_index equal JAX's pixel for pixel over reset and steps."""
    sensors = ("spectrogram", "pose", "category", "semantic_object", "mpcat40_index")
    jenv = jbuilder.construct_batched_env(jax_get_config(SAVI, opts=TINY), extra_sensors=sensors)
    import dataclasses

    jenv.config = dataclasses.replace(jenv.config, sensors=sensors)
    from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv

    jenv = JaxEnv(jenv.bank, {k: np.asarray(v) for k, v in jenv.eps.items()}, jenv.config)
    env = port_env_from_jax(jenv)
    jstate, jobs = jenv.reset()
    state, obs = env.reset()
    assert (obs["semantic_object"].numpy() == mp3d_utils.NUM_TASK_CATEGORIES).any()
    for k in ("semantic_object", "mpcat40_index"):
        np.testing.assert_array_equal(obs[k].numpy(), np.asarray(jobs[k]), err_msg=k)
    rng = np.random.RandomState(1)
    for _ in range(4):
        a = rng.randint(0, 4, 3)
        jstate, jout = jenv.step(jstate, jnp.asarray(a, jnp.int32))
        state, out = env.step(state, torch.as_tensor(a))
        for k in ("semantic_object", "mpcat40_index"):
            np.testing.assert_array_equal(out.obs[k].numpy(), np.asarray(jout.obs[k]), err_msg=k)


def test_semantic_sensor_reads_odd_instance_ids_as_jax():
    """Instance ids past the scene's table read instance 0, negative ids
    count from its end, and ids below minus its width read mpcat40 0, as
    JAX's take_along_axis does."""
    jenv = jbuilder.construct_batched_env(jax_get_config(SAVI, opts=TINY), extra_sensors=("semantic_object",))
    jbank = jenv.bank
    width = int(jbank.semantic_instance_to_mp3d.shape[1])
    sem = np.asarray(jbank.semantic).copy()
    odd = np.array([width, width + 5, -1, -width, -width - 1, -3 * width, 0, 1], np.int32)
    sem[..., 0, :8] = odd
    jbank.semantic = jnp.asarray(sem)
    from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv

    jenv = JaxEnv(jbank, {k: np.asarray(v) for k, v in jenv.eps.items()}, jenv.config)
    env = port_env_from_jax(jenv)
    _, jobs = jenv.reset()
    _, obs = env.reset()
    np.testing.assert_array_equal(obs["semantic_object"].numpy(), np.asarray(jobs["semantic_object"]))


HOUSE = """\
H name 0 0 0 0 0 0 11 1 1 2 1 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
L 0 1 0 label 0 0 0 0 0 0 0 0 0 0 0 0 0
R 0 0 0 0 b 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
R 1 0 0 0 k 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0 0
C 3 3 chair 3 chair 0 0 0 0 0
C 7 7 bath#tub 25 bathtub 0 0 0 0 0
C 9 9 wall 1 wall 0 0 0 0 0
O 0 0 3 1.0 2.0 3.0 1 0 0 0 1 0 0.5 0.5 0.5 0 0 0 0 0 0 0 0
O 1 0 7 4.0 5.0 6.0 1 0 0 0 1 0 1.0 1.0 1.0 0 0 0 0 0 0 0 0
O 2 1 9 7.0 8.0 9.0 1 0 0 0 1 0 2.0 2.0 2.0 0 0 0 0 0 0 0 0
O 4 1 5 0.0 0.0 0.0 1 0 0 0 1 0
"""


@pytest.mark.parametrize("which", ["fixture", "written"])
def test_house_reader_matches_jax(tmp_path, which):
    if which == "fixture":
        path = os.path.join(FIXTURE, "metadata", "mp3d", "sceneA", "sceneA.house")
    else:
        path = str(tmp_path / "scene.house")
        with open(path, "w") as f:
            f.write(HOUSE)
    got, want = mp3d_utils.HouseReader(path), jmp3d.HouseReader(path)
    assert (got.num_levels, got.num_regions) == (want.num_levels, want.num_regions)
    assert {k: vars(v) for k, v in got.categories.items()} == {k: vars(v) for k, v in want.categories.items()}
    assert len(got.objects) == len(want.objects)
    for o, w in zip(got.objects, want.objects):
        assert (o.index, o.region_index, o.category_index) == (w.index, w.region_index, w.category_index)
        np.testing.assert_array_equal(o.center, w.center)
        np.testing.assert_array_equal(o.radii, w.radii)
        assert got.object_task_category(o) == want.object_task_category(w)
    assert got.compute_object_to_category_index_mapping() == want.compute_object_to_category_index_mapping()
    for task in range(mp3d_utils.NUM_TASK_CATEGORIES):
        assert [o.index for o in got.objects_in_category(task)] == [o.index for o in want.objects_in_category(task)]
    np.testing.assert_array_equal(mp3d_utils.task_id_to_mp3d_id(), jmp3d.task_id_to_mp3d_id())
    np.testing.assert_array_equal(mp3d_utils.mp3d_id_to_task_id(), jmp3d.mp3d_id_to_task_id())
    assert mp3d_utils.CATEGORY_INDEX_MAPPING == jmp3d.CATEGORY_INDEX_MAPPING
