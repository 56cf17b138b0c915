"""The port's small modules against the JAX package on the CPU:
observation transformers (utils/obs_transformers.py: f32 within 1e-4,
uint8 within 1 with at least 99 % exact, up- and down-sampling), the
scripted agents and ``benchmark_agent`` (sim/simple_agents.py: the oracle's
stats equal to JAX's, success 1.0), ``QuesGen`` (dialog/ques_gen.py: ids
equal to JAX's with its parameters carried across) and the sm_90a gate
(utils/platform.py: it raises on another capability before any kernel is
built or loaded, and ``run.main`` calls it)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.core.episodes import pack_episodes as jax_pack
from avlen_tpu.dialog import ques_gen as jqg
from avlen_tpu.sim import simple_agents as jagents
from avlen_tpu.sim.env import BatchedAudioNavEnv as JaxEnv
from avlen_tpu.sim.env import EnvConfig as JaxEnvConfig
from avlen_tpu.sim.synthetic import make_episodes, make_scene_bank
from avlen_tpu.utils import obs_transformers as jot
from avlen_tpu_torch.core.registry import registry
from avlen_tpu_torch.dialog.ques_gen import QUESTION_WORDS, QuesGen, ques_out, ques_vocabulary
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig
from avlen_tpu_torch.sim.simple_agents import (
    ForwardOnlyAgent,
    GoalFollower,
    RandomAgent,
    RandomForwardAgent,
    benchmark_agent,
)
from avlen_tpu_torch.utils import cuda_build, platform
from avlen_tpu_torch.utils import obs_transformers as ot
from avlen_tpu_torch.utils.flax_bridge import load_quesgen_params, scene_bank_from_jax

torch.set_num_threads(1)

F32_TOL = 1e-4

# (H, W, size): downsampling (antialiased), upsampling, mixed, identity
RESIZE_CASES = [(64, 128, 32), (100, 80, 64), (37, 53, 17), (16, 24, 40), (12, 9, 30), (20, 20, 20)]


@pytest.mark.parametrize("h,w,size", RESIZE_CASES)
def test_resize_shortest_edge_matches_jax(h, w, size):
    rng = np.random.RandomState(h * w + size)
    obs = {
        "rgb": (rng.rand(2, h, w, 3) * 255).astype(np.uint8),
        "depth": rng.rand(2, h, w, 1).astype(np.float32),
        "semantic": (rng.rand(2, h, w, 1) * 40).astype(np.float32),
        "pose": rng.rand(2, 4).astype(np.float32),
    }
    got = ot.ResizeShortestEdge(size)({k: torch.as_tensor(v) for k, v in obs.items()})
    want = jot.ResizeShortestEdge(size)({k: jnp.asarray(v) for k, v in obs.items()})
    for k in obs:
        g, wv = got[k].numpy(), np.asarray(want[k])
        assert g.shape == wv.shape and g.dtype == wv.dtype, k
        if k == "pose":
            np.testing.assert_array_equal(g, wv)  # non-image keys untouched
        elif k == "rgb":
            d = np.abs(g.astype(np.int16) - wv.astype(np.int16))
            assert d.max() <= 1 and (d == 0).mean() >= 0.99, (d.max(), (d == 0).mean())
        else:
            np.testing.assert_allclose(g, wv, atol=F32_TOL * max(1.0, float(np.abs(wv).max())), rtol=0,
                                       err_msg=k)


@pytest.mark.parametrize("shape", [(4, 4), (6, 10), (10, 10), (12, 3)])
def test_center_crop_and_pipeline_match_jax(shape):
    img = np.random.RandomState(0).rand(2, 10, 10, 1).astype(np.float32)
    got = ot.CenterCropper(shape)({"depth": torch.as_tensor(img)})["depth"].numpy()
    np.testing.assert_array_equal(got, np.asarray(jot.CenterCropper(shape)({"depth": jnp.asarray(img)})["depth"]))
    rgb = (np.random.RandomState(1).rand(1, 100, 80, 3) * 255).astype(np.uint8)
    size = (4 * max(shape), 4 * max(shape))
    got = ot.apply_obs_transforms({"rgb": torch.as_tensor(rgb)}, [ot.ResizeCenterCropper(size)])["rgb"].numpy()
    want = np.asarray(jot.apply_obs_transforms({"rgb": jnp.asarray(rgb)}, [jot.ResizeCenterCropper(size)])["rgb"])
    assert got.shape == want.shape == (1,) + size + (3,)
    assert np.abs(got.astype(np.int16) - want.astype(np.int16)).max() <= 1
    assert registry.get_model("ResizeShortestEdge") is ot.ResizeShortestEdge
    assert registry.get_model("CenterCropper") is ot.CenterCropper


@pytest.fixture(scope="module")
def envs():
    """test_aux.py's world in both packages (the JAX world carried across)."""
    bank, tables = make_scene_bank(
        np.random.RandomState(0), num_scenes=1, side=5, rir_length=300, sampling_rate=2000,
        with_frames=False,
    )
    eps = make_episodes(np.random.RandomState(1), tables, 12, min_hops=1, max_hops=4)
    packed = jax_pack(eps, num_envs=3)
    sensors = ("spectrogram", "pose")
    jenv = JaxEnv(bank, packed, JaxEnvConfig(max_episode_steps=20, sensors=sensors))
    tenv = BatchedAudioNavEnv(scene_bank_from_jax(bank, "cpu"), {k: np.asarray(v) for k, v in packed.items()},
                              EnvConfig(max_episode_steps=20, sensors=sensors))
    return jenv, tenv


@pytest.mark.parametrize("num_episodes,max_steps", [(6, 2000), (20, 2000), (50, 9)])
def test_goal_follower_benchmark_matches_jax(envs, num_episodes, max_steps):
    jenv, tenv = envs
    got = benchmark_agent(tenv, GoalFollower(), num_episodes=num_episodes, max_steps=max_steps)
    want = jagents.benchmark_agent(jenv, jagents.GoalFollower(), num_episodes=num_episodes, max_steps=max_steps)
    assert got == want
    assert got["success"] == 1.0 and got["spl"] == pytest.approx(1.0, abs=1e-5)


def test_scripted_agents(envs):
    _, tenv = envs
    oracle = benchmark_agent(tenv, GoalFollower(), num_episodes=6)
    random_stats = benchmark_agent(tenv, RandomAgent(), num_episodes=6)
    assert random_stats["success"] <= oracle["success"]
    state, obs = tenv.reset()
    for agent in (RandomAgent(seed=3), RandomForwardAgent(seed=3), ForwardOnlyAgent()):
        a = agent.act(tenv, state, obs)
        assert a.shape == (3,) and a.dtype == torch.long and bool(((a >= 0) & (a <= 3)).all())
    # seeded: the same seed deals the same stream, another seed another

    def stream(agent):
        return torch.cat([agent.act(tenv, state, obs) for _ in range(20)])

    assert torch.equal(stream(RandomAgent(seed=5)), stream(RandomAgent(seed=5)))
    assert not torch.equal(stream(RandomAgent(seed=5)), stream(RandomAgent(seed=6)))
    fwd = stream(RandomForwardAgent(seed=1))
    assert set(fwd.tolist()) <= {1, 2, 3} and (fwd == 1).float().mean() > 0.5
    assert ForwardOnlyAgent().act(tenv, state, obs).tolist() == [1, 1, 1]


def test_ques_gen_matches_jax():
    vocab = ques_vocabulary()
    assert len(vocab) == len(jqg.ques_vocabulary()) and "what" in vocab.word2idx
    assert QUESTION_WORDS == jqg.QUESTION_WORDS
    jmodel = jqg.QuesGen(vocab_size=len(vocab), hidden_size=32, max_len=5)
    rgb = (np.random.RandomState(0).rand(6, 32, 32, 3) * 255).astype(np.uint8)
    rgb[0] = 0  # test_aux.py's all-black frame
    params = jax.jit(jmodel.init)(jax.random.key(0), jnp.asarray(rgb))
    want = np.asarray(jax.jit(jmodel.apply)(params, jnp.asarray(rgb)))
    model = QuesGen(len(vocab), hidden_size=32, max_len=5, generator=torch.Generator().manual_seed(0))
    load_quesgen_params(model, jax.tree_util.tree_map(np.asarray, params))
    got = model(torch.as_tensor(rgb))
    assert got.shape == (6, 5) and got.dtype == torch.long
    np.testing.assert_array_equal(got.numpy(), want)
    # JAX's ques_out is apply + decode; its eager apply is slow, so decode the jitted ids
    jvocab = jqg.ques_vocabulary()
    assert ques_out(model, vocab, torch.as_tensor(rgb)) == [" ".join(jvocab.decode(row)) for row in want]
    with pytest.raises(KeyError):  # every parameter must be covered
        load_quesgen_params(model, {"params": {k: v for k, v in params["params"].items() if k != "Dense_1"}})


def _card(monkeypatch, cap):
    monkeypatch.setattr(torch.cuda, "get_device_capability", lambda device=None: cap)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda device=None: "NVIDIA A100-SXM4-80GB")


def test_require_sm90a_raises_on_another_card(monkeypatch):
    _card(monkeypatch, (8, 0))
    with pytest.raises(RuntimeError, match=r"A100-SXM4-80GB has compute capability 8\.0"):
        platform.require_sm90a()
    # before any nvcc run or library load
    monkeypatch.setattr(cuda_build, "nvcc_path", lambda: pytest.fail("nvcc reached"))
    monkeypatch.setattr(cuda_build, "_LOADED", {})
    for call in (lambda: cuda_build.build(("spectrogram",)), lambda: cuda_build.load("spectrogram")):
        with pytest.raises(RuntimeError, match="sm_90a"):
            call()
    # run.main checks the card after the device check
    from avlen_tpu_torch import run

    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    with pytest.raises(RuntimeError, match="capability 8.0"):
        run.main(["--device", "cuda"])
    _card(monkeypatch, (9, 0))
    platform.require_sm90a()


def test_require_device_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        platform.require_device("cuda")
    platform.require_device("cpu")
