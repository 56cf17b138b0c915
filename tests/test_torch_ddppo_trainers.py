"""DD-PPO in the port's four trainers on 2 gloo ranks of the CPU, through
``run.main`` as torchrun would call it on each rank
(``tests/torch_dist.py``), on the tiny worlds of the trainers' own test
files:

* SAVi, AV-Nav, AV-WAN and AVLEN (π_q + π_l's replay) each take 2 updates
  and the ranks' parameters are bit-equal after each one (and moved);
  SAVi's run (greedy, one minibatch and one epoch, shared by the next
  case) writes one checkpoint set, from rank 0, and a second run resumes
  from it exactly on both ranks;
* the first update of that SAVi run over 2 ranks equals one process's
  within rtol 2e-4 / atol 2e-5 (JAX's
  ``test_superstep_sharded_matches_local_single_minibatch`` rule; the
  belief predictor's entries so where its gradient is settled, |g| > 2e-3,
  and elsewhere within Adam's first step of either sign, 2·lr + 1e-4, as
  chip_smoke's ``update_reference`` holds them), and rank 0's logged window
  stats equal the one process's;
* 3 envs over 2 ranks log JAX's warning, rank 1 trains nothing, and rank
  0's run equals single-device training;
* a TPU.MESH_SHAPE of fewer ranks than the group is refused.
"""

import hashlib
import logging
import os

import numpy as np
import pytest
import torch

from tests.torch_dist import run_ranks

torch.set_num_threads(1)

SAVI = "configs/semantic_audionav/savi/savi.yaml"
AVNAV = "configs/audionav/av_nav/audiogoal_depth.yaml"
AVWAN = "configs/audionav/av_wan/audiogoal_depth.yaml"
STAGE1 = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"
TINY_WORLD = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "3",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "4",
    "LOG_INTERVAL", "1",
    "VIDEO_OPTION", "[]",
]
SAVI_OPTS = TINY_WORLD + [  # tests/test_torch_slice.py's OPTS at 4 envs
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
    "RL.PPO.num_steps", "5",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.ppo_epoch", "1",
]
BASELINE_OPTS = TINY_WORLD + [  # tests/test_torch_avnav.py's and _avwan.py's worlds at 4 envs
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "6",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8",
    "PREDICTION_INTERVAL", "3",
    "RL.PPO.num_steps", "4",
    "RL.PPO.hidden_size", "32",
    "RL.PPO.ppo_epoch", "1",
    "RL.PPO.num_mini_batch", "2",
    "CHECKPOINT_INTERVAL", "100",
]
AVLEN_OPTS = TINY_WORLD + [  # tests/test_torch_interactive_train.py's TINY at 4 envs
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32", "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.CLIP_WIDTH", "32", "RL.PPO.CLIP_LAYERS", "1", "SPEAKER.BACKEND", "template",
    "SPEAKER.BANK_MODE", "callback", "RL.PPO.num_steps", "6", "RL.PPO.ppo_epoch", "1",
    "VLN_CKPT_PATH", "", "GOAL_CKPT_PATH", "", "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "",
    "REPLAY_STORE", "True", "CHECKPOINT_INTERVAL", "100",
]


def _digest(trainer) -> str:
    h = hashlib.sha256()
    for m in trainer.trained_modules():
        if m is not None:
            for p in m.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def train_rank(rank, runs, deterministic=False):
    """Each argv of ``runs`` through ``run.main`` on this rank: the
    parameters' digest after setup (and after a resume's restore) and after
    each update, the log records, what each trainer did."""
    import chip_smoke
    from avlen_tpu_torch import run
    from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.utils import preemption
    from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
    from avlen_tpu_torch.utils.logging import logger

    seen = {"updates": [], "broadcasts": [], "resume_diffs": []}
    refresh, broadcast, collect = (BaseRLTrainer._refresh_episode_stream, BaseRLTrainer.broadcast_parameters,
                                   SaviTrainer.collect)

    def after_update(self, carry):
        seen["updates"].append(_digest(self))
        return refresh(self, carry)

    def after_broadcast(self):
        broadcast(self)
        seen["broadcasts"].append(_digest(self))
        ckpts = list_checkpoints(self.config.CHECKPOINT_FOLDER) if self.config.RESUME_CHECKPOINT else []
        if ckpts and len(seen["broadcasts"]) == 2:  # the resumed run's restore
            seen["resume_diffs"].append(chip_smoke.state_differences(self, load_checkpoint(ckpts[-1])))

    def greedy(self, carry=None, deterministic=False, **kw):
        return collect(self, carry, True, **kw)

    BaseRLTrainer._refresh_episode_stream = after_update
    BaseRLTrainer.broadcast_parameters = after_broadcast
    if deterministic:
        SaviTrainer.collect = greedy
    records = []
    handler = logging.Handler(level=logging.INFO)
    handler.emit = lambda r: records.append(r.getMessage())
    logger.addHandler(handler)
    out = []
    preemption.INTERRUPTED_STATE_DIR = os.path.join(os.path.dirname(runs[0][runs[0].index("--model-dir") + 1]),
                                                    "interrupted")
    for argv in runs:
        seen.update(updates=[], broadcasts=[], resume_diffs=[])
        tr = run.main(argv)
        out.append({"updates": list(seen["updates"]), "broadcasts": list(seen["broadcasts"]),
                    "resume_diffs": list(seen["resume_diffs"]), "mesh": tr.mesh is not None,
                    "sits_out": tr.sits_out, "num_updates": tr.num_updates_done, "steps": tr.num_steps_done,
                    "local_envs": tr.env.num_envs if getattr(tr, "_setup_done", False) else None})
    out.append({"log": records})
    return out


def _argv(config, model_dir, *opts):
    return ["--run-type", "train", "--exp-config", config, "--model-dir", str(model_dir), "--device", "cpu",
            *opts]


def _checkpoints(model_dir):
    return sorted(os.listdir(os.path.join(str(model_dir), "data")))


def _assert_ranks_equal(ranks, updates):
    for run_i in range(len(ranks[0]) - 1):
        a, b = ranks[0][run_i], ranks[1][run_i]
        assert a["mesh"] and b["mesh"] and a["local_envs"] == b["local_envs"] == 2
        assert len(a["updates"]) == updates[run_i] and a["updates"] == b["updates"]
        assert a["broadcasts"] == b["broadcasts"]
        assert a["broadcasts"][0] != a["updates"][0]  # the parameters moved


@pytest.fixture(scope="module")
def savi_ranks(tmp_path_factory):
    """SAVi over 2 ranks with greedy acting and one minibatch: 2 updates,
    a checkpoint after each, then a run that resumes for 1 more."""
    d = tmp_path_factory.mktemp("savi")
    opts = [*SAVI_OPTS, "RL.PPO.num_mini_batch", "1", "CHECKPOINT_INTERVAL", "1"]
    runs = [_argv(SAVI, d / "model", *opts, "NUM_UPDATES", "2"),
            _argv(SAVI, d / "model", *opts, "NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True")]
    return d / "model", run_ranks(train_rank, 2, d, runs, True)


def test_savi_ranks_stay_equal_write_one_checkpoint_set_and_resume(savi_ranks):
    d, ranks = savi_ranks
    _assert_ranks_equal(ranks, [2, 1])
    for rank in ranks:
        assert rank[0]["steps"] == 2 * 5 * 4  # frames over both ranks' envs
        assert rank[1]["resume_diffs"] == [{"state_dict": 0.0, "belief_predictor": 0.0, "optim_state": 0.0,
                                            "belief_optim_state": 0.0}]
    assert _checkpoints(d) == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]
    assert len(os.listdir(d / "tb")) == 2  # one event file a run, rank 0's
    assert any(m.startswith("data-parallel training over 2 ranks") for m in ranks[0][-1]["log"])
    assert not any(m.startswith("savi update") for m in ranks[1][-1]["log"])  # rank 1 logs warnings only


@pytest.mark.parametrize("stack", ["avnav", "avwan", "avlen"])
def test_ranks_stay_bit_equal(stack, tmp_path):
    config, opts = {"avnav": (AVNAV, BASELINE_OPTS), "avwan": (AVWAN, BASELINE_OPTS),
                    "avlen": (STAGE1, AVLEN_OPTS)}[stack]
    ranks = run_ranks(train_rank, 2, tmp_path, [_argv(config, tmp_path / stack, *opts, "NUM_UPDATES", "2")])
    _assert_ranks_equal(ranks, [2])
    assert _checkpoints(tmp_path / stack) == ["ckpt.0.pth"]


def _flat(prefix, tree, out):
    for k, v in tree.items():
        if isinstance(v, dict):
            _flat(f"{prefix}/{k}", v, out)
        else:
            out[f"{prefix}/{k}"] = np.asarray(v)
    return out


def _params(model_dir, name="ckpt.0.pth"):
    """(policy and belief parameters, the belief Adam's first moments) of
    the run's checkpoint, flat by path."""
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint

    ckpt = load_checkpoint(os.path.join(str(model_dir), "data", name))
    params = {}
    for part in ("state_dict", "belief_predictor"):
        _flat(part, ckpt[part], params)
    return params, _flat("belief_predictor", ckpt["belief_optim_state"]["adam"]["exp_avg"], {})


def _one_process(model_dir, opts, deterministic=False):
    from avlen_tpu_torch import run
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    collect = SaviTrainer.collect
    with pytest.MonkeyPatch.context() as mp:
        if deterministic:
            mp.setattr(SaviTrainer, "collect",
                       lambda self, carry=None, deterministic=False, **kw: collect(self, carry, True, **kw))
        return run.main(_argv(SAVI, model_dir, *opts))


def test_two_ranks_match_one_process(savi_ranks, tmp_path):
    """The shared run's first update (ckpt.0, the first logged step)
    against one process's single update."""
    from avlen_tpu_torch.utils.tb import read_scalars

    d, _ = savi_ranks
    opts = [*SAVI_OPTS, "NUM_UPDATES", "1", "CHECKPOINT_INTERVAL", "1", "RL.PPO.num_mini_batch", "1"]
    one = _one_process(tmp_path / "one", opts, deterministic=True)
    assert one.mesh is None and one.num_steps_done == 5 * 4
    (got, _), (want, exp_avg) = _params(d), _params(tmp_path / "one")
    assert set(got) == set(want)
    settled = 0
    for k in want:
        if k.startswith("belief_predictor"):
            firm = np.abs(exp_avg.get(k, np.zeros_like(want[k])) / (1 - 0.9)) > 2e-3
            settled += int(firm.sum())
            np.testing.assert_allclose(got[k][firm], want[k][firm], rtol=2e-4, atol=2e-5, err_msg=k)
            np.testing.assert_allclose(got[k], want[k], rtol=0, atol=2 * 1e-3 + 1e-4, err_msg=k)
        else:
            np.testing.assert_allclose(got[k], want[k], rtol=2e-4, atol=2e-5, err_msg=k)
    assert settled > 0
    s1 = read_scalars(str(tmp_path / "one" / "tb"))
    s2 = {k: [(s, v) for s, v in ev if s == 5 * 4] for k, ev in read_scalars(str(d / "tb")).items()}
    metrics = sorted(k for k in s1 if k.startswith("Metrics/"))
    assert metrics and metrics == sorted(k for k in s2 if k.startswith("Metrics/") and s2[k])
    for k in metrics:
        assert [s for s, _ in s2[k]] == [s for s, _ in s1[k]], k
        np.testing.assert_allclose([v for _, v in s2[k]], [v for _, v in s1[k]], rtol=1e-6, err_msg=k)
    for k in ("Policy/value_loss", "Policy/action_loss", "Policy/entropy"):
        np.testing.assert_allclose([v for _, v in s2[k]], [v for _, v in s1[k]], rtol=2e-4, atol=2e-5, err_msg=k)


def test_indivisible_envs_fall_back_to_single_device(tmp_path):
    opts = [*SAVI_OPTS, "NUM_PROCESSES", "3", "NUM_UPDATES", "1", "CHECKPOINT_INTERVAL", "100"]
    ranks = run_ranks(train_rank, 2, tmp_path, [_argv(SAVI, tmp_path / "ranks2", *opts)])
    warning = "num_envs=3 not divisible by mesh size 2; falling back to single-device training"
    for rank in ranks:
        assert warning in rank[-1]["log"]
    r0, r1 = ranks[0][0], ranks[1][0]
    assert not r0["mesh"] and not r0["sits_out"] and r0["num_updates"] == 1 and r0["local_envs"] == 3
    assert r1["sits_out"] and r1["num_updates"] == 0 and r1["updates"] == []
    one = _one_process(tmp_path / "one", opts)
    assert one.num_updates_done == 1
    (got, _), (want, _) = _params(tmp_path / "ranks2"), _params(tmp_path / "one")
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


@pytest.mark.parametrize("shape, world_size, size", [
    ([-1], 4, 4), ([4], 4, 4), ([2, -1], 4, None), ([1], 2, None), ([2], 4, None), ([3], 4, None)])
def test_mesh_must_span_the_process_group(shape, world_size, size, monkeypatch):
    """TPU.MESH_SHAPE over the group: a mesh of every rank on the 'data'
    axis trains; a smaller one, or one that shards another axis, raises."""
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.parallel import mesh as mesh_mod
    from avlen_tpu_torch.rl.trainers import base
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    axes = ["data", "model"][:len(shape)]
    cfg = get_config(SAVI, ["TPU.MESH_AXES", str(axes), "TPU.MESH_SHAPE", str(shape)])
    tr = SaviTrainer(cfg, device="cpu")
    for mod in (mesh_mod, base):
        monkeypatch.setattr(mod, "world", lambda: (1, world_size))
    if size is None:
        with pytest.raises(ValueError, match="shards the 'data' axis over all"):
            tr._make_train_mesh(8)
    else:
        mesh = tr._make_train_mesh(8)
        assert (mesh.shape, mesh.rank, mesh.world_size, tr.sits_out) == ((size,), 1, world_size, False)
