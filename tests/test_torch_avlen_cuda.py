"""AVLEN stage-2 evaluation on a CUDA card, 10 envs at the published widths
(savi_interactive_2nd_stage.yaml, run type eval, the neural speaker on the
host per query): over an ``eval_collect``, π_g's act, replayed from its CUDA
graphs once its key repeats, returns what the same collect's eager act
returns, bit for bit, and so does everything the collect gives; the CLIP
tower's calls and the speaker's decodes come out equal. Run on the card with
``python -m pytest tests/test_torch_avlen_cuda.py --noconftest``; skips
where there is no card."""

import pytest
import torch

pytestmark = pytest.mark.cuda

STAGE2 = "configs/semantic_audionav/savi/savi_interactive_2nd_stage.yaml"
STEPS = 24
OPTS = ["TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "6", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "40",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "4000", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "128",
        "VLN_CKPT_PATH", "", "GOAL_CKPT_PATH", "", "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "",
        "SPEAKER.BACKEND", "neural", "SPEAKER.CKPT_PATH", "", "SPEAKER.BANK_MODE", "callback",
        "VIDEO_OPTION", "[]", "RL.PPO.num_steps", str(STEPS)]


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _collect(trainer, path):
    """One recorded collect of a fresh eval of ``path``: (π_g's act
    outputs, the trajectory, the counters with the CLIP tower's calls, the
    act graph's replays)."""
    from avlen_tpu_torch.utils import profiling

    acts = []
    act = trainer.goal_policy.act

    def recorded(*a, **k):
        out = act(*a, **k)
        acts.append(out)
        return out

    trainer.goal_policy.act = recorded
    trainer.instr_source._cache.clear()
    replays = profiling.GRAPH_COUNTERS["act"]["replays"]
    clip0 = trainer.clip_calls
    profiling.enable()
    try:
        traj = trainer.eval_collect(trainer.eval_start(path))
    finally:
        profiling.disable()
        del trainer.goal_policy.act
    counters = dict(profiling.export()["counters"], **{"clip.calls": trainer.clip_calls - clip0})
    return acts, traj, counters, profiling.GRAPH_COUNTERS["act"]["replays"] - replays


def _leaves(tree):
    from avlen_tpu_torch.models import graphed

    leaves = []
    graphed.flatten(tree, leaves)
    return leaves


def test_goal_act_replays_equal_the_eager_acts_in_the_eval(dev, tmp_path, monkeypatch):
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.models import graphed
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer

    cfg = get_config(STAGE2, opts=OPTS, model_dir=str(tmp_path), run_type="eval")
    trainer = InteractiveDDPPOTrainer(cfg, device=dev)
    trainer._setup()
    assert trainer.env.num_envs == 10
    path = trainer.save_checkpoint("ckpt.0.pth")
    acts, traj, counters, replays = _collect(trainer, path)
    with monkeypatch.context() as mp:
        mp.setattr(graphed, "on_card", lambda leaves, generator: False)
        eager_acts, eager_traj, eager_counters, eager_replays = _collect(trainer, path)
    assert replays == STEPS - 2 and eager_replays == 0  # the first call at a key is eager, the second captures
    assert len(acts) == len(eager_acts) == STEPS
    for got, want in zip(acts, eager_acts):
        assert all(torch.equal(a, b) for a, b in zip(got, want))
    got, want = _leaves(traj), _leaves(eager_traj)
    assert len(got) == len(want) and all(torch.equal(a, b) for a, b in zip(got, want))
    assert counters["clip.calls"] == eager_counters["clip.calls"] > 0
    assert counters.get("speaker.decodes", 0) == eager_counters.get("speaker.decodes", 0) > 0
