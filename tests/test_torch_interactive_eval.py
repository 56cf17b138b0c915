"""AVLEN's interactive eval on the port, through ``run.main(["--run-type",
"eval", ... "--device", "cpu"])`` on a tiny world of
savi_interactive_2nd_stage.yaml: a checkpoint that a set-up trainer writes
is evaluated with the configured query strategy (here ``uniform`` with a
budget of one query an episode) over the train split; each episode is
counted once, the means go to ``val/*`` and each episode to
``test_log_ckpt0_{sound}.txt`` and ``eval_stats_ckpt0_{sound}.npz``; with
VIDEO_OPTION set the eval refuses to start (videos are not ported)."""

import shutil

import numpy as np
import pytest
import torch

from avlen_tpu_torch import run
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.utils.tb import read_scalars
from tests.test_torch_interactive_train import STAGE2, TINY

torch.set_num_threads(1)

OPTS = TINY + ["VLN_CKPT_PATH", "", "GOAL_CKPT_PATH", "", "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "",
               "QS_METHOD", "uniform", "LIMIT_QUERY", "True", "HOW_MANY_QUERY", "1", "EVAL.SPLIT", "train",
               "TEST_EPISODE_COUNT", "6"]


@pytest.fixture(scope="module")
def evaluated(tmp_path_factory):
    d = tmp_path_factory.mktemp("avlen_eval")
    try:
        tr = InteractiveDDPPOTrainer(get_config(STAGE2, opts=OPTS, model_dir=str(d)), device="cpu")
        tr._setup()
        tr.save_checkpoint("ckpt.0.pth")
        ev = run.main(["--run-type", "eval", "--exp-config", STAGE2, "--model-dir", str(d), "--device", "cpu",
                       *OPTS, "VIDEO_OPTION", "[]", "USE_LAST_CKPT", "True"])
        yield d, ev, read_scalars(str(d / "tb"))
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_eval_counts_each_episode_once(evaluated):
    d, ev, scalars = evaluated
    ids = ev._last_eval_episode_ids
    assert len(ids) == 6 == len(set(ids))
    assert scalars["val/episodes_evaluated"] == [(0, 6.0)]
    for k in ("val/success", "val/spl", "val/query_count"):
        assert np.isfinite(scalars[k][0][1]), k


def test_eval_takes_the_configured_query_strategy(evaluated):
    d, ev, scalars = evaluated
    assert ev.config.QS_METHOD == "uniform" and ev.config.HOW_MANY_QUERY == 1
    log = (d / "test_log_ckpt0_unheard.txt").read_text().splitlines()
    stats = np.load(d / "eval_stats_ckpt0_unheard.npz")
    assert len(log) == 6 and all(line.startswith("episode ") and "queries=" in line for line in log)
    assert sorted(stats["episode"].tolist()) == ev._last_eval_episode_ids
    # uniform asks at the first step of an episode, and the budget allows one
    assert set(stats["query_count"].tolist()) == {1.0}
    assert scalars["val/query_count"][0][1] == 1.0


def test_eval_refuses_videos(tmp_path):
    with pytest.raises(NotImplementedError, match="VIDEO_OPTION"):
        run.main(["--run-type", "eval", "--exp-config", STAGE2, "--model-dir", str(tmp_path), "--device", "cpu",
                  *OPTS])
