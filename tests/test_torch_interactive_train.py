"""AVLEN's training loop, checkpoints, resume and eval on the port, through
``run.main([... "--device", "cpu"])`` on a tiny world: stage 1
(savi_interactive_1st_stage.yaml) trains one update and writes ``ckpt.0``
with the JAX trainer's keys, whose parameter trees the JAX package's
``load_checkpoint`` reads; stage 2 (2nd_stage.yaml,
RESUME_CHECKPOINT, REPLAY_STORE) resumes π_q, π_g, π_l and both Adam
states exactly, trains π_q and π_l, and writes ``ckpt.1``. The
checkpoints (~0.7 GB each: three policies' full-width ResNet towers and two
Adams) are deleted after. The eval is tests/test_torch_interactive_eval.py."""

import os
import shutil

import numpy as np
import pytest
import torch

import chip_smoke
from avlen_tpu.utils import checkpoint as jckpt
from avlen_tpu_torch import run
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.utils import preemption
from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
from avlen_tpu_torch.utils.flax_bridge import _flatten, to_flax_params
from avlen_tpu_torch.utils.tb import read_scalars

torch.set_num_threads(1)

STAGE1 = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"
STAGE2 = "configs/semantic_audionav/savi/savi_interactive_2nd_stage.yaml"
TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000", "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "NUM_PROCESSES", "3", "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32", "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.CLIP_WIDTH", "32", "RL.PPO.CLIP_LAYERS", "1", "SPEAKER.BACKEND", "template",
    "RL.PPO.num_steps", "6", "LOG_INTERVAL", "1",
    "SPEAKER.BANK_MODE", "callback",  # the host speaker: no bank to build at each setup
]
JAX_KEYS = {"state_dict", "state_dict_goal", "state_dict_vln", "optim_state", "optim_state_vln", "config",
            "extra_state", "belief_predictor"}  # InteractiveDDPPOTrainer._checkpoint_payload


def _main(model_dir, config, *args, run_type="train"):
    return run.main(["--run-type", run_type, "--exp-config", config, "--model-dir", str(model_dir),
                     "--device", "cpu", *TINY, *args])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Stage 1 (one update), then stage 2 resumed (one update)."""
    d = tmp_path_factory.mktemp("avlen")
    out = {"dir": d}
    try:
        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(preemption, "INTERRUPTED_STATE_DIR", str(d / "interrupted"))
            common = ["VLN_CKPT_PATH", "", "GOAL_CKPT_PATH", "", "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "",
                      "CHECKPOINT_INTERVAL", "1"]
            out["stage1"] = _main(d, STAGE1, *common, "NUM_UPDATES", "1")
            out["saved"] = load_checkpoint(str(d / "data" / "ckpt.0.pth"))
            out["jax_read"] = jckpt.load_checkpoint(str(d / "data" / "ckpt.0.pth"))

            collect = InteractiveDDPPOTrainer.collect
            seen = {}

            def hooked(self, *args, **kwargs):
                if not seen:  # before the resumed run's first update
                    seen["diffs"] = chip_smoke.state_differences(self, out["saved"])
                    seen["count"], seen["steps"] = self.optimizer_q.count, self.num_steps_done
                return collect(self, *args, **kwargs)

            mp.setattr(InteractiveDDPPOTrainer, "collect", hooked)
            out["stage2"] = _main(d, STAGE2, *common, "NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True")
            mp.setattr(InteractiveDDPPOTrainer, "collect", collect)
            out["resumed"] = seen
            out["after"] = load_checkpoint(str(d / "data" / "ckpt.1.pth"))
            out["ckpts"] = [os.path.basename(p) for p in list_checkpoints(str(d / "data"))]
        yield out
    finally:
        shutil.rmtree(d, ignore_errors=True)


def test_stage1_writes_the_jax_trainers_checkpoint(runs):
    tr, saved, jread = runs["stage1"], runs["saved"], runs["jax_read"]
    assert set(saved) == JAX_KEYS and runs["ckpts"] == ["ckpt.0.pth", "ckpt.1.pth"]
    assert saved["extra_state"] == {"step": 18} and saved["optim_state"]["count"] == 2 * 2  # epochs x minibatches
    # the JAX package reads the port's parameters, at its modules' paths and shapes
    for k in ("state_dict", "state_dict_goal", "state_dict_vln", "belief_predictor"):
        assert chip_smoke._max_tree_diff(jread[k], saved[k]) == 0
    # the trees the port's modules give, whose paths and shapes are the JAX
    # modules' (tests/test_torch_dialog_models.py holds that)
    for k, module in (("state_dict", tr.option_policy), ("state_dict_goal", tr.goal_policy),
                      ("state_dict_vln", tr.dialog_policy), ("belief_predictor", tr.belief_net)):
        assert _flatten(saved[k]).keys() == _flatten(to_flax_params(module)).keys(), k
    # π_l's Adam lists every Flax path and holds the parameters that took a
    # step: none in stage 1 (no REPLAY_STORE), never the frozen CLIP tower
    for ckpt, trained in ((saved, False), (runs["after"], True)):
        vln = ckpt["optim_state_vln"]
        assert sorted(vln["paths"].values()) == sorted("/".join(p) for p in _flatten(ckpt["state_dict_vln"]))
        steps = _flatten(vln["adam"]["step"])
        assert _flatten(vln["adam"]["exp_avg"]).keys() == steps.keys()
        assert not any("clip" in p for p in steps)  # the frozen tower
        assert {float(v) for v in steps.values()} == ({1.0} if trained else set())


def test_stage2_resumes_exactly_and_trains_both_learners(runs):
    resumed, saved, after = runs["resumed"], runs["saved"], runs["after"]
    assert resumed["diffs"] == {k: 0.0 for k in JAX_KEYS - {"config", "extra_state"}}
    assert resumed["count"] == 4 and resumed["steps"] == 18
    assert after["extra_state"] == {"step": 36} and after["optim_state"]["count"] == 8
    assert chip_smoke._max_tree_diff(after["state_dict"], saved["state_dict"]) > 0  # π_q trained
    assert chip_smoke._max_tree_diff(after["state_dict_vln"], saved["state_dict_vln"]) > 0  # π_l's replay CE
    assert chip_smoke._max_tree_diff(after["state_dict_goal"], saved["state_dict_goal"]) == 0  # π_g frozen
    clip = {p: v for p, v in _flatten(after["state_dict_vln"]).items() if "clip" in p}
    assert clip and all(np.array_equal(v, _flatten(saved["state_dict_vln"])[p]) for p, v in clip.items())
    scalars = read_scalars(str(runs["dir"] / "tb"))
    for tag in ("Policy/value_loss", "Policy/action_loss", "Policy/entropy", "Policy/unct_loss",
                "Policy/dialog_loss"):
        assert tag in scalars and all(np.isfinite(v) for _, v in scalars[tag]), tag
