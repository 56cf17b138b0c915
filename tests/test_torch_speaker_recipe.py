"""Recipe stage 4 → 5 on the port, the counterpart of
tests/test_speaker_recipe_r4.py: the shipped AVLEN stage yamls declare the
neural speaker; a tiny speaker trained by the port's ``train_speaker``
serves an instruction bank equal, token for token, to the bank the JAX
package builds from the same ``speaker.pth``; and the shipped
savi_interactive_1st_stage.yaml, shrunk to a tiny world but with its
neural speaker kept, loads that snapshot through SPEAKER.CKPT_PATH and
takes one AVLEN update (π_q) with finite losses."""

import numpy as np
import pytest
import torch

from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.dialog import instruction_bank as jbank
from avlen_tpu.dialog import instruction_source as jsource
from avlen_tpu.sim.graph import build_scene_tables as jax_build_scene_tables
from avlen_tpu.sim.synthetic import make_grid_scene as jax_make_grid_scene
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.dialog import instruction_bank, instruction_source
from avlen_tpu_torch.dialog.speaker.train_speaker import train_speaker
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_grid_scene
from tests.test_torch_interactive_setup import WORLD

torch.set_num_threads(1)

YAML_1ST = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"
YAML_2ND = "configs/semantic_audionav/savi/savi_interactive_2nd_stage.yaml"


@pytest.fixture(scope="module")
def speaker_pth(tmp_path_factory):
    d = tmp_path_factory.mktemp("speaker")
    tables = [build_scene_tables(make_grid_scene(np.random.RandomState(s), side=4)) for s in (0, 1)]
    train_speaker(tables, num_steps=20, batch=8, hidden_size=32, num_pairs=64, checkpoint_dir=str(d), device="cpu")
    return str(d / "speaker.pth")


@pytest.mark.parametrize("path", [YAML_1ST, YAML_2ND])
def test_shipped_yamls_declare_the_neural_speaker(path):
    for cfg in (get_config(path), jax_get_config(path)):
        assert cfg.SPEAKER.BACKEND == "neural"
        assert cfg.SPEAKER.CKPT_PATH == "data/pretrained_weights/speaker/speaker.pth"


def test_neural_bank_matches_jax(speaker_pth):
    jt = [jax_build_scene_tables(jax_make_grid_scene(np.random.RandomState(s), side=4)) for s in (2, 3)]
    tt = [build_scene_tables(make_grid_scene(np.random.RandomState(s), side=4)) for s in (2, 3)]
    cfg = get_config(YAML_1ST, opts=["SPEAKER.CKPT_PATH", speaker_pth])
    spk = instruction_source.speaker_from_config(cfg, tt, device="cpu")
    jspk = jsource.speaker_from_config(jax_get_config(YAML_1ST, opts=["SPEAKER.CKPT_PATH", speaker_pth]), jt)
    assert spk.backend == jspk.backend == "neural"
    got = instruction_bank.build_instruction_bank(spk, tt)
    want = jbank.build_instruction_bank(jspk, jt)
    np.testing.assert_array_equal(got, want)
    assert len({tuple(r) for r in got.reshape(-1, got.shape[-1])}) > 2  # not one text everywhere


def test_stage_trains_with_the_shipped_yaml_and_the_trained_speaker(speaker_pth, tmp_path, monkeypatch):
    built = {}
    orig = instruction_source.speaker_from_config

    def spy(*args, **kwargs):
        sp = orig(*args, **kwargs)
        built.update(backend=sp.backend, model=sp.model is not None)
        return sp

    monkeypatch.setattr(instruction_source, "speaker_from_config", spy)
    missing = str(tmp_path / "missing.pth")
    cfg = get_config(YAML_1ST, opts=WORLD + [
        "RL.PPO.CLIP_WIDTH", "64", "RL.PPO.CLIP_LAYERS", "2", "SPEAKER.CKPT_PATH", speaker_pth,
        "GOAL_CKPT_PATH", missing, "VLN_CKPT_PATH", missing, "RL.PPO.BELIEF_PREDICTOR.pretrained_path", missing])
    assert cfg.SPEAKER.BACKEND == "neural"  # the shipped yaml's, not an override
    tr = InteractiveDDPPOTrainer(cfg, device="cpu")
    tr._setup()
    assert built == {"backend": "neural", "model": True}
    assert tr.instr_bank is not None and tr.bank_seconds > 0
    _, traj = tr.collect(n=6)
    stats = tr.update(traj)
    assert all(torch.isfinite(v) for v in stats.values())

    with pytest.raises(FileNotFoundError, match="speaker checkpoint"):
        InteractiveDDPPOTrainer(get_config(YAML_1ST, opts=WORLD + ["SPEAKER.CKPT_PATH", missing]),
                                device="cpu")._setup()
