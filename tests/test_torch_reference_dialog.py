"""AVLEN's dialog data from an aligned reference tree, on the CPU: a copy of
tests/data/reference_tree gets chip_smoke's fabricated FGR2R / VLN-CE /
connectivity files for its scene, aligned into its dialog_approx split
(min_path_len 2, as the card's ``vln_dialog`` phase) by the port and by
the JAX package alike. From that split (the split stub, ``content/`` beside
it, ``dialog_node`` as a node path, ``rotation_angle`` over the
quaternion) the port's env gives JAX's ``sub_instr`` token bank, π_l's
pretraining rollout serves each episode's dataset instruction in place of
the oracle bank's, and AVLEN stage 1 collects."""

import gzip
import os

import numpy as np
import pytest
import torch

import chip_smoke
from avlen_tpu.config import get_config as jax_get_config
from avlen_tpu.data import vln as jvln
from avlen_tpu.data.reference import load_scene_graph as jax_load_scene_graph
from avlen_tpu.dialog.instruction_source import sub_instr_token_bank as jax_sub_instr_token_bank
from avlen_tpu.sim import builder as jbuilder
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.dialog.instruction_source import sub_instr_token_bank
from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
from avlen_tpu_torch.sim.builder import construct_batched_env
from tests.test_torch_native import build_jax_native
from tests.test_torch_reference_env import copy_fixture

torch.set_num_threads(1)


SCAN = chip_smoke.VLN_SCAN
TINY = [
    "NUM_PROCESSES", "3",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "4",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "RL.PPO.CLIP_WIDTH", "64", "RL.PPO.CLIP_LAYERS", "2",
    "SPEAKER.BACKEND", "template",
]


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    build_jax_native()


@pytest.fixture(scope="module")
def aligned(tmp_path_factory):
    """The port's aligned tree and JAX's (each its own copy: the host RIR
    packs go beside the tree)."""
    tmp = tmp_path_factory.mktemp("dialog")
    tree = copy_fixture(tmp / "port")
    data_path, counts, _ = chip_smoke.align_reference_dialog(tree)
    jtree = copy_fixture(tmp / "jax")
    paths = chip_smoke.write_r2r_fixtures(jtree)
    jout = os.path.join(jtree, "datasets", "semantic_audionav_dialog_approx", "v1", "train")
    jcounts = jvln.generate_dialog_dataset(
        fgr2r_path=paths["fgr2r"], vlnce_paths=[paths["vlnce"]], connectivity_dir=paths["connectivity_dir"],
        scene_graphs={SCAN: jax_load_scene_graph(os.path.join(jtree, "metadata", "mp3d", SCAN))},
        audionav_dataset_dir=os.path.join(jtree, "datasets", "semantic_audionav", "v1", "train"),
        output_dir=jout, min_path_len=chip_smoke.VLN_MIN_PATH_LEN)
    return dict(tree=tree, data_path=data_path, counts=counts, jtree=jtree,
                jdata_path=os.path.join(jout, "dataset.json.gz"), jcounts=jcounts)


def _opts(tree, data_path, extra=()):
    return chip_smoke.dialog_overrides(tree, data_path) + TINY + list(extra)


def _port_env(tree, data_path):
    return construct_batched_env(get_config(chip_smoke.DIALOG_YAML, opts=_opts(tree, data_path)), with_depth=True,
                                 with_rgb=True, extra_sensors=("category_belief", "location_belief", "category"),
                                 device="cpu")


def test_alignment_of_the_tree_matches_jax(aligned):
    """The count the card's phase asserts, and JAX's shard, text for text;
    the reference's bar of 7 nodes aligns nothing on the 2x2 tree."""
    assert aligned["counts"] == aligned["jcounts"] == {SCAN: chip_smoke.VLN_EPISODES}
    rel = os.path.join("content", f"{SCAN}.json.gz")
    with gzip.open(os.path.join(os.path.dirname(aligned["data_path"]), rel), "rb") as f, \
            gzip.open(os.path.join(os.path.dirname(aligned["jdata_path"]), rel), "rb") as g:
        assert f.read() == g.read()
    _, counts, _ = chip_smoke.align_reference_dialog(aligned["tree"], min_path_len=7)
    assert counts == {SCAN: 0}


def test_sub_instr_token_bank_matches_jax(aligned):
    env = _port_env(aligned["tree"], aligned["data_path"])
    jenv = jbuilder.construct_batched_env(
        jax_get_config(chip_smoke.DIALOG_YAML, opts=_opts(aligned["jtree"], aligned["jdata_path"])),
        with_depth=True, with_rgb=True, extra_sensors=("category_belief", "location_belief", "category"))
    bank, jbank = sub_instr_token_bank(env.episodes), jax_sub_instr_token_bank(jenv.episodes)
    np.testing.assert_array_equal(bank, jbank)
    assert bank.shape == (chip_smoke.VLN_EPISODES, 77) and (bank != 0).any(-1).all()
    got = [(e.sub_instr, e.start_node, e.start_rot_idx, e.goal_node, e.dialog_node) for e in env.episodes]
    assert got == [(e.sub_instr, e.start_node, e.start_rot_idx, e.goal_node, e.dialog_node) for e in jenv.episodes]
    # rotation_angle (0 and 90) over the [w, x, y, z] quaternion; the last node of dialog_node
    assert [g[1:] for g in got] == [(1, 0, 2, 2), (2, 1, 0, 0)]


def test_dialog_pretraining_serves_the_dataset_instructions(aligned):
    """π_l pretraining (savi_pretraining_dialog_training.yaml, tiny widths)
    on the aligned tree: every step's instruction is its episode's dataset
    row, which the oracle bank's would not be; one update, finite CE."""
    tr = InteractiveDDPPOTrainer(get_config(chip_smoke.DIALOG_YAML, opts=_opts(aligned["tree"], aligned["data_path"])),
                                 device="cpu")
    tr._setup()
    assert (tr.sub_instr_bank != 0).any(-1).all() and tr.instr_source is None
    states = []
    step = tr.env.step

    def logged(state, actions, query=None, consts=None):
        states.append(state)
        return step(state, actions, query, consts)

    tr.env.step = logged
    _, traj = tr.collect_dialog(n=6)
    eps = torch.stack([s.ep_i for s in states])
    rows = tr.sub_instr_bank[eps]
    assert torch.equal(traj["dialog"], rows)
    oracle = torch.stack([tr.instr_bank[s.scene, s.node, s.rot, s.goal_node] for s in states])
    assert (oracle != rows).any(-1).all()
    loss = tr.update_dialog(traj)["dialog_loss"]
    assert torch.isfinite(loss)


def test_avlen_stage1_collects_from_the_aligned_tree(aligned, tmp_path):
    missing = str(tmp_path / "missing.pth")
    tr = InteractiveDDPPOTrainer(get_config(
        chip_smoke.INTERACTIVE_STAGE1,
        opts=_opts(aligned["tree"], aligned["data_path"],
                   ["GOAL_CKPT_PATH", missing, "VLN_CKPT_PATH", missing,
                    "RL.PPO.BELIEF_PREDICTOR.pretrained_path", missing])), device="cpu")
    tr._setup()
    assert len(tr.env.episodes) == chip_smoke.VLN_EPISODES and (tr.sub_instr_bank != 0).any(-1).all()
    _, traj = tr.collect(n=6)
    assert traj["actions"].shape == (6, 3)
    for k in ("rewards", "values_option", "log_probs_option"):
        assert torch.isfinite(traj[k].float()).all(), k
