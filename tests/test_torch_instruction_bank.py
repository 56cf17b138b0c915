"""The port's oracle-instruction channel (avlen_tpu_torch/dialog/) against the
JAX package on a tiny world: the template speaker's text string for string,
``path_features`` array for array, the token bank int for int (and the
host speaker's rows equal to it), ``sub_instr_token_bank``, and the config
rules of ``resolve_instruction_source``: auto banks up to MAX_BANK_NODES
and calls the host speaker above; an untrained neural speaker and the
panorama features resolve; the ``cached`` mode raises JAX's RuntimeError
where the env has no host prefetcher (the default here)."""

import numpy as np
import pytest
import torch

from avlen_tpu.dialog import instruction_bank as jbank
from avlen_tpu.dialog import instruction_source as jsource
from avlen_tpu.dialog.speaker.speaker import Speaker as JaxSpeaker
from avlen_tpu.sim.synthetic import make_scene_bank as jax_make_scene_bank
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.core.episodes import Episode
from avlen_tpu_torch.dialog import instruction_bank, instruction_source
from avlen_tpu_torch.dialog.speaker.speaker import Speaker
from avlen_tpu_torch.sim.synthetic import make_scene_bank

torch.set_num_threads(1)

CFG = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"


@pytest.fixture(scope="module")
def worlds():
    _, jtables = jax_make_scene_bank(np.random.RandomState(3), num_scenes=2, side=4, with_frames=False)
    _, tables = make_scene_bank(np.random.RandomState(3), num_scenes=2, side=4, with_frames=False, device="cpu")
    for a, b in zip(jtables, tables):
        np.testing.assert_array_equal(a.oracle_next, b.oracle_next)
        np.testing.assert_array_equal(a.positions, b.positions)
    return jtables, tables


def _items(tables):
    items = []
    for si, t in enumerate(tables):
        for goal in range(t.num_nodes):
            for node in range(0, t.num_nodes, 2):
                path = instruction_bank.shortest_path_prefix(t, node, goal)
                for rot in range(4):
                    items.append({"heading": (270 - rot * 90) % 360, "scene": si, "path": path,
                                  "category": (node + goal) % 23 if rot == 1 else None})
    return items


def test_template_speaker_matches_jax(worlds):
    jtables, tables = worlds
    items = _items(tables)
    jitems = _items(jtables)
    assert [i["path"] for i in items] == [i["path"] for i in jitems]
    sp = Speaker([t.positions for t in tables])
    jsp = JaxSpeaker([t.positions for t in jtables], backend="template")
    assert sp.instruction_text(items) == jsp.instruction_text(jitems)
    for it in items[::7]:
        got = sp.path_features(it["scene"], it["path"], it["heading"], it["category"])
        want = jsp.path_features(it["scene"], it["path"], it["heading"], it["category"])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)


def test_bank_matches_jax(worlds):
    jtables, tables = worlds
    got = instruction_bank.build_instruction_bank_fast(tables)
    want = jbank.build_instruction_bank_fast(jtables)
    n = max(t.num_nodes for t in tables)
    assert got.dtype == np.int32 and got.shape == (2, n, 4, n, 77)
    np.testing.assert_array_equal(got, want)

    # the host speaker gives the bank's rows for the envs whose query starts
    src = instruction_source.HostSpeakerInstructionSource(Speaker([t.positions for t in tables]), tables)
    rng = np.random.RandomState(0)
    scene = rng.randint(0, 2, 40)
    node = np.array([rng.randint(0, tables[s].num_nodes) for s in scene])
    goal = np.array([rng.randint(0, tables[s].num_nodes) for s in scene])
    rot = rng.randint(0, 4, 40)
    newly = rng.rand(40) < 0.5
    state = type("S", (), {k: torch.as_tensor(v) for k, v in
                           dict(scene=scene, node=node, rot=rot, goal_node=goal).items()})
    toks = src(state, torch.as_tensor(newly)).numpy()
    np.testing.assert_array_equal(toks[newly], got[scene, node, rot, goal][newly])
    assert (toks[~newly] == 0).all() and src.host_calls == 1


def test_sub_instr_token_bank_matches_jax():
    eps = [Episode(episode_id=str(i), scene_id=0, start_node=0, start_rot_idx=0, goal_node=1, sub_instr=s)
           for i, s in enumerate(("go forward two steps", None, "turn left and stop there"))]
    np.testing.assert_array_equal(instruction_source.sub_instr_token_bank(eps),
                                  jsource.sub_instr_token_bank(eps))
    assert instruction_source.sub_instr_token_bank(eps[1:2]) is None


@pytest.mark.parametrize("opts,want", [
    (["SPEAKER.BANK_MODE", "auto"], "bank"),  # 16-node scenes, MAX_BANK_NODES 64
    (["SPEAKER.BANK_MODE", "auto", "SPEAKER.MAX_BANK_NODES", "8"], "callback"),
    (["SPEAKER.BANK_MODE", "callback"], "callback"),
    (["SPEAKER.BANK_MODE", "bank", "SPEAKER.MAX_BANK_NODES", "8"], "bank"),
    (["SPEAKER.BANK_MODE", "cached"], "RuntimeError"),
    # an untrained neural speaker (no CKPT_PATH), served per query
    (["SPEAKER.BACKEND", "neural", "SPEAKER.CKPT_PATH", "", "SPEAKER.BANK_MODE", "callback"], "callback"),
    # panorama features of a frame bank under the template channel
    (["SPEAKER.USE_PANO_FEATURES", "True"], "bank"),
])
def test_resolve_instruction_source(worlds, opts, want):
    _, tables = worlds
    cfg = get_config(CFG, opts=["SPEAKER.BACKEND", "template"] + opts)
    if want == "RuntimeError":
        with pytest.raises(RuntimeError, match="chunk-aware trainers"):
            instruction_source.resolve_instruction_source(cfg, tables, device="cpu")
        return
    rgb = None
    if cfg.SPEAKER.USE_PANO_FEATURES:
        n = max(t.num_nodes for t in tables)
        rgb = np.random.RandomState(0).randint(0, 256, (len(tables), n, 4, 16, 16, 3), np.uint8)
    bank, source = instruction_source.resolve_instruction_source(cfg, tables, rgb_bank=rgb, device="cpu")
    assert (bank is not None, source is not None) == (want == "bank", want == "callback")
    speaker = source.speaker if source is not None else None
    if cfg.SPEAKER.BACKEND == "neural":
        assert speaker.backend == "neural" and speaker.model is not None
        words = speaker.generate_instr([{"heading": 0, "scene": 0, "path": [0, 1, 2]}])[0]["words"]
        assert isinstance(words, list)
