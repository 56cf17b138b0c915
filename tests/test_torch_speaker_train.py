"""The port's speaker training and snapshot (recipe stage 4) against the
JAX package on the CPU at hidden 32: ``build_dataset`` exactly; one
``train_step`` (Adam) against JAX's loss, gradients and update on the
minibatch JAX's key draws (loss 1e-5, gradients 5e-4 + 1e-3·|g|; the
parameters 1e-5 from optax.adam on the port's gradients, and 1e-5 from
JAX's wherever |g| ≥ 1e-6, since Adam's first step turns a gradient near
its eps into a sign); ``speaker.pth`` both ways (a JAX-written file served by the port's
``speaker_from_config`` decodes JAX's words, and the file the port's
``train_speaker`` writes loads in JAX's ``speaker_from_config`` with the
same parameters and words); the missing-snapshot and ``world_feat_dim``
errors."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avlen_tpu.dialog import instruction_source as jsource
from avlen_tpu.dialog.speaker import train_speaker as jtrain
from avlen_tpu.dialog.speaker.model import Seq2SeqSpeaker as JaxSeq2Seq
from avlen_tpu.dialog.speaker.speaker import Speaker as JaxSpeaker
from avlen_tpu.dialog.speaker.vocab import Vocabulary as JaxVocabulary
from avlen_tpu.sim.graph import build_scene_tables as jax_build_scene_tables
from avlen_tpu.sim.synthetic import make_grid_scene as jax_make_grid_scene
from avlen_tpu.utils.checkpoint import save_checkpoint as jax_save_checkpoint
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.dialog import instruction_source
from avlen_tpu_torch.dialog.speaker import train_speaker
from avlen_tpu_torch.dialog.speaker.model import Seq2SeqSpeaker
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_grid_scene
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params, to_flax_params
from tests.test_torch_slice import filled_params

torch.set_num_threads(1)

H = 32
V = len(Vocabulary().idx2word)
CFG = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"


def _t(x):
    return torch.as_tensor(np.asarray(x))


@pytest.fixture(scope="module")
def tables():
    jt = [jax_build_scene_tables(jax_make_grid_scene(np.random.RandomState(s), side=4)) for s in (0, 1)]
    tt = [build_scene_tables(make_grid_scene(np.random.RandomState(s), side=4)) for s in (0, 1)]
    return jt, tt


@pytest.fixture(scope="module")
def data(tables):
    """build_dataset of both packages (equal exactly) and a ragged batch."""
    jt, tt = tables
    jd = jtrain.build_dataset(jt, JaxVocabulary(), 96, seed=3)
    td = train_speaker.build_dataset(tt, Vocabulary(), 96, seed=3)
    for a, b in zip(jd, td):
        np.testing.assert_array_equal(b, np.asarray(a))
    acts, feats, lens, words = (np.array(x) for x in td)
    lens[:3] = [1, 3, 16]
    return acts, feats, lens, words


@pytest.fixture(scope="module")
def models(data):
    """One JAX model with jitted greedy and beam-4 decodes, and the port's
    model holding the same (filled, He-scale) weights."""
    acts, feats, lens, words = data
    jm = JaxSeq2Seq(vocab_size=V, hidden_size=H, world_feat_dim=feats.shape[-1])
    shapes = jax.eval_shape(lambda k: jm.init(k, acts[:2], feats[:2], lens[:2], words[:2, :3],
                                              method=JaxSeq2Seq.teacher_logits), jax.random.key(0))
    params = filled_params(np.random.RandomState(0), shapes)
    m = Seq2SeqSpeaker(V, H, feats.shape[-1])
    load_flax_params(m, jax.tree.map(np.asarray, params))
    v = Vocabulary()
    greedy = jax.jit(lambda p, a, f, l: jm.apply(p, a, f, l, v.bos_id, v.eos_id, method=JaxSeq2Seq.rollout))
    beam = jax.jit(lambda p, a, f, l: jm.apply(p, a, f, l, v.bos_id, v.eos_id, 4,
                                               method=JaxSeq2Seq.beam_rollout))
    return types.SimpleNamespace(jm=jm, params=params, m=m, greedy=greedy, beam=beam)


def test_train_step_matches_jax(data):
    """JAX's step (train_speaker.py:117-139) at its first step (sample_prob
    0) on the minibatch its key draws, against the port's ``train_step``."""
    acts, feats, lens, words = data
    words = words[:, :13]  # BOS + 12 targets: JAX's loss, a shorter unrolled decode
    batch = 8
    jm = JaxSeq2Seq(vocab_size=V, hidden_size=H, max_decode_len=40, world_feat_dim=feats.shape[-1])
    shapes = jax.eval_shape(lambda k: jm.init(k, acts[:2], feats[:2], lens[:2], words[:2],
                                              method=JaxSeq2Seq.teacher_logits), jax.random.key(0))
    params = filled_params(np.random.RandomState(1), shapes)
    m = Seq2SeqSpeaker(V, H, feats.shape[-1])
    load_flax_params(m, jax.tree.map(np.asarray, params))
    pad = Vocabulary().pad_id
    k_idx, k_ss = jax.random.split(jax.random.key(9))
    idx = np.asarray(jax.random.randint(k_idx, (batch,), 0, acts.shape[0]))

    def loss_fn(p, a, f, l, w):
        logits = jm.apply(p, a, f, l, w[:, :-1], k_ss, 0.0, method=JaxSeq2Seq.scheduled_logits)
        targets = w[:, 1:]
        mask = (targets != pad).astype(jnp.float32)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, targets)
        return (ce * mask).sum() / jnp.maximum(mask.sum(), 1)

    j_loss, j_grads = jax.jit(jax.value_and_grad(loss_fn))(params, acts[idx], feats[idx], lens[idx], words[idx])
    opt = optax.adam(1e-3)
    adam_step = jax.jit(lambda g, p: optax.apply_updates(p, opt.update(g, opt.init(p), p)[0]))
    j_new = adam_step(j_grads, params)

    adam = torch.optim.Adam(m.parameters(), lr=1e-3, betas=(0.9, 0.999), eps=1e-8)
    loss, acc = train_speaker.train_step(m, adam, *(_t(x[idx]) for x in (acts, feats, lens, words)), pad, 0.0,
                                         torch.Generator().manual_seed(0))
    assert abs(float(loss) - float(j_loss)) <= 1e-5
    assert 0.0 <= float(acc) <= 1.0
    grads = _flatten(to_flax_params(m, {n: p.grad for n, p in m.named_parameters()}))
    for path, g in _flatten(jax.tree.map(np.asarray, j_grads)).items():
        np.testing.assert_allclose(grads[path], g, atol=5e-4, rtol=1e-3, err_msg="/".join(path))
    # Adam's first step is lr·g/(|g| + 1e-8): where |g| is near 1e-8 it
    # turns the gradients' last-bit differences into up to 2·lr. So the
    # port's step is held to optax.adam on the port's own gradients (1e-5),
    # and to JAX's parameters (1e-5) wherever |g| ≥ 1e-6, within 2·lr elsewhere.
    port_grads = jax.tree.map(jnp.asarray, to_flax_params(m, {n: p.grad for n, p in m.named_parameters()}))
    want_ours = _flatten(jax.tree.map(np.asarray, adam_step(port_grads, params)))
    ours = _flatten(to_flax_params(m))
    j_g = _flatten(jax.tree.map(np.asarray, j_grads))
    for path, p in _flatten(jax.tree.map(np.asarray, j_new)).items():
        name = "/".join(path)
        np.testing.assert_allclose(ours[path], want_ours[path], atol=1e-5, rtol=0, err_msg=name)
        steady = np.abs(j_g[path]) >= 1e-6
        np.testing.assert_allclose(ours[path][steady], p[steady], atol=1e-5, rtol=0, err_msg=name)
        np.testing.assert_allclose(ours[path], p, atol=2e-3 + 1e-6, rtol=0, err_msg=name)


def _items(tables, n=24, seed=0):
    rng = np.random.RandomState(seed)
    items = []
    for i in range(n):
        s = i % len(tables)
        t = tables[s]
        a, b = rng.randint(t.num_nodes, size=2)
        path = train_speaker.shortest_path_prefix(t, int(a), int(b), max_len=6)
        items.append({"heading": int(rng.choice([0, 90, 180, 270])), "scene": s, "path": path,
                      "category": int(rng.randint(21)) if i % 2 else None})
    return items


def test_speaker_pth_both_ways(models, data, tables, tmp_path):
    jt, tt = tables
    items = _items(tt)
    # JAX writes (its save_checkpoint, train_speaker's payload); the port serves it
    vocab = JaxVocabulary()
    jax_save_checkpoint(str(tmp_path / "jax"), "speaker.pth", {
        "state_dict": models.params, "vocab": vocab.idx2word, "hidden_size": H,
        "world_feat_dim": int(data[1].shape[-1])})
    jspk = JaxSpeaker([t.positions for t in jt], backend="neural", vocab=vocab, neural_params=models.params,
                      hidden_size=H)
    want = jspk.generate_instr(items)
    cfg = get_config(CFG, opts=["SPEAKER.CKPT_PATH", str(tmp_path / "jax" / "speaker.pth")])
    assert cfg.SPEAKER.BACKEND == "neural"
    spk = instruction_source.speaker_from_config(cfg, tt, device="cpu")
    assert spk.backend == "neural" and spk.vocab.idx2word == vocab.idx2word
    assert spk.generate_instr(items) == want

    # the port writes (train_speaker, one step); JAX's speaker_from_config serves it
    params, _, _ = train_speaker.train_speaker(tt, num_steps=1, batch=8, hidden_size=H, num_pairs=32,
                                               checkpoint_dir=str(tmp_path / "port"), device="cpu")
    path = str(tmp_path / "port" / "speaker.pth")
    jcfg = types.SimpleNamespace(SPEAKER=types.SimpleNamespace(
        BACKEND="neural", CKPT_PATH=path, USE_PANO_FEATURES=False))
    jspk = jsource.speaker_from_config(jcfg, jt)
    spk = instruction_source.speaker_from_config(get_config(CFG, opts=["SPEAKER.CKPT_PATH", path]), tt,
                                                 device="cpu")
    assert jspk.generate_instr(items) == spk.generate_instr(items)
    for p, v in _flatten(params).items():
        np.testing.assert_array_equal(np.asarray(_flatten(jspk.neural_params)[p]), v)

    with pytest.raises(FileNotFoundError, match="speaker checkpoint not found"):
        instruction_source.speaker_from_config(get_config(CFG), tt, device="cpu")
    rgb = np.random.RandomState(0).randint(0, 256, (2, max(t.num_nodes for t in tt), 4, 16, 16, 3), np.uint8)
    with pytest.raises(ValueError, match="world_feat_dim"):
        instruction_source.speaker_from_config(
            get_config(CFG, opts=["SPEAKER.CKPT_PATH", path, "SPEAKER.USE_PANO_FEATURES", "True"]), tt,
            rgb_bank=rgb, device="cpu")


