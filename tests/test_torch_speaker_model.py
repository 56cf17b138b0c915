"""The port's neural speaker model (avlen_tpu_torch/dialog/speaker/) against
the JAX package on the CPU at hidden 32, with the weights carried across:
``Seq2SeqSpeaker``'s Flax tree, its teacher-forced logits and its
scheduled-sampling logits at sample_prob 0 and 1 (2e-5), greedy and beam-4
tokens exactly over all 40 decode steps, on ragged paths (lengths 1, 3 and
16; the JAX decodes compiled once for the module); ``corpus_bleu`` against
nltk (1e-9); and the panorama features with the encoder's weights carried
across (2e-5)."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.dialog.speaker import pano_features as jpano
from avlen_tpu.dialog.speaker import train_speaker as jtrain
from avlen_tpu.dialog.speaker.model import Seq2SeqSpeaker as JaxSeq2Seq
from avlen_tpu.dialog.speaker.vocab import Vocabulary as JaxVocabulary
from avlen_tpu.sim.graph import build_scene_tables as jax_build_scene_tables
from avlen_tpu.sim.synthetic import make_grid_scene as jax_make_grid_scene
from avlen_tpu_torch.dialog.speaker import eval_speaker, pano_features, train_speaker
from avlen_tpu_torch.dialog.speaker.model import Seq2SeqSpeaker
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
from avlen_tpu_torch.sim.graph import build_scene_tables
from avlen_tpu_torch.sim.synthetic import make_grid_scene
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params, to_flax_params
from tests.test_torch_slice import filled_params

torch.set_num_threads(1)

H = 32
V = len(Vocabulary().idx2word)


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


def test_flax_tree_round_trips(models):
    ours = _flatten(to_flax_params(models.m))
    theirs = _flatten(jax.tree.map(np.asarray, models.params))
    assert sorted(ours) == sorted(theirs)
    for path, val in theirs.items():
        np.testing.assert_array_equal(ours[path], val, err_msg="/".join(path))


def test_teacher_and_scheduled_logits_match_jax(models, data):
    acts, feats, lens, words = (x[:8] for x in data)
    inputs = words[:, :12]
    want = models.jm.apply(models.params, acts, feats, lens, inputs, method=JaxSeq2Seq.teacher_logits)
    with torch.no_grad():
        got = models.m.teacher_logits(_t(acts), _t(feats), _t(lens), _t(inputs))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0)
    for p in (0.0, 1.0):
        want = models.jm.apply(models.params, acts, feats, lens, inputs, jax.random.key(5), p,
                               method=JaxSeq2Seq.scheduled_logits)
        with torch.no_grad():
            got = models.m.scheduled_logits(_t(acts), _t(feats), _t(lens), _t(inputs), p,
                                            torch.Generator().manual_seed(5))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5, rtol=0, err_msg=f"p={p}")


def test_greedy_and_beam_tokens_match_jax(models, data):
    acts, feats, lens, _ = (x[:16] for x in data)
    v = Vocabulary()
    for jit_fn, ours in ((models.greedy, models.m.rollout),
                         (models.beam, lambda *a: models.m.beam_rollout(*a, beam_size=4))):
        want = np.asarray(jit_fn(models.params, acts, feats, lens))
        got = ours(_t(acts), _t(feats), _t(lens), v.bos_id, v.eos_id).numpy()
        assert got.shape == want.shape == (16, 40)
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("case", range(4))
def test_corpus_bleu_matches_nltk(case):
    nltk_bleu = pytest.importorskip("nltk.translate.bleu_score")
    rng = np.random.RandomState(case)
    words = Vocabulary().idx2word[4:30]
    cands, refs = [], []
    for _ in range(3 + case):
        ref = [words[i] for i in rng.randint(0, len(words), rng.randint(4, 14))]
        cand = [w if rng.rand() < 0.7 else words[rng.randint(len(words))] for w in ref[: rng.randint(3, len(ref) + 1)]]
        cands.append(cand)
        refs.append([ref, ref[::-1]] if case % 2 else [ref])
    want = nltk_bleu.corpus_bleu(refs, cands)
    assert eval_speaker.corpus_bleu(cands, refs) == pytest.approx(want, abs=1e-9)


def test_panorama_features_match_jax():
    rng = np.random.RandomState(4)
    rgb = rng.randint(0, 256, (1, 3, 4, 16, 16, 3)).astype(np.uint8)
    enc = jpano.PanoramaEncoder()
    shapes = jax.eval_shape(lambda k: enc.init(k, jnp.zeros((1, 16, 16, 3), jnp.float32)), jax.random.key(0))
    params = filled_params(rng, shapes)
    want = jpano.precompute_panorama_features(rgb, params, enc, batch=8)
    ours = pano_features.PanoramaEncoder(3)
    load_flax_params(ours, jax.tree.map(np.asarray, params))
    got = pano_features.precompute_panorama_features(rgb, ours, batch=8, device="cpu")
    assert got.shape == want.shape == (1, 3, 4, pano_features.PANO_FEAT_DIM)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    for h in (0, 45, 90, 180, 270, 359):
        assert int(pano_features.heading_to_rot_index(h)) == int(jpano.heading_to_rot_index(h))
