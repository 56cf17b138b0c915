"""Stage 0 of the recipe on the port (avlen_tpu_torch/pretraining/
audiogoal_predictor.py) against the JAX package: ``sample_from_indices`` on
the draws of the JAX sampler (its own ``jax.random`` calls, replayed) equals
what that sampler renders (spectrogram 1e-5, location 1e-6, category
exactly); ``loss_fn`` and one Adam step on a fixed batch equal JAX's with
the same weights (loss terms 1e-5, gradients 5e-4 + 1e-3·|g|,
parameters 1e-6 where |g| > 2e-3, else 2·lr + 1e-5: Adam's first step takes
either sign on a gradient near rounding); the CLI's ``label_predictor.pth``
loads in the JAX package's ``load_checkpoint`` and in the port's
``SaviTrainer._setup``; and the job learns the category of distinct tones
(the analogue of tests/test_aux.py::test_pretraining_job_learns_category)."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from avlen_tpu.models.belief_predictor import BeliefPredictorNet as JaxBeliefNet
from avlen_tpu.pretraining import audiogoal_predictor as jag
from avlen_tpu.sim.synthetic import make_scene_bank as jax_make_scene_bank
from avlen_tpu.utils import checkpoint as jckpt
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
from avlen_tpu_torch.pretraining import audiogoal_predictor as ag
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.sim.synthetic import make_scene_bank
from avlen_tpu_torch.utils.flax_bridge import _flatten, scene_bank_from_jax, to_flax_params

torch.set_num_threads(1)

BATCH = 6
LR = 1e-3


def _compile(fn, *args):
    return jax.jit(fn).lower(*args).compile(compiler_options={"xla_llvm_disable_expensive_passes": True})(*args)


@pytest.fixture(scope="module")
def banks():
    """A 2-scene world at 16 kHz with 2,000-tap RIRs (the CLI's, side 4):
    32,768-point convolutions."""
    jbank, _ = jax_make_scene_bank(np.random.RandomState(0), num_scenes=2, side=4, with_frames=False)
    return jbank, scene_bank_from_jax(jbank, "cpu")


def _jax_draws(jbank, key, batch):
    """The indices the JAX sampler draws from ``key`` (its own calls)."""
    ks = jax.random.split(key, 6)
    s = jbank.tables["positions"].shape[0]
    scene = jax.random.randint(ks[0], (batch,), 0, s)
    n = jbank.tables["num_nodes"][scene]
    recv = jax.random.randint(ks[1], (batch,), 0, 10**6) % n
    src = jax.random.randint(ks[2], (batch,), 0, 10**6) % n
    rot = jax.random.randint(ks[3], (batch,), 0, 4)
    sound = jax.random.randint(ks[4], (batch,), 0, jbank.sounds_padded.shape[0])
    return [torch.tensor(np.asarray(a)).long() for a in (scene, recv, src, rot, sound)]


@pytest.fixture(scope="module")
def batch(banks):
    jbank, bank = banks
    key = jax.random.key(3)
    sampler = jag.make_sampler(jbank, BATCH, 21)
    want = [np.asarray(a) for a in _compile(sampler.impl, jbank, key)]
    got = ag.sample_from_indices(bank, *_jax_draws(jbank, key, BATCH), num_categories=21)
    return want, got


def test_sample_from_indices_matches_jax_sampler(batch):
    (wspec, wcat, wloc), (spec, cat, loc) = batch
    assert spec.shape == (BATCH, 65, 26, 2)
    np.testing.assert_allclose(spec.numpy(), wspec, atol=1e-5, rtol=0)
    np.testing.assert_array_equal(cat.numpy(), wcat)
    np.testing.assert_allclose(loc.numpy(), wloc, atol=1e-6, rtol=0)


def test_sampler_draws_valid_indices(banks):
    _, bank = banks
    spec, cat, loc = ag.make_sampler(bank, 8, 21, torch.Generator().manual_seed(0))()
    assert spec.shape == (8, 65, 26, 2) and torch.isfinite(spec).all()
    assert ((cat >= 0) & (cat < bank.sounds_padded.shape[0])).all() and torch.isfinite(loc).all()


def test_loss_and_adam_step_match_jax(batch):
    (spec, cat, loc), _ = batch
    jnet = JaxBeliefNet(num_categories=21)
    net = BeliefPredictorNet(num_categories=21, generator=torch.Generator().manual_seed(0))
    params = to_flax_params(net)  # the port's own init, in the JAX init's tree
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.asarray(spec)))
    assert jax.tree.map(np.shape, params) == jax.tree.map(lambda a: a.shape, shapes)

    def jloss(p):
        pred_loc, logits = jnet.apply(p, spec)
        ce = optax.softmax_cross_entropy_with_integer_labels(logits, cat).mean()
        mse = ((pred_loc - loc) ** 2).sum(-1).mean()
        return ce + mse, (ce, mse, (jnp.argmax(logits, -1) == cat).mean())

    def jstep(p):
        (loss, aux), grads = jax.value_and_grad(jloss, has_aux=True)(p)
        opt = optax.adam(LR)
        updates, _ = opt.update(grads, opt.init(p), p)
        return loss, aux, grads, optax.apply_updates(p, updates)

    wloss, (wce, wmse, wacc), wgrads, wparams = _compile(jstep, params)

    t = [torch.tensor(spec), torch.tensor(cat).long(), torch.tensor(loc)]
    loss, aux = ag.loss_fn(net, *t)
    for got, want in ((loss, wloss), (aux["ce"], wce), (aux["mse"], wmse), (aux["acc"], wacc)):
        assert abs(got.item() - float(want)) <= 1e-5 * max(1.0, abs(float(want)))
    opt = torch.optim.Adam(net.parameters(), lr=LR, betas=(0.9, 0.999), eps=1e-8)
    ag.train_step(net, opt, *t)
    grads = {n: opt.state[p]["exp_avg"] / 0.1 for n, p in net.named_parameters()}  # first step: (1-b1)·g
    g_want, p_want = _flatten(jax.tree.map(np.asarray, wgrads)), _flatten(jax.tree.map(np.asarray, wparams))
    g_got, p_got = _flatten(to_flax_params(net, grads)), _flatten(to_flax_params(net))
    assert g_got.keys() == g_want.keys()
    for k in g_want:
        g = g_want[k]
        np.testing.assert_allclose(g_got[k], g, atol=5e-4, rtol=1e-3, err_msg=str(k))
        tol = np.where(np.abs(g) > 2e-3, 1e-6, 2 * LR + 1e-5)
        assert (np.abs(p_got[k] - p_want[k]) <= tol).all(), k


def test_checkpoint_loads_in_jax_and_in_the_savi_trainer(tmp_path):
    out = ag.main(["--device", "cpu", "--steps", "2", "--batch", "4", "--scenes", "1", "--side", "4",
                   "--output", str(tmp_path)])
    assert out["checkpoint"] == str(tmp_path / "label_predictor.pth") and out["steps"] == 2
    assert len(out["history"]) == 2 and all(np.isfinite(list(h.values())).all() for h in out["history"])
    ckpt = jckpt.load_checkpoint(out["checkpoint"])
    assert set(ckpt["metrics"]) == {"ce", "mse", "acc"} and ckpt["metrics"] == pytest.approx(out["metrics"])
    jnet = JaxBeliefNet(num_categories=21)
    shapes = jax.eval_shape(lambda: jnet.init(jax.random.key(0), jnp.zeros((1, 65, 26, 2))))
    assert jax.tree.map(np.shape, ckpt["state_dict"]) == jax.tree.map(lambda a: a.shape, shapes)

    tr = SaviTrainer(get_config("configs/semantic_audionav/savi/savi.yaml", opts=[
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "10",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16", "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "2", "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "2",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32", "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
        "RL.PPO.BELIEF_PREDICTOR.pretrained_path", out["checkpoint"]]), device="cpu")
    tr._setup()
    got, want = _flatten(to_flax_params(tr.belief_net)), _flatten(ckpt["state_dict"])
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])


def test_pretraining_job_learns_category():
    bank, _ = make_scene_bank(np.random.RandomState(0), num_scenes=1, side=4, rir_length=200,
                              sampling_rate=2000, num_sounds=3, with_frames=False, device="cpu")
    _, metrics = ag.train_audiogoal_predictor(bank, num_steps=30, batch=16, num_categories=3, log_interval=100)
    assert np.isfinite(metrics["ce"]) and np.isfinite(metrics["mse"])
    assert metrics["acc"] > 0.4  # distinct synthetic tones separate quickly
