"""The AV-Nav towers of the port against the JAX package on the CPU, with
numpy-seeded inputs and the JAX weights carried across: the mask-aware
``RNNStateEncoder`` (GRU and LSTM; one step and a sequence, 1e-6; the
sequence equals stepping, the mask resets the hidden), ``VisualCNN`` (rgb,
depth and both, at the small and the large schedule, 2e-5), and
``AudioNavBaselineNet`` under ``Policy`` (``act``'s logits and values, the
log-probs of fixed actions, ``get_value``, ``evaluate_actions``' values,
log-probs and entropy, 2e-5); the port's initialisers follow Flax's laws;
the Flax tree of the port's policy has the JAX init's paths and shapes, and
the GRU's bare ``w_ih``/``w_hh``/``b_ih``/``b_hh`` cross the bridge in
their own layout."""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.models.encoders import VisualCNN as JaxVisualCNN
from avlen_tpu.models.policy import AudioNavBaselineNet as JaxNet
from avlen_tpu.models.policy import Policy as JaxPolicy
from avlen_tpu.models.rnn_state_encoder import RNNStateEncoder as JaxRNN
from avlen_tpu_torch.models.encoders import VisualCNN
from avlen_tpu_torch.models.policy import AudioNavBaselineNet, Policy
from avlen_tpu_torch.models.rnn_state_encoder import RNNStateEncoder
from avlen_tpu_torch.utils.flax_bridge import _flatten, load_flax_params, to_flax_params
from tests.test_torch_slice import filled_params

torch.set_num_threads(1)


def _init(module, rng, *args, method=None):
    """Flax parameters of ``module`` from ``jax.eval_shape``, filled from
    the numpy generator ``rng`` (no initialiser is compiled)."""
    shapes = jax.eval_shape(lambda k: module.init(k, *args, method=method), jax.random.key(0))
    return filled_params(rng, shapes)


def _np(x):
    return np.asarray(x)


def _t(x):
    return torch.tensor(np.asarray(x))


@pytest.mark.parametrize("rnn_type", ["GRU", "LSTM"])
def test_rnn_step_and_sequence_match_jax(rnn_type):
    t, b, d, h = 7, 4, 16, 32
    rng = np.random.RandomState(0)
    x = rng.randn(t, b, d).astype(np.float32)
    masks = (rng.rand(t, b) > 0.3).astype(np.float32)
    h0 = rng.randn(b, (2 if rnn_type == "LSTM" else 1) * h).astype(np.float32)
    jm = JaxRNN(input_size=d, hidden_size=h, rnn_type=rnn_type)
    params = _init(jm, rng, x[0], h0, masks[0])
    # biases nonzero so that every term of the cell is exercised
    params = jax.tree.map(lambda v: v + 0.1 * rng.randn(*v.shape).astype(np.float32), params)
    m = RNNStateEncoder(d, h, rnn_type)
    load_flax_params(m, jax.tree.map(np.asarray, params))
    for name in ("w_ih", "w_hh", "b_ih", "b_hh"):  # bare leaves keep name and layout
        np.testing.assert_array_equal(getattr(m, name).detach().numpy(), _np(params["params"][name]))

    j_out, j_h = jm.apply(params, x[0], h0, masks[0])
    with torch.no_grad():
        out, hh = m(_t(x[0]), _t(h0), _t(masks[0]))
    np.testing.assert_allclose(out.numpy(), _np(j_out), atol=1e-6, rtol=0)
    np.testing.assert_allclose(hh.numpy(), _np(j_h), atol=1e-6, rtol=0)

    j_seq, j_final = jm.apply(params, x, h0, masks, method=JaxRNN.forward_sequence)
    with torch.no_grad():
        seq, final = m.forward_sequence(_t(x), _t(h0), _t(masks))
        steps, hs = [], _t(h0)
        for i in range(t):
            o, hs = m(_t(x[i]), hs, _t(masks[i]))
            steps.append(o)
    np.testing.assert_allclose(seq.numpy(), _np(j_seq), atol=1e-6, rtol=0)
    np.testing.assert_allclose(final.numpy(), _np(j_final), atol=1e-6, rtol=0)
    np.testing.assert_array_equal(seq.numpy(), torch.stack(steps).numpy())  # sequence == stepping
    np.testing.assert_array_equal(final.numpy(), hs.numpy())


def test_rnn_mask_resets_hidden():
    d, h = 8, 16
    m = RNNStateEncoder(d, h, generator=torch.Generator().manual_seed(0))
    x = torch.ones((2, d))
    with torch.no_grad():
        out_masked, _ = m(x, torch.full((2, h), 5.0), torch.tensor([0.0, 1.0]))
        out_zero, _ = m(x, torch.zeros((2, h)), torch.ones(2))
    np.testing.assert_array_equal(out_masked[0].numpy(), out_zero[0].numpy())
    assert not np.allclose(out_masked[1].numpy(), out_zero[1].numpy())
    assert m.initial_state(3).shape == (3, h)
    assert RNNStateEncoder(d, h, "LSTM").initial_state(3).shape == (3, 2 * h)


def test_initialisers_follow_flax_laws():
    """Orthogonal (D, 3H) and (H, 3H) cell matrices, zero biases; the
    ConvEncoder's kernels a truncated fan-in normal of variance 2/fan_in;
    the heads orthogonal at gains 0.01 and 1."""
    gen = torch.Generator().manual_seed(3)
    m = RNNStateEncoder(96, 32, generator=gen)
    w = m.w_ih.detach().numpy()  # (96, 96): square, so orthogonal both ways
    np.testing.assert_allclose(w @ w.T, np.eye(96), atol=1e-5)
    w = m.w_hh.detach().numpy()  # (32, 96): orthonormal rows
    np.testing.assert_allclose(w @ w.T, np.eye(32), atol=1e-5)
    assert not m.b_ih.detach().any() and not m.b_hh.detach().any()
    net = AudioNavBaselineNet(hidden_size=64, spectrogram_hw=(65, 26), visual_hw=(64, 64), generator=gen)
    conv = net.visual_encoder.ConvEncoder_0.Conv_0.weight.detach().numpy()
    fan_in = conv[0].size
    assert np.abs(conv).max() <= 2 * np.sqrt(2.0 / fan_in) / 0.8796256610342398 + 1e-6  # truncated at 2σ
    np.testing.assert_allclose(conv.std(), np.sqrt(2.0 / fan_in), rtol=0.1)
    pol = Policy(net, 4, generator=gen)
    for head, gain in ((pol.action_head.Dense_0.weight, 0.01), (pol.critic.Dense_0.weight, 1.0)):
        w = head.detach().numpy()
        np.testing.assert_allclose(w @ w.T, gain ** 2 * np.eye(w.shape[0]), atol=1e-6)


@pytest.mark.parametrize("hw", [16, 64], ids=["small_schedule", "large_schedule"])
@pytest.mark.parametrize("use_rgb,use_depth", [(True, False), (False, True), (True, True)],
                         ids=["rgb", "depth", "rgbd"])
def test_visual_cnn_matches_jax(hw, use_rgb, use_depth):
    rng = np.random.RandomState(hw + 2 * use_rgb + use_depth)
    rgb = rng.randint(0, 256, (3, hw, hw, 3)).astype(np.uint8) if use_rgb else None
    depth = rng.rand(3, hw, hw, 1).astype(np.float32) if use_depth else None
    jm = JaxVisualCNN(output_size=32)
    params = _init(jm, rng, rgb, depth)
    want = jm.apply(params, rgb, depth)
    m = VisualCNN(32, (hw, hw), use_rgb, use_depth)
    load_flax_params(m, jax.tree.map(np.asarray, params))
    with torch.no_grad():
        got = m(None if rgb is None else _t(rgb), None if depth is None else _t(depth))
    np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=0)


@pytest.fixture(scope="module")
def policies():
    b, t, h = 3, 5, 64
    rng = np.random.RandomState(7)
    obs = {"spectrogram": rng.rand(b, 65, 26, 2).astype(np.float32),
           "depth": rng.rand(b, 32, 32, 1).astype(np.float32)}
    jpol = JaxPolicy(net=JaxNet(hidden_size=h, spectrogram_hw=(65, 26), use_depth=True), num_actions=4)
    hidden = rng.randn(b, h).astype(np.float32)
    masks = np.array([1.0, 0.0, 1.0], np.float32)
    params = _init(jpol, rng, obs, hidden, masks, jax.random.key(1), method=JaxPolicy.act)
    pol = Policy(AudioNavBaselineNet(hidden_size=h, spectrogram_hw=(65, 26), visual_hw=(32, 32)), 4)
    load_flax_params(pol, jax.tree.map(np.asarray, params))
    seq_obs = {k: rng.rand(t, *v.shape).astype(np.float32) for k, v in obs.items()}
    seq_masks = (rng.rand(t, b) > 0.3).astype(np.float32)
    actions = rng.randint(0, 4, (t, b)).astype(np.int32)
    return dict(jpol=jpol, params=params, pol=pol, obs=obs, hidden=hidden, masks=masks, seq_obs=seq_obs,
                seq_masks=seq_masks, actions=actions)


def test_policy_flax_tree_matches_jax(policies):
    ours = _flatten(to_flax_params(policies["pol"]))
    theirs = _flatten(jax.tree.map(np.asarray, policies["params"]))
    assert sorted(ours) == sorted(theirs)
    for path, v in theirs.items():
        np.testing.assert_array_equal(ours[path], v, err_msg="/".join(path))


def test_policy_act_and_get_value_match_jax(policies):
    p = policies
    jact = p["jpol"].apply(p["params"], p["obs"], p["hidden"], p["masks"], jax.random.key(2), True,
                           method=JaxPolicy.act)
    jval = p["jpol"].apply(p["params"], p["obs"], p["hidden"], p["masks"], method=JaxPolicy.get_value)
    obs = {k: _t(v) for k, v in p["obs"].items()}
    with torch.no_grad():
        action, logp, value, hidden, logits = p["pol"].act(obs, _t(p["hidden"]), _t(p["masks"]),
                                                           deterministic=True)
        val = p["pol"].get_value(obs, _t(p["hidden"]), _t(p["masks"]))
        # log-probs of fixed actions: the sampled ones (sampling draws differ)
        fixed = torch.tensor([3, 0, 2])
        sampled = p["pol"].act(obs, _t(p["hidden"]), _t(p["masks"]), torch.Generator().manual_seed(0))
    np.testing.assert_array_equal(action.numpy(), _np(jact[0]))
    for got, want in ((logp, jact[1]), (value, jact[2]), (hidden, jact[3]), (logits, jact[4]), (val, jval)):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=0)
    want_lp = jax.nn.log_softmax(jact[4])[np.arange(3), fixed.numpy()]
    np.testing.assert_allclose(torch.log_softmax(logits, -1)[torch.arange(3), fixed].numpy(), _np(want_lp),
                               atol=2e-5)
    np.testing.assert_allclose(sampled[1].numpy(), _np(jax.nn.log_softmax(jact[4]))[np.arange(3),
                                                                                 sampled[0].numpy()], atol=2e-5)


def test_policy_evaluate_actions_matches_jax(policies):
    p = policies
    want = p["jpol"].apply(p["params"], p["seq_obs"], p["hidden"], p["seq_masks"], jnp.asarray(p["actions"]),
                           method=JaxPolicy.evaluate_actions)
    with torch.no_grad():
        got = p["pol"].evaluate_actions({k: _t(v) for k, v in p["seq_obs"].items()}, _t(p["hidden"]),
                                        _t(p["seq_masks"]), _t(p["actions"]).long())
    for name, g, w in zip(("values", "log_probs", "entropy", "logits"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5, rtol=0, err_msg=name)


def test_no_visual_policy_matches_jax():
    """Neither depth nor RGB (a reference bank without cached frames): no
    visual tower, the GRU fed by the audio CNN alone, as the JAX net builds
    it; act's logits and values and evaluate_actions' log-probs within
    2e-5. ``AVNavTrainer._make_policy`` builds that net from such an env."""
    from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer

    b, t, h = 3, 4, 32
    rng = np.random.RandomState(11)
    obs = {"spectrogram": rng.rand(b, 65, 26, 2).astype(np.float32)}
    jpol = JaxPolicy(net=JaxNet(hidden_size=h, spectrogram_hw=(65, 26), use_depth=False), num_actions=4)
    hidden = rng.randn(b, h).astype(np.float32)
    masks = np.array([1.0, 0.0, 1.0], np.float32)
    params = _init(jpol, rng, obs, hidden, masks, jax.random.key(1), method=JaxPolicy.act)
    pol = Policy(AudioNavBaselineNet(hidden_size=h, spectrogram_hw=(65, 26), visual_hw=None, use_depth=False), 4)
    assert not hasattr(pol.net, "visual_encoder")
    load_flax_params(pol, jax.tree.map(np.asarray, params))
    jact = jpol.apply(params, obs, hidden, masks, jax.random.key(2), True, method=JaxPolicy.act)
    with torch.no_grad():
        _, _, value, hid, logits = pol.act({k: _t(v) for k, v in obs.items()}, _t(hidden), _t(masks),
                                           deterministic=True)
    for got, want in ((value, jact[2]), (hid, jact[3]), (logits, jact[4])):
        np.testing.assert_allclose(got.numpy(), _np(want), atol=2e-5, rtol=0)
    seq_obs = {"spectrogram": rng.rand(t, b, 65, 26, 2).astype(np.float32)}
    seq_masks = (rng.rand(t, b) > 0.3).astype(np.float32)
    actions = rng.randint(0, 4, (t, b)).astype(np.int32)
    want = jpol.apply(params, seq_obs, hidden, seq_masks, jnp.asarray(actions), method=JaxPolicy.evaluate_actions)
    with torch.no_grad():
        got = pol.evaluate_actions({k: _t(v) for k, v in seq_obs.items()}, _t(hidden), _t(seq_masks),
                                   _t(actions).long())
    for name, g, w in zip(("values", "log_probs", "entropy", "logits"), got, want):
        np.testing.assert_allclose(g.numpy(), _np(w), atol=2e-5, rtol=0, err_msg=name)

    env = types.SimpleNamespace(config=types.SimpleNamespace(sensors=("spectrogram", "pose")),
                                bank=types.SimpleNamespace(depth=None, rgb=None),
                                spec_config=types.SimpleNamespace(out_shape=(65, 26, 2)))
    trainer = types.SimpleNamespace(env=env, config=types.SimpleNamespace(
        RL=types.SimpleNamespace(PPO=types.SimpleNamespace(hidden_size=h)),
        TASK_CONFIG=types.SimpleNamespace(TASK=types.SimpleNamespace(POSSIBLE_ACTIONS=["a", "b", "c", "d"]))))
    built = AVNavTrainer._make_policy(trainer, torch.Generator().manual_seed(0))
    assert sorted(_flatten(to_flax_params(built))) == sorted(_flatten(jax.tree.map(np.asarray, params)))
