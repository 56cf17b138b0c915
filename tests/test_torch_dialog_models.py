"""The port's AVLEN policies against the JAX package with the same weights
(2e-5): the port's own init, as a Flax tree (``to_flax_params``), whose
paths and shapes must be those of the JAX ``init`` (traced, not run), is
applied by the JAX modules. Cases: ``DialogStateEncoder`` with and without
a dialog embedding (Flax weights carried in); ``DialogPolicy.act`` / ``evaluate_step`` (π_l: SMT over the
dialog window, the CLIP tower, the dialog state encoder) with the tower run
in the call or its embedding given; ``OptionPolicy.act`` / ``evaluate_step``
(π_q: 308-d features with the pose at (272, 276) at full width, the
uncertainty head); each in SMT pretraining mode and not. Logits, log-probs,
values, entropies, uncertainty logits, ``x_mem`` and ``x_att``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.models.dialog_encoder import DialogStateEncoder as JaxDialogStateEncoder
from avlen_tpu.models.dialog_policy import AudioNavDialogNet as JaxDialogNet
from avlen_tpu.models.dialog_policy import DialogPolicy as JaxDialogPolicy
from avlen_tpu.models.option_policy import AudioNavOptionNet as JaxOptionNet
from avlen_tpu.models.option_policy import OptionPolicy as JaxOptionPolicy
from avlen_tpu_torch.models.clip_text import tokenize
from avlen_tpu_torch.models.dialog_encoder import DialogStateEncoder
from avlen_tpu_torch.models.dialog_policy import AudioNavDialogNet, DialogPolicy
from avlen_tpu_torch.models.option_policy import AudioNavOptionNet, OptionPolicy
from avlen_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params

torch.set_num_threads(1)

B, D, H, QC = 3, 32, 4, 32
SPEC_HW = (65, 13)  # an 8 kHz world's spectrogram
TOL = 2e-5
COMMON = dict(spectrogram_hw=SPEC_HW, num_actions=4, d_model=D, nhead=H, use_rgb=False, use_depth=True)


def _obs(rng):
    return {
        "depth": rng.rand(B, 16, 16, 1).astype(np.float32),
        "spectrogram": rng.rand(B, *SPEC_HW, 2).astype(np.float32),
        "pose": np.concatenate([rng.randn(B, 3), rng.randint(0, 9, (B, 1))], 1).astype(np.float32),
        "category_belief": rng.dirichlet(np.ones(21), B).astype(np.float32),
        "location_belief": rng.randn(B, 2).astype(np.float32),
    }


def _j(tree):
    return jax.tree.map(lambda a: None if a is None else jnp.asarray(a), tree)


def _t(tree):
    return {k: torch.as_tensor(v) for k, v in tree.items()} if isinstance(tree, dict) else (
        None if tree is None else torch.as_tensor(tree))


def _flax_params(jmod, init, tmod):
    """``to_flax_params(tmod)``, held to the paths and shapes of
    ``init()``, the JAX module's init traced with ``jax.eval_shape``."""
    params = to_flax_params(tmod)
    want = jax.tree.map(lambda a: a.shape, jax.eval_shape(init))
    assert jax.tree.map(np.shape, params) == want
    return params


def _close(got, want):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w), atol=TOL, rtol=0)


@pytest.mark.parametrize("with_emb", [True, False])
def test_dialog_state_encoder_matches_flax(with_emb):
    rng = np.random.RandomState(0)
    jmod = JaxDialogStateEncoder(state_size=D, dialog_emb_size=D, d_model=D, nhead=H)
    x_att, mem = rng.randn(B, D).astype(np.float32), rng.randn(B, 3, D).astype(np.float32)
    masks = np.array([[1, 0, 1], [0, 0, 0], [1, 1, 1]], np.float32)
    emb = rng.randn(B, D).astype(np.float32)
    step = np.array([0, 2, 150], np.int32)  # the last past max_len: clipped to 99
    goal = rng.randn(B, D).astype(np.float32)
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(0), x_att, mem, masks, emb, step, goal))
    tmod = DialogStateEncoder(D, D, D, H)
    load_flax_params(tmod, params)
    e = emb if with_emb else None
    want = jmod.apply(params, x_att, mem, masks, _j(e), step, goal)
    with torch.no_grad():
        got = tmod(*(_t(a) for a in (x_att, mem, masks, e, step, goal)))
    _close([got], [want])


def _dialog_pair(pretraining, seed):
    rng = np.random.RandomState(seed)
    kw = dict(COMMON, pretraining=pretraining, clip_width=64, clip_layers=2)
    jpol = JaxDialogPolicy(net=JaxDialogNet(**kw))
    obs = _obs(rng)
    f = 64 + 16 + 128 + 4
    pa = np.array([0, 3, 1], np.int32)
    mf, mv = rng.randn(B, 3, f).astype(np.float32), np.array([[1, 1, 0], [0, 0, 0], [1, 1, 1]], np.float32)
    smf, smv = rng.randn(B, 3, D).astype(np.float32), np.array([[1, 0, 0], [0, 0, 0], [1, 1, 1]], np.float32)
    dialog = tokenize(["turn left then go forward two steps", "stop here", "go forward one step"])
    step = np.array([0, 1, 2], np.int32)
    args = (obs, pa, mf, mv, smf, smv, dialog, step)
    g = torch.Generator().manual_seed(seed)
    tpol = DialogPolicy(AudioNavDialogNet(**kw, generator=g), generator=g)
    params = _flax_params(jpol, lambda: jpol.init(jax.random.key(seed), *_j(args), jax.random.key(1),
                                                  method=JaxDialogPolicy.act), tpol)
    return jpol, params, tpol, args


@pytest.mark.parametrize("pretraining,precomputed", [(False, False), (True, False), (False, True), (True, True)])
def test_dialog_policy_matches_flax(pretraining, precomputed):
    jpol, params, tpol, args = _dialog_pair(pretraining, seed=1 + int(pretraining))
    targs = tuple(_t(a) for a in args)
    jclip = tclip = None
    if precomputed:
        jclip = jpol.apply(params, jnp.asarray(args[6]), method=JaxDialogPolicy.clip_embed)
        tclip = tpol.clip_embed(targs[6])
        _close([tclip], [jclip])
        assert not tclip.requires_grad
    want = jpol.apply(params, *_j(args), jax.random.key(0), True, dialog_clip=jclip, method=JaxDialogPolicy.act)
    with torch.no_grad():
        got = tpol.act(*targs, deterministic=True, dialog_clip=tclip)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1:], want[1:])  # log-prob, value, x, x_att, logits

    actions = np.array([3, 0, 1], np.int32)
    want = jpol.apply(params, *_j(args), jnp.asarray(actions), dialog_clip=jclip,
                      method=JaxDialogPolicy.evaluate_step)
    with torch.no_grad():
        got = tpol.evaluate_step(*targs, torch.as_tensor(actions).long(), dialog_clip=tclip)
    _close(got, want)  # value, log-prob, entropy, logits, x, x_att


def test_clip_embed_is_frozen():
    _, _, tpol, args = _dialog_pair(False, seed=5)
    targs = tuple(_t(a) for a in args)
    value, logp, _, _, _, _ = tpol.evaluate_step(*targs, torch.tensor([0, 1, 2]))
    (value.sum() + logp.sum()).backward()
    assert all(p.grad is None for p in tpol.net.clip.parameters())
    assert tpol.net.dialog_layer.weight.grad is not None


def _option_pair(pretraining, seed, use_rgb=False):
    rng = np.random.RandomState(seed)
    kw = dict(COMMON, pretraining=pretraining, query_count_emb_size=QC, use_rgb=use_rgb)
    jpol = JaxOptionPolicy(net=JaxOptionNet(**kw))
    obs = _obs(rng)
    if use_rgb:
        obs["rgb"] = rng.randint(0, 255, (B, 16, 16, 3)).astype(np.uint8)
    f = jpol.net.feature_size
    pa = np.array([2, 0, 1], np.int32)
    mf, mv = rng.randn(B, 5, f).astype(np.float32), np.array(
        [[1, 1, 1, 0, 0], [0, 0, 0, 0, 0], [1, 1, 1, 1, 1]], np.float32)
    qs, lqi = rng.randn(B, QC).astype(np.float32), rng.randn(B, QC).astype(np.float32)
    args = (obs, pa, mf, mv, qs, lqi)
    g = torch.Generator().manual_seed(seed)
    tpol = OptionPolicy(AudioNavOptionNet(**kw, generator=g), generator=g)
    params = _flax_params(jpol, lambda: jpol.init(jax.random.key(seed), *_j(args), jax.random.key(1),
                                                  method=JaxOptionPolicy.act), tpol)
    return jpol, params, tpol, args


@pytest.mark.parametrize("pretraining", [False, True])
def test_option_policy_matches_flax(pretraining):
    jpol, params, tpol, args = _option_pair(pretraining, seed=3)
    targs = tuple(_t(a) for a in args)
    want = jpol.apply(params, *_j(args), jax.random.key(0), True, method=JaxOptionPolicy.act)
    with torch.no_grad():
        got = tpol.act(*targs, deterministic=True)
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    _close(got[1:], want[1:])  # log-prob, value, x_mem, logits, uncertainty logits

    actions = np.array([1, 0, 1], np.int32)
    want = jpol.apply(params, *_j(args), jnp.asarray(actions), method=JaxOptionPolicy.evaluate_step)
    with torch.no_grad():
        got = tpol.evaluate_step(*targs, torch.as_tensor(actions).long())
    _close(got, want)  # value, log-prob, entropy, logits, uncertainty logits, x_mem


def test_option_net_full_width_layout():
    """RGB-D: 276-d step features + 32-d query state = 308, pose at (272,
    276), so the SMT's entries are 320 wide."""
    net = AudioNavOptionNet(spectrogram_hw=SPEC_HW, d_model=D, nhead=H)
    assert (net.base_feature_size, net.feature_size, net.pose_indices) == (276, 308, (272, 276))
    assert net.smt.fusion0.weight.shape == (D, 320)
    jnet = JaxOptionNet(spectrogram_hw=SPEC_HW, d_model=D, nhead=H)
    assert (jnet.feature_size, jnet.pose_indices) == (308, (272, 276))
