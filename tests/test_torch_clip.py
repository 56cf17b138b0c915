"""The port's CLIP text tower and tokenizer (avlen_tpu_torch/models/
clip_text.py, clip_bpe.py) against the JAX package: ``tokenize`` id for id
(truncation at 77 included), the tower at a tiny width with the Flax
weights carried across (2e-5), ``to_flax_params`` giving back the Flax
tree exactly, and ``load_openai_weights`` mapping a CLIP state dict as the
JAX function does."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.models import clip_text as jclip
from avlen_tpu_torch.models import clip_bpe
from avlen_tpu_torch.models.clip_text import CLIPTextEncoder, load_openai_weights, tokenize
from avlen_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params

torch.set_num_threads(1)

WIDTH, LAYERS, HEADS, EMBED = 64, 2, 4, 48

INSTRUCTIONS = [
    "turn left then go forward three steps and stop there",
    "go forward one step to reach the chair",
    "turn around",
    "stop here",
    "Turn LEFT, then go   forward.",
    "a cat's hat!! café 123 <|endoftext|>ish",
    "Ünïcode ½ ² Ⅻ ٣ 東京 naïve — ok",
    "",
    # over 77 ids without merges: truncated, EOT kept
    "then go forward two steps " * 6,
]


def test_tokenize_matches_jax():
    got = tokenize(INSTRUCTIONS)
    want = jclip.tokenize(INSTRUCTIONS)
    assert got.dtype == np.int32 and got.shape == (len(INSTRUCTIONS), 77)
    np.testing.assert_array_equal(got, want)
    assert got[-1, -1] == jclip.EOT_TOKEN  # the long one was cut to fit
    for ctx in (16, 77):
        np.testing.assert_array_equal(tokenize(INSTRUCTIONS, ctx), jclip.tokenize(INSTRUCTIONS, ctx))


def test_split_pattern_matches_regex_module():
    """The stdlib-``re`` split equals the ``regex`` one of the JAX package."""
    from avlen_tpu.models.clip_bpe import _PAT

    for text in INSTRUCTIONS:
        t = text.lower()
        assert clip_bpe.split_pattern().findall(t) == _PAT.findall(t)


def _pair(seed=0):
    jmod = jclip.CLIPTextEncoder(width=WIDTH, layers=LAYERS, heads=HEADS, embed_dim=EMBED)
    tokens = tokenize(INSTRUCTIONS[:6])
    params = jax.tree.map(np.asarray, jmod.init(jax.random.key(seed), jnp.asarray(tokens)))
    tmod = CLIPTextEncoder(width=WIDTH, layers=LAYERS, heads=HEADS, embed_dim=EMBED)
    load_flax_params(tmod, params)
    return jmod, params, tmod, tokens


def test_tower_matches_flax():
    jmod, params, tmod, tokens = _pair(1)
    want = np.asarray(jmod.apply(params, jnp.asarray(tokens)))
    with torch.no_grad():
        got = tmod(torch.as_tensor(tokens)).numpy()
    assert got.shape == (tokens.shape[0], EMBED)
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)


def test_to_flax_params_round_trips_the_tower():
    _, params, tmod, _ = _pair(2)
    back = to_flax_params(tmod)
    flat_want = dict(jax.tree_util.tree_flatten_with_path(params)[0])
    flat_got = dict(jax.tree_util.tree_flatten_with_path(back)[0])
    assert flat_got.keys() == flat_want.keys()
    for k, v in flat_want.items():
        assert flat_got[k].shape == v.shape, k
        np.testing.assert_array_equal(flat_got[k], v)


def test_own_init_follows_flax_initialisers():
    """Without carried weights the tower's init has Flax's scales: the
    embedding std 1/sqrt(width), positions 0.01, projection 0.02, dense
    kernels truncated fan-in normals of variance 1/fan_in."""
    tmod = CLIPTextEncoder(width=WIDTH, layers=LAYERS, heads=HEADS, embed_dim=EMBED,
                           generator=torch.Generator().manual_seed(0))
    emb = tmod.token_embedding.weight
    assert abs(emb.std().item() - WIDTH ** -0.5) < 0.01
    assert abs(tmod.positional_embedding.std().item() - 0.01) < 0.001
    assert abs(tmod.text_projection.std().item() - 0.02) < 0.002
    fc = tmod.mlp_fc_0.weight
    assert abs(fc.std().item() - WIDTH ** -0.5) < 0.01 and fc.abs().max() <= 2 * WIDTH ** -0.5 / 0.8796 + 1e-6
    assert tmod.ln1_0.eps == 1e-6


def _openai_state_dict(rng):
    w = WIDTH
    sd = {
        "token_embedding.weight": rng.randn(clip_bpe.VOCAB_SIZE, w),
        "positional_embedding": rng.randn(77, w),
        "text_projection": rng.randn(w, EMBED),
        "ln_final.weight": rng.randn(w),
        "ln_final.bias": rng.randn(w),
    }
    for i in range(LAYERS):
        pre = f"transformer.resblocks.{i}"
        sd.update({
            f"{pre}.ln_1.weight": rng.randn(w), f"{pre}.ln_1.bias": rng.randn(w),
            f"{pre}.ln_2.weight": rng.randn(w), f"{pre}.ln_2.bias": rng.randn(w),
            f"{pre}.attn.in_proj_weight": rng.randn(3 * w, w), f"{pre}.attn.in_proj_bias": rng.randn(3 * w),
            f"{pre}.attn.out_proj.weight": rng.randn(w, w), f"{pre}.attn.out_proj.bias": rng.randn(w),
            f"{pre}.mlp.c_fc.weight": rng.randn(4 * w, w), f"{pre}.mlp.c_fc.bias": rng.randn(4 * w),
            f"{pre}.mlp.c_proj.weight": rng.randn(w, 4 * w), f"{pre}.mlp.c_proj.bias": rng.randn(w),
        })
    return {k: (0.05 * v).astype(np.float32) for k, v in sd.items()}


def test_load_openai_weights_matches_jax():
    _, params, tmod, tokens = _pair(3)
    sd = _openai_state_dict(np.random.RandomState(4))
    want_params = jclip.load_openai_weights(params, sd)
    load_openai_weights(tmod, sd)
    got_params = to_flax_params(tmod)
    for (path, want), (_, got) in zip(jax.tree_util.tree_flatten_with_path(want_params)[0],
                                      jax.tree_util.tree_flatten_with_path(got_params)[0]):
        np.testing.assert_array_equal(got, want, err_msg=str(path))
    with pytest.raises(KeyError):
        load_openai_weights(tmod, {k: v for k, v in sd.items() if k != "ln_final.bias"})
