"""TPU.PRECISION in the port's non-convolutional nets against the JAX
package on the CPU, as tests/test_torch_precision.py holds the conv towers
(the same dtype-chain and value checks, at bfloat16 and float16): the SMT
encoder with two encoder and two decoder layers (the plain layers of
``ops/smt_cuda.py`` at the dtype, as JAX's non-fused layers), the CLIP text
tower, the dialog state encoder, and the AV-Nav and AV-WAN nets' feature
towers; then AV-Nav's and AV-WAN's ``act`` at bfloat16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.models.avwan_policy import AVWanNet as JaxAVWanNet
from avlen_tpu.models.avwan_policy import AVWanPolicy as JaxAVWanPolicy
from avlen_tpu.models.clip_text import CLIPTextEncoder as JaxCLIP
from avlen_tpu.models.dialog_encoder import DialogStateEncoder as JaxDialogStateEncoder
from avlen_tpu.models.policy import AudioNavBaselineNet as JaxBaselineNet
from avlen_tpu.models.policy import Policy as JaxPolicy
from avlen_tpu.models.smt import SMTStateEncoder as JaxSMT
from avlen_tpu_torch.models.avwan_policy import AVWanNet, AVWanPolicy
from avlen_tpu_torch.models.clip_text import CLIPTextEncoder
from avlen_tpu_torch.models.dialog_encoder import DialogStateEncoder
from avlen_tpu_torch.models.policy import AudioNavBaselineNet, Policy
from avlen_tpu_torch.models.smt import SMTStateEncoder
from tests.test_torch_precision import B, D, H, LOW, check_values, compiled, flax_params, run_case

torch.set_num_threads(1)


def _smt_layers(dt, jdt, rng):
    # two encoder and two decoder layers: the non-fused plain layers at dtype
    f = 12
    return (SMTStateEncoder(f, D, H, 2, 2, pose_indices=(f - 4, f), generator=torch.Generator().manual_seed(0),
                            dtype=dt),
            JaxSMT(input_size=f, d_model=D, nhead=H, num_encoder_layers=2, num_decoder_layers=2,
                   pose_indices=(f - 4, f), dtype=jdt),
            (rng.randn(B, f).astype(np.float32), rng.randn(B, 5, f).astype(np.float32),
             (rng.rand(B, 5) > 0.3).astype(np.float32), rng.randn(B, D).astype(np.float32)))


def _clip(dt, jdt, rng):
    tokens = rng.randint(1, 1000, (B, 77)).astype(np.int32)
    tokens[:, 0], tokens[np.arange(B), [5, 9, 76]] = 49406, 49407
    return (CLIPTextEncoder(width=D, layers=2, heads=H, embed_dim=16, generator=torch.Generator().manual_seed(0),
                            dtype=dt),
            JaxCLIP(width=D, layers=2, heads=H, embed_dim=16, dtype=jdt), (tokens,))


def _dialog_encoder(dt, jdt, rng):
    # the state memory as the batched re-evaluation casts it
    mem = np.asarray(jnp.asarray(rng.randn(B, 3, D), jdt).astype(jnp.float32))
    return (DialogStateEncoder(D, D, D, H, generator=torch.Generator().manual_seed(0), dtype=dt),
            JaxDialogStateEncoder(state_size=D, dialog_emb_size=D, d_model=D, nhead=H, dtype=jdt),
            (rng.randn(B, D).astype(np.float32), mem, np.array([[1, 0, 1], [0, 0, 0], [1, 1, 1]], np.float32),
             rng.randn(B, D).astype(np.float32), np.array([0, 2, 7], np.int32), rng.randn(B, D).astype(np.float32)))


def _avnav(dt, jdt, rng):
    net = AudioNavBaselineNet(hidden_size=D, spectrogram_hw=(65, 13), visual_hw=(16, 16),
                              generator=torch.Generator().manual_seed(0), dtype=dt)
    obs = {"spectrogram": rng.rand(B, 65, 13, 2).astype(np.float32), "depth": rng.rand(B, 16, 16, 1).astype(np.float32)}
    return (Policy(net, 4, generator=torch.Generator().manual_seed(1)),
            JaxPolicy(net=JaxBaselineNet(hidden_size=D, spectrogram_hw=(65, 13), dtype=jdt), num_actions=4),
            (obs, rng.randn(B, D).astype(np.float32), np.array([1.0, 0.0, 1.0], np.float32)))


def _avwan(dt, jdt, rng):
    net = AVWanNet(hidden_size=D, spectrogram_hw=(65, 13), gm_size=20, am_size=20, action_map_size=3,
                   generator=torch.Generator().manual_seed(0), dtype=dt)
    obs = {"spectrogram": rng.rand(B, 65, 13, 2).astype(np.float32), "gm": rng.rand(B, 20, 20, 2).astype(np.float32),
           "am": rng.rand(B, 20, 20, 1).astype(np.float32)}
    return (AVWanPolicy(net, generator=torch.Generator().manual_seed(1)),
            JaxAVWanPolicy(net=JaxAVWanNet(hidden_size=D, spectrogram_hw=(65, 13), action_map_size=3, dtype=jdt)),
            (obs, rng.randn(B, D).astype(np.float32), np.array([1.0, 0.0, 1.0], np.float32),
             (rng.rand(B, 9) > 0.3).astype(np.float32)))


NETS = {
    "smt_layers": (_smt_layers, None), "clip": (_clip, None), "dialog_encoder": (_dialog_encoder, None),
    "avnav_policy": (_avnav, "features"), "avwan_policy": (_avwan, "features"),
}


@pytest.mark.parametrize("low", list(LOW))
@pytest.mark.parametrize("case", list(NETS))
def test_net_dtype_chain_and_values_match_jax(case, low):
    run_case(*NETS[case][:1], low, NETS[case][1])


def test_policies_act_at_low_precision_match_jax():
    """AV-Nav's and AV-WAN's ``act`` at bfloat16 (CNNs at bf16, the GRU and
    the heads float32, as in JAX): logits, values and the hidden state
    within the bound; every output float32."""
    for build in (_avnav, _avwan):
        rng = np.random.RandomState(1)
        t32, j32, args = build(torch.float32, jnp.float32, rng)
        tlow, jlow, _ = build(torch.bfloat16, jnp.bfloat16, np.random.RandomState(1))
        tlow.load_state_dict(t32.state_dict())
        key = jax.random.key(0)
        params = flax_params(t32, j32, *args, key, method="act")
        obs, hidden, masks = args[:3]
        extra = args[3:]

        def act(jmod):
            return compiled(lambda p, o, h, m, *e: jmod.apply(p, o, h, m, *e, key, True, method="act"),
                            params, obs, hidden, masks, *extra)

        with torch.no_grad():
            out = tlow.act({k: torch.as_tensor(v) for k, v in obs.items()}, torch.as_tensor(hidden),
                           torch.as_tensor(masks), *[torch.as_tensor(e) for e in extra], deterministic=True)
        got = [out[2], out[3], out[4]]  # value, hidden, logits
        assert all(x.dtype == torch.float32 for x in got)
        jl, jf = act(jlow), act(j32)
        check_values(got, [jl[2], jl[3], jl[4]], [jf[2], jf[3], jf[4]])
