"""PyTorch port's world and audio path against the JAX package, on the CPU
(where the port's kernel wrappers run their plain versions): the same seed
gives the same world; the analytic RIR spectra equal rfft of the RIRs; the
plain partial irfft and spectrogram match the JAX paths and the numpy
golden references; render_audiogoal matches with and without a distractor."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from avlen_tpu.ops import audio as jaudio
from avlen_tpu.sim import synthetic as jsyn
from avlen_tpu_torch.ops import audio as taudio
from avlen_tpu_torch.ops.irfft_cuda import partial_irfft, supported
from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram, spectrogram_plain
from avlen_tpu_torch.sim import synthetic as tsyn
from avlen_tpu_torch.sim.scene import precompute_sound_fft_bank
from avlen_tpu_torch.utils.flax_bridge import scene_bank_from_jax
from tests.golden_audio import reference_spectrogram

torch.set_num_threads(1)

SR, RIR = 8000, 2000  # fft_len 16384, the smallest the CUDA kernel takes


@pytest.fixture(scope="module")
def worlds():
    kw = dict(num_scenes=2, side=4, sampling_rate=SR, rir_length=RIR, num_sounds=3, frame_res=16)
    jbank, jtables = jsyn.make_scene_bank(np.random.RandomState(5), **kw)
    tbank, ttables = tsyn.make_scene_bank(np.random.RandomState(5), device="cpu", **kw)
    return jbank, jtables, tbank, ttables


def test_same_seed_same_world(worlds):
    jbank, jtables, tbank, ttables = worlds
    for k, v in jbank.tables.items():
        np.testing.assert_array_equal(tbank.tables[k].numpy(), np.asarray(v), err_msg=k)
    for name in ("rgb", "depth", "semantic", "semantic_instance_to_mp3d", "sounds_padded", "sound_secs"):
        np.testing.assert_array_equal(getattr(tbank, name).numpy(), np.asarray(getattr(jbank, name)), err_msg=name)
    jeps = jsyn.make_episodes(np.random.RandomState(9), jtables, 12, with_distractor=True)
    teps = tsyn.make_episodes(np.random.RandomState(9), ttables, 12, with_distractor=True)
    assert [vars(e) for e in jeps] == [vars(e) for e in teps]
    # the procedural tails come from each framework's own generator
    assert tbank.rir.tail_fft.shape == jbank.rir.tail_fft.shape
    assert tbank.rir.itd_phase.shape == jbank.rir.itd_phase.shape


def _pairs(bank, n=6, seed=0):
    rng = np.random.RandomState(seed)
    nn_ = bank.max_nodes
    return [rng.randint(0, k, n).astype(np.int32) for k in (bank.num_scenes, 4, nn_, nn_)]


def test_gather_fft_is_rfft_of_gather(worlds):
    _, _, tbank, _ = worlds
    idx = [torch.as_tensor(a).long() for a in _pairs(tbank)]
    rir = tbank.rir.gather(*idx)
    want = torch.fft.rfft(rir.transpose(1, 2), n=tbank.rir.fft_len, dim=-1)
    got = tbank.rir.gather_fft(*idx)
    scale = want.abs().max().item()
    assert (got - want).abs().max().item() < 2e-5 * scale


def test_carried_rirs_match_jax(worlds):
    jbank, _, _, _ = worlds
    cbank = scene_bank_from_jax(jbank, "cpu")
    idx = _pairs(jbank, seed=1)
    jidx = [jnp.asarray(a) for a in idx]
    tidx = [torch.as_tensor(a).long() for a in idx]
    np.testing.assert_allclose(cbank.rir.gather(*tidx).numpy(), np.asarray(jbank.rir.gather(*jidx)), atol=1e-6)
    want = np.asarray(jbank.rir.gather_fft(*jidx))
    got = cbank.rir.gather_fft(*tidx).numpy()
    np.testing.assert_allclose(got, want, atol=2e-5 * np.abs(want).max())


def test_sound_fft_bank_matches_jax(worlds):
    jbank, _, tbank, _ = worlds
    from avlen_tpu.sim.scene import precompute_sound_fft_bank as jax_sound_fft_bank

    want = np.asarray(jax_sound_fft_bank(jbank))
    got = precompute_sound_fft_bank(tbank).numpy()
    np.testing.assert_allclose(got, want, atol=1e-5 * np.abs(want).max())


@pytest.mark.parametrize("fft_len,out_start,out_len", [(16384, 1999, 8000), (32768, 7999, 16000), (16384, 333, 777)])
def test_plain_irfft_matches_jax(fft_len, out_start, out_len):
    rng = np.random.RandomState(fft_len + out_start)
    x = rng.randn(3, 2, fft_len).astype(np.float32)
    spec = np.fft.rfft(x, axis=-1).astype(np.complex64)
    got = partial_irfft(torch.as_tensor(spec), fft_len, out_start, out_len).numpy()
    ref = np.asarray(jnp.fft.irfft(jnp.asarray(spec), n=fft_len, axis=-1))[..., out_start : out_start + out_len]
    mm = np.asarray(jaudio.partial_irfft_matmul(jnp.asarray(spec), fft_len, out_start, out_len))
    scale = max(np.abs(ref).max(), 1.0)
    np.testing.assert_allclose(got, ref, atol=5e-6 * scale, rtol=0)
    np.testing.assert_allclose(got, mm, atol=5e-6 * scale, rtol=0)
    assert supported(fft_len) and not supported(8192) and not supported(3 * 8192)


def test_plain_spectrogram_matches_jax_and_golden():
    rng = np.random.RandomState(0)
    cfg = taudio.SpectrogramConfig(sampling_rate=4000)
    audio = rng.randn(3, 2, 4000).astype(np.float32)
    got = spectrogram(torch.as_tensor(audio), cfg).numpy()
    assert got.shape == (3,) + cfg.out_shape
    want = np.asarray(jaudio.spectrogram_from_audiogoal(
        jnp.asarray(audio), jaudio.SpectrogramConfig(sampling_rate=4000, use_pallas=False)))
    np.testing.assert_allclose(got, want, atol=2e-3, rtol=0)
    for b in range(3):
        np.testing.assert_allclose(got[b], reference_spectrogram(audio[b].astype(np.float64)), atol=2e-3)
    np.testing.assert_array_equal(spectrogram_plain(torch.as_tensor(audio), cfg).numpy(), got)


def test_plain_spectrogram_matches_jax_and_pallas_at_savi_rate():
    """At savi.yaml's 16 kHz the plain version agrees with the JAX XLA path and
    with the Pallas kernel (interpreted) to f32 rounding."""
    from avlen_tpu.ops.pallas_spectrogram import spectrogram_pallas

    rng = np.random.RandomState(1)
    audio = rng.randn(2, 2, 16000).astype(np.float32)
    got = spectrogram_plain(torch.as_tensor(audio), taudio.SpectrogramConfig(sampling_rate=16000)).numpy()
    jcfg = jaudio.SpectrogramConfig(sampling_rate=16000, use_pallas=False)
    xla = np.asarray(jaudio.spectrogram_from_audiogoal(jnp.asarray(audio), jcfg))
    pallas = np.asarray(spectrogram_pallas(jnp.asarray(audio), jcfg, interpret=True))
    assert got.shape == xla.shape == pallas.shape == (2, 65, 26, 2)
    np.testing.assert_allclose(got, xla, atol=1e-5, rtol=0)
    np.testing.assert_allclose(got, pallas, atol=1e-5, rtol=0)


@pytest.mark.parametrize("distractor", [False, True])
def test_render_audiogoal_matches_jax(worlds, distractor):
    jbank, _, _, _ = worlds
    cbank = scene_bank_from_jax(jbank, "cpu")
    scene, az, recv, src = _pairs(jbank, n=4, seed=2)
    dsrc = (src + 1) % jbank.max_nodes
    sound = np.array([0, 1, 2, 1])
    dsound = np.array([2, 0, 1, 0])
    idx = np.array([0, 0, 0, 0], np.int32)
    active = np.array([True, True, False, True])
    cfg_j = jaudio.SpectrogramConfig(sampling_rate=SR)
    cfg_t = taudio.SpectrogramConfig(sampling_rate=SR)

    def args(bank, to, rf):
        kw = dict(rir_f=rf(scene, az, recv, src), rir_len=RIR)
        if distractor:
            kw.update(has_distractor=True, distractor_sound_padded=bank.sounds_padded[to(dsound)],
                      distractor_rir_f=rf(scene, az, recv, dsrc))
        return (bank.sounds_padded[to(sound)], to(idx), None, to(active), SR), kw

    ja, jkw = args(jbank, jnp.asarray,
                   lambda *a: jbank.rir.gather_fft(*(jnp.asarray(x) for x in a)))
    j_audio, j_spec = jaudio.render_audiogoal(*ja, config=cfg_j, **jkw)
    ta, tkw = args(cbank, lambda a: torch.as_tensor(a).long() if a.dtype != bool else torch.as_tensor(a),
                   lambda *a: cbank.rir.gather_fft(*(torch.as_tensor(x).long() for x in a)))
    t_audio, t_spec = taudio.render_audiogoal(*ta, config=cfg_t, **tkw)
    scale = np.abs(np.asarray(j_audio)).max()
    np.testing.assert_allclose(t_audio.numpy(), np.asarray(j_audio), atol=5e-6 * scale)
    np.testing.assert_allclose(t_spec.numpy(), np.asarray(j_spec), atol=2e-3)
    assert not t_audio[2].any()  # inactive env renders silence


def test_binaural_convolve_time_domain_matches_jax_and_golden(worlds):
    """The per-step segment gather + rFFT and the RIR rFFT branches (no
    precomputed spectra), against JAX and the scipy-window golden."""
    from tests.golden_audio import reference_audiogoal

    _, _, tbank, _ = worlds
    idx = [torch.as_tensor(a).long() for a in _pairs(tbank, n=3, seed=3)]
    rir = tbank.rir.gather(*idx)  # (3, L, 2)
    sound = torch.tensor([0, 2, 1])
    padded = tbank.sounds_padded[sound]
    start = torch.zeros(3, dtype=torch.long)
    got = taudio.binaural_convolve(padded, start, rir, SR).numpy()
    want = np.asarray(jaudio.binaural_convolve(jnp.asarray(padded.numpy()), jnp.asarray(start.numpy()),
                                               jnp.asarray(rir.numpy()), SR))
    scale = np.abs(want).max()
    np.testing.assert_allclose(got, want, atol=5e-6 * scale)
    for b in range(3):
        mono = padded[b, RIR - 1 :].numpy().astype(np.float64)
        gold = reference_audiogoal(mono, rir[b].numpy().astype(np.float64), 0, SR)
        np.testing.assert_allclose(got[b], gold, atol=1e-5 * scale)
