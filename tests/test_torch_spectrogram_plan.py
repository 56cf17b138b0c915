"""The launch plan of the port's spectrogram kernel (``csrc/spectrogram.cu``),
on the CPU: ``spectrogram_plan`` fits an H100 block, its spans give each
frame the reflect-padded samples, no radix stage conflicts on shared-memory
banks, and a numpy evaluation of the kernel's algorithm (the two-ear pack,
the plan's Stockham radices and twiddle table, the unpack, the pooling order
and log1p, in float32) equals ``spectrogram_plain``."""

import numpy as np
import pytest
import torch

from avlen_tpu_torch.ops.audio import SpectrogramConfig, centered_window
from avlen_tpu_torch.ops.spectrogram_cuda import (
    MAX_SMEM,
    VALUES,
    spectrogram_plain,
    spectrogram_plan,
    swizzle,
)

torch.set_num_threads(1)

N_FFTS = (64, 128, 256, 512, 1024)
RATES = (4000, 8000, 16000)


def _config(n_fft, sr):
    return SpectrogramConfig(sampling_rate=sr, n_fft=n_fft, win_length=min(400, n_fft) * 3 // 4)


@pytest.mark.parametrize("batch", [1, 3, 16, 256])
@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("n_fft", N_FFTS)
def test_plan_fits_an_h100_block(n_fft, sr, batch):
    cfg = _config(n_fft, sr)
    plan = spectrogram_plan(batch, sr, cfg)
    assert plan.grid == (plan.tprime, batch, 1)
    assert (plan.fprime, plan.tprime, 2) == cfg.out_shape and plan.n_frames == cfg.num_frames
    assert plan.threads % 32 == 0 and plan.threads <= 1024
    assert plan.threads - 32 < plan.bt * n_fft // VALUES <= plan.threads  # whole frames, whole warps
    assert int(np.prod(plan.radices)) == n_fft and plan.radices[1:] == (8,) * (len(plan.radices) - 1)
    assert plan.radices[0] in (2, 4, 8) and len(plan.radices) <= 4  # at most three exchanges
    assert plan.span == (plan.bt - 1) * plan.hop + n_fft
    assert plan.buffer_slots >= max(plan.span, plan.bt * (n_fft + 1))
    assert plan.smem_bytes == 2 * plan.buffer_slots * 8 <= MAX_SMEM
    assert plan.group >= min(plan.bt, 32) and plan.group & (plan.group - 1) == 0
    assert 32 % plan.group == 0 and plan.threads % plan.group == 0
    m = np.arange(n_fft)
    np.testing.assert_allclose(plan.twiddles, np.exp(2j * np.pi * m / n_fft), atol=1e-7)
    assert plan.twiddles.dtype == np.complex64


@pytest.mark.parametrize("sr", RATES)
@pytest.mark.parametrize("n_fft", N_FFTS)
def test_spans_hold_each_frame_reflect_padded(n_fft, sr):
    """Frame g's samples are span[f*hop : f*hop + n_fft] of block column
    g // bt (f = g % bt), and equal np.pad(..., mode="reflect")."""
    plan = spectrogram_plan(2, sr, _config(n_fft, sr))
    padded = np.pad(np.arange(sr), plan.pad, mode="reflect")
    for col in range(plan.tprime):
        idx = plan.span_indices(col)
        assert idx.shape == (plan.span,) and idx.min() >= -1 and idx.max() < sr
        for f in range(min(plan.bt, plan.n_frames - col * plan.bt)):
            g = col * plan.bt + f
            np.testing.assert_array_equal(idx[f * plan.hop : f * plan.hop + n_fft],
                                          padded[g * plan.hop : g * plan.hop + n_fft])


def _smem_accesses(plan):
    """The shared-memory slots that each group of 16 lanes loads or stores
    together (a warp's 8-byte accesses go to the banks a half-warp at a
    time), per radix stage and for pooling: (what, slots) pairs. Exchange
    buffers hold frames at n_fft through the swizzle; the last stage
    stores, and pooling reads, natural order at n_fft + 1."""
    n = plan.n_fft
    tpf = n // VALUES
    tid = np.arange(plan.threads)
    frame, t = tid // tpf, tid % tpf
    swizzled = lambda f, i: f * n + swizzle(i)  # noqa: E731
    natural = lambda f, i: f * (n + 1) + i  # noqa: E731
    ns, out = 1, []
    for s, r_ in enumerate(plan.radices):
        last = s == len(plan.radices) - 1
        for q in range(VALUES // r_):
            j = t + q * tpf
            k = j % ns
            for r in range(r_):
                acc = [(f"stage {s} stores", natural if last else swizzled, (j - k) * r_ + k + r * ns)]
                if s:
                    acc.append((f"stage {s} loads", swizzled, j + r * (n // r_)))
                for what, layout, idx in acc:
                    slots = layout(frame, idx)
                    for h in range(0, plan.threads, 16):
                        keep = frame[h : h + 16] < plan.bt
                        out.append((what, slots[h : h + 16][keep]))
        ns *= r_
    jf, fr = tid // plan.group, tid % plan.group  # pooling: lane (bin, frame)
    for j0 in range(0, plan.fprime, plan.threads // plan.group):
        for fi in range(plan.bf):
            k = (j0 + jf) * plan.bf + fi
            ok = (j0 + jf < plan.fprime) & (k <= n // 2) & (fr < plan.bt)
            for what, idx in (("pool", k), ("pool mirror", (n - k) % n)):
                slots = natural(fr, idx)
                for h in range(0, plan.threads, 16):
                    out.append((what, slots[h : h + 16][ok[h : h + 16]]))
    return out


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_no_shared_memory_bank_conflicts(n_fft):
    """Every stage's loads and stores, and pooling's reads, of 16 lanes hit
    16 different bank pairs, for n_fft >= 128; at 64 a half-warp spans two
    frames and may meet twice."""
    plan = spectrogram_plan(1, 16000, _config(n_fft, 16000))
    worst = {}
    for what, slots in _smem_accesses(plan):
        if len(slots):
            hits = np.bincount(np.unique(slots) % 16, minlength=16).max()
            worst[what] = max(worst.get(what, 1), hits)
    assert max(worst.values()) == (2 if n_fft == 64 else 1), worst
    # the swizzle permutes each frame's slots, and is linear over bits
    i = np.arange(n_fft)
    np.testing.assert_array_equal(np.sort(swizzle(i)), i)
    a, b = i & 0x55, i & 0xAA
    np.testing.assert_array_equal(swizzle(a | b), swizzle(a) ^ swizzle(b))


def _stockham(x, plan):
    """The kernel's stages on rows of x (complex64): item j of a radix-R stage
    after ns points loads x[j + r*n/R], multiplies by w^r, w = twiddles[k*n/(ns*R)]
    (k = j mod ns), takes the R-point inverse DFT, stores y[(j-k)*R + k + r*ns]."""
    n = x.shape[-1]
    ns = 1
    for R in plan.radices:
        per = n // R
        j = np.arange(per)
        k = j % ns
        r = np.arange(R)
        v = x[..., j[:, None] + r[None, :] * per]
        m = k * (n // (ns * R))  # twiddles: w = e^{2 pi i m/n}; w, w^2, w^4 from the table
        w = [None] * R
        for p in range(1, R):
            low = p & -p
            w[p] = plan.twiddles[p * m] if low == p else w[p - low] * w[low]
        v[..., 1:] = v[..., 1:] * np.stack(w[1:], 1)
        dft = np.exp(2j * np.pi * np.outer(r, r) / R).astype(np.complex64)
        v = v @ dft
        y = np.empty_like(x)
        y[..., ((j - k) * R + k)[:, None] + r[None, :] * ns] = v
        x, ns = y, ns * R
    return x


def _emulate(audio, cfg):
    """The kernel's algorithm in float32 numpy: (B, 2, T) → (B, F', T', 2)."""
    b, _, t = audio.shape
    plan = spectrogram_plan(b, t, cfg)
    n, hop, bf, bt = plan.n_fft, plan.hop, plan.bf, plan.bt
    win = centered_window(n, cfg.win_length)
    zs = []
    for col in range(plan.tprime):
        idx = plan.span_indices(col)
        span = np.where(idx >= 0, audio[:, :, np.maximum(idx, 0)], np.float32(0))  # (B, 2, span)
        frames = [span[:, :, f * hop : f * hop + n] * win for f in range(bt)]
        zs.append(np.stack([(fr[:, 0] + 1j * fr[:, 1]).astype(np.complex64) for fr in frames], 1))
    z = _stockham(np.stack(zs, 1), plan)  # (B, T', bt, n)
    k = np.arange(n // 2 + 1)
    a, c = z[..., k], z[..., (n - k) % n]
    mag_l = np.sqrt((a.real + c.real) ** 2 + (a.imag - c.imag) ** 2)
    mag_r = np.sqrt((a.real - c.real) ** 2 + (a.imag + c.imag) ** 2)
    real = (np.arange(plan.tprime)[:, None] * bt + np.arange(bt)[None, :]) < plan.n_frames
    g, nb = plan.group, bf * bt
    out = np.zeros((b, plan.fprime, plan.tprime, 2), np.float32)
    for ear, mag in enumerate((mag_l, mag_r)):
        mag = np.where(real[None, :, :, None], mag, np.float32(0))
        lanes = np.zeros((b, plan.tprime, plan.fprime, g), np.float32)
        for lane in range(g):
            for fr in range(lane, bt, g):  # a lane's frames, each its bf bins in order
                for fi in range(bf):
                    kk = np.arange(plan.fprime) * bf + fi
                    ok = kk <= n // 2
                    lanes[:, :, ok, lane] += mag[:, :, fr, kk[ok]]
        o = g // 2
        while o:  # the shuffle tree: lane l adds lane l ^ o
            lanes = lanes + lanes[..., np.arange(g) ^ o]
            o //= 2
        pooled = lanes[..., 0] * (np.float32(0.5) / np.float32(nb))
        out[..., ear] = np.log1p(pooled).transpose(0, 2, 1)
    return out


def _audio(b, t, seed, right_scale=1.0, silent_row=None):
    audio = (0.3 * np.random.RandomState(seed).randn(b, 2, t)).astype(np.float32)
    audio[:, 1] *= np.float32(right_scale)
    if silent_row is not None:
        audio[silent_row] = 0
    return audio


@pytest.mark.parametrize("case,b,t,n_fft,right_scale,silent_row", [
    ("savi", 2, 16000, 512, 1.0, None),
    ("uneven", 3, 16000, 512, 1e-3, 1),  # quiet right ear, one silent env
    ("rate8k", 3, 8000, 512, 1.0, None),
    ("rate4k", 2, 4000, 512, 1.0, None),
    ("n64", 2, 4000, 64, 1.0, None),
    ("n128", 2, 4000, 128, 1.0, None),
    ("n256", 2, 4000, 256, 1e-3, None),
    ("n1024", 2, 8000, 1024, 1.0, 0),
])
def test_emulated_kernel_matches_plain(case, b, t, n_fft, right_scale, silent_row):
    cfg = _config(n_fft, t) if n_fft != 512 else SpectrogramConfig(sampling_rate=t)
    audio = _audio(b, t, n_fft + t, right_scale, silent_row)
    got = _emulate(audio, cfg)
    want = spectrogram_plain(torch.as_tensor(audio), cfg).numpy()
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0, err_msg=case)
    if silent_row is not None:
        assert not got[silent_row].any()


@pytest.mark.parametrize("kw", [
    dict(n_fft=32, win_length=32), dict(n_fft=2048), dict(n_fft=384), dict(n_fft=256, win_length=400),
    dict(pad_mode="constant"), dict(n_fft=1024, win_length=1000, block=(4, 16)),
])
def test_plan_rejects_what_the_kernel_does_not_take(kw):
    with pytest.raises(ValueError):
        spectrogram_plan(2, 16000, SpectrogramConfig(**kw))


def test_plan_rejects_a_signal_too_short_to_pad():
    with pytest.raises(ValueError, match="too short"):
        spectrogram_plan(2, 256, SpectrogramConfig())
