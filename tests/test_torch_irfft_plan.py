"""The launch plan of the port's partial-irfft kernel (``csrc/partial_irfft.cu``),
on the CPU: ``irfft_plan`` fits an H100 block and cluster, its rows cover the
window exactly, and a numpy evaluation of the kernel's four-step
decomposition with the plan's split (P, Q, C, radix stages, u-window)
equals ``np.fft.irfft``."""

import numpy as np
import pytest

from avlen_tpu_torch.ops.irfft_cuda import CTA_ELEMS, irfft_plan

H100_SMEM = 232448  # bytes of shared memory one H100 block may use (227 KB)
MAX_CLUSTER = 16  # the non-portable maximum; 8 is portable

LOG_LENS = range(14, 19)  # fft_len 2^14 .. 2^18: clusters of 1 .. 16 CTAs


def _windows(n):
    # "edge": the last sample is the first of its row u (z index n/8 = h/4)
    return {"zero": (0, 1000), "end": (n - 999, 999), "odd": (n // 3 | 1, n // 5 | 1), "edge": (1, n // 4)}


CASES = [(1 << ln, name) for ln in LOG_LENS for name in ("zero", "end", "odd", "edge")]


def _stockham(x, radices):
    """Inverse (sign +) unnormalised FFT of each row of x, as the kernel's
    radix stages do it: item j of a radix-R stage reads x[j + r*n/R],
    multiplies by e^{2 pi i r k/(ns R)} (k = j mod ns), transforms and
    writes y[(j - k)*R + k + r*ns]."""
    n = x.shape[-1]
    ns = 1
    for R in radices:
        per = n // R
        j = np.arange(per)
        k = j % ns
        r = np.arange(R)
        v = x[..., j[:, None] + r[None, :] * per]  # (..., per, R)
        v = v * np.exp(2j * np.pi * r[None, :] * k[:, None] / (ns * R))
        v = np.fft.ifft(v, axis=-1) * R
        y = np.empty_like(x)
        y[..., ((j - k) * R + k)[:, None] + r[None, :] * ns] = v
        x, ns = y, ns * R
    assert ns == n
    return x


def _four_step(spec, plan):
    """out[n] for n in the window, evaluated CTA by CTA of one row's cluster."""
    h, P, Q, C = plan.h, plan.P, plan.Q, plan.cluster
    X = spec.astype(np.complex128)
    k = np.arange(h)
    xk, xr = X[k].copy(), X[h - k].copy()
    xk[0], xr[0] = xk[0].real, xr[0].real  # DC and Nyquist are read as real
    Z = 0.5 * ((xk + np.conj(xr)) + 1j * np.exp(2j * np.pi * k / (2 * h)) * (xk - np.conj(xr)))
    Y = np.empty((P, Q), np.complex128)  # Y[a, v]
    for c in range(C):  # pass 1: CTA c owns columns a in [c*cols1, (c+1)*cols1)
        a = np.arange(c * plan.cols1, (c + 1) * plan.cols1)
        cols = Z[a[:, None] + P * np.arange(Q)[None, :]]
        Y[a] = _stockham(cols, plan.radices_q) * np.exp(2j * np.pi * a[:, None] * np.arange(Q)[None, :] / h)
    out = np.full(plan.out_len, np.nan)
    hits = np.zeros(plan.out_len, int)
    for c in range(C):  # pass 2: CTA c owns columns v in [c*cols2, (c+1)*cols2)
        v = np.arange(c * plan.cols2, (c + 1) * plan.cols2)
        z = _stockham(Y[:, v].T, plan.radices_p) / h  # z[v, u]
        for u in range(plan.u0, plan.u1 + 1):
            for part in (0, 1):
                n = 2 * (Q * u + v) + part - plan.out_start
                ok = (n >= 0) & (n < plan.out_len)
                out[n[ok]] = (z[ok, u].imag if part else z[ok, u].real)
                hits[n[ok]] += 1
    return out, hits


@pytest.mark.parametrize("fft_len,window", CASES)
def test_plan_fits_an_h100_cluster(fft_len, window):
    start, length = _windows(fft_len)[window]
    plan = irfft_plan(fft_len, start, length, rows=32)
    assert plan.smem_bytes <= H100_SMEM
    assert 1 <= plan.cluster <= MAX_CLUSTER and plan.grid == (32 * plan.cluster, 1, 1)
    assert plan.P * plan.Q == plan.h == fft_len // 2
    assert plan.cluster * CTA_ELEMS == plan.h  # 64 KB of the row on each CTA
    assert plan.cols1 * plan.cluster == plan.P and plan.cols2 * plan.cluster == plan.Q
    assert plan.cols1 >= 16 and plan.cols2 >= 16  # a half-warp spans whole columns
    assert np.prod(plan.radices_q) == plan.Q and np.prod(plan.radices_p) == plan.P
    assert len(plan.radices_p) == 2 and set(plan.radices_q + plan.radices_p) <= {8, 16}
    assert plan.threads * 32 == CTA_ELEMS  # 32 values per thread in registers


@pytest.mark.parametrize("fft_len,window", CASES)
def test_plan_rows_cover_the_window_exactly(fft_len, window):
    start, length = _windows(fft_len)[window]
    plan = irfft_plan(fft_len, start, length)
    t = np.arange(plan.u0 * plan.Q, (plan.u1 + 1) * plan.Q)  # z indices the rows give
    written = np.concatenate([2 * t, 2 * t + 1]) - start
    inside = np.sort(written[(written >= 0) & (written < length)])
    np.testing.assert_array_equal(inside, np.arange(length))  # each sample once
    # the first and last rows are needed: no row is written for nothing
    assert plan.u0 == (start // 2) // plan.Q
    assert plan.u1 == ((start + length - 1) // 2) // plan.Q


@pytest.mark.parametrize("fft_len,window", CASES)
def test_four_step_with_the_plan_matches_numpy(fft_len, window):
    start, length = _windows(fft_len)[window]
    plan = irfft_plan(fft_len, start, length)
    rng = np.random.RandomState(fft_len + start)
    spec = np.fft.rfft(rng.randn(fft_len)).astype(np.complex64)
    got, hits = _four_step(spec, plan)
    want = np.fft.irfft(spec.astype(np.complex128), n=fft_len)[start : start + length]
    assert (hits == 1).all()
    scale = max(np.abs(want).max(), 1.0)
    np.testing.assert_allclose(got, want, atol=5e-6 * scale, rtol=0)


def test_plan_rejects_what_the_kernel_does_not_take():
    for bad in ((1 << 13, 0, 100), (1 << 19, 0, 100), (3 << 14, 0, 100), (1 << 14, -1, 10), (1 << 14, 16380, 10)):
        with pytest.raises(ValueError):
            irfft_plan(*bad)
