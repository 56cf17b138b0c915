"""Partial inverse real FFT: the valid window of the RIR⊛source convolution.

``partial_irfft(spec, fft_len, out_start, out_len)`` equals
``torch.fft.irfft(spec, n=fft_len)[..., out_start:out_start+out_len]``.

Replaces the TPU kernel ``avlen_tpu/ops/pallas_irfft.py:partial_irfft_pallas``
(body ``_irfft_kernel``). On a CUDA tensor it launches the hand-written
kernel ``csrc/partial_irfft.cu``; on a CPU tensor it runs the plain version.

Bound on an H100: bytes. At the audio path's shape, (16, 2, 32769) complex64
in and (16, 2, 16000) f32 out, the call moves ~10.4 MB: ~3 µs at 3.35 TB/s.
The TPU kernel's dense DFT-as-matmul (~2.7 GFLOP, ~40 µs of f32) is not
carried over. The real inverse of length N is packed into a complex one of
length h = N/2, split h = P·Q, and each row is one thread-block cluster of
C = h/8192 CTAs (a row shorter than that, h = 1024 to 4096, is one CTA of
h/32 threads) that keeps the whole transform on chip: pass 1 (hermitian
pack + Q-point column FFTs + twiddle) leaves each CTA's 64 KB of columns in
its shared memory, pass 2 reads them across the cluster (distributed shared
memory) and runs the P-point transforms, writing only the rows that cover
the window. One launch per call, no scratch tensor. ``irfft_plan`` holds the
index math; the kernel takes it as it is.
"""

from __future__ import annotations

import ctypes
import functools
from dataclasses import dataclass
from typing import Dict, Tuple

import torch

from avlen_tpu_torch.utils import cuda_build

MIN_FFT_LEN = 1 << 11
MAX_FFT_LEN = 1 << 18
VALUES = 32  # complex64 values per thread, held in registers through each stage
THREADS = 256  # threads of a CTA of a cluster
CTA_ELEMS = THREADS * VALUES  # values per CTA of a cluster: 64 KB of shared memory per pass
# radix stages of an n-point column FFT, by log2 n (n = 32 only in a
# short row's one CTA, whose kernel takes radices 8 and 4)
RADICES = {5: (8, 4), 6: (8, 8), 7: (16, 8), 8: (16, 16), 9: (8, 8, 8)}


@dataclass(frozen=True)
class IrfftPlan:
    """One launch of ``csrc/partial_irfft.cu`` for ``rows`` rows.

    Row-level math: ``h = fft_len/2 = P*Q``, input index ``k = a + P*b``,
    output index ``t = Q*u + v``. A CTA holds ``threads * 32`` values:
    8192 in a cluster of ``h/8192`` CTAs, or the whole row below h = 8192
    (a cluster of one). CTA ``c`` of a row's cluster owns the
    pass-1 columns ``a`` in ``[c*cols1, (c+1)*cols1)`` and the pass-2
    columns ``v`` in ``[c*cols2, (c+1)*cols2)``; pass 2 writes the rows
    ``u`` in ``[u0, u1]``, where ``z[t]`` gives outputs ``2t`` and ``2t+1``.
    """

    fft_len: int
    out_start: int
    out_len: int
    rows: int
    h: int
    P: int
    Q: int
    cluster: int
    cols1: int
    cols2: int
    radices_q: Tuple[int, ...]
    radices_p: Tuple[int, ...]
    u0: int
    u1: int
    log_fine: int  # e^{2 pi i m/N} = fine[m % 2^log_fine] * coarse[m >> log_fine]
    smem_bytes: int
    threads: int
    grid: Tuple[int, int, int]


def _pad(n: int) -> int:
    """Entries of a twiddle table of n values padded one slot per 16."""
    return n + n // 16


@functools.lru_cache(maxsize=64)
def irfft_plan(fft_len: int, out_start: int, out_len: int, rows: int = 1) -> IrfftPlan:
    if not supported(fft_len):
        raise ValueError(
            f"partial_irfft: fft_len {fft_len} must be a power of two in "
            f"[{MIN_FFT_LEN}, {MAX_FFT_LEN}]"
        )
    if not (0 <= out_start and out_len > 0 and out_start + out_len <= fft_len):
        raise ValueError(f"partial_irfft: window [{out_start}, {out_start + out_len}) outside [0, {fft_len})")
    h = fft_len // 2
    logh = h.bit_length() - 1
    log_q = (logh + 1) // 2
    Q = 1 << log_q
    P = h // Q
    elems = min(h, CTA_ELEMS)
    cluster = h // elems
    log_n = logh + 1
    log_fine = (log_n + 1) // 2
    t0 = out_start // 2
    t1 = (out_start + out_len + 1) // 2  # exclusive
    tables = Q + _pad(1 << log_fine) + _pad(fft_len >> log_fine)
    smem = elems * 8 + tables * 8
    return IrfftPlan(
        fft_len=fft_len, out_start=out_start, out_len=out_len, rows=rows, h=h, P=P, Q=Q,
        cluster=cluster, cols1=P // cluster, cols2=Q // cluster,
        radices_q=RADICES[log_q], radices_p=RADICES[logh - log_q],
        u0=t0 // Q, u1=(t1 - 1) // Q, log_fine=log_fine, smem_bytes=smem, threads=elems // VALUES,
        grid=(cluster * rows, 1, 1),
    )


def partial_irfft_plain(spec: torch.Tensor, fft_len: int, out_start: int, out_len: int) -> torch.Tensor:
    """The plain PyTorch version: full inverse transform, then the slice."""
    return torch.fft.irfft(spec, n=fft_len, dim=-1)[..., out_start : out_start + out_len]


def supported(fft_len: int) -> bool:
    return MIN_FFT_LEN <= fft_len <= MAX_FFT_LEN and fft_len & (fft_len - 1) == 0


def partial_irfft(spec: torch.Tensor, fft_len: int, out_start: int, out_len: int) -> torch.Tensor:
    """spec (..., fft_len//2 + 1) complex64 → (..., out_len) f32."""
    if spec.device.type == "cpu":
        return partial_irfft_plain(spec, fft_len, out_start, out_len)
    if spec.device.type != "cuda":
        raise ValueError(f"partial_irfft: unsupported device {spec.device}")
    return _launch(spec, fft_len, out_start, out_len)


partial_irfft.launches = 0


class _CPlan(ctypes.Structure):
    """Mirror of ``struct IrfftPlan`` in csrc/partial_irfft.cu."""

    _fields_ = [(n, ctypes.c_int) for n in (
        "rows", "h", "P", "Q", "cluster", "cols1", "cols2", "nq", "rq0", "rq1", "rq2", "rp0", "rp1",
        "out_start", "out_len", "u0", "u1", "log_fine", "smem_bytes", "threads",
    )]


def _c_plan(plan: IrfftPlan) -> _CPlan:
    rq = plan.radices_q + (0,) * (3 - len(plan.radices_q))
    return _CPlan(plan.rows, plan.h, plan.P, plan.Q, plan.cluster, plan.cols1, plan.cols2,
                  len(plan.radices_q), *rq, *plan.radices_p, plan.out_start, plan.out_len,
                  plan.u0, plan.u1, plan.log_fine, plan.smem_bytes, plan.threads)


_MAX_CLUSTERS: Dict[Tuple[int, int], int] = {}


def max_active_clusters(plan: IrfftPlan) -> int:
    """``cudaOccupancyMaxActiveClusters`` for the plan's cluster size and
    shared memory on the current card. The first call also sets the kernel's
    attributes (dynamic shared memory, non-portable cluster size), once per
    process and CTA size."""
    key = (plan.cluster, plan.smem_bytes, plan.threads)
    if key not in _MAX_CLUSTERS:
        n = _lib().partial_irfft_max_clusters(plan.cluster, plan.smem_bytes, plan.threads)
        if n < 0 and plan.cluster <= 8:  # a portable cluster size: a real fault
            cuda_build.check(-n, "partial_irfft_max_clusters")
        _MAX_CLUSTERS[key] = max(n, 0)  # a refused non-portable size schedules nothing
    return _MAX_CLUSTERS[key]


def _launch(spec: torch.Tensor, fft_len: int, out_start: int, out_len: int) -> torch.Tensor:
    h = fft_len // 2
    if spec.dtype != torch.complex64 or spec.shape[-1] != h + 1:
        raise ValueError(f"partial_irfft: want (..., {h + 1}) complex64, got {tuple(spec.shape)} {spec.dtype}")
    lead = spec.shape[:-1]
    rows = 1
    for n in lead:
        rows *= n
    plan = irfft_plan(fft_len, out_start, out_len, rows)
    if max_active_clusters(plan) < 1:
        raise ValueError(
            f"partial_irfft: fft_len {fft_len} needs a cluster of {plan.cluster} CTAs with "
            f"{plan.smem_bytes} bytes of shared memory each, which this card cannot schedule"
        )
    spec2 = spec.reshape(rows, h + 1).contiguous()
    out = torch.empty((rows, out_len), dtype=torch.float32, device=spec.device)
    rc = _lib().partial_irfft(
        spec2.data_ptr(), out.data_ptr(), ctypes.byref(_c_plan(plan)),
        cuda_build.current_stream(spec.device),
    )
    cuda_build.check(rc, "partial_irfft")
    partial_irfft.launches += 1
    return out.reshape(*lead, out_len)


def _lib():
    lib = cuda_build.load("partial_irfft")
    fn = lib.partial_irfft
    if fn.argtypes is None:
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(_CPlan), ctypes.c_void_p]
        fn.restype = ctypes.c_int
        mc = lib.partial_irfft_max_clusters
        mc.argtypes = [ctypes.c_int, ctypes.c_int, ctypes.c_int]
        mc.restype = ctypes.c_int
    return lib
