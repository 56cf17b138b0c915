"""Ops of the port. The hand-written CUDA kernels are ``KERNELS``: by the
name of its wrapper, each kernel's module, which launches the kernel
through its module-level ``_launch`` and counts every launch on the
wrapper's ``.launches``."""

from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

KERNELS = {"smt_encode": smt_cuda, "partial_irfft": irfft_cuda, "spectrogram": spectrogram_cuda}
