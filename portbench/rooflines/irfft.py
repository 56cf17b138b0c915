"""Work of one launch of the partial inverse real FFT (``csrc/partial_irfft.cu``).

Operations: one inverse real FFT of ``fft_len`` points a row, 2.5·N·log2 N
(half the 5·N·log2 N of a complex one), though the kernel writes only the
valid window. Bytes: the (fft_len/2 + 1) complex64 input read once, the
``out_len`` float32 outputs written once. Bytes bound it.
"""

import math

MODULE = "avlen_tpu_torch.ops.irfft_cuda"  # its ``_launch`` is recorded
PATTERNS = ("irfft",)
PEAK = "fp32"
BOUND = "bytes"


def shapes(spec, fft_len, out_start, out_len):
    """``work``'s arguments from one call of the module's ``_launch``."""
    return dict(rows=spec.numel() // spec.shape[-1], fft_len=fft_len, out_len=out_len)


def work(rows, fft_len, out_len):
    flops = rows * 2.5 * fft_len * math.log2(fft_len)
    nbytes = rows * ((fft_len // 2 + 1) * 8 + out_len * 4)
    return flops, nbytes
