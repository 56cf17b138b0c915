"""Work of one launch of the log-mean-pooled spectrogram (``csrc/spectrogram.cu``).

Operations: one n_fft-point complex FFT (5·N·log2 N) per frame carrying both
ears, the least transform work for two real frames. Bytes: the binaural
audio, the window and the twiddles read once, the pooled output written
once. At the rollout's 32 envs neither bound is near the kernel's time.
"""

import math

MODULE = "avlen_tpu_torch.ops.spectrogram_cuda"  # its ``_launch`` is recorded
PATTERNS = ("spectrogram",)
PEAK = "fp32"
BOUND = "bytes"


def shapes(audio, config):
    """``work``'s arguments from one call of the module's ``_launch``."""
    return dict(batch=audio.shape[0], samples=audio.shape[2], n_fft=config.n_fft, hop=config.hop_length,
                block=list(config.block))


def work(batch, samples, n_fft, hop, block):
    frames = 1 + samples // hop
    fprime = -(-(n_fft // 2 + 1) // block[0])
    tprime = -(-frames // block[1])
    flops = batch * frames * 5 * n_fft * math.log2(n_fft)
    nbytes = 4 * (batch * 2 * samples + 3 * n_fft + batch * fprime * tprime * 2)
    return flops, nbytes
