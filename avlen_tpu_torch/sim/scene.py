"""Scene asset bank: stacked device tables + frames + sounds + RIR provider.

PyTorch counterpart of ``avlen_tpu/sim/scene.py``. Every table is a tensor
on the bank's device and shared by all env slots. The RIRs come from a
provider with ``gather`` (B indices → (B, L, 2) time-domain RIRs) and
``length``:

* ``DenseRIRBank``: the full (S, 4, N, N, L, 2) tensor of measured RIRs
  (reference data small enough to hold on the device);
* ``data.reference.HostRIRStore``: measured RIRs read per step from a
  memory-mapped host file;
* ``ProceduralRIRBank``: direct-path impulses (distance delay, interaural
  level and time differences) plus one of ``num_tails`` exponentially
  decaying noise tails, served either in the time domain (``gather``) or
  directly as the spectra at the convolution length (``gather_fft``), which
  equal ``rfft(gather(...))`` without a per-step transform.

A provider without ``tail_fft`` takes the time-domain audio path: the RIR's
rFFT is computed every step before the partial irfft.

The tails are drawn from a ``torch.Generator`` seeded with ``seed``; the JAX
package draws them from ``jax.random``, so the two packages' tails differ.
Tests carry the JAX tables across (``utils/flax_bridge.scene_bank_from_jax``).
"""

from __future__ import annotations

import dataclasses
import math
from typing import Dict, Optional

import numpy as np
import torch

SPEED_OF_SOUND = 343.0


class DenseRIRBank:
    """Tensor of binaural RIRs indexed (scene, azimuth, receiver, source)."""

    def __init__(self, rirs: torch.Tensor):
        if rirs.ndim != 6 or rirs.shape[1] != 4 or rirs.shape[-1] != 2:
            raise ValueError(f"RIR bank must be (S, 4, N, N, L, 2), got {tuple(rirs.shape)}")
        self.rirs = rirs

    @property
    def length(self) -> int:
        return self.rirs.shape[4]

    @property
    def device(self) -> torch.device:
        return self.rirs.device

    def gather(self, scene, az_idx, recv, src) -> torch.Tensor:
        """(B,) indices → (B, L, 2) time-domain RIRs."""
        return self.rirs[scene, az_idx, recv, src]


def serves_spectra(rir) -> bool:
    """Whether the RIR provider serves spectra at the convolution length
    (``gather_fft``); the others take the time-domain audio path."""
    return getattr(rir, "tail_fft", None) is not None


@dataclasses.dataclass
class ProceduralRIRBank:
    """Deterministic RIR synthesis from scene geometry (see module doc)."""

    positions: torch.Tensor  # (S, N, 3)
    length: int
    sampling_rate: int
    seed: int = 0
    tail_scale: float = 0.05
    tail_tau_s: float = 0.15
    num_tails: int = 64
    tail_noise: Optional[torch.Tensor] = None  # (P, L, 2) envelope-weighted tails
    tail_fft: Optional[torch.Tensor] = None  # (4, P, F) planes re_l/re_r/im_l/im_r
    itd_phase: Optional[torch.Tensor] = None  # (2, itd_cap+1, F) re/im phase ramps

    @property
    def delay_cap(self) -> int:
        return min(self.length // 4, 4096)

    @property
    def itd_cap(self) -> int:
        return int(0.0008 * self.sampling_rate) + 1

    @property
    def fft_len(self) -> int:
        from avlen_tpu_torch.ops.audio import conv_fft_len

        return conv_fft_len(self.sampling_rate, self.length)

    @property
    def device(self) -> torch.device:
        return self.positions.device

    def ensure_tables(self) -> "ProceduralRIRBank":
        """Populate the tail and phase tables (idempotent)."""
        if self.tail_fft is not None:
            return self
        n = self.fft_len
        support = self.length - self.delay_cap
        tau = self.tail_tau_s * self.sampling_rate
        gen = torch.Generator(device="cpu").manual_seed(self.seed)
        noise = torch.randn((self.num_tails, self.length, 2), generator=gen).to(self.device)
        j = torch.arange(self.length, device=self.device, dtype=torch.float32)[None, :, None]
        env = torch.exp(-j / tau) * (j < support)
        self.tail_noise = noise * env  # (P, L, 2)
        self.tail_fft, self.itd_phase = _spectral_tables(self.tail_noise, n, self.itd_cap)
        return self

    def _geometry(self, scene, az_idx, recv, src):
        """Shared per-pair acoustics: gains, amplitude, delays, tail id/jitter."""
        pos = self.positions
        p_r = pos[scene, recv]  # (B, 3)
        p_s = pos[scene, src]
        d = p_s - p_r
        dist = torch.sqrt(torch.sum(d * d, dim=-1) + 1e-6)

        # agent heading from azimuth index: rotation = (4 - az) % 4 * 90 deg
        rot = ((4 - az_idx) % 4).float() * (math.pi / 2)
        fwd_x, fwd_z = -torch.sin(rot), -torch.cos(rot)
        inv = 1.0 / torch.clamp(dist, min=1e-3)
        cos_rel = (fwd_x * d[:, 0] + fwd_z * d[:, 2]) * inv
        sin_rel = (fwd_x * d[:, 2] - fwd_z * d[:, 0]) * inv

        g_l = 0.6 + 0.35 * sin_rel + 0.05 * cos_rel
        g_r = 0.6 - 0.35 * sin_rel + 0.05 * cos_rel
        amp = 1.0 / torch.clamp(dist, min=0.3)
        delay = torch.clamp(
            (dist / SPEED_OF_SOUND * self.sampling_rate).to(torch.int64), 0, self.delay_cap
        )
        itd = torch.clamp(
            (sin_rel * 0.0008 * self.sampling_rate).to(torch.int64),
            -self.itd_cap, self.itd_cap,
        )  # ±~0.8 ms

        # uint32 hash arithmetic, carried in int64 and wrapped explicitly
        mask = 0xFFFFFFFF
        pair_id = (scene.long() * 1_000_003 + recv.long() * 1009 + src.long()) & mask
        tail_id = pair_id % self.num_tails
        h = (pair_id * 2654435761) & mask
        jitter = 0.75 + 0.5 * (h.float() / float(2**32))
        return g_l, g_r, amp, delay, itd, tail_id, jitter

    def gather(self, scene, az_idx, recv, src):
        """(B,) indices → (B, L, 2) time-domain RIRs."""
        if self.tail_noise is None:
            raise RuntimeError("call ensure_tables() after construction")
        g_l, g_r, amp, delay, itd, tail_id, jitter = self._geometry(scene, az_idx, recv, src)
        k = torch.arange(self.length, device=self.device)[None, :]  # (1, L)
        direct_l = (k == (delay + torch.clamp(-itd, min=0))[:, None]).float()
        direct_r = (k == (delay + torch.clamp(itd, min=0))[:, None]).float()

        base = self.tail_noise[tail_id]  # (B, L, 2)
        j = k - delay[:, None]  # (B, L)
        idx = torch.clamp(j, 0, self.length - 1)[..., None].expand(-1, -1, 2)
        shifted = torch.gather(base, 1, idx) * (j >= 0)[..., None]
        rir = shifted * (jitter * self.tail_scale * amp)[:, None, None]
        direct = torch.stack(
            [direct_l * (amp * g_l)[:, None], direct_r * (amp * g_r)[:, None]], dim=-1
        )
        return rir + direct

    def gather_fft(self, scene, az_idx, recv, src):
        """(B,) indices → (B, 2, F) complex64 == rfft(gather(...), fft_len)
        per channel, channel-major."""
        if self.tail_fft is None:
            raise RuntimeError("call ensure_tables() after construction")
        g_l, g_r, amp, delay, itd, tail_id, jitter = self._geometry(scene, az_idx, recv, src)
        n = self.fft_len
        f = torch.arange(n // 2 + 1, device=self.device, dtype=torch.int64)[None, :]
        ang = -2.0 * math.pi * ((delay[:, None] * f) % n).float() / n
        ph = torch.complex(torch.cos(ang), torch.sin(ang))  # (B, F) e^{-iω·delay}
        itd_l = torch.clamp(-itd, min=0)
        itd_r = torch.clamp(itd, min=0)
        iph = self.itd_phase
        ph_l = ph * torch.complex(iph[0, itd_l], iph[1, itd_l])
        ph_r = ph * torch.complex(iph[0, itd_r], iph[1, itd_r])
        tf = self.tail_fft  # (4, P, F)
        t_l = torch.complex(tf[0, tail_id], tf[2, tail_id])
        t_r = torch.complex(tf[1, tail_id], tf[3, tail_id])
        mod = ph * (jitter * self.tail_scale * amp)[:, None]
        rir_l = t_l * mod + (amp * g_l)[:, None] * ph_l
        rir_r = t_r * mod + (amp * g_r)[:, None] * ph_r
        return torch.stack([rir_l, rir_r], dim=1)  # (B, 2, F)


def _spectral_tables(tails: torch.Tensor, n: int, itd_cap: int):
    """(4, P, F) tail spectra planes and (2, itd_cap+1, F) ITD phase ramps."""
    tfft = torch.fft.rfft(tails.transpose(1, 2), n=n, dim=-1)  # (P, 2, F)
    re, im = tfft.real, tfft.imag
    tail_fft = torch.stack([re[:, 0], re[:, 1], im[:, 0], im[:, 1]]).float().contiguous()
    offs = torch.arange(itd_cap + 1, device=tails.device, dtype=torch.int64)[:, None]
    f = torch.arange(n // 2 + 1, device=tails.device, dtype=torch.int64)[None, :]
    ang = -2.0 * math.pi * ((offs * f) % n).float() / n
    itd_phase = torch.stack([torch.cos(ang), torch.sin(ang)]).contiguous()
    return tail_fft, itd_phase


@dataclasses.dataclass
class SceneBank:
    """All device-resident assets for a set of scenes."""

    tables: Dict[str, torch.Tensor]  # positions/fwd_next/hops/oracle_next/num_nodes
    sounds_padded: torch.Tensor  # (K, L-1 + S_max) with L-1 leading zeros
    sound_secs: torch.Tensor  # (K,)
    rir: object  # a provider with gather/length (module doc)
    rgb: Optional[torch.Tensor] = None  # (S, N, 4, H, W, 3) uint8
    depth: Optional[torch.Tensor] = None  # (S, N, 4, H, W, 1) f32
    semantic: Optional[torch.Tensor] = None  # (S, N, 4, H, W) int32 instance ids
    semantic_instance_to_mp3d: Optional[torch.Tensor] = None  # (S, I) int32
    grid_size: float = 1.0
    sampling_rate: int = 16000
    num_categories: int = 21
    # (K, S_secs, F) complex64 per-(sound, second) segment rFFTs
    sound_fft_bank: Optional[torch.Tensor] = None
    # (S, K, 4, N, N, F', T', 2) bf16 precomputed spectrograms
    spec_bank: Optional[torch.Tensor] = None

    @property
    def num_scenes(self) -> int:
        return self.tables["positions"].shape[0]

    @property
    def max_nodes(self) -> int:
        return self.tables["positions"].shape[1]

    @property
    def device(self) -> torch.device:
        return self.tables["positions"].device


@torch.no_grad()
def precompute_spectrogram_bank(
    bank: SceneBank,
    batch: int = 256,
    dtype=torch.bfloat16,
    max_bytes: int = 4 << 30,
) -> Optional[torch.Tensor]:
    """Render every (scene, sound, azimuth, receiver, source) spectrogram once.

    Returns the (S, K, 4, N, N, F', T', 2) bank, or None when the sounds are
    not all 1-second or the bank would exceed ``max_bytes``.
    """
    from avlen_tpu_torch.ops.audio import SpectrogramConfig, render_audiogoal

    secs = bank.sound_secs.cpu().numpy()
    if not (secs == 1).all():
        return None
    s = bank.num_scenes
    n = bank.max_nodes
    k = int(bank.sounds_padded.shape[0])
    cfg = SpectrogramConfig(sampling_rate=bank.sampling_rate)
    f, t, _ = cfg.out_shape
    total = s * k * 4 * n * n * f * t * 2 * torch.finfo(dtype).bits // 8
    if total > max_bytes:
        return None

    idx = np.stack(
        np.meshgrid(
            np.arange(s), np.arange(k), np.arange(4), np.arange(n), np.arange(n), indexing="ij"
        ),
        axis=-1,
    ).reshape(-1, 5)
    idx = torch.as_tensor(idx, device=bank.device)
    use_fft = serves_spectra(bank.rir)
    chunks = []
    for i in range(0, idx.shape[0], batch):
        scene, sound, az, recv, src = idx[i : i + batch].unbind(-1)
        if use_fft:  # the analytic spectra, as the live env takes them
            kw = dict(rir=None, rir_f=bank.rir.gather_fft(scene, az, recv, src), rir_len=bank.rir.length)
        else:
            kw = dict(rir=bank.rir.gather(scene, az, recv, src))
        _, spec = render_audiogoal(
            bank.sounds_padded[sound],
            torch.zeros_like(sound),
            active=torch.ones(sound.shape, dtype=torch.bool, device=bank.device),
            sampling_rate=bank.sampling_rate,
            config=cfg,
            **kw,
        )
        chunks.append(spec.to(dtype))
    return torch.cat(chunks, dim=0).reshape(s, k, 4, n, n, f, t, 2)


@torch.no_grad()
def precompute_sound_fft_bank(bank: SceneBank) -> torch.Tensor:
    """(K, S_max, F) complex64 rFFTs of every (sound, second) convolution
    segment, by the same segment gather + rFFT the per-step path uses."""
    from avlen_tpu_torch.ops.audio import conv_fft_len

    sr = bank.sampling_rate
    l = bank.rir.length
    seg_len = sr + l - 1
    fft_len = conv_fft_len(sr, l)
    k = int(bank.sounds_padded.shape[0])
    s_max = int(bank.sound_secs.max())
    dev = bank.device
    starts = (torch.arange(s_max, device=dev) * sr)[None, :, None]  # (1, S, 1)
    idx = starts + torch.arange(seg_len, device=dev)[None, None, :]
    idx = torch.clamp(idx, 0, bank.sounds_padded.shape[-1] - 1).expand(k, s_max, seg_len)
    segs = torch.gather(bank.sounds_padded[:, None, :].expand(k, s_max, -1), -1, idx)
    return torch.fft.rfft(segs.float(), n=fft_len, dim=-1)


def pad_sounds(sounds: "list[np.ndarray]", rir_length: int, sampling_rate: int) -> "tuple[np.ndarray, np.ndarray]":
    """Pad mono sounds with rir_length-1 leading zeros to a common length."""
    secs = np.array([max(1, s.shape[0] // sampling_rate) for s in sounds], np.int32)
    s_max = int(max(s.shape[0] for s in sounds))
    out = np.zeros((len(sounds), rir_length - 1 + s_max), np.float32)
    for i, s in enumerate(sounds):
        out[i, rir_length - 1 : rir_length - 1 + s.shape[0]] = s
    return out, secs
