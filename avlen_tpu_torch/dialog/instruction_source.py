"""Oracle-instruction sources for the interactive rollout.

PyTorch counterpart of ``avlen_tpu/dialog/instruction_source.py``. The
reference runs a pretrained speaker on every query
(ss_baselines/savi/ppo/ppo_trainer.py:549-562 → speaker_pipeline.py:110-124)
and tokenizes its text with CLIP (ppo_trainer.py:560-561). Two sources:

* **bank**: the whole (S, N, 4, N, 77) token tensor built at setup
  (``instruction_bank.py``); a query is one device gather. O(S·N²·4·77), so
  for small worlds only.
* **callback**: ``HostSpeakerInstructionSource``, the speaker called on the
  host for the envs whose query starts this step, every answer memoized.
  The port's rollout is an eager loop, so this is a plain host call (the
  JAX package needs ``io_callback`` inside its scan).

``resolve_instruction_source`` chooses from SPEAKER.BANK_MODE (auto, bank,
callback, cached) and SPEAKER.MAX_BANK_NODES. The JAX package serves
``cached`` through a chunked prefetch cache of the host speaker's tokens,
for backends without host callbacks, and only where its env has a host
prefetcher (``has_host_prefetcher``); the cache is a transport, its tokens
are the host speaker's. The port's eager rollout calls the host speaker
directly, so ``cached`` is the callback source there, and raises JAX's
error elsewhere. ``speaker_from_config`` serves the template or the neural
speaker (SPEAKER.BACKEND, SPEAKER.CKPT_PATH), with the panorama features
under SPEAKER.USE_PANO_FEATURES.
"""

from __future__ import annotations

import os
from typing import List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlen_tpu_torch.dialog.instruction_bank import APP_PATH_LEN, build_instruction_bank, shortest_path_prefix
from avlen_tpu_torch.dialog.speaker.speaker import GEOM_DIM, NUM_CATEGORIES, Speaker
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
from avlen_tpu_torch.models.clip_text import CONTEXT_LENGTH, tokenize
from avlen_tpu_torch.utils import profiling
from avlen_tpu_torch.utils.logging import logger


def speaker_from_config(cfg, tables_list, rgb_bank=None, device: Union[str, torch.device] = "cuda") -> Speaker:
    """The Speaker of the instruction channel, from SPEAKER (the reference
    always serves its pretrained neural speaker, speaker_pipeline.py:27).

    BACKEND template or neural; a neural speaker's weights, vocabulary,
    hidden size and word-embedding width come from the ``speaker.pth`` at
    CKPT_PATH (either package's ``train_speaker`` output; FileNotFoundError
    when it is missing), and its ``world_feat_dim`` must match
    USE_PANO_FEATURES.
    USE_PANO_FEATURES encodes ``rgb_bank`` with a PanoramaEncoder (a fresh
    init, seeded 0, as the JAX package draws its own each call). The
    speaker and the encoder run on ``device``."""
    sp_cfg = cfg.SPEAKER
    positions = [t.positions for t in tables_list]

    pano = None
    if sp_cfg.USE_PANO_FEATURES:
        if rgb_bank is None:
            raise ValueError("SPEAKER.USE_PANO_FEATURES requires an RGB frame bank to encode")
        from avlen_tpu_torch.dialog.speaker.pano_features import PanoramaEncoder, precompute_panorama_features

        bank = rgb_bank.cpu().numpy() if isinstance(rgb_bank, torch.Tensor) else np.asarray(rgb_bank)
        encoder = PanoramaEncoder(bank.shape[-1], generator=torch.Generator().manual_seed(0))
        pano = precompute_panorama_features(bank, encoder, device=device)

    if sp_cfg.BACKEND == "template":
        return Speaker(positions, backend="template", pano_features=pano, device=device)

    vocab = Vocabulary()
    neural_params = None
    hidden, word_emb = 256, 128
    if sp_cfg.CKPT_PATH:
        if not os.path.exists(sp_cfg.CKPT_PATH):
            raise FileNotFoundError(f"speaker checkpoint not found: {sp_cfg.CKPT_PATH}")
        from avlen_tpu_torch.utils.checkpoint import load_checkpoint

        ckpt = load_checkpoint(sp_cfg.CKPT_PATH)
        raw = ckpt["vocab"]
        if isinstance(raw, dict):  # msgpack round-trips lists as {'0': ...}
            raw = [raw[k] for k in sorted(raw, key=int)]
        vocab = Vocabulary.from_words([w.decode() if isinstance(w, bytes) else str(w) for w in raw])
        neural_params = ckpt["state_dict"]
        hidden = int(ckpt.get("hidden_size", 256))
        word_emb = int(ckpt.get("word_emb", 128))
        want_feat = GEOM_DIM + NUM_CATEGORIES + (pano.shape[-1] if pano is not None else 0)
        have_feat = int(ckpt.get("world_feat_dim", want_feat))
        if have_feat != want_feat:
            raise ValueError(
                f"speaker checkpoint world_feat_dim={have_feat} does not match the "
                f"configured feature layout ({want_feat}); check SPEAKER.USE_PANO_FEATURES"
            )
    return Speaker(positions, backend="neural", vocab=vocab, neural_params=neural_params,
                   hidden_size=hidden, pano_features=pano, device=device, word_emb=word_emb)


class HostSpeakerInstructionSource:
    """The speaker per query, on the host (reference: on-demand
    Speaker.generate_instr, speaker_pipeline.py:110-124).

    Called with the whole env batch: only envs whose ``newly`` flag is set
    are computed, and every (scene, node, rot, goal) is memoized, so the
    host work falls to near zero. Each decode opens the span
    ``speaker.decode``; the counters ``speaker.queries``,
    ``speaker.cache_hits`` and ``speaker.decodes`` count the envs asked,
    those answered from the memo and the speaker's decodes (``host_calls``
    counts the steps on which some env asked)."""

    def __init__(self, speaker: Speaker, tables_list: Sequence, context_length: int = CONTEXT_LENGTH):
        self.speaker = speaker
        self.tables = list(tables_list)
        self.context_length = context_length
        self._cache = {}
        self._stop_tokens = tokenize(["stop here"])[0].astype(np.int32)
        self.host_calls = 0  # steps on which some query started

    def _lookup(self, s: int, n: int, r: int, g: int) -> np.ndarray:
        key = (s, n, r, g)
        hit = self._cache.get(key)
        if hit is not None:
            profiling.count("speaker.cache_hits")
            return hit
        path = shortest_path_prefix(self.tables[s], n, g, max_len=APP_PATH_LEN + 1)
        if len(path) < 2:
            toks = self._stop_tokens
        else:
            heading = (270 - r * 90) % 360
            with profiling.span("speaker.decode"):
                text = self.speaker.instruction_text([{"heading": heading, "scene": s, "path": path}])[0]
            profiling.count("speaker.decodes")
            toks = tokenize([text], context_length=self.context_length)[0].astype(np.int32)
        self._cache[key] = toks
        return toks

    def host_tokens(self, scene, node, rot, goal, newly) -> np.ndarray:
        """(B, 77) int32: the instruction of each env whose query starts, zeros elsewhere."""
        scene, node, rot, goal, newly = (np.asarray(x) for x in (scene, node, rot, goal, newly))
        out = np.zeros((newly.shape[0], self.context_length), np.int32)
        idx = np.nonzero(newly)[0]
        if idx.size:
            self.host_calls += 1
            profiling.count("speaker.queries", int(idx.size))
            for i in idx:
                out[i] = self._lookup(int(scene[i]), int(node[i]), int(rot[i]), int(goal[i]))
        return out

    def __call__(self, env_state, newly: torch.Tensor) -> torch.Tensor:
        host = [t.cpu().numpy() for t in (env_state.scene, env_state.node, env_state.rot,
                                          env_state.goal_node, newly)]
        return torch.from_numpy(self.host_tokens(*host)).to(newly.device)


def has_host_prefetcher(cfg, env) -> bool:
    """Whether the JAX package's builder would give ``env`` its host RIR
    prefetcher (``avlen_tpu/sim/builder.py:303-320``), the condition under
    which its trainer allows BANK_MODE cached: RIRs served from the host
    store, and TPU.HOST_PREFETCH on (auto engages it only on a backend
    without host callbacks, and CUDA has them)."""
    from avlen_tpu_torch.data.reference import HostRIRStore

    return isinstance(env.bank.rir, HostRIRStore) and cfg.TPU.HOST_PREFETCH == "on"


def resolve_instruction_source(cfg, tables_list, rgb_bank=None, device: Union[str, torch.device] = "cuda",
                               allow_cached: bool = False) -> Tuple[Optional[np.ndarray], Optional[object]]:
    """(bank, source): exactly one is not None. BANK_MODE auto banks worlds
    whose scenes all have at most MAX_BANK_NODES nodes and calls the host
    speaker otherwise; bank and callback force one; cached, allowed only
    with ``allow_cached`` (``has_host_prefetcher``), calls the host speaker
    (the tokens of JAX's prefetch cache). The speaker runs on ``device``."""
    mode = cfg.SPEAKER.BANK_MODE
    if mode == "cached" and not allow_cached:
        raise RuntimeError(
            "SPEAKER.BANK_MODE 'cached' serves instructions through the "
            "chunked-rollout prefetch cache, which only chunk-aware trainers "
            "on the host-prefetch audio path provide (TPU.HOST_PREFETCH + "
            "savi/ddppo trainers). Use bank/callback/auto here."
        )
    speaker = speaker_from_config(cfg, tables_list, rgb_bank=rgb_bank, device=device)
    n_max = max(t.num_nodes for t in tables_list)
    if mode == "auto":
        mode = "bank" if n_max <= cfg.SPEAKER.MAX_BANK_NODES else "callback"
    if mode == "bank":
        return build_instruction_bank(speaker, tables_list), None
    if mode not in ("callback", "cached"):
        raise ValueError(f"unknown SPEAKER.BANK_MODE {cfg.SPEAKER.BANK_MODE!r}")
    logger.info(f"instructions from the host speaker per query (N={n_max}, MAX_BANK_NODES="
                f"{cfg.SPEAKER.MAX_BANK_NODES}, BANK_MODE {cfg.SPEAKER.BANK_MODE})")
    return None, HostSpeakerInstructionSource(speaker, tables_list)


def sub_instr_token_bank(episodes: Sequence, context_length: int = CONTEXT_LENGTH) -> Optional[np.ndarray]:
    """(E, 77) CLIP-token bank of the episodes' dataset instructions
    (``sub_instr``, tokenized once; ppo_trainer.py:354-369); an episode
    without one has an all-zero row. None when no episode has one."""
    texts: List[str] = []
    any_instr = False
    for ep in episodes:
        s = getattr(ep, "sub_instr", None)
        texts.append(s or "")
        any_instr = any_instr or bool(s)
    if not any_instr:
        return None
    out = np.zeros((len(texts), context_length), np.int32)
    for i, s in enumerate(texts):
        if s:
            out[i] = tokenize([s], context_length=context_length)[0]
    return out
