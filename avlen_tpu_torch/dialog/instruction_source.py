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
callback) and SPEAKER.MAX_BANK_NODES. The JAX package's ``cached`` mode (the
chunked prefetch for backends without host callbacks) is ROADMAP item 9.
"""

from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from avlen_tpu_torch.dialog.instruction_bank import APP_PATH_LEN, build_instruction_bank, shortest_path_prefix
from avlen_tpu_torch.dialog.speaker.speaker import NEURAL_SPEAKER_LATER, Speaker
from avlen_tpu_torch.models.clip_text import CONTEXT_LENGTH, tokenize
from avlen_tpu_torch.utils.logging import logger


def speaker_from_config(cfg, tables_list, rgb_bank=None) -> Speaker:
    """The Speaker of the instruction channel, from SPEAKER: the template
    back end; the neural one and the panorama features are ROADMAP item 6."""
    sp_cfg = cfg.SPEAKER
    if sp_cfg.USE_PANO_FEATURES:
        raise NotImplementedError(
            "SPEAKER.USE_PANO_FEATURES: the panorama feature encoder is not ported yet (ROADMAP item 6)")
    if sp_cfg.BACKEND != "template":
        raise NotImplementedError(NEURAL_SPEAKER_LATER)
    return Speaker([t.positions for t in tables_list], backend="template")


class HostSpeakerInstructionSource:
    """The speaker per query, on the host (reference: on-demand
    Speaker.generate_instr, speaker_pipeline.py:110-124).

    Called once a step with the whole env batch: only envs whose ``newly``
    flag is set are computed, and every (scene, node, rot, goal) is
    memoized, so the host work falls to near zero."""

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
            return hit
        path = shortest_path_prefix(self.tables[s], n, g, max_len=APP_PATH_LEN + 1)
        if len(path) < 2:
            toks = self._stop_tokens
        else:
            heading = (270 - r * 90) % 360
            text = self.speaker.instruction_text([{"heading": heading, "scene": s, "path": path}])[0]
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
            for i in idx:
                out[i] = self._lookup(int(scene[i]), int(node[i]), int(rot[i]), int(goal[i]))
        return out

    def __call__(self, env_state, newly: torch.Tensor) -> torch.Tensor:
        host = [t.cpu().numpy() for t in (env_state.scene, env_state.node, env_state.rot,
                                          env_state.goal_node, newly)]
        return torch.from_numpy(self.host_tokens(*host)).to(newly.device)


def resolve_instruction_source(cfg, tables_list, rgb_bank=None) -> Tuple[Optional[np.ndarray], Optional[object]]:
    """(bank, source): exactly one is not None. BANK_MODE auto banks worlds
    whose scenes all have at most MAX_BANK_NODES nodes and calls the host
    speaker otherwise; bank and callback force one."""
    speaker = speaker_from_config(cfg, tables_list, rgb_bank=rgb_bank)
    mode = cfg.SPEAKER.BANK_MODE
    n_max = max(t.num_nodes for t in tables_list)
    if mode == "cached":
        raise NotImplementedError(
            "SPEAKER.BANK_MODE 'cached': the chunked instruction prefetch is not ported "
            "(ROADMAP item 9); the port's eager rollout calls the host speaker directly "
            "(BANK_MODE callback)")
    if mode == "auto":
        mode = "bank" if n_max <= cfg.SPEAKER.MAX_BANK_NODES else "callback"
    if mode == "bank":
        return build_instruction_bank(speaker, tables_list), None
    if mode != "callback":
        raise ValueError(f"unknown SPEAKER.BANK_MODE {cfg.SPEAKER.BANK_MODE!r}")
    logger.info(f"instructions from the host speaker per query (N={n_max} > "
                f"MAX_BANK_NODES={cfg.SPEAKER.MAX_BANK_NODES} or BANK_MODE callback)")
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
