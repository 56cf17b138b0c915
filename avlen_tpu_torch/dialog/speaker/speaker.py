"""Speaker service: oracle instruction generation.

Counterpart of ``avlen_tpu/dialog/speaker/speaker.py`` (reference
``Speaker``, ss_baselines/savi/dialog/speaker/tasks/R2R/
speaker_pipeline.py:89-152): ``generate_instr(batch)`` takes {heading,
scene, path} items and returns {'words': [...]} per item; the trainer calls
it only when an agent queries, off the hot path.

Two back ends:

* 'template' (default): the deterministic path→language channel of the
  synthetic world (templates.py);
* 'neural': the Seq2SeqSpeaker (model.py) trained to imitate the templates
  (train_speaker.py), as the reference serves its pretrained R2R speaker.
  ``generate_instr`` decodes a whole batch in one call, on ``device``
  (the card unless the caller asks for the CPU), greedily or with beam
  search.

``path_features`` builds the neural speaker's per-step inputs, with the
optional panorama view features (pano_features.py).
"""

from __future__ import annotations

from typing import Dict, List, Mapping, Optional, Sequence, Union

import numpy as np
import torch

from avlen_tpu_torch.dialog.speaker.pano_features import heading_to_rot_index
from avlen_tpu_torch.dialog.speaker.templates import generate_template_instruction
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary

__all__ = ["GEOM_DIM", "MAX_PATH_LEN", "NUM_CATEGORIES", "Speaker", "heading_to_rot_index"]

MAX_PATH_LEN = 16
GEOM_DIM = 8  # per-step geometry features
NUM_CATEGORIES = 21  # optional goal-category conditioning block


class Speaker:
    def __init__(
        self,
        positions_per_scene: Sequence[np.ndarray],
        backend: str = "template",
        vocab: Optional[Vocabulary] = None,
        neural_params: Optional[Mapping] = None,
        hidden_size: int = 256,
        pano_features=None,
        beam_size: int = 1,
        device: Union[str, torch.device] = "cuda",
    ):
        """``pano_features``: optional (S, N, 4, D) view-feature bank; world
        features then become geometry ⊕ the heading-aligned view feature of
        each traversed node. ``neural_params``: the Flax tree of a trained
        speaker (``{"params": ...}``, as ``speaker.pth`` holds it); without
        it the neural back end starts from a fresh init."""
        if backend not in ("template", "neural"):
            raise ValueError(f"unknown speaker backend {backend!r}")
        self.positions = [np.asarray(p) for p in positions_per_scene]
        self.backend = backend
        self.vocab = vocab or Vocabulary()
        self.pano = np.asarray(pano_features) if pano_features is not None else None
        self.feat_dim = GEOM_DIM + NUM_CATEGORIES + (
            self.pano.shape[-1] if self.pano is not None else 0
        )
        self.beam_size = int(beam_size)
        self.device = torch.device(device)
        self.model = None
        if backend == "neural":
            self._init_neural(neural_params, hidden_size)

    def _init_neural(self, neural_params: Optional[Mapping], hidden_size: int) -> None:
        from avlen_tpu_torch.dialog.speaker.model import Seq2SeqSpeaker
        from avlen_tpu_torch.utils.flax_bridge import load_flax_params

        self.model = Seq2SeqSpeaker(
            vocab_size=len(self.vocab), hidden_size=hidden_size, world_feat_dim=self.feat_dim,
            generator=torch.Generator().manual_seed(0),
        )
        if neural_params is not None:
            load_flax_params(self.model, neural_params)
        self.model.to(self.device).eval()

    def decode(self, acts: np.ndarray, feats: np.ndarray, lens: np.ndarray) -> np.ndarray:
        """(B, 40) int32 word ids of a batch of path features, greedy or
        beam search as configured."""
        t = [torch.as_tensor(x).to(self.device) for x in (acts, feats, lens)]
        v = self.vocab
        if self.beam_size > 1:
            ids = self.model.beam_rollout(*t, v.bos_id, v.eos_id, self.beam_size)
        else:
            ids = self.model.rollout(*t, v.bos_id, v.eos_id)
        return ids.cpu().numpy()

    # ------------------------------------------------------------------
    def path_features(self, scene: int, path: Sequence[int], heading_deg: int,
                      category: Optional[int] = None):
        """Per-step (action ids, world features, length) of a path, the
        neural speaker's inputs: turn-to-face action, step vector, walking
        direction, step index, the goal category one-hot (zeros when None)
        and, with a panorama bank, the view of the node being left."""
        pos = self.positions[scene]
        acts = np.zeros((MAX_PATH_LEN,), np.int32)
        feats = np.zeros((MAX_PATH_LEN, self.feat_dim), np.float32)
        orient = heading_deg % 360
        n = 0
        for a, b in zip(path[:-1], path[1:]):
            if n >= MAX_PATH_LEN:
                break
            p1, p2 = pos[a], pos[b]
            direction = int(np.around(np.rad2deg(np.arctan2(p2[2] - p1[2], p2[0] - p1[0])))) % 360
            delta = (direction - orient) % 360
            acts[n] = {0: 1, 90: 3, 180: 4, 270: 2}.get(delta, 1)  # fwd/left/right/around
            feats[n, :3] = p2 - p1
            feats[n, 3] = np.cos(np.deg2rad(direction))
            feats[n, 4] = np.sin(np.deg2rad(direction))
            feats[n, 5] = n / MAX_PATH_LEN
            if category is not None and 0 <= int(category) < NUM_CATEGORIES:
                feats[n, GEOM_DIM + int(category)] = 1.0
            if self.pano is not None:
                rot = int(heading_to_rot_index(direction))
                feats[n, GEOM_DIM + NUM_CATEGORIES:] = self.pano[scene, a, rot]
            orient = direction
            n += 1
        return acts, feats, max(n, 1)

    def generate_instr(self, batch: List[Dict]) -> List[Dict]:
        """batch items: {'heading': deg, 'scene': int, 'path': [nodes],
        'category': optional int} → [{'words': [...]}] per item; the neural
        back end decodes the batch in one call."""
        if self.backend == "template":
            return [
                {"words": generate_template_instruction(
                    self.positions[item["scene"]], item["path"], int(item["heading"]), item.get("category"))}
                for item in batch
            ]
        acts = np.zeros((len(batch), MAX_PATH_LEN), np.int32)
        feats = np.zeros((len(batch), MAX_PATH_LEN, self.feat_dim), np.float32)
        lens = np.zeros((len(batch),), np.int32)
        for i, item in enumerate(batch):
            acts[i], feats[i], lens[i] = self.path_features(
                item["scene"], item["path"], int(item["heading"]), item.get("category"))
        return [{"words": self.vocab.decode(row)} for row in self.decode(acts, feats, lens)]

    def instruction_text(self, batch: List[Dict]) -> List[str]:
        return [" ".join(o["words"]) for o in self.generate_instr(batch)]
