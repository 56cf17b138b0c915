"""Speaker service: oracle instruction generation.

Counterpart of ``avlen_tpu/dialog/speaker/speaker.py`` (reference
``Speaker``, ss_baselines/savi/dialog/speaker/tasks/R2R/
speaker_pipeline.py:89-152): ``generate_instr(batch)`` takes {heading,
scene, path} items and returns {'words': [...]} per item; the trainer calls
it only when an agent queries, off the hot path.

The template back end (templates.py) is ported: the deterministic
path→language channel of the synthetic world. The neural back end (the
Seq2Seq speaker trained to imitate the templates) is ROADMAP item 6 and
raises here. ``path_features`` (the neural speaker's per-step inputs) is
ported, with the optional panorama view features.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence

import numpy as np

from avlen_tpu_torch.dialog.speaker.templates import generate_template_instruction
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary

MAX_PATH_LEN = 16
GEOM_DIM = 8  # per-step geometry features
NUM_CATEGORIES = 21  # optional goal-category conditioning block

NEURAL_SPEAKER_LATER = (
    "the neural speaker (SPEAKER.BACKEND neural) is not ported yet (ROADMAP item 6); "
    "use SPEAKER.BACKEND template"
)


def heading_to_rot_index(heading_deg) -> np.ndarray:
    """Nearest frame-bank rotation index for a heading in degrees (rot r
    faces (270 - 90 r) % 360; ``avlen_tpu/dialog/speaker/pano_features.py``)."""
    h = np.asarray(heading_deg, np.float64)
    return (np.rint((270.0 - h) / 90.0).astype(np.int64) % 4).astype(np.int32)


class Speaker:
    def __init__(
        self,
        positions_per_scene: Sequence[np.ndarray],
        backend: str = "template",
        vocab: Optional[Vocabulary] = None,
        pano_features=None,
    ):
        """``pano_features``: optional (S, N, 4, D) view-feature bank; world
        features then become geometry ⊕ the heading-aligned view feature of
        each traversed node."""
        if backend == "neural":
            raise NotImplementedError(NEURAL_SPEAKER_LATER)
        if backend != "template":
            raise ValueError(f"unknown speaker backend {backend!r}")
        self.positions = [np.asarray(p) for p in positions_per_scene]
        self.backend = backend
        self.vocab = vocab or Vocabulary()
        self.pano = np.asarray(pano_features) if pano_features is not None else None
        self.feat_dim = GEOM_DIM + NUM_CATEGORIES + (
            self.pano.shape[-1] if self.pano is not None else 0
        )

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
        'category': optional int} → [{'words': [...]}] per item."""
        return [
            {"words": generate_template_instruction(
                self.positions[item["scene"]], item["path"], int(item["heading"]), item.get("category"))}
            for item in batch
        ]

    def instruction_text(self, batch: List[Dict]) -> List[str]:
        return [" ".join(o["words"]) for o in self.generate_instr(batch)]
