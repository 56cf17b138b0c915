"""Template instruction synthesis from graph paths.

A copy of ``avlen_tpu/dialog/speaker/templates.py`` (numpy only).

The reference's oracle instructions come from a pretrained R2R speaker over
Matterport panoramas (speaker_pipeline.py:110-124). In this framework's
closed synthetic world, deterministic template instructions generated from
the shortest-path geometry provide the ground-truth language channel: they
describe the turn/forward structure of the path the same way the R2R data
does ("turn left, go forward three steps, then turn right ..."), optionally
naming the goal category landmark. The neural speaker (model.py) is trained
to reproduce these from path features, mirroring the reference's
teacher-forced speaker training (train_speaker.py).
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import numpy as np

from avlen_tpu_torch.dialog.speaker.vocab import CATEGORY_WORDS

NUM_WORDS = ["zero", "one", "two", "three", "four", "five", "six", "seven", "eight", "nine"]


def path_to_motions(positions: np.ndarray, path: Sequence[int], start_heading_deg: int) -> List[str]:
    """Convert a node path into atomic motions: 'left'/'right'/'around'/'forward'.

    Mirrors the oracle action construction (soundspaces/simulator.py:758-787):
    orientation starts at the agent's heading; each edge contributes turns to
    face the edge direction plus one forward step.
    """
    motions: List[str] = []
    orient = start_heading_deg % 360
    for a, b in zip(path[:-1], path[1:]):
        p1, p2 = positions[a], positions[b]
        direction = int(np.around(np.rad2deg(np.arctan2(p2[2] - p1[2], p2[0] - p1[0])))) % 360
        delta = (direction - orient) % 360
        if delta == 270:
            motions.append("left")
        elif delta == 90:
            motions.append("right")
        elif delta == 180:
            motions.append("around")
        orient = direction
        motions.append("forward")
    return motions


def motions_to_instruction(motions: Sequence[str], category: Optional[int] = None) -> List[str]:
    """Group motions into a natural instruction word list."""
    words: List[str] = []
    i = 0
    first = True
    while i < len(motions):
        m = motions[i]
        if m == "forward":
            n = 0
            while i < len(motions) and motions[i] == "forward":
                n += 1
                i += 1
            n_word = NUM_WORDS[n] if n < len(NUM_WORDS) else "nine"
            if not first:
                words.append("then")
            words += ["go", "forward", n_word, "steps" if n != 1 else "step"]
        else:
            if not first:
                words.append("then")
            if m == "around":
                words += ["turn", "around"]
            else:
                words += ["turn", m]
            i += 1
        first = False
    if category is not None and 0 <= category < len(CATEGORY_WORDS):
        words += ["to", "reach", "the", CATEGORY_WORDS[category]]
    else:
        words += ["and", "stop", "there"]
    return words


def generate_template_instruction(
    positions: np.ndarray,
    path: Sequence[int],
    start_heading_deg: int,
    category: Optional[int] = None,
) -> List[str]:
    if len(path) < 2:
        return ["stop", "here"]
    motions = path_to_motions(positions, path, start_heading_deg)
    return motions_to_instruction(motions, category)
