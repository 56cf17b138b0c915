"""Precomputed oracle-instruction token bank.

PyTorch counterpart of ``avlen_tpu/dialog/instruction_bank.py``. The
reference calls the speaker + CLIP tokenizer on the host whenever an agent
queries (savi/ppo/ppo_trainer.py:549-562). The speaker is a deterministic
function of (scene, node, heading, goal): the instruction describes the
≤3-node prefix of the shortest path from the current pose
(ppo_trainer.py:538-548). So a scene set's whole instruction space is one
int32 tensor

    tokens[scene, node, rot, goal_node] -> (77,) CLIP ids,

built on the host once and moved to the device once; a query is then one
gather. Worlds too large to bank call the speaker per query instead
(``instruction_source.HostSpeakerInstructionSource``).
"""

from __future__ import annotations

from typing import List, Sequence

import numpy as np

from avlen_tpu_torch.dialog.speaker.speaker import Speaker
from avlen_tpu_torch.models.clip_text import CONTEXT_LENGTH, tokenize
from avlen_tpu_torch.sim.graph import SceneTables

APP_PATH_LEN = 3  # reference keeps the first <=3 unique next nodes
SPEAKER_BATCH = 512  # speaker items a call while building the bank


def shortest_path_prefix(tables: SceneTables, node: int, goal: int, max_len: int = APP_PATH_LEN + 1) -> List[int]:
    """Path [node, next, ...] truncated like the reference's gt_app_path
    (ppo_trainer.py:538-548: first element + up to 3 unique successors)."""
    path = [node]
    cur = node
    for _ in range(max_len - 1):
        nxt = int(tables.oracle_next[cur, goal])
        if nxt < 0 or nxt in path:
            break
        path.append(nxt)
        cur = nxt
    return path


def build_instruction_bank(
    speaker: Speaker,
    tables_list: Sequence[SceneTables],
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """(S, N_max, 4, N_max, 77) int32 CLIP-token bank, on the host.

    ``rot`` indexes rotation_angle//90; the speaker's heading is the agent
    orientation in degrees, (270 - rot*90) % 360 (simulator.py:595-597).
    A node at its goal, or with no path, gets "stop here". Speaker calls go
    ``SPEAKER_BATCH`` items at a time, and each distinct text is tokenized
    once."""
    s = len(tables_list)
    n_max = max(t.num_nodes for t in tables_list)
    bank = np.zeros((s, n_max, 4, n_max, context_length), np.int32)
    stop_tokens = tokenize(["stop here"])[0]

    items: List[dict] = []
    slots: List[tuple] = []
    tok_cache: dict = {}  # template texts repeat heavily across (node, goal)

    def flush():
        if not items:
            return
        texts = speaker.instruction_text(items)
        fresh = sorted({t for t in texts if t not in tok_cache})
        if fresh:
            for t, tk in zip(fresh, tokenize(fresh, context_length=context_length)):
                tok_cache[t] = tk
        for (si, node, rot, goal), text in zip(slots, texts):
            bank[si, node, rot, goal] = tok_cache[text]
        items.clear()
        slots.clear()

    for si, t in enumerate(tables_list):
        n = t.num_nodes
        for goal in range(n):
            for node in range(n):
                path = shortest_path_prefix(t, node, goal)
                for rot in range(4):
                    if len(path) < 2:
                        bank[si, node, rot, goal] = stop_tokens
                        continue
                    heading = (270 - rot * 90) % 360
                    items.append({"heading": heading, "scene": si, "path": path})
                    slots.append((si, node, rot, goal))
                    if len(items) >= SPEAKER_BATCH:
                        flush()
    flush()
    return bank


def build_instruction_bank_fast(
    tables_list: Sequence[SceneTables],
    context_length: int = CONTEXT_LENGTH,
) -> np.ndarray:
    """The template-backend bank without a caller-made Speaker."""
    speaker = Speaker([t.positions for t in tables_list], backend="template")
    return build_instruction_bank(speaker, tables_list, context_length=context_length)
