"""Checkpoint save/load, in the JAX package's file format.

PyTorch counterpart of ``avlen_tpu/utils/checkpoint.py`` (reference
ss_baselines/savi/ppo/ppo_trainer.py:193-275): ``ckpt.{i}.pth`` files
holding the model state, a config snapshot and ``extra_state`` (+ optimizer
states), folder polling for eval (common/utils.py:159-186) and resume
scanning. The files are data-only msgpack as ``flax.serialization`` writes
them (``utils/msgpack_codec.py``), byte for byte: a payload (dicts, lists,
numpy arrays and Python scalars) is turned into a state dict as
``flax.serialization.to_state_dict`` does (lists and tuples become
``{"0": ...}`` maps), the config is stored as
a JSON string, and the file is written to ``.tmp`` and then renamed, so
eval's folder polling never sees a partial file. Nothing here is pickle or
``torch.load``; the ``.pth`` suffix is the reference's folder layout only.

The trainers store their parameters as Flax parameter trees
(``utils/flax_bridge.to_flax_params``), so a checkpoint of either package
loads in the other and ``merge_matching_params`` sees the JAX paths.
"""

from __future__ import annotations

import glob
import json
import os
import re
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from avlen_tpu_torch.utils import msgpack_codec


def _state_dict(tree: Any) -> Any:
    """``flax.serialization.to_state_dict`` of a tree of dicts, lists and
    leaves."""
    if isinstance(tree, dict):
        return {str(k): _state_dict(v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return {str(i): _state_dict(v) for i, v in enumerate(tree)}
    return tree


def save_checkpoint(folder: str, name: str, payload: Dict[str, Any]) -> str:
    os.makedirs(folder, exist_ok=True)
    path = os.path.join(folder, name)
    payload = dict(payload)
    if "config" in payload and not isinstance(payload["config"], (str, bytes)):
        # the config as JSON: a state dict would turn its list-valued keys
        # (VIDEO_OPTION, CONTENT_SCENES, HELD_OUT_SOUNDS) into {'0': ...} maps
        payload["config"] = json.dumps(payload["config"])
    pieces: List[Any] = []
    msgpack_codec.pack_into(_state_dict(payload), pieces)
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        f.writelines(pieces)
    os.replace(tmp, path)
    return path


def load_checkpoint(path: str) -> Dict[str, Any]:
    with open(path, "rb") as f:
        state = msgpack_codec.unpackb(f.read())
    cfg = state.get("config") if isinstance(state, dict) else None
    if isinstance(cfg, (str, bytes)):
        state["config"] = json.loads(cfg if isinstance(cfg, str) else cfg.decode())
    return state


def merge_matching_params(target, source) -> Tuple[Any, List[str], List[str]]:
    """Partial checkpoint load over nested dicts of arrays: copy ``source``
    leaves into ``target`` where the same path exists with the same shape,
    in the target's dtype (the reference's filtered load_state_dict for
    cross-stage weight transfer, ppo_trainer.py:301-513). Returns (merged,
    copied_paths, skipped_paths), the paths as the JAX package lists them."""
    copied: List[str] = []
    skipped: List[str] = []

    def rec(t, s, path):
        if isinstance(t, dict) and isinstance(s, dict):
            out = {}
            for k, v in t.items():
                if k in s:
                    out[k] = rec(v, s[k], path + (k,))
                else:
                    skipped.append("/".join(path + (k,)))
                    out[k] = v
            return out
        ts = getattr(t, "shape", None)
        ss = getattr(s, "shape", None)
        if ts is not None and ts == ss:
            copied.append("/".join(path))
            return np.asarray(s, dtype=np.asarray(t).dtype) if hasattr(t, "dtype") else np.asarray(s)
        if ts is None and ss is None:
            copied.append("/".join(path))
            return s
        skipped.append("/".join(path))
        return t

    return rec(target, source, ()), copied, skipped


def poll_checkpoint_folder(folder: str, previous_index: int) -> Optional[str]:
    """Next ``ckpt.{i}.pth`` after previous_index (common/utils.py:159-186)."""
    paths = list_checkpoints(folder)
    ind = previous_index + 1
    if ind < len(paths):
        return paths[ind]
    return None


def list_checkpoints(folder: str) -> List[str]:
    """``ckpt.{i}.pth`` in ``folder`` by index (``ckpt.10`` after ``ckpt.9``)."""
    paths = glob.glob(os.path.join(folder, "ckpt.*.pth"))

    def index(p):
        m = re.search(r"ckpt\.(\d+)\.pth", p)
        return int(m.group(1)) if m else -1

    return sorted(paths, key=index)
