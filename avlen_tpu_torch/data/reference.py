"""Ingestion of the reference's on-disk world (SoundSpaces/Matterport data).

PyTorch counterpart of ``avlen_tpu/data/reference.py``: loads every format
the reference trains from and compiles it into the ``SceneBank`` the
batched env runs on, on the caller's device:

* metadata ``points.txt``/``graph.pkl`` navigation graphs
  (soundspaces/utils.py:16-42; graph node ``point`` attributes are the
  source of truth for positions, as in the reference simulator; the pickle
  is read without networkx, ``sim/graph.read_networkx_pickle``)
* binaural RIR wav trees ``binaural_rirs/<dataset>/<scene>/<azimuth>/
  <receiver>_<source>.wav`` (soundspaces/simulator.py:644-699)
* per-scene frame-cache pickles ``scene_observations/<dataset>/<scene>.pkl``
  holding ``(node, rotation_angle) -> {rgb, depth, semantic}``
  (scripts/cache_observations.py:33-119, simulator.py:62-93, 372-377)
* source-sound folders of wav files (simulator.py:609-637)
* sharded episode datasets ``<split>.json.gz`` + ``content/{scene}.json.gz``
  in the `SemanticAudioNav` schema
  (soundspaces/datasets/semantic_audionav_dataset.py:32-256)

Small RIR trees load whole onto the device as a ``DenseRIRBank``. Large
ones are packed once into a flat binary + index (``pack_rir_tree``) and
served by ``HostRIRStore``: the file is memory-mapped, and each env step
reads the (B, L, 2) RIRs it needs into a pinned host buffer and copies them
to the device (the counterpart of the reference's per-step
``wavfile.read``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import gzip
import json
import os
import pickle
import re
import time
from typing import Dict, Iterable, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch

from avlen_tpu_torch.core.episodes import Episode
from avlen_tpu_torch.sim.graph import NavGraph, build_scene_tables, load_metadata_graph, pad_and_stack_tables

AZIMUTHS = (0, 90, 180, 270)


# ---------------------------------------------------------------------------
# metadata graphs
# ---------------------------------------------------------------------------
def load_scene_graph(metadata_scene_dir: str) -> NavGraph:
    """points.txt + graph.pkl for one scene (soundspaces/utils.py:16-42)."""
    points_file = os.path.join(metadata_scene_dir, "points.txt")
    graph_file = os.path.join(metadata_scene_dir, "graph.pkl")
    if not os.path.exists(graph_file):
        raise FileNotFoundError(f"{graph_file} does not exist")
    return load_metadata_graph(points_file, graph_file)


def position_encoding(position: Sequence[float]) -> str:
    """The reference's node lookup key (simulator.py:437-439)."""
    return "{:.2f}_{:.2f}_{:.2f}".format(*position)


def build_position_index(graph: NavGraph) -> Dict[str, int]:
    return {position_encoding(p): i for i, p in enumerate(graph.positions)}


# ---------------------------------------------------------------------------
# sounds
# ---------------------------------------------------------------------------
def _read_wav(path: str) -> Tuple[int, np.ndarray]:
    from scipy.io import wavfile

    sr, data = wavfile.read(path)
    if data.dtype == np.int16:
        data = data.astype(np.float32) / 32768.0
    elif data.dtype == np.int32:
        data = data.astype(np.float32) / 2147483648.0
    elif data.dtype == np.uint8:
        data = (data.astype(np.float32) - 128.0) / 128.0
    else:
        data = data.astype(np.float32)
    return sr, data


def _resample(data: np.ndarray, sr: int, target_sr: int) -> np.ndarray:
    if sr == target_sr:
        return data
    from math import gcd

    from scipy.signal import resample_poly

    g = gcd(sr, target_sr)
    return resample_poly(data, target_sr // g, sr // g, axis=0).astype(np.float32)


def load_sound_dir(sound_dir: str, sampling_rate: int) -> Tuple[List[str], List[np.ndarray]]:
    """All mono source sounds, loaded once, resampled to the RIR sampling rate
    (the reference's `_load_source_sounds`, simulator.py:609-618; names keep
    their extension, matching episode ``sound_id`` strings)."""
    names, sounds = [], []
    for fname in sorted(os.listdir(sound_dir)):
        if not fname.endswith(".wav"):
            continue
        sr, data = _read_wav(os.path.join(sound_dir, fname))
        if data.ndim > 1:
            data = data.mean(axis=1)
        names.append(fname)
        sounds.append(_resample(data, sr, sampling_rate))
    if not names:
        raise FileNotFoundError(f"no .wav files in {sound_dir}")
    return names, sounds


# ---------------------------------------------------------------------------
# binaural RIR trees
# ---------------------------------------------------------------------------
_PAIR_RE = re.compile(r"^(\d+)_(\d+)\.wav$")


def iter_rir_files(scene_rir_dir: str):
    """Yield (azimuth_idx, receiver, source, path) over a scene's wav tree."""
    for az_i, az in enumerate(AZIMUTHS):
        az_dir = os.path.join(scene_rir_dir, str(az))
        if not os.path.isdir(az_dir):
            continue
        for fname in sorted(os.listdir(az_dir)):
            m = _PAIR_RE.match(fname)
            if m:
                yield az_i, int(m.group(1)), int(m.group(2)), os.path.join(az_dir, fname)


def _read_rir(path: str, sampling_rate: Optional[int]) -> np.ndarray:
    """One RIR wav as (L, 2) float32 at ``sampling_rate`` (mono doubled)."""
    sr, rir = _read_wav(path)
    if rir.ndim == 1:
        rir = rir[:, None].repeat(2, axis=1)
    if sampling_rate is not None and sr != sampling_rate:
        rir = _resample(rir, sr, sampling_rate)
    return rir[:, :2]


def load_rir_tree(
    scene_rir_dirs: Sequence[str],
    num_nodes: int,
    max_length: Optional[int] = None,
    sampling_rate: Optional[int] = None,
) -> np.ndarray:
    """Load wav trees fully into a dense (S, 4, N, N, L, 2) array (small
    scenes / tests). Missing pairs stay zero, like the reference's
    empty-file fallback (simulator.py:652-662)."""
    lengths = []
    per_scene: List[List[Tuple[int, int, int, np.ndarray]]] = []
    for d in scene_rir_dirs:
        items = []
        for az_i, recv, src, path in iter_rir_files(d):
            rir = _read_rir(path, sampling_rate)
            items.append((az_i, recv, src, rir))
            lengths.append(rir.shape[0])
        per_scene.append(items)
    if not lengths:
        raise FileNotFoundError(f"no RIR wavs under {list(scene_rir_dirs)}")
    length = max(lengths)
    if max_length is not None:
        length = min(length, max_length)
    out = np.zeros((len(scene_rir_dirs), 4, num_nodes, num_nodes, length, 2), np.float32)
    for s, items in enumerate(per_scene):
        for az_i, recv, src, rir in items:
            rir = rir[:length]
            out[s, az_i, recv, src, : rir.shape[0]] = rir
    return out


@contextlib.contextmanager
def _atomic_file(path: str):
    """A file object whose content appears at ``path`` only when the block
    ends without an error, so that a reader never sees a half-written pack."""
    tmp = f"{path}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as f:
            yield f
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def _write_index(out_prefix: str, offsets: np.ndarray, lengths: np.ndarray, pad_length: int,
                 sampling_rate: int) -> str:
    idx_path = out_prefix + ".npz"
    with _atomic_file(idx_path) as f:
        np.savez(f, offsets=offsets, lengths=lengths, pad_length=np.int64(pad_length),
                 sampling_rate=np.int64(sampling_rate))
    return idx_path


def pack_rir_tree(
    scene_rir_dirs: Sequence[str],
    num_nodes: int,
    out_prefix: str,
    max_length: Optional[int] = None,
    sampling_rate: Optional[int] = None,
) -> str:
    """Convert wav trees into one flat float32 binary + index, the on-disk
    format `HostRIRStore` memory-maps. Returns the index (.npz) path.

    Layout: ``<prefix>.bin`` holds concatenated (len_i, 2) float32 RIRs;
    ``<prefix>.npz`` holds (S, 4, N, N) ``offset``/``length`` tables (both
    -1/0 for missing pairs) plus the pad length and sampling rate. The index
    is written last, so its presence means a whole pack."""
    s_count = len(scene_rir_dirs)
    offsets = np.full((s_count, 4, num_nodes, num_nodes), -1, np.int64)
    lengths = np.zeros((s_count, 4, num_nodes, num_nodes), np.int32)
    max_seen = 0
    pos = 0
    with _atomic_file(out_prefix + ".bin") as f:
        for s, d in enumerate(scene_rir_dirs):
            for az_i, recv, src, path in iter_rir_files(d):
                rir = np.ascontiguousarray(_read_rir(path, sampling_rate), np.float32)
                if max_length is not None:
                    rir = rir[:max_length]
                offsets[s, az_i, recv, src] = pos
                lengths[s, az_i, recv, src] = rir.shape[0]
                max_seen = max(max_seen, rir.shape[0])
                f.write(rir.tobytes())
                pos += rir.shape[0]
    return _write_index(out_prefix, offsets, lengths, max_seen, sampling_rate or 0)


def pack_dense_rir_chunks(chunks: Iterable[np.ndarray], shape: Tuple[int, int, int, int], length: int,
                          out_prefix: str, sampling_rate: int) -> str:
    """Write (k, L, 2) float32 chunks that together hold an (S, 4, N, N, L,
    2) RIR tensor in C order, in the HostRIRStore format (the layout of
    `pack_rir_tree`, every pair present), without holding the tensor."""
    count = int(np.prod(shape))
    written = 0
    with _atomic_file(out_prefix + ".bin") as f:
        for chunk in chunks:
            chunk = np.ascontiguousarray(chunk, np.float32)
            f.write(chunk.tobytes())
            written += chunk.shape[0]
    if written != count:
        raise ValueError(f"packed {written} RIRs, the shape {shape} holds {count}")
    offsets = (np.arange(count, dtype=np.int64) * length).reshape(shape)
    lengths = np.full(shape, length, np.int32)
    return _write_index(out_prefix, offsets, lengths, length, sampling_rate)


def pack_dense_rirs(rirs: np.ndarray, out_prefix: str, sampling_rate: int) -> str:
    """Write an in-memory (S, 4, N, N, L, 2) RIR tensor in the HostRIRStore
    on-disk format (same layout as `pack_rir_tree`)."""
    rirs = np.asarray(rirs, np.float32)
    s, a, n, _, length, _ = rirs.shape
    return pack_dense_rir_chunks([rirs.reshape(-1, length, 2)], (s, a, n, n), length, out_prefix,
                                 sampling_rate)


class HostRIRStore:
    """Memory-mapped RIR bank, gathered per step onto the device.

    The counterpart of the reference's per-step
    ``wavfile.read(binaural_rir_file)`` (simulator.py:652-662): the packed
    bank is mapped once; ``gather`` brings the (B,) indices to the host (a
    device synchronisation), reads the (B, L, 2) RIRs into a pinned buffer
    and copies them to the device behind the work already queued. Two
    pinned buffers take turns, each with a CUDA event, so a read never
    overwrites a buffer whose copy is still in flight. Missing pairs are
    zeros.

    ``profile``, when set to a dict, collects the gathers' count and rows,
    their host seconds of the index synchronisation and of the read, and
    CUDA events around each copy (``copy_events``).
    """

    def __init__(self, index_path: str, device: Union[str, torch.device] = "cuda"):
        idx = np.load(index_path)
        self.offsets = idx["offsets"]
        self.lengths = idx["lengths"]
        self.length = int(idx["pad_length"])
        self.sampling_rate = int(idx["sampling_rate"])
        self.index_path = index_path
        bin_path = index_path[: -len(".npz")] + ".bin"
        self._data = np.memmap(bin_path, dtype=np.float32, mode="r").reshape(-1, 2)
        self.device = torch.device(device)
        if self.device.type == "cuda" and not torch.cuda.is_available():
            raise RuntimeError("HostRIRStore on a CUDA device, but CUDA is not available")
        self._staging: List[Optional[Tuple[torch.Tensor, torch.cuda.Event]]] = [None, None]
        self._turn = 0
        self.profile: Optional[dict] = None

    def gather_host(self, scene, az_idx, recv, src, out: Optional[np.ndarray] = None) -> np.ndarray:
        """(B,) host indices → (B, L, 2) float32 RIRs (written into ``out``
        when given)."""
        scene = np.atleast_1d(np.asarray(scene))
        az_idx = np.atleast_1d(np.asarray(az_idx))
        recv = np.atleast_1d(np.asarray(recv))
        src = np.atleast_1d(np.asarray(src))
        b = scene.shape[0]
        if out is None:
            out = np.zeros((b, self.length, 2), np.float32)
        for i in range(b):
            off = self.offsets[scene[i], az_idx[i], recv[i], src[i]]
            n = self.lengths[scene[i], az_idx[i], recv[i], src[i]] if off >= 0 else 0
            out[i, :n] = self._data[off : off + n]
            out[i, n:] = 0.0
        return out

    def _buffer(self, b: int) -> Tuple[torch.Tensor, torch.cuda.Event]:
        """The next pinned buffer of at least ``b`` rows, once its last copy
        has finished."""
        slot = self._staging[self._turn]
        if slot is None or slot[0].shape[0] < b:
            if slot is not None:
                slot[1].synchronize()
            slot = (torch.empty((b, self.length, 2), dtype=torch.float32, pin_memory=True),
                    torch.cuda.Event())
            self._staging[self._turn] = slot
        else:
            slot[1].synchronize()
        self._turn ^= 1
        return slot

    def gather(self, scene, az_idx, recv, src) -> torch.Tensor:
        """(B,) index tensors → (B, L, 2) RIRs on the store's device
        (pluggable into SceneBank.rir like DenseRIRBank)."""
        prof = self.profile
        t0 = time.perf_counter()
        idx = torch.stack([torch.as_tensor(x).long() for x in (scene, az_idx, recv, src)]).cpu().numpy()
        t1 = time.perf_counter()
        b = idx.shape[1]
        timed = prof is not None and self.device.type == "cuda"
        if self.device.type != "cuda":
            out = torch.from_numpy(self.gather_host(*idx)).to(self.device)
        else:
            pinned, event = self._buffer(b)
            self.gather_host(*idx, out=pinned[:b].numpy())
            out = torch.empty((b, self.length, 2), dtype=torch.float32, device=self.device)
            stream = torch.cuda.current_stream(self.device)
            if timed:
                start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
                start.record(stream)
            out.copy_(pinned[:b], non_blocking=True)
            event.record(stream)
            if timed:
                end.record(stream)
                prof.setdefault("copy_events", []).append((start, end))
        if prof is not None:
            t2 = time.perf_counter()
            for key, add in (("calls", 1), ("rows", b), ("index_sync_s", t1 - t0), ("host_read_s", t2 - t1)):
                prof[key] = prof.get(key, 0) + add
        return out


# ---------------------------------------------------------------------------
# frame caches
# ---------------------------------------------------------------------------
def load_frame_cache(
    pkl_path: str, num_nodes: int
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray], Optional[np.ndarray]]:
    """One scene's observation pickle → (rgb, depth, semantic) banks of shape
    (N, 4, H, W, C). Keys are (node, rotation_angle) with angles in degrees
    (cache_observations.py:103-108); bank rotation index = angle // 90."""
    with open(pkl_path, "rb") as f:
        cache = pickle.load(f)
    rgb = depth = semantic = None
    for (node, angle), obs in cache.items():
        rot = (int(angle) // 90) % 4
        if "rgb" in obs and obs["rgb"] is not None:
            frame = np.asarray(obs["rgb"])[..., :3].astype(np.uint8)
            if rgb is None:
                rgb = np.zeros((num_nodes, 4) + frame.shape, np.uint8)
            rgb[node, rot] = frame
        if "depth" in obs and obs["depth"] is not None:
            frame = np.asarray(obs["depth"], np.float32)
            if frame.ndim == 2:
                frame = frame[..., None]
            if depth is None:
                depth = np.zeros((num_nodes, 4) + frame.shape, np.float32)
            depth[node, rot] = frame
        if "semantic" in obs and obs["semantic"] is not None:
            # (H, W) instance ids, no channel dim (SemanticObjectSensor
            # consumes flat id frames, nav.py:676-698)
            frame = np.asarray(obs["semantic"], np.int32)
            if frame.ndim == 3:
                frame = frame[..., 0]
            if semantic is None:
                semantic = np.zeros((num_nodes, 4) + frame.shape, np.int32)
            semantic[node, rot] = frame
    return rgb, depth, semantic


# ---------------------------------------------------------------------------
# episode datasets (SemanticAudioNav json.gz schema)
# ---------------------------------------------------------------------------
def _quat_to_rot_idx(quat: Sequence[float]) -> int:
    """Rotation-about-+Y quaternion [x, y, z, w] → rotation_angle // 90
    (start rotations are cardinal yaw rotations,
    cache_observations.py:84-85)."""
    x, y, z, w = (float(q) for q in quat)
    angle = np.degrees(2.0 * np.arctan2(y, w))
    return int(np.round(angle / 90.0)) % 4


def _view_position(view) -> Optional[Sequence[float]]:
    """Serialized ObjectViewLocation → position. The shipped datasets store
    each view as its agent state (semantic_audionav_dataset.py:173-180);
    accept dict/list spellings."""
    if isinstance(view, dict):
        state = view.get("agent_state", view)
        if isinstance(state, dict):
            return state.get("position")
        return state
    if isinstance(view, (list, tuple)):
        if len(view) == 3 and all(isinstance(v, (int, float)) for v in view):
            return view
        if view and isinstance(view[0], (list, tuple)):
            return view[0]
    return None


def _scene_name(scene_id: str) -> str:
    """'data/scene_datasets/mp3d/sceneX/sceneX.glb' → 'sceneX'
    (simulator.py:325-327 takes path component 3; fall back to the file's
    parent directory name for relative paths)."""
    parts = scene_id.split("/")
    if len(parts) > 3 and parts[0] == "data":
        return parts[3]
    return parts[-2] if len(parts) >= 2 else os.path.splitext(parts[-1])[0]


def load_reference_episodes(
    data_path: str,
    scene_graphs: Dict[str, NavGraph],
    sound_names: Sequence[str],
    grid_size: float = 1.0,
    content_scenes: Optional[Sequence[str]] = None,
    scene_index: Optional[Dict[str, int]] = None,
) -> List[Episode]:
    """Parse ``<split>.json.gz`` (+ its ``content/{scene}.json.gz`` shards)
    into node-indexed Episodes.

    Positions resolve to graph nodes through the reference's 2-decimal
    position encoding (simulator.py:437-443); ``sound_id`` strings resolve
    through ``sound_names``; ``object_category`` through the 21-class mp3d
    mapping. ``scene_index`` fixes each scene's id in the stacked bank."""
    from avlen_tpu_torch.sim.mp3d_utils import CATEGORY_INDEX_MAPPING

    with gzip.open(data_path, "rt") as f:
        top = json.load(f)
    episodes_raw = list(top.get("episodes", []))

    content_dir = os.path.join(os.path.dirname(data_path), "content")
    if os.path.isdir(content_dir):
        for fname in sorted(os.listdir(content_dir)):
            if not fname.endswith(".json.gz"):
                continue
            scene = fname[: -len(".json.gz")]
            if content_scenes is not None and scene not in content_scenes:
                continue
            with gzip.open(os.path.join(content_dir, fname), "rt") as f:
                episodes_raw.extend(json.load(f).get("episodes", []))

    sound_to_id = {name: i for i, name in enumerate(sound_names)}
    # also accept extensionless sound ids
    for i, name in enumerate(list(sound_names)):
        sound_to_id.setdefault(os.path.splitext(name)[0], i)
    if scene_index is None:
        scene_index = {name: i for i, name in enumerate(sorted(scene_graphs))}
    pos_index = {name: build_position_index(g) for name, g in scene_graphs.items()}

    episodes: List[Episode] = []
    for raw in episodes_raw:
        scene = _scene_name(raw["scene_id"])
        if scene not in scene_graphs:
            continue
        graph = scene_graphs[scene]
        pidx = pos_index[scene]

        def node_of(position) -> int:
            key = position_encoding(position)
            if key in pidx:
                return pidx[key]
            # nearest node fallback (float drift in serialized positions)
            d = np.abs(graph.positions - np.asarray(position, np.float32)).sum(axis=1)
            return int(np.argmin(d))

        start_node = node_of(raw["start_position"])
        if raw.get("rotation_angle") is not None:
            start_rot = (int(raw["rotation_angle"]) // 90) % 4
        else:
            start_rot = _quat_to_rot_idx(raw["start_rotation"])

        goals = raw.get("goals", [])
        goal_positions = [g["position"] for g in goals if g.get("position") is not None]
        goal_node = node_of(goal_positions[0]) if goal_positions else start_node
        view_nodes: List[int] = []
        for g in goals:
            for view in g.get("view_points") or []:
                p = _view_position(view)
                if p is not None:
                    view_nodes.append(node_of(p))
        category_name = raw.get("object_category") or (
            goals[0].get("object_category") if goals else None
        )
        category = CATEGORY_INDEX_MAPPING.get(category_name, 0)

        distractor_node = raw.get("distractor_position_index")
        distractor_node = int(distractor_node) if distractor_node is not None else -1
        d_sound = raw.get("distractor_sound_id")
        distractor_sound = sound_to_id.get(d_sound, -1) if d_sound else -1

        info = raw.get("info") or {}
        dialog_raw = raw.get("dialog_node")
        if isinstance(dialog_raw, (list, tuple)):
            # dialog_approx datasets store the whole sub-instruction node
            # path (generate_vln_episode.py:621); the language subgoal is
            # its last node
            dialog_raw = dialog_raw[-1] if dialog_raw else None
        episodes.append(
            Episode(
                episode_id=str(raw.get("episode_id", len(episodes))),
                scene_id=scene_index[scene],
                start_node=start_node,
                start_rot_idx=start_rot,
                goal_node=goal_node,
                sound_id=sound_to_id.get(raw.get("sound_id"), 0),
                offset=int(raw.get("offset", 0) or 0),
                duration=int(raw.get("duration", 500) or 500),
                category=category,
                view_point_nodes=view_nodes or [goal_node],
                distractor_node=distractor_node,
                distractor_sound_id=distractor_sound,
                geodesic_distance=info.get("geodesic_distance"),
                num_action=info.get("num_action"),
                sub_instr=raw.get("sub_instr"),
                dialog_node=int(dialog_raw) if dialog_raw is not None else -1,
            )
        )
    if not episodes:
        raise ValueError(f"no episodes loaded from {data_path}")
    return episodes


# ---------------------------------------------------------------------------
# full bank assembly
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class ReferenceDataConfig:
    metadata_dir: str  # .../metadata/<dataset> (one subdir per scene)
    binaural_rir_dir: str  # .../binaural_rirs/<dataset>
    source_sound_dir: str
    data_path: str  # <split>.json.gz
    scene_observations_dir: Optional[str] = None  # .../scene_observations/<dataset>
    sampling_rate: int = 16000
    grid_size: float = 1.0
    max_rir_length: int = 24000
    scenes: Optional[Sequence[str]] = None  # default: all metadata subdirs
    # dense device bank below this byte size, HostRIRStore pack above
    dense_rir_max_bytes: int = 2 << 30
    rir_pack_dir: Optional[str] = None  # where packed banks live/get built


def build_reference_scene_bank(cfg: ReferenceDataConfig, device: Union[str, torch.device] = "cuda"):
    """Assemble (SceneBank, tables_list, episodes) from a reference data tree,
    the bank's tensors on ``device``."""
    from avlen_tpu_torch.sim.scene import DenseRIRBank, SceneBank, pad_sounds

    device = torch.device(device)
    scenes = list(cfg.scenes) if cfg.scenes else sorted(
        d for d in os.listdir(cfg.metadata_dir)
        if os.path.isdir(os.path.join(cfg.metadata_dir, d))
    )
    if not scenes:
        raise FileNotFoundError(f"no scene subdirectories in {cfg.metadata_dir}")

    graphs = {s: load_scene_graph(os.path.join(cfg.metadata_dir, s)) for s in scenes}
    tables_list = [build_scene_tables(graphs[s]) for s in scenes]
    stacked = pad_and_stack_tables(tables_list)
    n_max = stacked["positions"].shape[1]

    sound_names, sounds = load_sound_dir(cfg.source_sound_dir, cfg.sampling_rate)

    def dev(a):
        return torch.as_tensor(a, device=device)

    # RIRs: dense device bank when small, packed host store otherwise
    rir_dirs = [os.path.join(cfg.binaural_rir_dir, s) for s in scenes]
    probe_lengths = [
        min(_read_wav(p)[1].shape[0], cfg.max_rir_length)
        for _, _, _, p in _first_files(rir_dirs, k=8)
    ]
    est_len = max(probe_lengths) if probe_lengths else cfg.max_rir_length
    dense_bytes = len(scenes) * 4 * n_max * n_max * est_len * 2 * 4
    if dense_bytes <= cfg.dense_rir_max_bytes:
        rirs = load_rir_tree(rir_dirs, n_max, cfg.max_rir_length, cfg.sampling_rate)
        rir = DenseRIRBank(dev(rirs))
        rir_length = rirs.shape[4]
    else:
        pack_dir = cfg.rir_pack_dir or os.path.join(cfg.binaural_rir_dir, "_packed")
        os.makedirs(pack_dir, exist_ok=True)
        prefix = os.path.join(pack_dir, "rirs")
        if not os.path.exists(prefix + ".npz"):
            pack_rir_tree(rir_dirs, n_max, prefix, cfg.max_rir_length, cfg.sampling_rate)
        rir = HostRIRStore(prefix + ".npz", device=device)
        rir_length = rir.length

    sounds_padded, secs = pad_sounds(sounds, rir_length, cfg.sampling_rate)

    rgb = depth = semantic = inst_maps = None
    if cfg.scene_observations_dir:
        rgbs, depths, sems, maps = [], [], [], []
        for s, t in zip(scenes, tables_list):
            pkl = os.path.join(cfg.scene_observations_dir, s + ".pkl")
            r, d, sem = load_frame_cache(pkl, t.num_nodes)
            if r is not None:
                rp = np.zeros((n_max,) + r.shape[1:], np.uint8)
                rp[: t.num_nodes] = r
                rgbs.append(rp)
            if d is not None:
                dp = np.zeros((n_max,) + d.shape[1:], np.float32)
                dp[: t.num_nodes] = d
                depths.append(dp)
            if sem is not None:
                sp = np.zeros((n_max,) + sem.shape[1:], np.int32)
                sp[: t.num_nodes] = sem
                sems.append(sp)
                maps.append(_scene_instance_to_mp3d(cfg, s))
        if len(rgbs) == len(scenes):
            rgb = dev(np.stack(rgbs))
        if len(depths) == len(scenes):
            depth = dev(np.stack(depths))
        if len(sems) == len(scenes):
            semantic = dev(np.stack(sems))
            width = max(m.shape[0] for m in maps)
            padded = np.zeros((len(maps), width), np.int32)
            for i, m in enumerate(maps):
                padded[i, : m.shape[0]] = m
            inst_maps = dev(padded)

    bank = SceneBank(
        tables={k: dev(v) for k, v in stacked.items()},
        sounds_padded=dev(sounds_padded),
        sound_secs=dev(secs),
        rir=rir,
        rgb=rgb,
        depth=depth,
        semantic=semantic,
        semantic_instance_to_mp3d=inst_maps,
        grid_size=cfg.grid_size,
        sampling_rate=cfg.sampling_rate,
    )
    episodes = load_reference_episodes(
        cfg.data_path,
        graphs,
        sound_names,
        grid_size=cfg.grid_size,
        scene_index={s: i for i, s in enumerate(scenes)},
    )
    # host-side name table: heard/unheard sound splits resolve names → ids
    bank.sound_names = sound_names
    return bank, tables_list, episodes


def _scene_instance_to_mp3d(cfg: ReferenceDataConfig, scene: str) -> np.ndarray:
    """instance id → mpcat40 index for one scene, from the scene's .house
    file when present (SemanticObjectSensor builds this per episode from
    HouseReader, soundspaces/tasks/nav.py:676-681). Looked up as
    ``<metadata>/<scene>/<scene>.house`` (or any ``*.house`` in the scene's
    metadata dir). Without a house file, the identity map: frames are then
    read as already holding mpcat40 ids."""
    from avlen_tpu_torch.sim.mp3d_utils import HouseReader

    scene_dir = os.path.join(cfg.metadata_dir, scene)
    cands = [os.path.join(scene_dir, scene + ".house")]
    if os.path.isdir(scene_dir):
        cands += [
            os.path.join(scene_dir, f) for f in sorted(os.listdir(scene_dir)) if f.endswith(".house")
        ]
    for path in cands:
        if os.path.exists(path):
            mapping = HouseReader(path).compute_object_to_category_index_mapping()
            width = max(mapping) + 1 if mapping else 1
            table = np.zeros((width,), np.int32)
            for inst, mp3d in mapping.items():
                table[inst] = max(mp3d, 0)
            return table
    return np.arange(200, dtype=np.int32)


def _first_files(rir_dirs: Sequence[str], k: int):
    count = 0
    for d in rir_dirs:
        for item in iter_rir_files(d):
            yield item
            count += 1
            if count >= k:
                return
