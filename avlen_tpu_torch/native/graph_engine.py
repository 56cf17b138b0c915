"""ctypes bindings for the native graph/pose engine (graph_engine.cpp, the
port's copy of the JAX package's source).

The batched MatterSim-equivalent (pybind11 binding in the reference,
src/lib_python/MatterSimPython.cpp) — here a flat C ABI so no binding
framework is needed. The C side indexes its scenes and nodes unchecked, so
the bindings raise ``IndexError`` on a scene, node or batch slot out of
range (where JAX's bindings hand it to the library).
"""

from __future__ import annotations

import ctypes
from typing import List, Sequence, Tuple

import numpy as np

from avlen_tpu_torch.native.build import load_library

_I32P = np.ctypeslib.ndpointer(np.int32, flags="C_CONTIGUOUS")
_F32P = np.ctypeslib.ndpointer(np.float32, flags="C_CONTIGUOUS")
_U8P = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")


class GraphEngine:
    def __init__(self):
        lib = load_library("graph_engine")
        lib.ge_create.restype = ctypes.c_void_p
        lib.ge_destroy.argtypes = [ctypes.c_void_p]
        lib.ge_add_scene.restype = ctypes.c_int32
        lib.ge_add_scene.argtypes = [ctypes.c_void_p, ctypes.c_int32, _F32P, ctypes.c_int32, _I32P]
        lib.ge_num_scenes.argtypes = [ctypes.c_void_p]
        lib.ge_num_scenes.restype = ctypes.c_int32
        lib.ge_new_episode.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _I32P, _I32P]
        lib.ge_make_action.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _U8P]
        lib.ge_get_state.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _I32P, _F32P]
        lib.ge_hops.restype = ctypes.c_int32
        lib.ge_hops.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3
        lib.ge_shortest_path.restype = ctypes.c_int32
        lib.ge_shortest_path.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3 + [_I32P, ctypes.c_int32]
        lib.ge_oracle_actions.restype = ctypes.c_int32
        lib.ge_oracle_actions.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 4 + [_I32P, ctypes.c_int32]
        # arbitrary viewpoint graphs (MatterSim connectivity-graph parity)
        lib.ge_add_scene_vp.restype = ctypes.c_int32
        lib.ge_add_scene_vp.argtypes = [ctypes.c_void_p, ctypes.c_int32, _F32P, ctypes.c_int32, _I32P]
        lib.ge_vp_new_episode.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _I32P, _F32P]
        lib.ge_vp_navigable.restype = ctypes.c_int32
        lib.ge_vp_navigable.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _F32P, ctypes.c_int32]
        lib.ge_vp_make_action.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _F32P, _U8P]
        lib.ge_vp_get_state.argtypes = [ctypes.c_void_p, ctypes.c_int32, _I32P, _F32P, _F32P]
        lib.ge_vp_hops.restype = ctypes.c_int32
        lib.ge_vp_hops.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3
        lib.ge_vp_shortest_path.restype = ctypes.c_int32
        lib.ge_vp_shortest_path.argtypes = [ctypes.c_void_p] + [ctypes.c_int32] * 3 + [_I32P, ctypes.c_int32]
        self._lib = lib
        self._h = ctypes.c_void_p(lib.ge_create())
        self._batch = 0
        self._vp_batch = 0
        self._nodes: List[int] = []  # node count of each grid scene
        self._vp_nodes: List[int] = []  # and of each viewpoint scene

    @staticmethod
    def _check(counts: List[int], scenes, *nodes) -> None:
        """Every scene id in range of ``counts`` and every node below its
        scene's count."""
        scenes = np.atleast_1d(np.asarray(scenes, np.int64))
        if scenes.size and (scenes.min() < 0 or scenes.max() >= len(counts)):
            raise IndexError(f"scene id out of range of {len(counts)} scenes: {scenes.tolist()}")
        limit = np.asarray(counts, np.int64)[scenes] if scenes.size else scenes
        for n in nodes:
            n = np.atleast_1d(np.asarray(n, np.int64))
            if n.shape != limit.shape or (n.size and ((n < 0) | (n >= limit)).any()):
                raise IndexError(f"node out of range of its scene's {limit.tolist()} nodes: {n.tolist()}")

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.ge_destroy(self._h)
            self._h = None

    def add_scene(self, positions: np.ndarray, edges: np.ndarray) -> int:
        positions = np.ascontiguousarray(positions, np.float32)
        edges = np.ascontiguousarray(edges, np.int32).reshape(-1, 2)
        idx = self._lib.ge_add_scene(self._h, positions.shape[0], positions, edges.shape[0], edges)
        if idx < 0:
            raise ValueError("non-cardinal edge in scene graph")
        self._nodes.append(positions.shape[0])
        return int(idx)

    @property
    def num_scenes(self) -> int:
        return int(self._lib.ge_num_scenes(self._h))

    def new_episode(self, scene_ids, nodes, rots) -> None:
        s = np.ascontiguousarray(scene_ids, np.int32)
        n = np.ascontiguousarray(nodes, np.int32)
        r = np.ascontiguousarray(rots, np.int32)
        self._check(self._nodes, s, n)
        if r.shape != s.shape:
            raise IndexError(f"{len(r)} rotations for {len(s)} episodes")
        self._batch = len(s)
        self._lib.ge_new_episode(self._h, self._batch, s, n, r)

    def make_action(self, actions) -> np.ndarray:
        a = np.ascontiguousarray(actions, np.int32)
        if a.shape != (self._batch,):
            raise IndexError(f"{len(a)} actions for a batch of {self._batch}")
        collided = np.zeros((self._batch,), np.uint8)
        self._lib.ge_make_action(self._h, self._batch, a, collided)
        return collided.astype(bool)

    def get_state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        nodes = np.zeros((self._batch,), np.int32)
        rots = np.zeros((self._batch,), np.int32)
        pos = np.zeros((self._batch, 3), np.float32)
        self._lib.ge_get_state(self._h, self._batch, nodes, rots, pos)
        return nodes, rots, pos

    def hops(self, scene: int, a: int, b: int) -> int:
        self._check(self._nodes, scene, a, b)
        return int(self._lib.ge_hops(self._h, scene, a, b))

    def shortest_path(self, scene: int, a: int, b: int, max_len: int = 256) -> List[int]:
        self._check(self._nodes, scene, a, b)
        out = np.zeros((max_len,), np.int32)
        n = self._lib.ge_shortest_path(self._h, scene, a, b, out, max_len)
        if n < 0:
            return []
        return out[:n].tolist()

    def oracle_actions(self, scene: int, node: int, rot: int, goal: int, max_len: int = 1024) -> List[int]:
        self._check(self._nodes, scene, node, goal)
        out = np.zeros((max_len,), np.int32)
        n = self._lib.ge_oracle_actions(self._h, scene, node, rot, goal, out, max_len)
        return out[:n].tolist()

    # ---- arbitrary viewpoint graphs (MatterSim newEpisode/makeAction/
    # getState over R2R-style connectivity graphs; non-grid, any degree) ----

    def add_scene_viewpoint(self, positions: np.ndarray, edges: np.ndarray) -> int:
        positions = np.ascontiguousarray(positions, np.float32)
        edges = np.ascontiguousarray(edges, np.int32).reshape(-1, 2)
        idx = int(self._lib.ge_add_scene_vp(self._h, positions.shape[0], positions, edges.shape[0], edges))
        self._vp_nodes.append(positions.shape[0])
        return idx

    def vp_new_episode(self, scene_ids, nodes, headings_deg) -> None:
        s = np.ascontiguousarray(scene_ids, np.int32)
        n = np.ascontiguousarray(nodes, np.int32)
        hd = np.ascontiguousarray(headings_deg, np.float32)
        self._check(self._vp_nodes, s, n)
        if hd.shape != s.shape:
            raise IndexError(f"{len(hd)} headings for {len(s)} episodes")
        self._vp_batch = len(s)
        self._lib.ge_vp_new_episode(self._h, self._vp_batch, s, n, hd)

    def vp_navigable(self, i: int, max_len: int = 64) -> Tuple[np.ndarray, np.ndarray]:
        """Navigable locations for batch slot i: (nodes, rel_headings_deg);
        entry 0 is the current viewpoint, then neighbors sorted by absolute
        relative heading (MatterSim navigableLocations convention)."""
        if not 0 <= i < self._vp_batch:
            raise IndexError(f"slot {i} out of a batch of {self._vp_batch}")
        nodes = np.zeros((max_len,), np.int32)
        rels = np.zeros((max_len,), np.float32)
        n = self._lib.ge_vp_navigable(self._h, i, nodes, rels, max_len)
        return nodes[:n], rels[:n]

    def vp_make_action(self, loc_idx, heading_delta_deg) -> np.ndarray:
        idx = np.ascontiguousarray(loc_idx, np.int32)
        dh = np.ascontiguousarray(heading_delta_deg, np.float32)
        if idx.shape != (self._vp_batch,) or dh.shape != (self._vp_batch,):
            raise IndexError(f"{len(idx)} moves and {len(dh)} turns for a batch of {self._vp_batch}")
        invalid = np.zeros((self._vp_batch,), np.uint8)
        self._lib.ge_vp_make_action(self._h, self._vp_batch, idx, dh, invalid)
        return invalid.astype(bool)

    def vp_get_state(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        nodes = np.zeros((self._vp_batch,), np.int32)
        headings = np.zeros((self._vp_batch,), np.float32)
        pos = np.zeros((self._vp_batch, 3), np.float32)
        self._lib.ge_vp_get_state(self._h, self._vp_batch, nodes, headings, pos)
        return nodes, headings, pos

    def vp_hops(self, scene: int, a: int, b: int) -> int:
        self._check(self._vp_nodes, scene, a, b)
        return int(self._lib.ge_vp_hops(self._h, scene, a, b))

    def vp_shortest_path(self, scene: int, a: int, b: int, max_len: int = 256) -> List[int]:
        self._check(self._vp_nodes, scene, a, b)
        out = np.zeros((max_len,), np.int32)
        n = self._lib.ge_vp_shortest_path(self._h, scene, a, b, out, max_len)
        if n < 0:
            return []
        return out[:n].tolist()
