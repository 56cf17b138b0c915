"""R2R / VLN-CE → SoundSpaces dialog-episode alignment (PyTorch port: a host
program, the counterpart of ``avlen_tpu/data/vln.py`` function for function).

Counterpart of the reference's ``scripts/generate_vln_episode.py`` (719 LoC),
which builds the ``semantic_audionav_dialog_approx`` dataset by

1. walking each Fine-Grained-R2R path in MatterSim with a DummyAgent to
   approximate per-node headings (generate_vln_episode.py:49-110, 261-283),
2. pruning FGR2R instructions to those whose full text exists in VLN-CE and
   slicing each sub-instruction's path/rotation out of the matched VLN-CE
   episode (:200-257),
3. mapping MatterSim connectivity viewpoints onto SoundSpaces graph nodes by
   same-floor nearest-xz distance (view2node, :314-371),
4. re-expressing each sub-instruction path as SoundSpaces nodes (:391-432),
5. pairing every aligned sub-instruction with the scan's semantic-audionav
   episodes whose shortest start→goal path passes through the dialog end
   node, emitting ≤5 episodes per sub-instruction with dialog start
   position/rotation and an (az, el) direction hint (:543-664).

This module is the ingestion-side equivalent: it consumes the same three
public data formats (MatterSim ``{scan}_connectivity.json``, FGR2R
``FGR2R_{split}.json``, VLN-CE ``{split}.json.gz``) plus a semantic-audionav
dataset tree, and writes the same ``content/{scan}.json.gz`` output schema
that :func:`avlen_tpu_torch.data.reference.load_reference_episodes` reads back.
The MatterSim dependency is replaced by the native viewpoint engine
(:mod:`avlen_tpu_torch.native.graph_engine`, built from the port's own copy
of the source), which implements the same discretized-view heading search.

No real Matterport/R2R data ships with the repository; tests fabricate
format-exact fixtures (tests/test_vln_alignment.py), the same strategy the
reference-format ingestion layer uses.
"""

from __future__ import annotations

import ast
import dataclasses
import gzip
import json
import os
import random
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import dijkstra

from avlen_tpu_torch.data.reference import position_encoding
from avlen_tpu_torch.sim.graph import NavGraph

# MatterSim pose → habitat frame (generate_vln_episode.py:39): habitat keeps
# x, takes MatterSim z as y (up), and -y as z.
_R_MAT = np.array(
    [[1, 0, 0, 0], [0, 0, 1, 0], [0, -1, 0, 0], [0, 0, 0, 1]], np.float64
)
# cardinal yaw grid the generated start rotations snap to (:40, :628)
_ROTATION_BASE = np.array([0, 90, 180, 270])
# same-floor window when mapping a viewpoint to a graph node (:351)
_FLOOR_HEIGHT = 2.99


# ---------------------------------------------------------------------------
# connectivity graphs
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Connectivity:
    """One scan's MatterSim connectivity graph in the habitat frame."""

    view_ids: List[str]  # included viewpoints only
    positions: np.ndarray  # (N, 3) float32, habitat frame (y up)
    edges: np.ndarray  # (E, 2) int32 undirected, indices into view_ids

    @property
    def index(self) -> Dict[str, int]:
        return {v: i for i, v in enumerate(self.view_ids)}


def load_connectivity(path: str) -> Connectivity:
    """Parse ``{scan}_connectivity.json`` (list of ``{image_id, pose[16],
    included, unobstructed[]}``) the way the reference does: keep included
    viewpoints, connect mutually-unobstructed pairs, and read positions from
    the ``r_mat``-transformed pose column (:286-311, :331-341)."""
    with open(path) as f:
        data = json.load(f)
    keep = [i for i, item in enumerate(data) if item.get("included")]
    remap = {orig: new for new, orig in enumerate(keep)}
    view_ids, positions, edges = [], [], []
    for orig in keep:
        item = data[orig]
        view_ids.append(item["image_id"])
        pose = _R_MAT @ np.asarray(item["pose"], np.float64).reshape(4, 4)
        positions.append(pose[:3, 3])
        for j, conn in enumerate(item["unobstructed"]):
            # undirected: the reference asserts symmetry (:307)
            if conn and j in remap and data[j].get("included"):
                a, b = remap[orig], remap[j]
                if a < b:
                    edges.append((a, b))
    return Connectivity(
        view_ids=view_ids,
        positions=np.asarray(positions, np.float32),
        edges=np.asarray(edges, np.int32).reshape(-1, 2),
    )


# ---------------------------------------------------------------------------
# heading adjustment (DummyAgent equivalent)
# ---------------------------------------------------------------------------
def _mattersim_heading_to_deg(heading_rad: float) -> float:
    """MatterSim heading (radians, clockwise from +z/north in its z-up frame)
    → the viewpoint engine's atan2(dz, dx) degrees in the habitat frame.

    In the habitat frame a MatterSim bearing θ maps to direction
    (sin θ, ·, -cos θ), whose atan2(dz, dx) is θ - 90°."""
    return float(np.degrees(heading_rad) - 90.0) % 360.0


def _deg_to_mattersim_heading(deg: float) -> float:
    return float(np.radians((deg + 90.0) % 360.0))


def adjust_headings(
    engine,
    vp_scene: int,
    conn: Connectivity,
    path_view_ids: Sequence[str],
    start_heading_rad: float,
) -> List[float]:
    """Per-node approximate headings along an FGR2R path.

    DummyAgent.getHeadings (:49-110): at each node, sweep the discretized
    views (30° increments) and pick the one whose *nearest* navigable
    location is the next path node, minimizing the view-center distance;
    that discrete heading becomes the node's heading (kept unchanged by the
    forward move). If no view sees the next node as its nearest navigable,
    the previous heading carries over. Returns MatterSim-convention radians,
    one per path node (the first entry is the start heading, :64)."""
    index = conn.index
    headings = [float(start_heading_rad)]
    heading_deg = _mattersim_heading_to_deg(start_heading_rad)
    for a, b in zip(path_view_ids[:-1], path_view_ids[1:]):
        u, v = index[a], index[b]
        best = None  # (angular distance, discrete heading)
        for k in range(12):
            view_deg = k * 30.0
            engine.vp_new_episode([vp_scene], [u], [view_deg])
            nodes, rels = engine.vp_navigable(0)
            # nodes[0] is the current viewpoint; nodes[1] the nearest navigable
            if len(nodes) > 1 and nodes[1] == v:
                d = abs(float(rels[1]))
                if best is None or d < best[0]:
                    best = (d, view_deg)
        if best is not None:
            heading_deg = best[1]
        headings.append(_deg_to_mattersim_heading(heading_deg))
    return headings


def adjust_fgr2r_headings(
    fgr2r_items: Sequence[dict], conns: Dict[str, Connectivity]
) -> List[dict]:
    """``adjust_heading`` (:261-283): annotate every FGR2R item with
    ``all_headings`` by walking its path in the viewpoint engine."""
    from avlen_tpu_torch.native.graph_engine import GraphEngine

    engine = GraphEngine()
    scene_of: Dict[str, int] = {}
    out = []
    for item in fgr2r_items:
        scan = item["scan"]
        if scan not in scene_of:
            c = conns[scan]
            scene_of[scan] = engine.add_scene_viewpoint(c.positions, c.edges)
        new_item = dict(item)
        new_item["all_headings"] = adjust_headings(
            engine, scene_of[scan], conns[scan], item["path"], item["heading"]
        )
        out.append(new_item)
    return out


# ---------------------------------------------------------------------------
# FGR2R × VLN-CE matching
# ---------------------------------------------------------------------------
def _heading_to_rotation_coeffs(heading_rad: float) -> List[float]:
    """updating_fgr2r's intermediate-node rotation (:240-248): normalize the
    heading to [-π, π], build the quaternion about [0, -1, 0] (MatterSim
    headings are clockwise, habitat yaw counter-clockwise about +y), and
    emit [x, y, z, w] coefficients."""
    h = heading_rad if heading_rad <= 3.1416 else heading_rad - 3.1416 * 2
    half = 0.5 * h
    # quat_from_angle_axis(h, [0,-1,0]) = (w=cos h/2, xyz=sin(h/2)*axis)
    return [0.0, -float(np.sin(half)), 0.0, float(np.cos(half))]


def match_fgr2r_to_vlnce(
    fgr2r_items: Sequence[dict], vlnce_episodes: Sequence[dict]
) -> List[dict]:
    """``updating_fgr2r`` (:200-257): keep only FGR2R instructions whose full
    text appears in VLN-CE; for each of their sub-instructions slice the
    VLN-CE ``reference_path`` by the (1-based, inclusive) ``chunk_view``
    endpoints, skip stop sub-instructions (equal endpoints), and attach a
    start rotation — the VLN-CE episode's for path-initial chunks, else the
    adjusted heading at the chunk's first node."""
    by_text: Dict[str, dict] = {}
    for ep in vlnce_episodes:
        by_text.setdefault(ep["instruction"]["instruction_text"], ep)

    out: List[dict] = []
    for item in fgr2r_items:
        new_instrs = item["new_instructions"]
        if isinstance(new_instrs, str):
            # FGR2R serializes the token lists as a Python repr; the
            # reference eval()s it (:217) — parse literals only here
            new_instrs = ast.literal_eval(new_instrs)
        for instr_idx, sub_instrs in enumerate(new_instrs):
            vlnce = by_text.get(item["instructions"][instr_idx])
            if vlnce is None:
                continue
            for sub_idx, sub_instr in enumerate(sub_instrs):
                start, end = item["chunk_view"][instr_idx][sub_idx]
                if start == end:  # stop instruction (:227)
                    continue
                if start == 1:
                    rotation = list(vlnce["start_rotation"])  # [x,y,z,w] (:235)
                else:
                    rotation = _heading_to_rotation_coeffs(
                        item["all_headings"][start - 1]
                    )
                out.append(
                    {
                        "sub_instr": " ".join(sub_instr),
                        "path": vlnce["reference_path"][start - 1 : end],
                        "rotation": rotation,
                        "scan": item["scan"],
                        "view_points": item["path"][start - 1 : end],
                    }
                )
    return out


# ---------------------------------------------------------------------------
# view → node mapping and path approximation
# ---------------------------------------------------------------------------
def build_view2node(conn: Connectivity, graph: NavGraph) -> Dict[str, Optional[int]]:
    """``generate_view2node`` (:314-371): each viewpoint maps to the
    SoundSpaces node on the same floor (graph y ≤ view y < graph y + 2.99)
    with the smallest xz distance, or None when no node shares its floor."""
    out: Dict[str, Optional[int]] = {}
    gp = graph.positions
    for vid, p in zip(conn.view_ids, conn.positions):
        same_floor = (p[1] >= gp[:, 1]) & (p[1] < gp[:, 1] + _FLOOR_HEIGHT)
        if not same_floor.any():
            out[vid] = None
            continue
        cand = np.flatnonzero(same_floor)
        d = np.hypot(gp[cand, 0] - p[0], gp[cand, 2] - p[2])
        out[vid] = int(cand[np.argmin(d)])
    return out


def approximate_in_soundspace(
    items: Sequence[dict], view2node: Dict[str, Optional[int]], graph: NavGraph
) -> List[dict]:
    """``approximate_fgr2r_in_soundspace`` (:391-432): re-express each
    sub-instruction's viewpoints as graph nodes, collapsing consecutive
    duplicates; drop items that touch an unmapped viewpoint or shrink below
    two nodes."""
    out = []
    for item in items:
        nodes: List[int] = []
        for vid in item["view_points"]:
            node = view2node.get(vid)
            if node is None:
                nodes = []
                break
            if not nodes or nodes[-1] != node:
                nodes.append(node)
        if len(nodes) >= 2:
            new_item = {k: v for k, v in item.items() if k not in ("path", "view_points")}
            new_item["path_node"] = nodes
            new_item["path_position"] = [graph.positions[n].tolist() for n in nodes]
            out.append(new_item)
    return out


# ---------------------------------------------------------------------------
# episode generation
# ---------------------------------------------------------------------------
def _cart2sph(v: np.ndarray) -> Tuple[float, float]:
    az = float(np.arctan2(v[1], v[0]))
    el = float(np.arctan2(v[2], np.hypot(v[0], v[1])))
    return az, el


def _rotation_angle_of_coeffs(coeffs: Sequence[float]) -> int:
    """quat_to_angle_axis(quat_from_coeffs([x,y,z,w]))[0] degrees mod 360,
    then the reference's UNWRAPPED snap to {0, 90, 180, 270} (:627-628).
    Two reference quirks reproduced as-is for dataset parity: the axis sign
    is discarded (quat_to_angle_axis angles are non-negative, so a -90° yaw
    about -y reads as 90°), and argmin(|angle - base|) does not wrap (350°
    snaps to 270°, not 0°)."""
    x, y, z, w = (float(c) for c in coeffs)
    angle = np.degrees(2.0 * np.arctan2(np.sqrt(x * x + y * y + z * z), w))
    angle = int(np.around(angle)) % 360
    return int(_ROTATION_BASE[np.argmin(np.abs(angle - _ROTATION_BASE))])


def generate_dialog_episodes(
    items: Sequence[dict],
    audionav_episodes: Sequence[dict],
    graph: NavGraph,
    *,
    min_path_len: int = 7,
    max_per_item: int = 5,
    seed: int = 0,
) -> List[dict]:
    """``create_episodes_dialog_start`` (:543-664) for one scan: pair every
    aligned sub-instruction with the audionav episodes whose shortest
    dialog-start→goal path (weighted Dijkstra on the scene graph) contains
    the dialog end node and spans ≥ ``min_path_len`` nodes; each generated
    episode starts at the dialog position with the rotation snapped to the
    cardinal grid and carries the sub-instruction, the dialog node path, and
    the (az, el) direction of the language subgoal."""
    rng = random.Random(seed)
    n = graph.num_nodes
    pos = graph.positions
    w = np.linalg.norm(pos[graph.edges[:, 0]] - pos[graph.edges[:, 1]], axis=1)
    rows = np.concatenate([graph.edges[:, 0], graph.edges[:, 1]])
    cols = np.concatenate([graph.edges[:, 1], graph.edges[:, 0]])
    adj = csr_matrix((np.concatenate([w, w]), (rows, cols)), shape=(n, n))
    _, preds = dijkstra(adj, return_predecessors=True)

    pos_to_node = {position_encoding(pos[i]): i for i in range(n)}

    def path_between(a: int, b: int) -> Optional[List[int]]:
        if a == b:
            return [a]
        path = [b]
        while path[-1] != a:
            p = preds[a, path[-1]]
            if p < 0:
                return None
            path.append(int(p))
        return path[::-1]

    episodes: List[dict] = []
    episode_id = 0
    for item in items:
        s_node = item["path_node"][0]
        d_e_node = item["path_node"][-1]
        # direction of the language subgoal, reference axes [x, -z, y] (:608-612)
        sp = pos[s_node]
        dp = pos[d_e_node]
        az, el = _cart2sph(
            np.array([dp[0], -dp[2], dp[1]]) - np.array([sp[0], -sp[2], sp[1]])
        )
        rotation_angle = _rotation_angle_of_coeffs(item["rotation"])
        half = np.radians(rotation_angle) / 2.0
        # quaternion.as_float_array layout [w, x, y, z] (:629-631) — the
        # generated dataset keeps this layout (rotation_angle is canonical)
        start_rotation = [float(np.cos(half)), 0.0, float(np.sin(half)), 0.0]

        possible: List[dict] = []
        for nav_ep in audionav_episodes:
            goal_pos = nav_ep["goals"][0]["position"]
            goal_node = pos_to_node.get(position_encoding(goal_pos))
            if goal_node is None:
                continue
            s_path = path_between(s_node, goal_node)
            if s_path is None or len(s_path) < min_path_len:
                continue
            if d_e_node not in s_path:
                continue
            ep = dict(nav_ep)
            ep["dialog_node"] = list(item["path_node"])
            ep["start_position"] = item["path_position"][0]
            ep["sub_instr"] = item["sub_instr"]
            ep["direction"] = [az, el]
            ep["start_rotation"] = start_rotation
            ep["rotation_angle"] = rotation_angle
            ep["episode_id"] = episode_id
            episode_id += 1
            possible.append(ep)
        if len(possible) > max_per_item:
            possible = rng.sample(possible, max_per_item)
        episodes.extend(possible)
    return episodes


# ---------------------------------------------------------------------------
# end-to-end pipeline
# ---------------------------------------------------------------------------
def generate_dialog_dataset(
    *,
    fgr2r_path: str,
    vlnce_paths: Sequence[str],
    connectivity_dir: str,
    scene_graphs: Dict[str, NavGraph],
    audionav_dataset_dir: str,
    output_dir: str,
    min_path_len: int = 7,
    max_per_item: int = 5,
    seed: int = 0,
) -> Dict[str, int]:
    """Full pipeline over every scan that has a scene graph; writes
    ``{output_dir}/content/{scan}.json.gz`` in the reference's output schema
    (:652-662) and returns per-scan episode counts."""
    with open(fgr2r_path) as f:
        fgr2r_items = [it for it in json.load(f) if it["scan"] in scene_graphs]

    vlnce_episodes: List[dict] = []
    for p in vlnce_paths:
        with gzip.open(p, "rt") as f:
            vlnce_episodes.extend(json.load(f)["episodes"])
    # group by scan the way get_relevant_vlnce_episodes does (:159-163)
    vlnce_by_scan: Dict[str, List[dict]] = {}
    for ep in vlnce_episodes:
        scan = os.path.basename(ep["scene_id"]).split(".")[0]
        vlnce_by_scan.setdefault(scan, []).append(ep)

    conns = {
        scan: load_connectivity(
            os.path.join(connectivity_dir, f"{scan}_connectivity.json")
        )
        for scan in scene_graphs
    }
    adjusted = adjust_fgr2r_headings(fgr2r_items, conns)

    counts: Dict[str, int] = {}
    os.makedirs(os.path.join(output_dir, "content"), exist_ok=True)
    for scan, graph in scene_graphs.items():
        matched = match_fgr2r_to_vlnce(
            [it for it in adjusted if it["scan"] == scan],
            vlnce_by_scan.get(scan, []),
        )
        view2node = build_view2node(conns[scan], graph)
        approx = approximate_in_soundspace(matched, view2node, graph)

        nav_path = os.path.join(audionav_dataset_dir, "content", f"{scan}.json.gz")
        with gzip.open(nav_path, "rt") as f:
            audionav = json.load(f)["episodes"]

        episodes = generate_dialog_episodes(
            approx, audionav, graph,
            min_path_len=min_path_len, max_per_item=max_per_item, seed=seed,
        )
        counts[scan] = len(episodes)
        if episodes:
            out_path = os.path.join(output_dir, "content", f"{scan}.json.gz")
            with gzip.open(out_path, "wt") as f:
                json.dump({"episodes": episodes, "scan": scan}, f)
    # split-level stub so load_reference_episodes can open the tree
    top = os.path.join(output_dir, "dataset.json.gz")
    if not os.path.exists(top):
        with gzip.open(top, "wt") as f:
            json.dump({"episodes": []}, f)
    return counts
