"""Navigation graphs → dense device tables.

The reference agent lives on nodes of a per-scene networkx graph with
cardinal-direction edges (`SoundSpacesSim.step`, soundspaces/simulator.py:
476-592: MOVE_FORWARD follows the neighbor whose edge direction equals the
agent's orientation; TURN_LEFT/RIGHT rotate ±90°) and uses networkx Dijkstra
for geodesics and oracle paths (simulator.py:736-745, 758-787). Here each
scene graph is compiled once, on host, into dense integer tables so the whole
batched environment step is pure device gathers:

  fwd_next[node, orient]   next node when moving forward facing ``orient*90``°
                           (-1 = collision / no edge)
  hops[node, node]         all-pairs unweighted shortest-path length
  oracle_next[node, node]  greedy next hop toward a goal (argmin over cardinal
                           neighbors of remaining hops; first-match
                           tie-break like the reference's BFS ordering)

Orientation convention matches the reference exactly: the agent faces -Z at
rotation 0, rotation_angle increases counterclockwise about +Y in multiples of
90°, orientation = (270 - rotation_angle) % 360 (simulator.py:595-597), and
edge direction = round(deg(atan2(dz, dx))) % 360 on the X-Z plane.
"""

from __future__ import annotations

import dataclasses
import pickle
from typing import Dict, List, Optional, Tuple

import numpy as np
from scipy.sparse import csr_matrix
from scipy.sparse.csgraph import shortest_path

UNREACHABLE = np.int32(2**15)


@dataclasses.dataclass
class NavGraph:
    """A single scene's navigation graph (host-side)."""

    positions: np.ndarray  # (N, 3) float32, habitat frame (x, y, z); -Z forward
    edges: np.ndarray  # (E, 2) int32 undirected

    def __post_init__(self):
        self.positions = np.asarray(self.positions, np.float32)
        self.edges = np.asarray(self.edges, np.int32).reshape(-1, 2)

    @property
    def num_nodes(self) -> int:
        return self.positions.shape[0]


def edge_direction_deg(p1: np.ndarray, p2: np.ndarray) -> int:
    """Reference direction convention (simulator.py:503-507)."""
    return int(np.around(np.rad2deg(np.arctan2(p2[2] - p1[2], p2[0] - p1[0])))) % 360


@dataclasses.dataclass
class SceneTables:
    """Dense per-scene tables (host numpy; stacked/padded later by SceneBank)."""

    positions: np.ndarray  # (N, 3) f32
    fwd_next: np.ndarray  # (N, 4) i32, indexed by orientation//90
    neighbors: np.ndarray  # (N, 4) i32 cardinal neighbors by direction (-1 none)
    hops: np.ndarray  # (N, N) i32, UNREACHABLE if disconnected
    oracle_next: np.ndarray  # (N, N) i32, -1 when node==goal or unreachable

    @property
    def num_nodes(self) -> int:
        return self.positions.shape[0]


def build_scene_tables(graph: NavGraph) -> SceneTables:
    n = graph.num_nodes
    pos = graph.positions

    neighbors = np.full((n, 4), -1, np.int32)
    rows, cols, data = [], [], []
    for a, b in graph.edges:
        for u, v in ((a, b), (b, a)):
            d = edge_direction_deg(pos[u], pos[v])
            if d % 90 != 0:
                raise ValueError(
                    f"Edge {u}->{v} has non-cardinal direction {d}°; SoundSpaces"
                    " graphs are cardinal grids"
                )
            di = d // 90
            if neighbors[u, di] == -1:  # first match wins, like the reference's
                neighbors[u, di] = v  # neighbor-iteration break
            rows.append(u)
            cols.append(v)
            data.append(1)

    # fwd_next indexed by orientation (deg//90): same as neighbor direction
    fwd_next = neighbors.copy()

    if rows:
        adj = csr_matrix((data, (rows, cols)), shape=(n, n))
        dist = shortest_path(adj, method="D", unweighted=True, directed=True)
    else:
        dist = np.full((n, n), np.inf)
    np.fill_diagonal(dist, 0.0)
    hops = np.where(np.isinf(dist), UNREACHABLE, dist).astype(np.int32)

    # greedy next hop: cardinal neighbor minimizing remaining hops, direction
    # order 0°,90°,180°,270° as tie-break
    nb = neighbors  # (N, 4)
    valid = nb >= 0
    nb_safe = np.where(valid, nb, 0)
    nb_hops = hops[nb_safe, :]  # (N, 4, N) hops from each neighbor to each goal
    nb_hops = np.where(valid[:, :, None], nb_hops, UNREACHABLE)
    best_dir = np.argmin(nb_hops, axis=1)  # (N, N)
    oracle_next = np.take_along_axis(nb_safe[:, :, None].repeat(n, 2), best_dir[:, None, :], axis=1)[:, 0, :]
    reachable = hops < UNREACHABLE
    oracle_next = np.where(reachable & (hops > 0), oracle_next.astype(np.int32), -1)

    return SceneTables(
        positions=pos,
        fwd_next=fwd_next.astype(np.int32),
        neighbors=neighbors,
        hops=hops,
        oracle_next=oracle_next,
    )


def pad_and_stack_tables(tables: List[SceneTables]) -> Dict[str, np.ndarray]:
    """Stack per-scene tables into (S, ...) arrays padded to the max node count."""
    n_max = max(t.num_nodes for t in tables)
    s = len(tables)
    out = {
        "positions": np.zeros((s, n_max, 3), np.float32),
        "fwd_next": np.full((s, n_max, 4), -1, np.int32),
        "hops": np.full((s, n_max, n_max), UNREACHABLE, np.int32),
        "oracle_next": np.full((s, n_max, n_max), -1, np.int32),
        "num_nodes": np.zeros((s,), np.int32),
    }
    for i, t in enumerate(tables):
        n = t.num_nodes
        out["positions"][i, :n] = t.positions
        out["fwd_next"][i, :n] = t.fwd_next
        out["hops"][i, :n, :n] = t.hops
        out["oracle_next"][i, :n, :n] = t.oracle_next
        out["num_nodes"][i] = n
    return out


def load_metadata_graph(points_file: str, graph_pkl: Optional[str] = None) -> NavGraph:
    """Load a SoundSpaces metadata graph (points.txt + optional graph.pkl).

    The reference's loader is soundspaces/utils.py:16-42 (points.txt rows:
    ``index x y z``; graph.pkl a pickled networkx graph, whose node ``point``
    attributes are the positions). The pickle is read without networkx
    (``read_networkx_pickle``). When only points are available, edges are
    inferred by grid adjacency.
    """
    pts = np.loadtxt(points_file, dtype=np.float32)
    positions = pts[:, 1:4] if pts.shape[1] >= 4 else pts
    if graph_pkl is not None:
        node_attrs, edge_list = read_networkx_pickle(graph_pkl)
        nodes = sorted(node_attrs)
        index = {n: i for i, n in enumerate(nodes)}
        positions = np.array([node_attrs[n]["point"] for n in nodes], np.float32)
        edges = np.array([(index[a], index[b]) for a, b in edge_list], np.int32)
        return NavGraph(positions, edges)
    return infer_grid_graph(positions)


class _PickledGraph:
    """Takes the pickled state of a networkx graph: its node attributes
    (``_node``, ``node`` before networkx 2) and adjacency (``_adj``/``adj``;
    a directed graph's successors also as ``_succ``)."""

    directed = False

    def nodes(self) -> Dict:
        return self.__dict__["_node"] if "_node" in self.__dict__ else self.__dict__["node"]

    def adjacency(self) -> Dict:
        d = self.__dict__
        for key in ("_succ", "succ", "_adj", "adj"):
            if key in d:
                return d[key]
        raise pickle.UnpicklingError("pickled networkx graph has no adjacency")


class _PickledDiGraph(_PickledGraph):
    directed = True


_NETWORKX_GRAPHS = {"Graph": _PickledGraph, "DiGraph": _PickledDiGraph}


class _GraphUnpickler(pickle.Unpickler):
    """Maps networkx's Graph and DiGraph classes onto ``_PickledGraph``;
    refuses any other networkx class (multigraphs, views)."""

    def find_class(self, module: str, name: str):
        if module == "networkx" or module.startswith("networkx."):
            cls = _NETWORKX_GRAPHS.get(name)
            if cls is None or not module.startswith("networkx.classes"):
                raise pickle.UnpicklingError(f"unsupported networkx class in a graph pickle: {module}.{name}")
            return cls
        return super().find_class(module, name)


def read_networkx_pickle(path: str) -> Tuple[Dict, List[Tuple]]:
    """(node -> attribute dict, edge list) of a pickled networkx Graph or
    DiGraph, in networkx's own orders: nodes as inserted, and edges as
    ``G.edges()`` yields them (an undirected edge once, from the endpoint
    whose adjacency comes first)."""
    with open(path, "rb") as f:
        g = _GraphUnpickler(f).load()
    if not isinstance(g, _PickledGraph):
        raise pickle.UnpicklingError(f"{path} does not hold a networkx graph")
    edges: List[Tuple] = []
    seen = set()
    for n, nbrs in g.adjacency().items():
        for nbr in nbrs:
            if g.directed or nbr not in seen:
                edges.append((n, nbr))
        seen.add(n)
    return g.nodes(), edges


def infer_grid_graph(positions: np.ndarray, grid_size: float = 0.5) -> NavGraph:
    """Connect nodes exactly one grid step apart along X or Z."""
    n = positions.shape[0]
    edges = []
    for axis, delta in ((0, grid_size), (2, grid_size)):
        target = positions.copy()
        target[:, axis] += delta
        for i in range(n):
            diff = np.abs(positions - target[i]).sum(axis=1)
            j = int(np.argmin(diff))
            if diff[j] < 1e-4:
                edges.append((i, j))
    return NavGraph(positions, np.array(edges, np.int32) if edges else np.zeros((0, 2), np.int32))
