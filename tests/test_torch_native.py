"""The port's native host layer against the JAX package's: the graph engine
call by call (same source, same flags, so integers, float32 headings and
positions are exact), the frame server's files and gathers byte for byte
both ways, and the g++ build's atomic install under concurrent builds."""

import os
import subprocess
import sys
import textwrap

import numpy as np
import pytest
import torch

from avlen_tpu.native.frame_server import FrameServer as JaxFrameServer
from avlen_tpu.native.frame_server import write_frame_bank as jax_write_frame_bank
from avlen_tpu.native.graph_engine import GraphEngine as JaxGraphEngine
from avlen_tpu_torch.native import build as native_build
from avlen_tpu_torch.native.frame_server import MAGIC, FrameServer, write_frame_bank
from avlen_tpu_torch.native.graph_engine import GraphEngine
from avlen_tpu_torch.sim.synthetic import make_grid_scene

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(1)


def build_jax_native():
    """The JAX package's libraries from its own sources and flags, into its
    own build directory, as its ``build_native`` makes them, but each
    compiled to a per-process temporary file and renamed into place: its
    build writes the library in place, and parallel test workers must not
    load a half-written one. Skips what its build would skip."""
    from avlen_tpu.native import build as jax_build

    os.makedirs(jax_build._BUILD_DIR, exist_ok=True)
    for name, src in jax_build.SOURCES.items():
        src, out = os.path.join(jax_build._THIS_DIR, src), jax_build.native_lib_path(name)
        if os.path.exists(out) and os.path.getmtime(out) >= os.path.getmtime(src):
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        subprocess.run(["g++", "-O2", "-shared", "-fPIC", "-std=c++17", src, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, out)


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    build_jax_native()


def _both():
    return GraphEngine(), JaxGraphEngine()


def _same(got, want):
    if isinstance(want, tuple):
        assert len(got) == len(want)
        for g, w in zip(got, want):
            _same(g, w)
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
    else:
        assert got == want


def _random_geometric_scene(rng, n=40, k=3):
    """tests/test_graph_viewpoint.py's non-grid graph: kNN edges + a chain."""
    pos = rng.uniform(-10, 10, size=(n, 3)).astype(np.float32)
    pos[:, 1] = 0.0
    edges = set()
    for u in range(n):
        d = np.linalg.norm(pos - pos[u], axis=1)
        for v in np.argsort(d)[1 : k + 1]:
            edges.add((min(u, int(v)), max(u, int(v))))
    order = rng.permutation(n)
    for a, b in zip(order[:-1], order[1:]):
        edges.add((min(int(a), int(b)), max(int(a), int(b))))
    return pos, np.array(sorted(edges), np.int32)


def test_grid_engine_matches_jax_call_by_call():
    """tests/test_native.py's cases: hops, turns and forward moves, oracle
    actions replayed, shortest paths."""
    rng = np.random.RandomState(0)
    graph = make_grid_scene(rng, side=6, hole_frac=0.15)
    engines = _both()
    sids = [e.add_scene(graph.positions, graph.edges) for e in engines]
    assert sids[0] == sids[1] == 0 and engines[0].num_scenes == engines[1].num_scenes == 1
    n = graph.num_nodes
    hops = [[e.hops(0, a, b) for a in range(n) for b in range(n)] for e in engines]
    assert hops[0] == hops[1]

    calls = [
        ("new_episode", ([0, 0], [0, n - 1], [0, 1])), ("make_action", ([2, 3],)), ("get_state", ()),
        ("new_episode", ([0], [0], [0])), ("make_action", ([1],)), ("get_state", ()),
    ]
    pick = np.random.RandomState(1)
    for _ in range(5):
        a, b, rot = pick.randint(n), pick.randint(n), pick.randint(4)
        calls.append(("oracle_actions", (0, a, rot, b)))
        calls.append(("shortest_path", (0, a, b)))
    for name, args in calls:
        _same(getattr(engines[0], name)(*args), getattr(engines[1], name)(*args))
    for a, b in [(0, n - 1), (n // 2, 0)]:
        acts = engines[1].oracle_actions(0, a, 2, b)
        for e in engines:
            e.new_episode([0], [a], [2])
        for act in acts[:-1]:
            _same(engines[0].make_action([act]), engines[1].make_action([act]))
            _same(engines[0].get_state(), engines[1].get_state())


def test_grid_engine_random_walk_matches_jax():
    """A seeded make_grid_scene world, 8 episodes x 200 random actions
    through make_action/get_state: collisions, nodes, rotations and float32
    positions exact."""
    rng = np.random.RandomState(7)
    graphs = [make_grid_scene(rng, side=8) for _ in range(2)]
    engines = _both()
    for e in engines:
        for g in graphs:
            e.add_scene(g.positions, g.edges)
    scenes = rng.randint(2, size=8)
    nodes = [rng.randint(graphs[s].num_nodes) for s in scenes]
    rots = rng.randint(4, size=8)
    for e in engines:
        e.new_episode(scenes, nodes, rots)
    _same(engines[0].get_state(), engines[1].get_state())
    for _ in range(200):
        acts = rng.randint(4, size=8)
        _same(engines[0].make_action(acts), engines[1].make_action(acts))
        _same(engines[0].get_state(), engines[1].get_state())


def test_viewpoint_engine_matches_jax_call_by_call():
    """tests/test_graph_viewpoint.py's cases on both engines: hops and
    shortest paths on a non-grid graph, navigable locations and relative
    headings, moves, turns and invalid moves, grid and viewpoint scenes
    side by side."""
    engines = _both()
    pos, edges = _random_geometric_scene(np.random.RandomState(0))
    sids = [e.add_scene_viewpoint(pos, edges) for e in engines]
    assert sids[0] == sids[1]
    n = len(pos)
    assert [[engines[0].vp_hops(sids[0], a, b) for b in range(n)] for a in range(n)] == \
        [[engines[1].vp_hops(sids[1], a, b) for b in range(n)] for a in range(n)]
    for a, b in [(0, 17), (5, 29), (12, 3), (22, 22), (1, 39)]:
        _same(engines[0].vp_shortest_path(sids[0], a, b), engines[1].vp_shortest_path(sids[1], a, b))

    star = np.array([[0, 0, 0], [1, 0, 0], [0, 0, 1], [-1, 0, 0], [0, 0, -1]], np.float32)
    star_edges = np.array([[0, 1], [0, 2], [0, 3], [0, 4]], np.int32)
    line = np.array([[0, 0, 0], [2, 0, 0], [2, 0, 2]], np.float32)
    line_edges = np.array([[0, 1], [1, 2]], np.int32)
    grid = np.array([[0, 0, 0], [1, 0, 0]], np.float32)
    for e in engines:
        assert (e.add_scene_viewpoint(star, star_edges), e.add_scene_viewpoint(line, line_edges)) == (1, 2)
        assert e.add_scene(grid, np.array([[0, 1]], np.int32)) == 0
    headings = np.random.RandomState(3).uniform(-360, 720, size=12).astype(np.float32)
    calls = [("vp_new_episode", ([1] * 12, [0] * 12, headings))]
    calls += [("vp_navigable", (i,)) for i in range(12)]
    calls += [("vp_new_episode", ([2, 2], [0, 0], [0.0, 0.0])), ("vp_make_action", ([1, 0], [0.0, 45.0])),
              ("vp_get_state", ()), ("vp_make_action", ([1, 0], [0.0, 0.0])), ("vp_get_state", ()),
              ("vp_navigable", (0,)), ("vp_make_action", ([9, 0], [0.0, 0.0])), ("vp_get_state", ()),
              ("hops", (0, 0, 1)), ("vp_hops", (sids[0], 0, 0)), ("shortest_path", (0, 1, 0))]
    for name, args in calls:
        _same(getattr(engines[0], name)(*args), getattr(engines[1], name)(*args))


def test_viewpoint_walk_matches_jax():
    """100 random navigable moves and turns on the non-grid graph: invalid
    flags, nodes, float32 headings and positions exact."""
    rng = np.random.RandomState(5)
    pos, edges = _random_geometric_scene(rng, n=30)
    engines = _both()
    for e in engines:
        sid = e.add_scene_viewpoint(pos, edges)
        e.vp_new_episode([sid] * 4, [0, 7, 13, 29], [0.0, 90.0, 200.0, -30.0])
    for _ in range(100):
        idx = rng.randint(0, 5, size=4)
        dh = rng.uniform(-90, 90, size=4).astype(np.float32)
        _same(engines[0].vp_make_action(idx, dh), engines[1].vp_make_action(idx, dh))
        _same(engines[0].vp_get_state(), engines[1].vp_get_state())


def test_vp_shortest_path_truncation_matches_jax():
    """tests/test_advice_r3.py:78-93: a truncated path is [], not a prefix."""
    n = 6
    positions = np.stack([np.arange(n, dtype=np.float32), np.zeros(n, np.float32), np.zeros(n, np.float32)], 1)
    edges = np.array([[i, i + 1] for i in range(n - 1)], np.int32)
    for e in _both():
        sid = e.add_scene_viewpoint(positions, edges)
        assert e.vp_shortest_path(sid, 0, n - 1) == list(range(n))
        assert e.vp_shortest_path(sid, 0, n - 1, max_len=3) == []


@pytest.mark.parametrize("dtype", [np.uint8, np.uint16])
def test_frame_banks_byte_equal_both_ways(tmp_path, dtype):
    """Either package's write_frame_bank writes the other's bytes, and each
    package's server gathers the same frames from either file."""
    rng = np.random.RandomState(0)
    frames = rng.randint(0, np.iinfo(dtype).max, (7, 4, 8, 6, 3)).astype(dtype)
    ours, theirs = str(tmp_path / "port.avlf"), str(tmp_path / "jax.avlf")
    write_frame_bank(ours, frames)
    jax_write_frame_bank(theirs, frames)
    with open(ours, "rb") as f, open(theirs, "rb") as g:
        data = f.read()
        assert data == g.read()
    assert int(np.frombuffer(data[:4], "<i4")[0]) == MAGIC
    nodes = np.array([0, 3, 6, 6, 1], np.int32)
    rots = np.array([1, 0, 3, 2, 0], np.int32)
    for path in (ours, theirs):
        srv, ref = FrameServer(path, dtype=dtype), JaxFrameServer(path, dtype=dtype)
        assert (srv.n, srv.a, srv.itemsize, srv.frame_shape) == (ref.n, ref.a, ref.itemsize, ref.frame_shape)
        got = srv.gather(nodes, rots)
        assert got.dtype == np.dtype(dtype)
        assert got.tobytes() == ref.gather(nodes, rots).tobytes()
        np.testing.assert_array_equal(got, frames[nodes, rots])
        srv.close()
        ref.close()
    with pytest.raises(IOError):
        FrameServer(str(tmp_path / "absent.avlf"))


def test_out_of_range_ids_raise_before_the_library(tmp_path):
    """The C side indexes unchecked (JAX's bindings pass such ids on, and an
    unknown scene crashes the process): the port's bindings raise."""
    e = GraphEngine()
    grid = e.add_scene(np.array([[0, 0, 0], [1, 0, 0]], np.float32), np.array([[0, 1]], np.int32))
    vp = e.add_scene_viewpoint(np.zeros((3, 3), np.float32) + np.arange(3)[:, None], np.array([[0, 1], [1, 2]]))
    bad = [lambda: e.hops(grid + 1, 0, 1), lambda: e.hops(grid, 0, 2), lambda: e.shortest_path(grid, -1, 0),
           lambda: e.oracle_actions(grid, 0, 0, 5), lambda: e.new_episode([0, 1], [0, 0], [0, 0]),
           lambda: e.new_episode([0], [2], [0]), lambda: e.vp_hops(vp + 1, 0, 0), lambda: e.vp_shortest_path(vp, 0, 3),
           lambda: e.vp_new_episode([vp], [3], [0.0]), lambda: e.vp_navigable(0)]
    for call in bad:
        with pytest.raises(IndexError):
            call()
    e.new_episode([grid], [1], [0])
    with pytest.raises(IndexError):
        e.make_action([1, 1])
    e.vp_new_episode([vp, vp], [0, 2], [0.0, 90.0])
    assert len(e.vp_navigable(1)[0]) == 2
    with pytest.raises(IndexError):
        e.vp_navigable(2)
    with pytest.raises(IndexError):
        e.vp_make_action([1], [0.0])
    write_frame_bank(str(tmp_path / "b.avlf"), np.zeros((3, 4, 2, 2, 1), np.uint8))
    srv = FrameServer(str(tmp_path / "b.avlf"))
    for nodes, rots in (([3], [0]), ([0], [4]), ([-1], [0]), ([0, 1], [0])):
        with pytest.raises(IndexError):
            srv.gather(nodes, rots)
    assert srv.gather([2], [3]).shape == (1, 2, 2, 1)
    srv.close()


_BUILD_AND_LOAD = textwrap.dedent("""
    import sys, time
    from pathlib import Path
    import numpy as np
    from avlen_tpu_torch.native import build
    build.BUILD_DIR = Path(sys.argv[1])
    while time.time() < float(sys.argv[2]):
        time.sleep(0.005)
    from avlen_tpu_torch.native.graph_engine import GraphEngine
    build.load_library("frame_server").fs_open
    e = GraphEngine()
    sid = e.add_scene(np.array([[0, 0, 0], [1, 0, 0]], np.float32), np.array([[0, 1]], np.int32))
    print(e.hops(sid, 0, 1), build.native_lib_path("graph_engine"))
""")


def test_concurrent_builds_into_a_fresh_dir_load_good_libraries(tmp_path):
    """Two processes build both libraries into one empty directory at the
    same moment: each loads a working library, only the hashed names remain
    (no temporary file), and the names carry the sources' hash."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    import time

    start = str(time.time() + 2.0)
    procs = [subprocess.Popen([sys.executable, "-c", _BUILD_AND_LOAD, str(tmp_path), start], cwd=REPO, env=env,
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    for p, (out, err) in zip(procs, outs):
        assert p.returncode == 0, err
        hops, path = out.split()
        assert hops == "1" and os.path.dirname(path) == str(tmp_path)
    names = sorted(os.listdir(tmp_path))
    assert names == sorted(os.path.basename(native_build.native_lib_path(t)) for t in native_build.SOURCES)


def test_failed_compile_raises_with_the_compiler_output(tmp_path, monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("int f( {\n")
    monkeypatch.setattr(native_build, "SRC_DIR", tmp_path)
    monkeypatch.setattr(native_build, "BUILD_DIR", tmp_path / "out")
    monkeypatch.setitem(native_build.SOURCES, "broken", "broken.cpp")
    with pytest.raises(RuntimeError, match="(?s)g\\+\\+ failed for broken.*error"):
        native_build.build_native("broken")
    assert not any(p.suffix == ".so" for p in (tmp_path / "out").iterdir())
