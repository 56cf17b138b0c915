"""VLN alignment in the port (``avlen_tpu_torch/data/vln.py``) against the
JAX package's on tests/test_vln_alignment.py's fabricated, format-exact
FGR2R / VLN-CE / MatterSim-connectivity world: every public function gives
the same values (floats bit for bit: the viewpoint search runs in each
package's build of the same engine source), the written
``content/{scan}.json.gz`` decodes to the same text, and each package's
``load_reference_episodes`` of it gives the same episodes, at both
``min_path_len`` settings of the JAX tests. The ``generate_vln_episodes``
CLI, ``--from-r2r`` and synthetic, writes what the repo's script writes."""

import dataclasses
import gzip
import json
import os
import pickle
import runpy
import sys

import numpy as np
import pytest
import torch

from avlen_tpu.data import reference as jref
from avlen_tpu.data import vln as jvln
from avlen_tpu.native.graph_engine import GraphEngine as JaxGraphEngine
from avlen_tpu_torch.data import reference, vln
from avlen_tpu_torch.native.graph_engine import GraphEngine
from avlen_tpu_torch.scripts import generate_vln_episodes
from avlen_tpu_torch.sim.graph import NavGraph
from tests.test_torch_native import build_jax_native
from tests.test_vln_alignment import SCAN, _graph, _write_fixtures

torch.set_num_threads(1)


REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# tests/test_vln_alignment.py's two settings: the reference's bar (5 episodes
# after sampling) and a lowered one (both sub-instructions, 14 episodes)
MIN_PATH_LEN = {"reference_bar": (7, 5), "lowered": (4, 100)}


@pytest.fixture(scope="module", autouse=True)
def _jax_native():
    build_jax_native()


def _port_graph(g) -> NavGraph:
    return NavGraph(positions=g.positions.copy(), edges=g.edges.copy())


def _same(got, want, where="value"):
    """Equal structure and values, floats bit for bit; dataclasses by field."""
    if dataclasses.is_dataclass(want):
        assert type(got).__name__ == type(want).__name__, where
        for f in dataclasses.fields(want):
            _same(getattr(got, f.name), getattr(want, f.name), f"{where}.{f.name}")
    elif isinstance(want, dict):
        assert list(got) == list(want), where
        for k in want:
            _same(got[k], want[k], f"{where}[{k!r}]")
    elif isinstance(want, (list, tuple)):
        assert type(got) is type(want) and len(got) == len(want), where
        for i, (g, w) in enumerate(zip(got, want)):
            _same(g, w, f"{where}[{i}]")
    elif isinstance(want, np.ndarray):
        assert got.dtype == want.dtype and got.shape == want.shape, where
        np.testing.assert_array_equal(got, want, err_msg=where)
    else:
        assert type(got) is type(want) and got == want, f"{where}: {got!r} != {want!r}"


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    graph, conn_dir, fgr2r_path, vlnce_path, nav_dir = _write_fixtures(tmp_path_factory.mktemp("vln"))
    conn_path = os.path.join(conn_dir, f"{SCAN}_connectivity.json")
    with open(fgr2r_path) as f:
        items = json.load(f)
    with gzip.open(vlnce_path, "rt") as f:
        vlnce = json.load(f)["episodes"]
    return dict(graph=graph, conn_dir=conn_dir, conn_path=conn_path, fgr2r=fgr2r_path, vlnce=vlnce_path,
                nav_dir=nav_dir, items=items, vlnce_eps=vlnce)


def test_connectivity_view2node_and_headings_match_jax(world):
    conn, jconn = vln.load_connectivity(world["conn_path"]), jvln.load_connectivity(world["conn_path"])
    _same(conn, jconn, "connectivity")
    graph = _port_graph(world["graph"])
    _same(vln.build_view2node(conn, graph), jvln.build_view2node(jconn, world["graph"]), "view2node")
    far = conn.positions[0] + np.array([0, 5.0, 0], np.float32)
    for c in (conn, jconn):
        c.view_ids.append("vfar")
        c.positions = np.concatenate([c.positions, far[None]], 0)
    v2n = vln.build_view2node(conn, graph)
    _same(v2n, jvln.build_view2node(jconn, world["graph"]), "view2node+far")
    assert v2n["vfar"] is None

    conn, jconn = vln.load_connectivity(world["conn_path"]), jvln.load_connectivity(world["conn_path"])
    adjusted = vln.adjust_fgr2r_headings(world["items"], {SCAN: conn})
    _same(adjusted, jvln.adjust_fgr2r_headings(world["items"], {SCAN: jconn}), "adjusted")
    np.testing.assert_allclose(adjusted[0]["all_headings"][5:], np.pi, atol=1e-4)  # the turn
    engine, jengine = GraphEngine(), JaxGraphEngine()
    sid = engine.add_scene_viewpoint(conn.positions, conn.edges)
    jsid = jengine.add_scene_viewpoint(jconn.positions, jconn.edges)
    path = world["items"][0]["path"]
    for start in (0.0, 1.0, np.pi / 2, 4.0):  # direct calls from other start headings
        _same(vln.adjust_headings(engine, sid, conn, path, start),
              jvln.adjust_headings(jengine, jsid, jconn, path, start), f"headings from {start}")


def test_matching_and_approximation_match_jax(world):
    conn, jconn = vln.load_connectivity(world["conn_path"]), jvln.load_connectivity(world["conn_path"])
    adjusted = vln.adjust_fgr2r_headings(world["items"], {SCAN: conn})
    jadjusted = jvln.adjust_fgr2r_headings(world["items"], {SCAN: jconn})
    matched = vln.match_fgr2r_to_vlnce(adjusted, world["vlnce_eps"])
    jmatched = jvln.match_fgr2r_to_vlnce(jadjusted, world["vlnce_eps"])
    _same(matched, jmatched, "matched")
    assert len(matched) == 2 and isinstance(world["items"][0]["new_instructions"], str)  # literal_eval'd
    graph = _port_graph(world["graph"])
    approx = vln.approximate_in_soundspace(matched, vln.build_view2node(conn, graph), graph)
    _same(approx, jvln.approximate_in_soundspace(jmatched, jvln.build_view2node(jconn, world["graph"]),
                                                 world["graph"]), "approx")
    assert [a["path_node"] for a in approx] == [[0, 1, 2, 3, 4], [4, 5, 6, 7]]


@pytest.mark.parametrize("case", list(MIN_PATH_LEN))
def test_generate_dialog_episodes_match_jax(world, case):
    min_len, per_item = MIN_PATH_LEN[case]
    conn = vln.load_connectivity(world["conn_path"])
    graph = _port_graph(world["graph"])
    approx = vln.approximate_in_soundspace(
        vln.match_fgr2r_to_vlnce(vln.adjust_fgr2r_headings(world["items"], {SCAN: conn}), world["vlnce_eps"]),
        vln.build_view2node(conn, graph), graph)
    with gzip.open(os.path.join(world["nav_dir"], "content", f"{SCAN}.json.gz"), "rt") as f:
        nav = json.load(f)["episodes"]
    for seed in (0, 3):
        got = vln.generate_dialog_episodes(approx, nav, graph, min_path_len=min_len, max_per_item=per_item, seed=seed)
        _same(got, jvln.generate_dialog_episodes(approx, nav, world["graph"], min_path_len=min_len,
                                                 max_per_item=per_item, seed=seed), f"episodes seed {seed}")
        assert len(got) == (5 if case == "reference_bar" else 14)


@pytest.mark.parametrize("case", list(MIN_PATH_LEN))
def test_generate_dialog_dataset_matches_jax(world, tmp_path, case):
    """The written shard decodes to JAX's text (floats written alike), the
    split stub is JAX's, and both packages ingest the tree alike."""
    min_len, per_item = MIN_PATH_LEN[case]
    outs = {}
    for name, mod, graph in (("port", vln, _port_graph(world["graph"])), ("jax", jvln, world["graph"])):
        out = str(tmp_path / name / "train")
        counts = mod.generate_dialog_dataset(
            fgr2r_path=world["fgr2r"], vlnce_paths=[world["vlnce"]], connectivity_dir=world["conn_dir"],
            scene_graphs={SCAN: graph}, audionav_dataset_dir=world["nav_dir"], output_dir=out,
            min_path_len=min_len, max_per_item=per_item)
        outs[name] = (out, counts)
    (out, counts), (jout, jcounts) = outs["port"], outs["jax"]
    assert counts == jcounts == {SCAN: 5 if case == "reference_bar" else 14}
    for rel in (os.path.join("content", f"{SCAN}.json.gz"), "dataset.json.gz"):
        with gzip.open(os.path.join(out, rel), "rb") as f, gzip.open(os.path.join(jout, rel), "rb") as g:
            assert f.read() == g.read(), rel

    episodes = reference.load_reference_episodes(os.path.join(out, "dataset.json.gz"),
                                                 {SCAN: _port_graph(world["graph"])}, sound_names=["telephone.wav"])
    jepisodes = jref.load_reference_episodes(os.path.join(jout, "dataset.json.gz"), {SCAN: world["graph"]},
                                             sound_names=["telephone.wav"])
    _same(episodes, jepisodes, "ingested")
    assert {(e.start_node, e.start_rot_idx, e.goal_node, e.dialog_node) for e in episodes[:5]} == {(0, 1, 7, 4)}


def _write_metadata(root: str, graph) -> str:
    """points.txt + a networkx graph.pkl of ``graph`` for one scan, as
    tests/data/make_reference_fixtures.py writes them."""
    import networkx as nx

    meta = os.path.join(root, SCAN)
    os.makedirs(meta)
    rows = [[i, p[0], -p[2], p[1] + 1.5] for i, p in enumerate(graph.positions)]
    np.savetxt(os.path.join(meta, "points.txt"), np.array(rows), delimiter="\t")
    g = nx.Graph()
    for i, p in enumerate(graph.positions):
        g.add_node(i, point=tuple(float(v) for v in p))
    g.add_edges_from(map(tuple, graph.edges.tolist()))
    with open(os.path.join(meta, "graph.pkl"), "wb") as f:
        pickle.dump(g, f)
    return root


@pytest.mark.parametrize("case", list(MIN_PATH_LEN))
def test_cli_from_r2r_matches_the_repo_script(world, tmp_path, monkeypatch, capsys, case):
    meta = _write_metadata(str(tmp_path / "metadata"), _graph())
    common = ["--from-r2r", "--fgr2r", world["fgr2r"], "--vlnce", world["vlnce"], "--connectivity-dir",
              world["conn_dir"], "--metadata-dir", meta, "--audionav-dir", world["nav_dir"],
              "--min-path-len", str(MIN_PATH_LEN[case][0])]
    generate_vln_episodes.main(common + ["--output-dir", str(tmp_path / "port")])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["generate_vln_episodes.py", *common, "--output-dir", str(tmp_path / "jax")])
    runpy.run_path(os.path.join(REPO, "scripts", "generate_vln_episodes.py"), run_name="__main__")
    assert out.replace("port", "jax") == capsys.readouterr().out
    rel = os.path.join("content", f"{SCAN}.json.gz")
    with gzip.open(tmp_path / "port" / rel, "rb") as f, gzip.open(tmp_path / "jax" / rel, "rb") as g:
        assert f.read() == g.read()
    # the CLI keeps the default max_per_item 5: 5 per sub-instruction at most
    assert f"{5 if case == 'reference_bar' else 10} dialog episodes" in out


def test_cli_synthetic_mode_matches_the_repo_script(tmp_path, monkeypatch, capsys):
    args = ["--episodes", "24", "--scenes", "2", "--side", "5", "--seed", "2"]
    generate_vln_episodes.main(["--output", str(tmp_path / "port.json.gz"), *args])
    out = capsys.readouterr().out
    monkeypatch.setattr(sys, "argv", ["generate_vln_episodes.py", "--output", str(tmp_path / "jax.json.gz"), *args])
    runpy.run_path(os.path.join(REPO, "scripts", "generate_vln_episodes.py"), run_name="__main__")
    assert out.replace("port", "jax") == capsys.readouterr().out
    with gzip.open(tmp_path / "port.json.gz", "rb") as f, gzip.open(tmp_path / "jax.json.gz", "rb") as g:
        got, want = f.read(), g.read()
    assert got == want
    eps = json.loads(got)["episodes"]
    assert len(eps) == 24 and all(e["sub_instr"] for e in eps)
