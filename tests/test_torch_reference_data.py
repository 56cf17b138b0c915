"""The port's reference-data ingestion (avlen_tpu_torch/data/reference.py,
sim/graph.py's networkx-free graph reader) against the JAX package's on
the fixture tree tests/data/reference_tree, bit for bit: graph positions
and edges (the port's reader against networkx), sounds, the dense RIR
tree, ``pack_rir_tree``'s and ``pack_dense_rirs``' files (each package
writing into its own temporary directory), ``HostRIRStore.gather_host``
against the dense bank and JAX's store, frame caches, episodes field by
field, and every tensor of ``build_reference_scene_bank`` with the RIRs
dense and host-served. Nothing is written under tests/data."""

import dataclasses
import os
import pickle

import networkx as nx
import numpy as np
import pytest
import torch

from avlen_tpu.data import reference as jref
from avlen_tpu_torch.data import reference as tref
from avlen_tpu_torch.sim.graph import read_networkx_pickle
from avlen_tpu_torch.sim.scene import DenseRIRBank

torch.set_num_threads(1)

ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data", "reference_tree")
SCENE_DIR = os.path.join(ROOT, "metadata", "mp3d", "sceneA")
RIR_DIR = os.path.join(ROOT, "binaural_rirs", "mp3d", "sceneA")
SOUND_DIR = os.path.join(ROOT, "sounds", "1s_all")
OBS_PKL = os.path.join(ROOT, "scene_observations", "mp3d", "sceneA.pkl")
DATA_PATH = os.path.join(ROOT, "datasets", "semantic_audionav", "v1", "train", "train.json.gz")


def ref_kwargs(**extra):
    kw = dict(
        metadata_dir=os.path.join(ROOT, "metadata", "mp3d"),
        binaural_rir_dir=os.path.join(ROOT, "binaural_rirs", "mp3d"),
        source_sound_dir=SOUND_DIR,
        data_path=DATA_PATH,
        scene_observations_dir=os.path.join(ROOT, "scene_observations", "mp3d"),
        sampling_rate=4000,
    )
    kw.update(extra)
    return kw


def test_fixture_graph_matches_networkx():
    got, want = tref.load_scene_graph(SCENE_DIR), jref.load_scene_graph(SCENE_DIR)
    np.testing.assert_array_equal(got.positions, want.positions)
    np.testing.assert_array_equal(got.edges, want.edges)
    assert got.positions.dtype == want.positions.dtype and got.edges.dtype == want.edges.dtype


@pytest.mark.parametrize("graph_type", [nx.Graph, nx.DiGraph], ids=["graph", "digraph"])
def test_graph_reader_keeps_networkx_orders(tmp_path, graph_type):
    """Nodes inserted out of order, a self loop and a repeated edge: the
    reader yields networkx's own node and edge orders."""
    rng = np.random.RandomState(0)
    g = graph_type()
    for n in (5, 2, 9, 0, 7):
        g.add_node(n, point=tuple(float(v) for v in rng.rand(3)))
    for a, b in ((5, 2), (9, 0), (2, 9), (7, 5), (0, 0), (9, 2)):
        g.add_edge(a, b)
    path = str(tmp_path / "graph.pkl")
    with open(path, "wb") as f:
        pickle.dump(g, f)
    nodes, edges = read_networkx_pickle(path)
    assert list(nodes) == list(g.nodes())
    assert {n: a["point"] for n, a in nodes.items()} == dict(g.nodes(data="point"))
    assert edges == list(g.edges())


def test_graph_reader_refuses_other_networkx_classes(tmp_path):
    path = str(tmp_path / "graph.pkl")
    with open(path, "wb") as f:
        pickle.dump(nx.MultiGraph([(0, 1)]), f)
    with pytest.raises(pickle.UnpicklingError):
        read_networkx_pickle(path)


@pytest.mark.parametrize("rate", [4000, 8000])
def test_sounds_match_jax(rate):
    names, sounds = tref.load_sound_dir(SOUND_DIR, rate)
    jnames, jsounds = jref.load_sound_dir(SOUND_DIR, rate)
    assert names == jnames
    for got, want in zip(sounds, jsounds):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("rate,max_length", [(4000, None), (8000, 300)])
def test_rir_tree_matches_jax(rate, max_length):
    got = tref.load_rir_tree([RIR_DIR], 4, max_length, rate)
    want = jref.load_rir_tree([RIR_DIR], 4, max_length, rate)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


def _same_pack(got_idx: str, want_idx: str) -> None:
    got, want = np.load(got_idx), np.load(want_idx)
    assert sorted(got.files) == sorted(want.files)
    for k in want.files:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    with open(got_idx[:-4] + ".bin", "rb") as f, open(want_idx[:-4] + ".bin", "rb") as g:
        assert f.read() == g.read()


def test_pack_rir_tree_matches_jax(tmp_path):
    os.makedirs(tmp_path / "port")
    os.makedirs(tmp_path / "jax")
    got = tref.pack_rir_tree([RIR_DIR], 4, str(tmp_path / "port" / "rirs"), sampling_rate=4000)
    want = jref.pack_rir_tree([RIR_DIR], 4, str(tmp_path / "jax" / "rirs"), sampling_rate=4000)
    _same_pack(got, want)
    assert sorted(os.listdir(tmp_path / "port")) == ["rirs.bin", "rirs.npz"]  # no temporary left


def test_pack_dense_rirs_matches_jax(tmp_path):
    rirs = np.random.RandomState(1).randn(2, 4, 3, 3, 50, 2).astype(np.float32)
    got = tref.pack_dense_rirs(rirs, str(tmp_path / "port"), 8000)
    want = jref.pack_dense_rirs(rirs, str(tmp_path / "jax"), 8000)
    _same_pack(got, want)
    store = tref.HostRIRStore(got, device="cpu")
    idx = np.random.RandomState(2).randint(0, [2, 4, 3, 3], size=(16, 4)).T
    np.testing.assert_array_equal(store.gather_host(*idx), rirs[tuple(idx)])


def test_host_store_matches_dense_and_jax(tmp_path):
    dense = tref.load_rir_tree([RIR_DIR], 4, sampling_rate=4000)
    prefix = str(tmp_path / "rirs")
    tref.pack_rir_tree([RIR_DIR], 4, prefix, sampling_rate=4000)
    store = tref.HostRIRStore(prefix + ".npz", device="cpu")
    jstore = jref.HostRIRStore(prefix + ".npz")
    assert (store.length, store.sampling_rate) == (jstore.length, jstore.sampling_rate) == (dense.shape[4], 4000)
    scene = np.zeros((8,), np.int32)
    az = np.arange(8, dtype=np.int32) % 4
    recv = np.arange(8, dtype=np.int32) % 4
    src = (np.arange(8, dtype=np.int32) * 3) % 4
    want = dense[scene, az, recv, src]
    np.testing.assert_array_equal(store.gather_host(scene, az, recv, src), want)
    np.testing.assert_array_equal(store.gather_host(scene, az, recv, src),
                                  jstore.gather_host(scene, az, recv, src))
    # the per-step entry: index tensors in, a tensor on the store's device out
    t = [torch.as_tensor(x, dtype=torch.long) for x in (scene, az, recv, src)]
    got = store.gather(*t)
    assert got.dtype == torch.float32 and got.device.type == "cpu"
    np.testing.assert_array_equal(got.numpy(), want)
    # as the dense bank serves them
    np.testing.assert_array_equal(DenseRIRBank(torch.as_tensor(dense)).gather(*t).numpy(), want)


def test_host_store_zero_fills_missing_pairs(tmp_path):
    """A pair absent from the tree reads zeros, also into a reused buffer."""
    tree = tmp_path / "sceneA"
    for az in (0, 90, 180, 270):
        os.makedirs(tree / str(az))
        for f in os.listdir(os.path.join(RIR_DIR, str(az))):
            if f != "1_2.wav":
                with open(os.path.join(RIR_DIR, str(az), f), "rb") as src:
                    (tree / str(az) / f).write_bytes(src.read())
    prefix = str(tmp_path / "rirs")
    tref.pack_rir_tree([str(tree)], 4, prefix, sampling_rate=4000)
    jref.pack_rir_tree([str(tree)], 4, str(tmp_path / "jrirs"), sampling_rate=4000)
    _same_pack(prefix + ".npz", str(tmp_path / "jrirs.npz"))
    store = tref.HostRIRStore(prefix + ".npz", device="cpu")
    out = np.full((2, store.length, 2), 7.0, np.float32)
    got = store.gather_host([0, 0], [1, 1], [1, 0], [2, 1], out=out)
    assert got is out and not got[0].any()
    np.testing.assert_array_equal(got[1], jref.HostRIRStore(prefix + ".npz").gather_host(0, 1, 0, 1)[0])


def test_frame_cache_matches_jax():
    for got, want in zip(tref.load_frame_cache(OBS_PKL, 4), jref.load_frame_cache(OBS_PKL, 4)):
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    # padding nodes beyond the cache's are zeros, instance ids int32
    _, _, sem = tref.load_frame_cache(OBS_PKL, 6)
    assert sem.dtype == np.int32 and not sem[4:].any()


def test_episodes_match_jax():
    graphs = {"sceneA": tref.load_scene_graph(SCENE_DIR)}
    names, _ = tref.load_sound_dir(SOUND_DIR, 4000)
    got = tref.load_reference_episodes(DATA_PATH, graphs, names)
    want = jref.load_reference_episodes(DATA_PATH, {"sceneA": jref.load_scene_graph(SCENE_DIR)}, names)
    assert len(got) == len(want) == 3
    for e, w in zip(got, want):
        assert dataclasses.asdict(e) == dataclasses.asdict(w)
    # the content-shard filter
    only = tref.load_reference_episodes(DATA_PATH, graphs, names, content_scenes=["other"])
    assert [e.episode_id for e in only] == ["0"]


@pytest.fixture(scope="module", params=["dense", "host"])
def banks(request, tmp_path_factory):
    tmp = tmp_path_factory.mktemp(request.param)
    extra = dict(dense_rir_max_bytes=0) if request.param == "host" else {}
    bank, tables, eps = tref.build_reference_scene_bank(
        tref.ReferenceDataConfig(**ref_kwargs(rir_pack_dir=str(tmp / "port"), **extra)), device="cpu")
    jbank, jtables, jeps = jref.build_reference_scene_bank(
        jref.ReferenceDataConfig(**ref_kwargs(rir_pack_dir=str(tmp / "jax"), **extra)))
    return request.param, (bank, tables, eps), (jbank, jtables, jeps)


def _same(got: torch.Tensor, want, what: str) -> None:
    want = np.asarray(want)
    assert got.device.type == "cpu", what
    assert got.numpy().dtype == want.dtype, what
    np.testing.assert_array_equal(got.numpy(), want, err_msg=what)


def test_scene_bank_matches_jax(banks):
    kind, (bank, tables, eps), (jbank, jtables, jeps) = banks
    assert set(bank.tables) == set(jbank.tables)
    for k, v in jbank.tables.items():
        _same(bank.tables[k], v, k)
    for f in ("sounds_padded", "sound_secs", "rgb", "depth", "semantic", "semantic_instance_to_mp3d"):
        _same(getattr(bank, f), getattr(jbank, f), f)
    np.testing.assert_array_equal(bank.semantic_instance_to_mp3d.numpy()[0], [3, 25, 3])
    assert (bank.grid_size, bank.sampling_rate, bank.num_categories) == (
        jbank.grid_size, jbank.sampling_rate, jbank.num_categories)
    assert bank.sound_names == jbank.sound_names
    assert bank.rir.length == jbank.rir.length == 200
    if kind == "dense":
        assert isinstance(bank.rir, DenseRIRBank)
        _same(bank.rir.rirs, jbank.rir.rirs, "rirs")
    else:
        assert isinstance(bank.rir, tref.HostRIRStore) and isinstance(jbank.rir, jref.HostRIRStore)
        _same_pack(bank.rir.index_path, os.path.join(os.path.dirname(jbank.rir._data.filename), "rirs.npz"))
    assert [dataclasses.asdict(e) for e in eps] == [dataclasses.asdict(e) for e in jeps]
    for t, j in zip(tables, jtables):
        for f in dataclasses.fields(j):
            np.testing.assert_array_equal(np.asarray(getattr(t, f.name)), np.asarray(getattr(j, f.name)))


def test_pack_is_reused(tmp_path):
    """A pack directory that already holds an index is read, not rewritten."""
    cfg = tref.ReferenceDataConfig(**ref_kwargs(rir_pack_dir=str(tmp_path), dense_rir_max_bytes=0))
    first, _, _ = tref.build_reference_scene_bank(cfg, device="cpu")
    before = os.stat(tmp_path / "rirs.bin").st_mtime_ns
    again, _, _ = tref.build_reference_scene_bank(cfg, device="cpu")
    assert os.stat(tmp_path / "rirs.bin").st_mtime_ns == before
    assert again.rir.index_path == first.rir.index_path == str(tmp_path / "rirs.npz")


def test_instance_map_without_house_file_is_identity(tmp_path):
    cfg = dict(metadata_dir=str(tmp_path), binaural_rir_dir="", source_sound_dir="", data_path="")
    got = tref._scene_instance_to_mp3d(tref.ReferenceDataConfig(**cfg), "sceneA")
    want = jref._scene_instance_to_mp3d(jref.ReferenceDataConfig(**cfg), "sceneA")
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)
    house = tref._scene_instance_to_mp3d(tref.ReferenceDataConfig(**dict(cfg, metadata_dir=os.path.dirname(SCENE_DIR))),
                                         "sceneA")
    np.testing.assert_array_equal(house, [3, 25, 3])
