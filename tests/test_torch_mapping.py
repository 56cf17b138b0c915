"""The port's AV-WAN mapping ops against the JAX package's on the CPU, on
numpy-seeded inputs: ``depth_to_egomap`` (0/1 maps exact, at the
sensor's geometry and the mapper's), ``_rot90_batch`` over every k in
-5..5, ``register_egomap`` and ``egocentric_crop`` over all four
rotations (the crop passes -rot, so k is negative there) at map edges,
``distance_field`` exact (integers in f32, 1e6 where unreached or
blocked), and ``next_action_from_field`` exact, ties and the 180° turn
among its cases; then the env's ``egomap`` sensor against the JAX env's
over the same world."""

import numpy as np
import pytest
import torch

from avlen_tpu.ops import mapping as jm
from avlen_tpu_torch.ops import mapping as tm

torch.set_num_threads(1)


def _t(x):
    return torch.tensor(np.asarray(x))


def _depths(rng, b=4, h=16, w=16):
    """Depth frames in [0, 1]: a near wall, open floor, the far clip and
    the near clip, so that every branch of the projection is taken."""
    d = rng.rand(b, h, w, 1).astype(np.float32)
    d[0] = 0.05  # closer than 0.1 m × 10 → invalid
    d[1, :, : w // 2] = 1.0  # beyond 0.99 of max depth → invalid
    d[2] = rng.uniform(0.02, 0.2, (h, w, 1))  # near wall
    return d


@pytest.mark.parametrize("map_size,resolution", [(31, 0.5), (15, 0.5), (9, 0.25)])
def test_depth_to_egomap_matches_jax(map_size, resolution):
    depth = _depths(np.random.RandomState(map_size))
    want = np.asarray(jm.depth_to_egomap(depth, map_size=map_size, resolution=resolution))
    got = tm.depth_to_egomap(_t(depth), map_size=map_size, resolution=resolution).numpy()
    assert got.shape == (4, map_size, map_size, 2)
    assert 0 < want.sum() < want.size  # both values present
    np.testing.assert_array_equal(got, want)


def test_rot90_batch_matches_jax_for_every_k():
    rng = np.random.RandomState(1)
    m = rng.rand(11, 5, 5, 2).astype(np.float32)
    k = np.arange(-5, 6, dtype=np.int32)
    np.testing.assert_array_equal(tm._rot90_batch(_t(m), _t(k).long()).numpy(),
                                  np.asarray(jm._rot90_batch(m, k)))


def _poses(g):
    """(row, col, rot) for each of the four rotations at the centre, and at
    cells whose window crosses each edge."""
    rows = np.array([g // 2, 1, g - 2, 0, g // 2, 2, g - 1, g // 2], np.int32)
    cols = np.array([g // 2, g - 2, 1, g // 2, 0, g - 1, 3, g // 2], np.int32)
    rots = np.array([0, 1, 2, 3, 1, 2, 3, 0], np.int32)
    return rows, cols, rots


def test_register_egomap_matches_jax_over_all_rotations():
    g, e = 21, 7
    rng = np.random.RandomState(2)
    rows, cols, rots = _poses(g)
    b = rows.shape[0]
    allo = (rng.rand(b, g, g, 2) > 0.8).astype(np.float32)
    ego = (rng.rand(b, e, e, 2) > 0.5).astype(np.float32)
    want = np.asarray(jm.register_egomap(allo, ego, rows, cols, rots))
    got = tm.register_egomap(_t(allo), _t(ego), *(_t(x).long() for x in (rows, cols, rots))).numpy()
    np.testing.assert_array_equal(got, want)
    assert (want != allo).any()


@pytest.mark.parametrize("size", [9, 20])
def test_egocentric_crop_matches_jax_over_all_rotations(size):
    g = 21
    rng = np.random.RandomState(size)
    rows, cols, rots = _poses(g)
    allo = rng.rand(rows.shape[0], g, g, 2).astype(np.float32)
    want = np.asarray(jm.egocentric_crop(allo, rows, cols, rots, size))
    got = tm.egocentric_crop(_t(allo), *(_t(x).long() for x in (rows, cols, rots)), size).numpy()
    np.testing.assert_array_equal(got, want)


def test_distance_field_and_next_action_match_jax():
    g, b = 24, 8
    rng = np.random.RandomState(3)
    occ = (rng.rand(b, g, g) > 0.75).astype(np.float32)
    occ[0] = 0.0  # open grid: many equal neighbours (argmin takes the first)
    goal_r = rng.randint(0, g, b).astype(np.int32)
    goal_c = rng.randint(0, g, b).astype(np.int32)
    occ[1, goal_r[1], goal_c[1]] = 1.0  # a blocked goal reaches nothing
    want = np.asarray(jm.distance_field(occ, goal_r, goal_c, 40))
    got = tm.distance_field(_t(occ), _t(goal_r).long(), _t(goal_c).long(), 40)
    np.testing.assert_array_equal(got.numpy(), want)
    assert (want == 1e6).any() and (want < 1e6).sum() > g * g
    assert (want[1] == 1e6).all()

    # every agent cell of env 0 and 2 at every heading, plus goal cells
    for bi in (0, 2):
        rows, cols = np.meshgrid(np.arange(g), np.arange(g), indexing="ij")
        rows, cols = rows.ravel().astype(np.int32), cols.ravel().astype(np.int32)
        for o in range(4):
            ori = np.full_like(rows, o)
            d = np.broadcast_to(want[bi], (rows.size, g, g))
            want_a = np.asarray(jm.next_action_from_field(d, rows, cols, ori))
            got_a = tm.next_action_from_field(_t(np.ascontiguousarray(d)), _t(rows).long(), _t(cols).long(),
                                              _t(ori).long())
            np.testing.assert_array_equal(got_a.numpy(), want_a, err_msg=f"env {bi} heading {o}")
            assert set(np.unique(want_a)) == {0, 1, 2, 3}


def test_env_egomap_sensor_matches_jax():
    from avlen_tpu.config import get_config as jax_get_config
    from avlen_tpu.sim.builder import construct_batched_env as jax_construct
    from tests.test_torch_env import port_env_from_jax
    from tests.test_torch_slice import OPTS, SAVI

    opts = OPTS + ["TASK_CONFIG.TASK.SENSORS", "['SPECTROGRAM_SENSOR', 'EGOMAP_SENSOR']"]
    jenv = jax_construct(jax_get_config(SAVI, opts=opts), with_depth=True)
    assert "egomap" in jenv.config.sensors
    env = port_env_from_jax(jenv)
    assert (env.config.egomap_size, env.config.egomap_resolution) == (31, 0.5)
    jstate, jobs = jenv.reset()
    state, obs = env.reset()
    np.testing.assert_array_equal(obs["egomap"].numpy(), np.asarray(jobs["egomap"]))
    for a in ([1, 2, 1], [3, 1, 1], [1, 1, 2]):
        jstate, jout = jenv.step(jstate, np.asarray(a, np.int32))
        state, out = env.step(state, torch.tensor(a))
        np.testing.assert_array_equal(out.obs["egomap"].numpy(), np.asarray(jout.obs["egomap"]))
        assert out.obs["egomap"].shape == (3, 31, 31, 2)
