"""The port's eval videos against the JAX package on the CPU: the top-down
map, its fog of war and ``top_down_map_measure`` pixel for pixel on random
trails; the GIF writer's frames decode back exactly (PIL) and it refuses
more than 256 colours; the tensorboard video event parses with
tensorboardX's ``event_pb2`` and its GIF decodes to the frames;
``generate_eval_videos`` fed the same (dones, masks, metrics) writes the
files JAX writes (names, frame counts, frames), the eval loops' rule
included (2 videos, or 3 when a rollout that ends 2 more episodes follows
one video); and a tiny-world SAVi eval through ``run.main`` at the default
``VIDEO_OPTION`` writes videos and video events."""

import io
import os
import types

import numpy as np
import pytest
import torch
from PIL import Image
from tensorboardX.proto import event_pb2

from avlen_tpu.rl.trainers import base as jbase
from avlen_tpu.sim.synthetic import make_scene_bank as jax_make_scene_bank
from avlen_tpu.utils import maps as jmaps
from avlen_tpu.utils import video as jvideo
from avlen_tpu_torch import run
from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers import base as tbase
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.sim.synthetic import make_scene_bank
from avlen_tpu_torch.utils import maps, tb, video
from tests.test_torch_slice import OPTS, SAVI

torch.set_num_threads(1)


def gif_frames(data: bytes):
    im = Image.open(io.BytesIO(data))
    out = []
    for i in range(im.n_frames):
        im.seek(i)
        out.append(np.asarray(im.convert("RGB")))
    return out


@pytest.fixture(scope="module")
def tables():
    _, jt = jax_make_scene_bank(np.random.RandomState(5), num_scenes=2, side=4, with_frames=False)
    _, tt = make_scene_bank(np.random.RandomState(5), num_scenes=2, side=4, with_frames=False, device="cpu")
    for a, b in zip(jt, tt):
        np.testing.assert_array_equal(a.positions, b.positions)
    return jt, tt


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_maps_and_fog_match_jax(tables, seed):
    rng = np.random.RandomState(seed)
    jt, tt = tables
    s = seed % 2
    pos = tt[s].positions
    edges = np.array([[u, v] for u in range(tt[s].num_nodes) for v in tt[s].neighbors[u] if v >= 0], np.int32)
    obstacles = rng.rand(256, 256) < 0.01
    jfog = np.zeros((256, 256), np.uint8)
    tfog = np.zeros((256, 256), np.uint8)
    trail = list(rng.randint(0, tt[s].num_nodes, 6))
    for i, node in enumerate(trail):
        rot = int(rng.randint(4))
        yx = (int(rng.randint(256)), int(rng.randint(256)))
        jfog = jmaps.reveal_fog_of_war(obstacles, jfog, yx, np.deg2rad(rot * 90), max_line_len=40)
        tfog = maps.reveal_fog_of_war(obstacles, tfog, yx, np.deg2rad(rot * 90), max_line_len=40)
        np.testing.assert_array_equal(tfog, jfog)
        want = jmaps.draw_top_down_map(pos, edges, node, rot, trail[-1], trail=trail[:i + 1], fog=jfog)
        got = maps.draw_top_down_map(pos, edges, node, rot, trail[-1], trail=trail[:i + 1], fog=tfog)
        np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(maps.apply_fog_to_image(got, tfog, 0.5), jmaps.apply_fog_to_image(want, jfog, 0.5))
    metrics = {k: rng.randint(0, tt[s].num_nodes, (3, 2)).astype(np.float32)
               for k in ("agent_node", "goal_node")}
    metrics["agent_rot"] = rng.randint(0, 4, (3, 2)).astype(np.float32)
    metrics["agent_scene"] = np.full((3, 2), s, np.float32)
    for fog in (None, tfog):
        want = jmaps.top_down_map_measure(metrics, jt, 1, 1, trail=trail, fog=fog)
        got = maps.top_down_map_measure(metrics, tt, 1, 1, trail=trail, fog=fog)
        assert set(got) == set(want)
        for k in want:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)


@pytest.mark.parametrize("colours,hw", [(1, (5, 7)), (2, (16, 16)), (5, (33, 17)), (10, (64, 48)),
                                        (200, (40, 90)), (256, (97, 131))])
def test_gif_frames_decode_exactly(colours, hw):
    rng = np.random.RandomState(colours)
    palette = rng.randint(0, 256, (colours, 3)).astype(np.uint8)
    frames = [palette[rng.randint(0, colours, hw)] for _ in range(3)]
    frames.append(frames[0].copy())  # a repeated frame stays a frame
    got = gif_frames(video.gif_bytes(frames, fps=4))
    assert len(got) == len(frames)
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)


def test_gif_refuses_more_than_256_colours():
    frame = np.arange(257 * 3, dtype=np.int64).reshape(1, 257, 3).astype(np.uint8)
    frame[0, :, 0] = np.arange(257) % 256
    frame[0, :, 1] = np.arange(257) // 256
    with pytest.raises(ValueError, match="256"):
        video.gif_bytes([frame])


def test_tensorboard_video_event_parses(tmp_path):
    rng = np.random.RandomState(0)
    palette = rng.randint(0, 256, (6, 3)).astype(np.uint8)
    frames = [palette[rng.randint(0, 6, (24, 32))] for _ in range(5)]
    with tb.TensorboardWriter(str(tmp_path)) as w:
        w.add_scalar("a", 1.5, 3)
        w.add_video_from_np_images("episode0_4", 7, frames, fps=10)
    (path,) = [os.path.join(tmp_path, f) for f in os.listdir(tmp_path)]
    events = []
    for payload in tb.read_records(path):
        e = event_pb2.Event()
        e.ParseFromString(payload)
        events.append(e)
    assert events[0].file_version == "brain.Event:2"
    assert events[1].summary.value[0].simple_value == 1.5
    v = events[2].summary.value[0]
    assert (events[2].step, v.tag) == (7, "episode0_4")
    assert (v.image.height, v.image.width, v.image.colorspace) == (24, 32, 3)
    got = gif_frames(v.image.encoded_image_string)
    assert len(got) == 5
    for g, f in zip(got, frames):
        np.testing.assert_array_equal(g, f)
    assert tb.read_scalars(str(tmp_path)) == {"a": [(3, 1.5)]}


def _episodes(rng, t, b, num_nodes, ends):
    """(dones, masks, metrics) of a (t, b) rollout whose slots end an
    episode at the steps ``ends[bi]``."""
    dones = np.zeros((t, b), bool)
    for bi, steps in enumerate(ends):
        dones[steps, bi] = True
    masks = np.ones((t, b), np.float32)
    masks[1:] = 1.0 - dones[:-1]
    metrics = {k: rng.randint(0, num_nodes, (t, b)).astype(np.float32) for k in ("agent_node", "goal_node")}
    metrics["agent_rot"] = rng.randint(0, 4, (t, b)).astype(np.float32)
    metrics["agent_scene"] = rng.randint(0, 2, (t, b)).astype(np.float32)
    metrics["spl"] = rng.rand(t, b).astype(np.float32)
    metrics["success"] = (rng.rand(t, b) > 0.5).astype(np.float32)
    metrics["episode"] = rng.randint(0, 9, (t, b)).astype(np.float32)
    return dones, masks, metrics


def test_generate_eval_videos_match_jax(tables, tmp_path, monkeypatch):
    """Two rollouts: the first ends one episode (1 video), the second ends
    three (2 more: 3 in all, as JAX's ``videos_made < 2`` loop makes). The
    port's GIFs decode to the frames JAX rendered; JAX's own GIF (imageio's
    pillow writer) merges repeated consecutive frames, so it decodes to
    those frames with the repeats merged."""
    jt, tt = tables
    rng = np.random.RandomState(1)
    n = min(t.num_nodes for t in tt)
    rollouts = [_episodes(rng, 6, 3, n, [[], [4], []]), _episodes(rng, 6, 3, n, [[2, 5], [], [3]])]
    dirs = {"jax": str(tmp_path / "jax"), "port": str(tmp_path / "port")}

    def fake(tabs, d):
        return types.SimpleNamespace(config=types.SimpleNamespace(VIDEO_OPTION=["disk", "tensorboard"],
                                                                  VIDEO_DIR=d),
                                     env=types.SimpleNamespace(scene_tables=tabs))

    rendered = {}
    to_video = jvideo.images_to_video

    def recording(path, images, fps=10):
        rendered[os.path.basename(os.path.splitext(path)[0])] = list(images)
        return to_video(path, images, fps)

    monkeypatch.setattr(jvideo, "images_to_video", recording)
    jself = fake(jt, dirs["jax"])
    made = 0
    for dones, masks, metrics in rollouts:  # avlen_tpu/rl/trainers/savi.py:538-541
        if made < 2:
            made += jbase.BaseRLTrainer.generate_eval_videos(jself, dones, masks, metrics, None, 4)
    assert made == 3

    tself = fake(tt, dirs["port"])
    tself.generate_eval_videos = types.MethodType(tbase.BaseRLTrainer.generate_eval_videos, tself)
    with tb.TensorboardWriter(str(tmp_path / "tb")) as writer:
        hook = tbase.BaseRLTrainer.eval_videos(tself, writer, 4)
        for dones, masks, metrics in rollouts:
            hook(*(torch.as_tensor(x) for x in (dones, masks)), {k: torch.as_tensor(v) for k, v in metrics.items()})
        hook(*(torch.as_tensor(x) for x in rollouts[1][:2]),
             {k: torch.as_tensor(v) for k, v in rollouts[1][2].items()})  # no more after 3
    names = sorted(os.listdir(dirs["jax"]))
    assert names == sorted(os.listdir(dirs["port"]))
    assert len(names) == 3 and all(n.startswith("episode=") and "-ckpt=4-spl=" in n and n.endswith(".gif")
                                   for n in names)
    for n in names:
        with open(os.path.join(dirs["jax"], n), "rb") as f:
            jax_file = gif_frames(f.read())
        with open(os.path.join(dirs["port"], n), "rb") as f:
            got = gif_frames(f.read())
        want = rendered[n[:-len(".gif")]]
        assert len(got) == len(want) > 1
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w)
        merged = [g for i, g in enumerate(got) if i == 0 or not np.array_equal(g, got[i - 1])]
        assert len(jax_file) == len(merged)
        for j, g in zip(jax_file, merged):
            np.testing.assert_array_equal(j, g)
    (events,) = [os.path.join(tmp_path / "tb", f) for f in os.listdir(tmp_path / "tb")]
    assert len(tb.read_records(events)) == 1 + 3  # file version + one video event each
    assert tbase.BaseRLTrainer.eval_videos(fake(tt, dirs["port"]), None, 0) is not None
    off = fake(tt, dirs["port"])
    off.config.VIDEO_OPTION = []
    assert tbase.BaseRLTrainer.eval_videos(off, None, 0) is None  # no hook, no host copies


def test_savi_eval_writes_videos_through_run_main(tmp_path):
    """The default VIDEO_OPTION (disk + tensorboard) on a tiny savi.yaml
    world: the eval's sampled rollouts end episodes, and 2-3 of them become
    GIFs under MODEL_DIR/video_dir and video events beside the scalars."""
    d = tmp_path / "model"
    tr = SaviTrainer(get_config(SAVI, opts=list(OPTS), model_dir=str(d)), device="cpu")
    assert list(tr.config.VIDEO_OPTION) == ["disk", "tensorboard"]
    tr._setup()
    path = tr.save_checkpoint("ckpt.0.pth")
    try:
        ev = run.main(["--run-type", "eval", "--exp-config", SAVI, "--model-dir", str(d), "--device", "cpu",
                       *OPTS, "EVAL_CKPT_PATH_DIR", path, "TEST_EPISODE_COUNT", "6"])
    finally:
        os.remove(path)
    vids = sorted(os.listdir(ev.config.VIDEO_DIR))
    assert 2 <= len(vids) <= 3 and all(v.endswith(".gif") and "-ckpt=0-" in v for v in vids), vids
    for v in vids:
        with open(os.path.join(ev.config.VIDEO_DIR, v), "rb") as f:
            frames = gif_frames(f.read())
        assert frames and frames[0].shape == (256, 256, 3)
    tags = []
    for f in os.listdir(ev.config.TENSORBOARD_DIR):
        for payload in tb.read_records(os.path.join(ev.config.TENSORBOARD_DIR, f)):
            e = event_pb2.Event()
            e.ParseFromString(payload)
            tags += [v.tag for v in e.summary.value if v.HasField("image")]
    assert len(tags) == len(vids) and all(t.startswith("episode") for t in tags)
