"""The port's offline CLIs (avlen_tpu_torch/scripts/{ambisonic_to_binaural,
generate_metadata,interactive_demo,eval_speaker}.py) against the repo's JAX
scripts on the CPU: the binaural decode within 1e-6 of JAX's jitted one;
metadata files byte-equal at the same seed; the demo driven by the same
scripted keys (an episode ended by STOP among them, ``--record``) prints the
same text and records the same frames, its audio within 5e-6 of the peak
(the irfft plain version's parity) on the JAX world carried across;
``eval_speaker`` writes the same JSON keys, and with the same speaker
parameters the same greedy decodes."""

import builtins
import io
import json
import os
import runpy
import subprocess
import sys
import zipfile

import numpy as np
import pytest
import torch

import avlen_tpu.dialog.speaker.eval_speaker as jes
import avlen_tpu.dialog.speaker.train_speaker as jts
import avlen_tpu.sim.synthetic as jsyn
import avlen_tpu.utils.video as jvideo
import avlen_tpu_torch.dialog.speaker.eval_speaker as pes_lib
from avlen_tpu.dialog.speaker.vocab import Vocabulary as JaxVocabulary
from avlen_tpu_torch.scripts import ambisonic_to_binaural, eval_speaker, generate_metadata, interactive_demo
from avlen_tpu_torch.utils.flax_bridge import scene_bank_from_jax

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
AMBI_TOL = 1e-6
DEMO_AUDIO_TOL = 5e-6  # × the audio's peak


def _run_jax_script(monkeypatch, name, args):
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *args])
    runpy.run_path(os.path.join(REPO, "scripts", f"{name}.py"), run_name="__main__")


def test_ambisonic_to_binaural_matches_jax(tmp_path, monkeypatch):
    ambi = np.random.RandomState(0).randn(3, 4, 200).astype(np.float32)
    inp = tmp_path / "ambi.npy"
    np.save(inp, ambi)
    angles = ["0", "90", "180", "270", "45", "-30"]
    ambisonic_to_binaural.main(["--input", str(inp), "--output", str(tmp_path / "port"), "--angles", *angles,
                                "--device", "cpu"])
    _run_jax_script(monkeypatch, "ambisonic_to_binaural",
                    ["--input", str(inp), "--output", str(tmp_path / "jax"), "--angles", *angles])
    jax_fn = runpy.run_path(os.path.join(REPO, "scripts", "ambisonic_to_binaural.py"))["ambisonic_to_binaural"]
    for angle in angles:
        got = np.load(tmp_path / "port" / f"{angle}.npy")
        want = np.load(tmp_path / "jax" / f"{angle}.npy")
        assert got.shape == want.shape == (3, 200, 2) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, atol=AMBI_TOL, rtol=0, err_msg=angle)
        direct = ambisonic_to_binaural.ambisonic_to_binaural(torch.as_tensor(ambi), float(angle)).numpy()
        np.testing.assert_allclose(direct, np.asarray(jax_fn(ambi, np.float32(angle))), atol=AMBI_TOL, rtol=0)
    # test_aux.py's symmetry: rotation by 180° swaps the Y contribution sign
    b0, b180 = np.load(tmp_path / "port" / "0.npy"), np.load(tmp_path / "port" / "180.npy")
    np.testing.assert_allclose(b0[..., 0], b180[..., 1], atol=1e-5)


def _zip_members(path):
    with zipfile.ZipFile(path) as z:
        return {n: z.read(n) for n in sorted(z.namelist())}


@pytest.mark.parametrize("args", [["--scenes", "2", "--side", "5"],
                                  ["--scenes", "1", "--side", "7", "--grid-size", "0.5", "--seed", "3"]])
def test_generate_metadata_writes_the_jax_scripts_bytes(tmp_path, monkeypatch, args):
    generate_metadata.main(["--output", str(tmp_path / "port"), *args, "--device", "cpu"])
    _run_jax_script(monkeypatch, "generate_metadata", ["--output", str(tmp_path / "jax"), *args])
    scenes = sorted(os.listdir(tmp_path / "jax"))
    assert scenes == sorted(os.listdir(tmp_path / "port")) and scenes
    for scene in scenes:
        got, want = tmp_path / "port" / scene, tmp_path / "jax" / scene
        assert (got / "points.txt").read_bytes() == (want / "points.txt").read_bytes()
        # the archive's member bytes (each .npy: header and data); the zip's
        # own timestamps are the write's
        members = _zip_members(got / "scene.npz")
        assert members == _zip_members(want / "scene.npz")
        assert set(members) == {f"{k}.npy" for k in ("positions", "edges", "hops", "fwd_next", "oracle_next")}


# ≥ 10 keys: turns, forward moves into and along the graph, an unknown key,
# STOP (which ends the episode) and moves in the next episode
DEMO_KEYS = ["d", "w", "w", "a", "x", "w", "d", "w", "s", "w", "a", "w", "w", "q"]


def _drive_demo(monkeypatch, keys, run):
    """Run ``run()`` with ``input`` answering ``keys`` and the recorder
    captured; returns (stdout, recorder args)."""
    feed = iter(keys)
    monkeypatch.setattr(builtins, "input", lambda prompt="": next(feed))
    rec = {}

    def capture(path, images, audio, sampling_rate=16000, fps=10):
        rec.update(path=path, images=[np.array(i) for i in images], audio=np.array(audio),
                   sampling_rate=sampling_rate, fps=fps)
        return path

    monkeypatch.setattr(jvideo, "images_to_video_with_audio", capture)
    monkeypatch.setattr(interactive_demo, "images_to_video_with_audio", capture)
    out = io.StringIO()
    monkeypatch.setattr(sys, "stdout", out)
    try:
        run()
    finally:
        monkeypatch.setattr(sys, "stdout", sys.__stdout__)
    return out.getvalue(), rec


def test_interactive_demo_matches_jax(tmp_path, monkeypatch):
    jax_worlds = []

    def jax_world(rng, num_scenes=1, side=8, device="cuda"):
        """The port's demo over the JAX script's world (its jax.random RIR tails)."""
        bank, tables = jsyn.make_scene_bank(rng, num_scenes=num_scenes, side=side)
        jax_worlds.append(bank)
        return scene_bank_from_jax(bank, device), tables

    out_j, rec_j = _drive_demo(monkeypatch, DEMO_KEYS, lambda: _run_jax_script(
        monkeypatch, "interactive_demo", ["--record", str(tmp_path / "jax.mp4")]))
    monkeypatch.setattr(interactive_demo, "make_scene_bank", jax_world)
    out_p, rec_p = _drive_demo(monkeypatch, DEMO_KEYS, lambda: interactive_demo.main(
        ["--record", str(tmp_path / "jax.mp4"), "--device", "cpu"]))
    assert len(jax_worlds) == 1
    assert "=== episode finished:" in out_p and "done=True" in out_p  # STOP ended an episode
    assert out_p.splitlines() == out_j.splitlines()
    assert rec_p["path"] == rec_j["path"] and rec_p["fps"] == rec_j["fps"] == 2
    assert rec_p["sampling_rate"] == rec_j["sampling_rate"] == 16000
    frames = len(DEMO_KEYS)  # one before each prompt, an unknown key's included
    assert len(rec_p["images"]) == len(rec_j["images"]) == frames
    for g, w in zip(rec_p["images"], rec_j["images"]):
        np.testing.assert_array_equal(g, w)
    assert rec_p["audio"].shape == rec_j["audio"].shape == (frames * 16000, 2)
    peak = float(np.abs(rec_j["audio"]).max())
    assert peak > 0
    np.testing.assert_allclose(rec_p["audio"], rec_j["audio"], atol=DEMO_AUDIO_TOL * peak, rtol=0)


def test_interactive_demo_reads_keys_from_stdin(tmp_path):
    """``python -m`` with the keys piped in: the end of input quits, and
    ``--record`` writes a GIF (no imageio or ffmpeg needed) and a WAV."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONSTARTUP"}
    env["PYTHONPATH"] = REPO
    r = subprocess.run([sys.executable, "-m", "avlen_tpu_torch.scripts.interactive_demo", "--device", "cpu",
                        "--record", str(tmp_path / "demo.gif")], input="w\nd\ns\n", cwd=tmp_path, env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    assert r.stdout.count("reward=") == 3 and "recorded" in r.stdout
    assert (tmp_path / "demo.gif").stat().st_size > 0 and (tmp_path / "demo.wav").stat().st_size > 44


def test_eval_speaker_matches_jax_given_the_same_parameters(tmp_path, monkeypatch):
    """The port's CLI trains its speaker (2 steps); the JAX script is handed
    those parameters (the Flax tree ``train_speaker`` returns, the format
    speaker.pth holds) in place of its own training, so both decode with
    the same weights: the same words for every path and the same JSON."""
    args = ["--steps", "2", "--scenes", "1", "--side", "4", "--num-paths", "16"]
    trained, decodes = {}, {}
    port_train = eval_speaker.train_speaker

    def record_train(*a, **k):
        trained["out"] = port_train(*a, **k)
        return trained["out"]

    def record_decodes(name, fn):
        def run(speaker, items, refs, **kw):
            decodes[name] = [o["words"] for o in speaker.generate_instr(items)]
            return fn(speaker, items, refs, **kw)

        return run

    monkeypatch.setattr(eval_speaker, "train_speaker", record_train)
    monkeypatch.setattr(pes_lib, "evaluate_speaker", record_decodes("port", pes_lib.evaluate_speaker))
    monkeypatch.setattr(jes, "evaluate_speaker", record_decodes("jax", jes.evaluate_speaker))
    res = eval_speaker.main([*args, "--output", str(tmp_path / "port.json"), "--device", "cpu"])
    params, vocab, acc = trained["out"]
    assert vocab.idx2word == JaxVocabulary().idx2word
    monkeypatch.setattr(jts, "train_speaker", lambda *a, **k: (params, JaxVocabulary(), acc))
    _run_jax_script(monkeypatch, "eval_speaker", [*args, "--output", str(tmp_path / "jax.json")])
    got = json.loads((tmp_path / "port.json").read_text())
    want = json.loads((tmp_path / "jax.json").read_text())
    assert list(got) == list(want) == ["bleu", "avg_len", "num", "token_acc", "beam_size"]
    assert got == want == res
    assert len(decodes["port"]) == len(decodes["jax"]) == 16
    assert decodes["port"] == decodes["jax"]
