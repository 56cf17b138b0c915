"""Interactive keyboard demo over the batched env.

PyTorch-port counterpart of ``scripts/interactive_demo.py`` (the
reference's pygame keyboard demo over AudioNavRLEnv with audio+video
recording). A terminal REPL: w/a/d to move, s to stop, q to quit (the end
of standard input quits too, so a piped key sequence drives it); it
renders the top-down map as ASCII and, with ``--record``, writes the
frames with the binaural audio (``utils/video.images_to_video_with_audio``:
a GIF plus a WAV where there is no ffmpeg).

The env keeps the JAX script's sensors, ``audiogoal`` among them, so no
spectrogram bank is used: on a CUDA device both audio kernels run every
step.

Usage: python -m avlen_tpu_torch.scripts.interactive_demo [--record out.gif] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
from typing import Optional, Sequence

import numpy as np
import torch

from avlen_tpu_torch.core.episodes import pack_episodes
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig
from avlen_tpu_torch.sim.synthetic import make_episodes, make_scene_bank
from avlen_tpu_torch.utils.maps import draw_top_down_map
from avlen_tpu_torch.utils.platform import require_device
from avlen_tpu_torch.utils.video import images_to_video_with_audio

KEYMAP = {"w": 1, "a": 2, "d": 3, "s": 0}


def ascii_map(positions, edges, node, rot, goal, side=18):
    img = draw_top_down_map(positions, edges, node, rot, goal, size=side * 2)
    chars = np.full((side, side), " ")
    small = img[:: max(img.shape[0] // side, 1), :: max(img.shape[1] // side, 1)]
    for y in range(min(side, small.shape[0])):
        for x in range(min(side, small.shape[1])):
            r, g, b = small[y, x]
            if (r, g, b) == (255, 255, 255):
                continue
            if b > 200 and r < 100:
                chars[y, x] = "A"
            elif g > 150 and r < 100:
                chars[y, x] = "G"
            else:
                chars[y, x] = "."
    return "\n".join("".join(row) for row in chars)


def main(argv: Optional[Sequence[str]] = None) -> None:
    p = argparse.ArgumentParser()
    p.add_argument("--record", default=None)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    require_device(args.device)
    dev = torch.device(args.device)

    bank, tables = make_scene_bank(np.random.RandomState(0), num_scenes=1, side=8, device=dev)
    eps = make_episodes(np.random.RandomState(1), tables, 8, min_hops=3, max_hops=12)
    packed = pack_episodes(eps, num_envs=1)
    env = BatchedAudioNavEnv(
        bank, packed, EnvConfig(sensors=("spectrogram", "audiogoal", "rgb", "depth", "pose"))
    )
    state, obs = env.reset()
    t = tables[0]
    edges = np.array(
        [[u, v] for u in range(t.num_nodes) for v in t.neighbors[u] if v >= 0], np.int32
    )
    frames, audio_chunks = [], []

    print("Controls: w=forward a=left d=right s=stop q=quit")
    while True:
        node, rot, goal = int(state.node[0]), int(state.rot[0]), int(state.goal_node[0])
        print(ascii_map(t.positions, edges, node, rot, goal))
        print(f"node={node} rot={rot * 90}° goal={goal} dtg={float(state.prev_dtg[0]):.1f}")
        if args.record:
            frames.append(draw_top_down_map(t.positions, edges, node, rot, goal))
            audio_chunks.append(obs["audiogoal"][0].cpu().numpy().T)
        try:
            key = input("> ").strip().lower()
        except EOFError:
            break
        if key == "q":
            break
        if key not in KEYMAP:
            continue
        state, out = env.step(state, torch.tensor([KEYMAP[key]], device=dev))
        obs = out.obs
        print(f"reward={float(out.reward[0]):.3f} done={bool(out.done[0])}")
        if bool(out.done[0]):
            # sorted, as JAX's jitted step returns its dict
            print("=== episode finished:", {k: float(v[0]) for k, v in sorted(out.metrics.items())})

    if args.record and frames:
        audio = np.concatenate(audio_chunks, axis=0)
        images_to_video_with_audio(args.record, frames, audio, bank.sampling_rate, fps=2)
        print(f"recorded {args.record}")


if __name__ == "__main__":
    main()
