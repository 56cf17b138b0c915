#!/usr/bin/env python3
"""Where a rollout step's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/profile_torch_rollout.py [--steps 20] [--trace PATH] [--interactive]

Builds the port's ``SaviTrainer`` on configs/semantic_audionav/savi/savi.yaml
at its full widths (with ``--interactive``: the AVLEN trainer on
savi_interactive_1st_stage.yaml with the template speaker and banked
instructions), warms up with a short rollout, then runs ``--steps`` env
steps under ``torch.profiler`` (CPU and CUDA activities) and prints one JSON
line: host wall ms per step; device busy ms per step (the union of kernel
intervals) and the device's idle share of the window; host time per labelled
phase (env step, belief predictor, each policy's act and its visual / audio
/ SMT parts, the CLIP tower); and device time per kernel family, with the
top kernels by name. ``--trace`` also writes the Chrome trace there.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

FAMILIES = (  # (family, substrings of the kernel name), first match wins
    ("smt_encode (ours)", ("smt_",)),
    ("partial_irfft (ours)", ("irfft_cluster",)),
    ("spectrogram (ours)", ("spectrogram_kernel",)),
    ("convolution (cuDNN)", ("conv", "implicit", "winograd", "fprop", "xmma", "cudnn")),
    ("matmul (cuBLAS)", ("gemm", "gemv", "cutlass")),
    ("fft (cuFFT)", ("fft", "regular_fft", "vector_fft")),
    ("normalization", ("norm", "welford")),
    ("reduction", ("reduce",)),
)


def family(name: str) -> str:
    low = name.lower()
    for fam, keys in FAMILIES:
        if any(k.lower() in low for k in keys):
            return fam
    return "elementwise/other"


def labelled(name, fn):
    import torch

    def wrap(*args, **kwargs):
        with torch.profiler.record_function(name):
            return fn(*args, **kwargs)

    return wrap


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=20)
    ap.add_argument("--trace", default="")
    ap.add_argument("--interactive", action="store_true")
    args = ap.parse_args()

    import torch
    from torch.profiler import ProfilerActivity, profile

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    if not torch.cuda.is_available():
        print("profile_torch_rollout: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    if args.interactive:
        trainer = InteractiveDDPPOTrainer(get_config(
            "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml",
            opts=["SPEAKER.BACKEND", "template", "SPEAKER.BANK_MODE", "bank"]), device=dev)
        trainer._setup()
        policies = {"pi_g": (trainer.goal_policy, trainer.goal_policy.net),
                    "pi_l": (trainer.dialog_policy, trainer.dialog_policy.net.smt_net),
                    "pi_q": (trainer.option_policy, trainer.option_policy.net)}
        clip = trainer.dialog_policy.net.clip
        clip.forward = labelled("clip_tower", clip.forward)
    else:
        trainer = SaviTrainer(get_config("configs/semantic_audionav/savi/savi.yaml"), device=dev)
        trainer._setup()
        policies = {"policy": (trainer.policy, trainer.policy.net)}
    env = trainer.env
    env.step = labelled("env.step", env.step)
    for name, (policy, net) in policies.items():
        policy.act = labelled(f"{name}.act", policy.act)
        net.visual_encoder.forward = labelled(f"{name}.act.visual_towers", net.visual_encoder.forward)
        net.goal_encoder.forward = labelled(f"{name}.act.audio_cnn", net.goal_encoder.forward)
        net.smt.forward = labelled(f"{name}.act.smt", net.smt.forward)
    trainer.belief_net.forward = labelled("belief_predictor", trainer.belief_net.forward)
    label_names = {"env.step", "belief_predictor", "clip_tower"} | {
        f"{name}{part}" for name in policies for part in (".act", ".act.visual_towers", ".act.audio_cnn", ".act.smt")}

    trainer.collect(n=5)  # warm-up: cuDNN autotuning, allocator, kernel load
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.collect(n=args.steps)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)

    kernels, intervals = {}, []
    labels = {}
    for ev in prof.events():
        dt = getattr(ev, "device_type", None)
        is_dev = dt is not None and "CUDA" in str(dt)
        if is_dev and ev.time_range.elapsed_us() > 0 and not ev.name.startswith("Mem") and ev.name not in label_names:
            us = ev.time_range.elapsed_us()
            kernels[ev.name] = kernels.get(ev.name, 0.0) + us
            intervals.append((ev.time_range.start, ev.time_range.end))
        elif not is_dev and ev.name in label_names:
            labels[ev.name] = labels.get(ev.name, 0.0) + ev.time_range.elapsed_us()
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        busy += cur_e - cur_s
    fams = {}
    for name, us in kernels.items():
        fams[family(name)] = fams.get(family(name), 0.0) + us
    n = args.steps
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:12]
    print(json.dumps({
        "device": torch.cuda.get_device_name(0), "interactive": args.interactive,
        "steps": n, "num_envs": env.num_envs,
        "host_wall_ms_per_step": wall * 1e3 / n,
        "env_steps_per_s": n * env.num_envs / wall,
        "device_busy_ms_per_step": busy / 1e3 / n,
        "device_idle_share": 1.0 - busy / 1e6 / wall,
        "host_ms_per_step_by_phase": {k: v / 1e3 / n for k, v in sorted(labels.items())},
        "device_ms_per_step_by_family": {k: v / 1e3 / n for k, v in sorted(fams.items(), key=lambda kv: -kv[1])},
        "top_kernels_ms_per_step": {k[:90]: v / 1e3 / n for k, v in top},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
