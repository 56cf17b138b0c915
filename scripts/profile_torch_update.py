#!/usr/bin/env python3
"""Where a SAVi training update's time goes in the PyTorch port, on one CUDA card.

    python3 scripts/profile_torch_update.py [--trace PATH]

Builds the port's ``SaviTrainer`` on configs/semantic_audionav/savi/savi.yaml
at its full widths, collects one rollout of 150 steps, runs one warm-up
``update`` on it, then one more under ``torch.profiler`` (CPU and CUDA
activities) and prints one JSON line: host wall ms of the update; device
busy ms (the union of kernel intervals) and the device's idle share of the
update; host ms per labelled part (GAE, each minibatch's re-evaluation, the
SMT kernel's forward, its plain recompute + backward, the rest of the
backward, the optimizer steps, the belief step; the labels nest, so they
do not add up); device ms per kernel family with the top kernels by name;
and the count of device kernels.
``--trace`` also writes the Chrome trace there.
"""

from __future__ import annotations

import argparse
import contextlib
import functools
import json
import os
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from scripts.profile_torch_rollout import family, labelled  # noqa: E402

LABELS = ("update.gae", "update.evaluate", "update.backward", "update.optimizer_step",
          "smt.kernel_forward", "smt.plain_recompute_and_backward", "update.belief_step")


@contextlib.contextmanager
def instrumented(trainer):
    """Labels the update's parts for the profiler within the block."""
    import torch

    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.trainers import savi

    saved = [(savi, "compute_gae", savi.compute_gae), (torch.Tensor, "backward", torch.Tensor.backward)]
    savi.compute_gae = labelled("update.gae", savi.compute_gae)
    torch.Tensor.backward = labelled("update.backward", torch.Tensor.backward)
    trainer.optimizer.step = labelled("update.optimizer_step", trainer.optimizer.step)
    trainer.evaluate_actions = labelled("update.evaluate", trainer.evaluate_actions)
    trainer.belief_train_step = labelled("update.belief_step", trainer.belief_train_step)
    try:
        with smt_cuda.wrapped_passes(functools.partial(labelled, "smt.kernel_forward"),
                                     functools.partial(labelled, "smt.plain_recompute_and_backward")):
            yield
    finally:
        for obj, name, fn in saved:
            setattr(obj, name, fn)
        del trainer.optimizer.step, trainer.evaluate_actions, trainer.belief_train_step


def profile_update(trainer, batch):
    """One profiled ``trainer.update(batch)``: the JSON fields."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    with instrumented(trainer), profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        trainer.update(batch)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    kernels, intervals, labels, launches = {}, [], {}, 0
    for ev in prof.events():
        dt = getattr(ev, "device_type", None)
        is_dev = dt is not None and "CUDA" in str(dt)
        # the profiler also puts annotations on the device's timeline (our
        # labels, "Optimizer.step#Adam.step"): spans over kernels, not kernels
        annotation = getattr(ev, "is_user_annotation", False) or ev.name in LABELS \
            or ev.name.startswith("Optimizer.")
        if is_dev and ev.time_range.elapsed_us() > 0 and not ev.name.startswith(("Memcpy", "Memset")) \
                and not annotation:
            us = ev.time_range.elapsed_us()
            kernels[ev.name] = kernels.get(ev.name, 0.0) + us
            intervals.append((ev.time_range.start, ev.time_range.end))
            launches += 1
        elif not is_dev and ev.name in LABELS:
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
    top = sorted(kernels.items(), key=lambda kv: -kv[1])[:15]
    return dict(
        host_wall_ms=wall * 1e3,
        device_busy_ms=busy / 1e3,
        device_idle_share=1.0 - busy / 1e6 / wall,
        device_kernels=launches,
        host_ms_by_label={k: v / 1e3 for k, v in sorted(labels.items())},
        device_ms_by_family={k: v / 1e3 for k, v in sorted(fams.items(), key=lambda kv: -kv[1])},
        top_kernels_ms={k[:90]: v / 1e3 for k, v in top},
    ), prof


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--trace", default="")
    args = ap.parse_args()

    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    if not torch.cuda.is_available():
        print("profile_torch_update: no CUDA device", file=sys.stderr)
        return 1
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    trainer = SaviTrainer(get_config("configs/semantic_audionav/savi/savi.yaml"), device=torch.device("cuda:0"))
    trainer._setup()
    _, batch = trainer.collect()
    trainer.update(batch)  # warm-up: cuDNN autotuning, allocator, kernel load
    torch.cuda.synchronize()
    fields, prof = profile_update(trainer, batch)
    if args.trace:
        os.makedirs(os.path.dirname(args.trace) or ".", exist_ok=True)
        prof.export_chrome_trace(args.trace)
    smi = os.popen("nvidia-smi --query-gpu=name,power.limit --format=csv,noheader").read().strip()
    print(json.dumps({"device": torch.cuda.get_device_name(0), "nvidia_smi": smi, **fields}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
