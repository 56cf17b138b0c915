"""Offline belief-predictor pretraining (stage 0 of the recipe): the label
classifier and the location regressor, trained from RIRs and source sounds.

PyTorch counterpart of ``avlen_tpu/pretraining/audiogoal_predictor.py``
(reference ss_baselines/savi/pretraining/{audiogoal_predictor,
audiogoal_trainer,audiogoal_dataset}.py): each batch is drawn on the device
(scene, receiver, source, rotation, sound), rendered there (the RIR
convolution and the spectrogram: the irfft and spectrogram kernels on a
CUDA bank) and fed to one Adam step of CE + location MSE. The checkpoint,
``label_predictor.pth`` with the Flax parameter tree, is what the SAVi and
AVLEN trainers load as RL.PPO.BELIEF_PREDICTOR.pretrained_path; the JAX
package reads it too.

    python -m avlen_tpu_torch.pretraining.audiogoal_predictor [--device cuda|cpu]
        [--output DIR] [--steps N] [--batch B] [--scenes S] [--side K]
"""

from __future__ import annotations

import math
import os
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
from avlen_tpu_torch.ops.audio import render_audiogoal
from avlen_tpu_torch.sim.scene import SceneBank
from avlen_tpu_torch.utils.checkpoint import save_checkpoint
from avlen_tpu_torch.utils.flax_bridge import to_flax_params
from avlen_tpu_torch.utils.logging import logger


def sample_from_indices(bank: SceneBank, scene, recv, src, rot, sound, num_categories: int = 21):
    """(spectrogram (B, F, T, 2), category (B,), location (B, 2)) of the
    given draws: the receiver at ``recv`` facing ``rot`` hears ``sound`` from
    ``src``; the location target is the source in the agent's base frame
    (X forward, Y rightward), the belief predictor's frame."""
    b = scene.shape[0]
    dev = bank.device
    az = (4 - rot) % 4
    rir = bank.rir.gather(scene, az, recv, src)
    _, spec = render_audiogoal(
        bank.sounds_padded[sound],
        torch.zeros((b,), dtype=torch.long, device=dev),
        rir,
        torch.ones((b,), dtype=torch.bool, device=dev),
        bank.sampling_rate,
    )
    category = sound % num_categories
    positions = bank.tables["positions"]
    d = positions[scene, src] - positions[scene, recv]
    th = rot.float() * (math.pi / 2)
    fwd = -d[:, 0] * torch.sin(th) - d[:, 2] * torch.cos(th)
    rgt = d[:, 0] * torch.cos(th) - d[:, 2] * torch.sin(th)
    return spec, category, torch.stack([fwd, rgt], dim=1)


def make_sampler(bank: SceneBank, batch: int, num_categories: int = 21,
                 generator: Optional[torch.Generator] = None) -> Callable[[], Tuple[torch.Tensor, ...]]:
    """A sampler of uniform (scene, receiver, source, rotation, sound)
    draws from ``generator`` (on the bank's device) → ``sample_from_indices``."""
    dev = bank.device
    s = bank.tables["positions"].shape[0]
    k = bank.sounds_padded.shape[0]

    def draw(high: int) -> torch.Tensor:
        return torch.randint(0, high, (batch,), generator=generator, device=dev)

    def sample():
        scene = draw(s)
        n = bank.tables["num_nodes"][scene].long()
        recv = draw(10**6) % n
        src = draw(10**6) % n
        rot = draw(4)
        sound = draw(k)
        return sample_from_indices(bank, scene, recv, src, rot, sound, num_categories)

    return sample


def loss_fn(net: BeliefPredictorNet, spec, cat, loc) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """CE of the label logits + the location MSE summed over x, y; with the
    accuracy (``loss_fn`` of the JAX module)."""
    pred_loc, logits = net(spec)
    ce = F.cross_entropy(logits, cat)
    mse = ((pred_loc - loc) ** 2).sum(-1).mean()
    acc = (logits.argmax(-1) == cat).float().mean()
    return ce + mse, {"ce": ce.detach(), "mse": mse.detach(), "acc": acc}


def train_step(net: BeliefPredictorNet, optimizer: torch.optim.Optimizer, spec, cat, loc) -> Dict[str, torch.Tensor]:
    loss, aux = loss_fn(net, spec, cat, loc)
    optimizer.zero_grad(set_to_none=True)
    loss.backward()
    optimizer.step()
    return aux


def train_audiogoal_predictor(
    bank: SceneBank,
    num_steps: int = 1000,
    batch: int = 64,
    lr: float = 1e-3,
    num_categories: int = 21,
    checkpoint_dir: Optional[str] = None,
    log_interval: int = 50,
    seed: int = 0,
    stats: Optional[dict] = None,
):
    """Returns (Flax parameter tree, final metrics dict). ``stats``, when
    given, receives the loop's seconds (ending in a device synchronise),
    the first step's seconds and every step's ce/mse/acc."""
    dev = bank.device
    net = BeliefPredictorNet(num_categories=num_categories,
                             generator=torch.Generator(device="cpu").manual_seed(seed)).to(dev)
    sampler = make_sampler(bank, batch, num_categories, torch.Generator(device=dev).manual_seed(seed))
    # optax.adam's defaults
    optimizer = torch.optim.Adam(net.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    history: List[Dict[str, torch.Tensor]] = []
    sync()
    t0 = time.perf_counter()
    first_s = None
    aux: Dict[str, torch.Tensor] = {}
    for i in range(num_steps):
        aux = train_step(net, optimizer, *sampler())
        history.append(aux)
        if i == 0:
            sync()
            first_s = time.perf_counter() - t0
        if i % log_interval == 0:
            logger.info(
                f"audiogoal pretrain {i}: ce {float(aux['ce']):.3f} "
                f"mse {float(aux['mse']):.3f} acc {float(aux['acc']):.3f} "
                f"({(i + 1) * batch / (time.perf_counter() - t0):.0f} ex/s)"
            )
    sync()
    loop_s = time.perf_counter() - t0
    metrics = {k: float(v) for k, v in aux.items()}
    if stats is not None:
        stats.update(loop_seconds=loop_s, first_step_seconds=first_s, steps=num_steps, batch=batch,
                     history=[{k: float(v) for k, v in h.items()} for h in history])
    if checkpoint_dir:
        save_checkpoint(checkpoint_dir, "label_predictor.pth", {"state_dict": to_flax_params(net), "metrics": metrics})
    return to_flax_params(net), metrics


def main(argv: Optional[List[str]] = None) -> dict:
    """Runs the command line ``argv``; returns the run's ``stats`` with its
    final ``metrics`` and the ``checkpoint`` path."""
    import argparse

    from avlen_tpu_torch.sim.synthetic import make_scene_bank

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/pretrained_weights")
    p.add_argument("--steps", type=int, default=1000)
    p.add_argument("--batch", type=int, default=64)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=8)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")

    bank, _ = make_scene_bank(np.random.RandomState(0), num_scenes=args.scenes, side=args.side,
                              device=args.device)
    os.makedirs(args.output, exist_ok=True)
    stats: dict = {}
    _, metrics = train_audiogoal_predictor(bank, num_steps=args.steps, batch=args.batch,
                                           checkpoint_dir=args.output, stats=stats)
    logger.info(f"done: {metrics}")
    return dict(stats, metrics=metrics, checkpoint=os.path.join(args.output, "label_predictor.pth"))


if __name__ == "__main__":
    main()
