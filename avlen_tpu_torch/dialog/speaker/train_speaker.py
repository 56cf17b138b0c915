"""Speaker training (recipe stage 4): imitation of the instruction channel.

PyTorch counterpart of ``avlen_tpu/dialog/speaker/train_speaker.py``
(reference ss_baselines/savi/dialog/speaker/tasks/R2R/train_speaker.py:
seq2seq over (path, instruction) pairs). The pairs are sampled from the
scene graphs through the template channel (the synthetic world's
ground-truth language) by a numpy-seeded ``build_dataset``, so they equal
the JAX package's pair for pair. Each step is one Adam step (optax.adam's
arithmetic) on a minibatch drawn on the device, with scheduled sampling
ramped over the first half of training; the draws come from a
``torch.Generator`` seeded ``seed``.

``speaker.pth`` is written in the JAX package's format: ``state_dict`` as
the Flax tree (``to_flax_params``), ``vocab``, ``hidden_size`` and
``world_feat_dim``, so either package loads the other's file.

    python -m avlen_tpu_torch.dialog.speaker.train_speaker
        [--output data/pretrained_weights/speaker] [--steps N] [--scenes S]
        [--side K] [--device cuda|cpu]
"""

from __future__ import annotations

import os
import time
from typing import Dict, List, Optional, Sequence, Tuple, Union

import numpy as np
import torch
import torch.nn.functional as F

from avlen_tpu_torch.dialog.instruction_bank import shortest_path_prefix
from avlen_tpu_torch.dialog.speaker.model import Seq2SeqSpeaker
from avlen_tpu_torch.dialog.speaker.speaker import MAX_PATH_LEN, Speaker
from avlen_tpu_torch.dialog.speaker.templates import generate_template_instruction
from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
from avlen_tpu_torch.sim.graph import SceneTables
from avlen_tpu_torch.utils.checkpoint import save_checkpoint
from avlen_tpu_torch.utils.flax_bridge import to_flax_params
from avlen_tpu_torch.utils.logging import logger

MAX_WORDS = 40


def build_dataset(
    tables_list: Sequence[SceneTables],
    vocab: Vocabulary,
    num_pairs: int,
    seed: int = 0,
    pano_features=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Sample (path → instruction) pairs. Returns (actions, feats, lengths,
    target token ids (BOS-led)). ``pano_features`` (S, N, 4, D) adds the
    heading-aligned view feature per step (R2R panorama parity)."""
    rng = np.random.RandomState(seed)
    speaker = Speaker([t.positions for t in tables_list], backend="template", vocab=vocab,
                      pano_features=pano_features)
    acts = np.zeros((num_pairs, MAX_PATH_LEN), np.int32)
    feats = np.zeros((num_pairs, MAX_PATH_LEN, speaker.feat_dim), np.float32)
    lens = np.zeros((num_pairs,), np.int32)
    words = np.zeros((num_pairs, MAX_WORDS), np.int32)
    i = 0
    guard = 0
    while i < num_pairs and guard < num_pairs * 20:
        guard += 1
        s = rng.randint(len(tables_list))
        t = tables_list[s]
        a, b = rng.randint(t.num_nodes), rng.randint(t.num_nodes)
        if a == b or t.hops[a, b] >= 2**15:
            continue
        rot = rng.randint(4)
        heading = (270 - rot * 90) % 360
        path = shortest_path_prefix(t, a, b, max_len=MAX_PATH_LEN)
        # half the pairs are category-conditioned ("to reach the <cat>"),
        # half path-only ("and stop there"): the model serves both regimes
        category = int(rng.randint(21)) if rng.rand() < 0.5 else None
        instr = generate_template_instruction(t.positions, path, heading, category)
        acts[i], feats[i], lens[i] = speaker.path_features(s, path, heading, category)
        words[i] = vocab.encode(instr, MAX_WORDS)
        i += 1
    return acts[:i], feats[:i], lens[:i], words[:i]


def train_step(model: Seq2SeqSpeaker, optimizer, acts, feats, lens, words, pad_id: int,
               sample_prob: float = 0.0, generator: Optional[torch.Generator] = None):
    """One Adam step on the masked mean CE of words[:, 1:] predicted from
    the BOS-led words[:, :-1], with scheduled sampling at ``sample_prob``;
    returns (loss, token accuracy) as device tensors (the gradients stay in
    the parameters' ``.grad``)."""
    optimizer.zero_grad(set_to_none=True)
    logits = model.scheduled_logits(acts, feats, lens, words[:, :-1], sample_prob, generator)
    targets = words[:, 1:].long()
    mask = (targets != pad_id).float()
    denom = mask.sum().clamp_min(1.0)
    loss = (F.cross_entropy(logits.transpose(1, 2), targets, reduction="none") * mask).sum() / denom
    acc = ((logits.argmax(-1) == targets).float() * mask).sum() / denom
    loss.backward()
    optimizer.step()
    return loss.detach(), acc.detach()


def train_speaker(
    tables_list: Sequence[SceneTables],
    num_steps: int = 500,
    batch: int = 64,
    hidden_size: int = 256,
    lr: float = 1e-3,
    seed: int = 0,
    checkpoint_dir: Optional[str] = None,
    pano_features=None,
    scheduled_sampling: bool = True,
    max_sample_prob: float = 0.5,
    num_pairs: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
    stats: Optional[dict] = None,
):
    """Returns (Flax parameter tree, vocabulary, final token accuracy).
    ``scheduled_sampling`` ramps the probability of feeding the model its
    own previous prediction from 0 to ``max_sample_prob`` over the first
    half of training; ``num_pairs`` sizes the sampled supervision set.
    ``stats``, when given, receives the loop's seconds (ending in a device
    synchronise), the first step's seconds and the final loss/accuracy."""
    dev = torch.device(device)
    vocab = Vocabulary()
    data = build_dataset(tables_list, vocab, num_pairs or max(batch * 8, 512), seed,
                         pano_features=pano_features)
    feat_dim = int(data[1].shape[-1])
    model = Seq2SeqSpeaker(vocab_size=len(vocab), hidden_size=hidden_size, max_decode_len=MAX_WORDS,
                           world_feat_dim=feat_dim,
                           generator=torch.Generator().manual_seed(seed)).to(dev)
    # optax.adam's defaults
    optimizer = torch.optim.Adam(model.parameters(), lr=lr, betas=(0.9, 0.999), eps=1e-8)
    acts, feats, lens, words = (torch.as_tensor(x).to(dev) for x in data)
    gen = torch.Generator(device=dev).manual_seed(seed)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)

    sync()
    t0 = time.perf_counter()
    first_s = None
    loss = acc = torch.zeros(())
    ramp = max(num_steps // 2, 1)
    for i in range(num_steps):
        sample_prob = max_sample_prob * min(i / ramp, 1.0) if scheduled_sampling else 0.0
        idx = torch.randint(0, acts.shape[0], (batch,), generator=gen, device=dev)
        loss, acc = train_step(model, optimizer, acts[idx], feats[idx], lens[idx], words[idx],
                               vocab.pad_id, sample_prob, gen)
        if i == 0:
            sync()
            first_s = time.perf_counter() - t0
        if i % 100 == 0:
            logger.info(f"speaker {i}: loss {float(loss):.3f} acc {float(acc):.3f} ss {sample_prob:.2f}")
    sync()
    loop_s = time.perf_counter() - t0
    logger.info(f"speaker done in {loop_s:.1f}s: acc {float(acc):.3f}")
    params = to_flax_params(model)
    if stats is not None:
        stats.update(loop_seconds=loop_s, first_step_seconds=first_s, steps=num_steps, batch=batch,
                     loss=float(loss), acc=float(acc), num_pairs=int(acts.shape[0]))
    if checkpoint_dir:
        path = save_checkpoint(checkpoint_dir, "speaker.pth", {
            "state_dict": params,
            "vocab": vocab.idx2word,
            # the model's geometry, so loaders rebuild the exact net (and
            # fail loudly on a pano-feature on/off mismatch)
            "hidden_size": hidden_size,
            "world_feat_dim": feat_dim,
        })
        if stats is not None:
            stats.update(checkpoint=path, checkpoint_bytes=os.path.getsize(path))
    return params, vocab, float(acc)


def main(argv: Optional[List[str]] = None) -> Dict:
    """Runs the command line ``argv``; returns the run's ``stats`` (loop
    seconds, final loss and accuracy, the checkpoint's path and bytes)."""
    import argparse

    from avlen_tpu_torch.sim.graph import build_scene_tables
    from avlen_tpu_torch.sim.synthetic import make_grid_scene

    p = argparse.ArgumentParser()
    p.add_argument("--output", default="data/speaker")
    p.add_argument("--steps", type=int, default=2000)
    p.add_argument("--scenes", type=int, default=2)
    p.add_argument("--side", type=int, default=8)
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.device == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available (pass --device cpu to run on the CPU)")
    rng = np.random.RandomState(0)
    tables = [build_scene_tables(make_grid_scene(rng, side=args.side)) for _ in range(args.scenes)]
    stats: Dict = {}
    train_speaker(tables, num_steps=args.steps, checkpoint_dir=args.output, device=args.device, stats=stats)
    return stats


if __name__ == "__main__":
    main()
