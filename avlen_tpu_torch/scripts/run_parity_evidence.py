"""Seeded parity-evidence run: the staged AVLEN recipe and the paper's
Table-1-shaped protocol, on the port.

PyTorch counterpart of ``scripts/run_parity_evidence.py``: the same staged
recipe (SURVEY.md §2.8) on the same fixed synthetic world and seed — belief
pretraining → SAVi SMT pretrain (memory 1) → SAVi finetune (memory 30,
online belief) → π_l dialog pretraining → neural speaker training → AVLEN
interactive (the neural speaker serving the instruction channel) — each
stage's checkpoint picked by the reference's eval-best protocol, then on
the final checkpoints:

* heard/unheard sound splits (DATASET.HELD_OUT_SOUNDS + env.eval_consts),
* the query strategies ours/random/uniform/jask with SR/SPL/SNA/mean
  queries per cell,
* a goal-only (SAVi, no-query) row.

Training curves are read from the stages' event files with the port's own
reader (``utils/tb.read_scalars``; no tensorboard package) into
``curves.npz``; the table and stage finals go to ``summary.json``, both
under the JAX script's keys. The world and recipe options are the JAX
script's, lifted into ``recipe_options(seed, scale)`` (checkpoint paths as
``{name}`` fields filled at run time). The evals of one policy (the
checkpoint picks and the table's cells) share one trainer, its config
replaced eval by eval, where the JAX script builds a trainer an eval: each
eval resets its env state and seeds its own generator, so they read the
same. This is the port's own table; the
RNG streams differ from JAX's, so it is no claim of learning-curve parity.

Usage:
    python -m avlen_tpu_torch.scripts.run_parity_evidence [--workdir runs/parity_r3]
        [--scale 1.0] [--seed 7] [--eval-count 100] [--eval-only]
        [--retrain-interactive] [--device cuda|cpu]
"""

from __future__ import annotations

import argparse
import glob
import json
import os
import shutil
from typing import Any, Dict, List, Optional, Sequence

import numpy as np

PATHS = ("belief_ckpt", "pre_ckpt", "goal_ckpt", "vln_ckpt", "speaker_ckpt")


def recipe_options(seed: int, scale: float) -> Dict[str, Any]:
    """The JAX script's world and recipe options at ``seed`` and ``scale``
    (an update-count multiplier): opts lists whose checkpoint paths are
    ``{belief_ckpt}``-style fields, and the two offline stages' arguments."""

    def n(x):
        return str(max(2, int(round(x * scale))))

    world = [
        "SEED", str(seed),
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SCENES", "1",
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "5",
        "TASK_CONFIG.DATASET.SYNTHETIC.SEED", "0",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "64",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "300",
        "TASK_CONFIG.DATASET.SYNTHETIC.MIN_HOPS", "1",
        "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "8",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "4",
        # heard/unheard protocol: sound 3 never trains; unheard evals remap
        # every episode onto it via env.eval_consts
        "TASK_CONFIG.DATASET.HELD_OUT_SOUNDS", "[3]",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
        # full recipe sensor suite (semantic_audiogoal.yaml TASK.SENSORS):
        # online belief training needs the pointgoal sensor for the
        # location-head regression target
        "TASK_CONFIG.TASK.SENSORS",
        "['SPECTROGRAM_SENSOR','CATEGORY','CATEGORY_BELIEF','LOCATION_BELIEF',"
        "'POSE_SENSOR','COLLISION','ORACLE_ACTION_SENSOR',"
        "'POINTGOAL_WITH_GPS_COMPASS_SENSOR']",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "40",
        "NUM_PROCESSES", "32",
        "LOG_INTERVAL", "10",
        "RL.PPO.num_steps", "40",
        "RL.PPO.num_mini_batch", "2",
        "RL.PPO.ppo_epoch", "2",
        "RL.PPO.hidden_size", "128",
        "RL.PPO.CLIP_WIDTH", "128",
        "RL.PPO.CLIP_LAYERS", "4",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "128",
        "NUM_DIALOG_STEPS", "4",
        "CHECKPOINT_INTERVAL", "50",
        # the recipe hyperparameters (savi_pretraining.yaml:21-28)
        "RL.PPO.lr", "2.5e-4",
        "RL.PPO.entropy_coef", "0.05",
        "RL.PPO.max_grad_norm", "0.2",
        # linear LR decay (the reference's LambdaLR, ppo_trainer.py:1176-1178)
        "RL.PPO.use_linear_lr_decay", "True",
    ]
    # stage 1: SAVi SMT pretraining (memory 1) with the belief predictor
    # online (savi_pretraining.yaml:41,55-56): the beliefs are the goal
    pretrain = [
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "1",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.pretraining", "True",
        "RL.PPO.use_belief_predictor", "True",
        "RL.PPO.BELIEF_PREDICTOR.online_training", "True",
        "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "{belief_ckpt}",
    ]
    # stage 2: SAVi finetune (memory 30), frozen towers (savi.yaml:45)
    finetune = [
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "30",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.freeze_encoders", "True",
        "RL.PPO.use_belief_predictor", "True",
        "RL.PPO.BELIEF_PREDICTOR.online_training", "True",
        "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "{belief_ckpt}",
        "RL.DDPPO.pretrained", "True",
        "RL.DDPPO.pretrained_weights", "{pre_ckpt}",
    ]
    interactive = [
        "RL.PPO.policy_type", "interactive",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "30",
        "RL.PPO.use_belief_predictor", "True",
        "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "{belief_ckpt}",
        "REPLAY_STORE", "True",
        "GOAL_CKPT_PATH", "{goal_ckpt}",
        "VLN_CKPT_PATH", "{vln_ckpt}",
        "SPEAKER.BACKEND", "neural",
        "SPEAKER.CKPT_PATH", "{speaker_ckpt}",
    ]
    return {
        "world": world,
        "belief": dict(num_steps=int(300 * scale), batch=64, log_interval=100),
        "pretrain": pretrain,
        "pretrain_train": pretrain + ["NUM_UPDATES", n(300)],
        "finetune": finetune,
        "finetune_train": finetune + ["NUM_UPDATES", n(400)],
        "dialog_train": [
            "DIALOG_TRAINING", "True",
            "RL.PPO.policy_type", "dialog",
            "NUM_UPDATES_DIALOG", n(150),
            "CHECKPOINT_INTERVAL_DIALOG", "40",
            "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "30",
        ],
        "speaker": dict(num_steps=int(400 * scale), batch=32, hidden_size=128),
        "interactive": interactive,
        "interactive_train": interactive + ["NUM_UPDATES", n(200)],
        "pick_n_eval": 60,
        "pick_eval": ["NUM_UPDATES", "1", "TEST_EPISODE_COUNT", "{n_eval}", "VIDEO_OPTION", "[]"],
        "eval_count": ["TEST_EPISODE_COUNT", "{eval_count}", "VIDEO_OPTION", "[]"],
        "table_eval": ["NUM_UPDATES", "1", "QS_METHOD", "{qs}", "SOUND_TYPE", "{sound}"],
        "goal_only_eval": [
            "NUM_UPDATES", "1",
            "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "30",
            "RL.PPO.use_belief_predictor", "True",
            "RL.PPO.BELIEF_PREDICTOR.pretrained_path", "{belief_ckpt}",
            "SOUND_TYPE", "{sound}",
        ],
    }


def fill(opts: Sequence[str], **fields) -> List[str]:
    """``opts`` with its ``{name}`` fields filled from ``fields``."""
    return [o.format(**fields) if o.startswith("{") else o for o in opts]


def scrape_tb(event_dir: str):
    """{tag: (steps int64, values float32)} from an event directory."""
    from avlen_tpu_torch.utils.tb import read_scalars

    return {tag: (np.asarray([s for s, _ in ev], np.int64), np.asarray([v for _, v in ev], np.float32))
            for tag, ev in read_scalars(event_dir).items()}


def run(args, world_overrides: Sequence[str] = (), n_eval: Optional[int] = None) -> Dict[str, Any]:
    """The recipe and the table under ``args`` (``main``'s flags), the
    ``world_overrides`` opts after the world's in every config; returns the
    summary it writes."""
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.core.registry import registry
    from avlen_tpu_torch.dialog.speaker.train_speaker import train_speaker
    from avlen_tpu_torch.pretraining.audiogoal_predictor import train_audiogoal_predictor
    import avlen_tpu_torch.rl.trainers  # noqa: F401  (registers the trainers)
    from avlen_tpu_torch.sim.builder import build_world_from_config
    from avlen_tpu_torch.utils.tb import TensorboardWriter

    w = args.workdir
    os.makedirs(w, exist_ok=True)
    dev = args.device
    rec = recipe_options(args.seed, args.scale)
    world = rec["world"] + list(world_overrides)
    paths = {k: "" for k in PATHS}
    n_eval = rec["pick_n_eval"] if n_eval is None else n_eval
    curves: Dict[str, Any] = {}

    def opts(*parts, **extra):
        return world + [o for part in parts for o in fill(part, **paths, **extra)]

    def train_stage(stage, trainer_name, extra, model_dir):
        cfg = get_config(opts=opts(extra), model_dir=model_dir)
        if not args.eval_only:
            registry.get_trainer(trainer_name)(cfg, device=dev).train()
        for tag, series in scrape_tb(cfg.TENSORBOARD_DIR).items():
            curves[f"{stage}/{tag}"] = series
        print(f"[parity] stage {stage} done", flush=True)

    # the evals of one policy share one trainer, its config replaced eval by
    # eval (each eval resets its env state and seeds its own generator)
    trainers: Dict[str, Any] = {}

    def evaluate(trainer_name, cfg, ckpt):
        trainer = trainers.get(trainer_name)
        if trainer is None:
            trainer = trainers[trainer_name] = registry.get_trainer(trainer_name)(cfg, device=dev)
        trainer.config = cfg
        trainer.ensure_setup()
        with TensorboardWriter(None) as writer:
            return trainer._eval_checkpoint(ckpt, writer, 0)

    def pick_best_ckpt(stage, trainer_name, extra, ckpts):
        """The reference's eval-best protocol (run.py --run-type eval +
        find_best_ckpt_idx over val scalars): every saved checkpoint on the
        val protocol, the winner to the next stage."""
        if len(ckpts) == 1:
            return ckpts[0], {}
        cfg = get_config(opts=opts(extra, rec["pick_eval"], n_eval=n_eval),
                         model_dir=os.path.join(w, "eval", f"pick_{stage}"))
        scores = {}
        for ck in ckpts:
            means = evaluate(trainer_name, cfg, ck)
            scores[ck] = (float(means.get("success") or 0.0), float(means.get("spl") or 0.0))
            print(f"[parity] pick {stage}: {os.path.basename(ck)} -> "
                  f"SR {scores[ck][0]:.3f} SPL {scores[ck][1]:.3f}", flush=True)
        best = max(ckpts, key=lambda c: scores[c])
        print(f"[parity] pick {stage}: best = {os.path.basename(best)}", flush=True)
        return best, {os.path.basename(k): v for k, v in scores.items()}

    def ckpts_of(*parts):
        found = glob.glob(os.path.join(w, *parts, "ckpt.*.pth"))
        return sorted(found, key=lambda p: int(p.rsplit(".", 2)[-2]))

    # stage 0: offline belief (audiogoal predictor) pretraining on the same world
    paths["belief_ckpt"] = os.path.join(w, "belief", "label_predictor.pth")
    tables0 = None
    if not args.eval_only:
        cfg0 = get_config(opts=world, model_dir=os.path.join(w, "belief"))
        bank0, tables0, _ = build_world_from_config(cfg0, with_rgb=False, with_depth=False, device=dev)
        train_audiogoal_predictor(bank0, checkpoint_dir=os.path.join(w, "belief"), **rec["belief"])
        del bank0
        print("[parity] stage belief_pretrain done", flush=True)

    train_stage("savi_pretrain", "savi", rec["pretrain_train"], os.path.join(w, "savi_pre"))
    paths["pre_ckpt"], _ = pick_best_ckpt("savi_pretrain", "savi", rec["pretrain"], ckpts_of("savi_pre", "data"))

    train_stage("savi_finetune", "savi", rec["finetune_train"], os.path.join(w, "savi"))
    paths["goal_ckpt"], goal_scores = pick_best_ckpt("savi_finetune", "savi", rec["finetune"],
                                                     ckpts_of("savi", "data"))

    train_stage("dialog_pretrain", "ddppo", rec["dialog_train"], os.path.join(w, "vln"))
    paths["vln_ckpt"] = ckpts_of("vln", "data", "vln")[-1]

    # stage 4: the neural speaker the interactive stage loads (speaker_pipeline.py:27)
    paths["speaker_ckpt"] = os.path.join(w, "speaker", "speaker.pth")
    if not args.eval_only:
        train_speaker(tables0, checkpoint_dir=os.path.join(w, "speaker"), device=dev, **rec["speaker"])
        print("[parity] stage speaker done", flush=True)

    # stage 5: AVLEN interactive (π_q PPO + π_l replay, neural speaker)
    if args.retrain_interactive:
        shutil.rmtree(os.path.join(w, "avlen"), ignore_errors=True)
        args.eval_only = False  # train this stage
    train_stage("interactive", "ddppo", rec["interactive_train"], os.path.join(w, "avlen"))
    avlen_ckpt, avlen_scores = pick_best_ckpt("interactive", "ddppo", rec["interactive"],
                                              ckpts_of("avlen", "data"))

    # the paper's table: query strategies x heard/unheard (ppo_trainer.py:
    # 1333-1356) and a goal-only SAVi row
    table = {}
    for qs in ("ours", "random", "uniform", "jask"):
        for sound in ("heard", "unheard"):
            cfg = get_config(opts=opts(rec["interactive"], rec["eval_count"], rec["table_eval"],
                                       eval_count=args.eval_count, qs=qs, sound=sound),
                             model_dir=os.path.join(w, "eval", f"{qs}_{sound}"))
            means = evaluate("ddppo", cfg, avlen_ckpt)
            table[f"{qs}/{sound}"] = {
                "success": means.get("success"),
                "spl": means.get("spl"),
                "sna": means.get("sna"),
                "mean_queries": means.get("query_count"),
                "episodes": means.get("episodes_evaluated"),
            }
            print(f"[parity] eval {qs}/{sound}: {table[f'{qs}/{sound}']}", flush=True)
    for sound in ("heard", "unheard"):
        cfg = get_config(opts=opts(rec["eval_count"], rec["goal_only_eval"], eval_count=args.eval_count,
                                   sound=sound),
                         model_dir=os.path.join(w, "eval", f"goalonly_{sound}"))
        means = evaluate("savi", cfg, paths["goal_ckpt"])
        table[f"goal_only/{sound}"] = {
            "success": means.get("success"),
            "spl": means.get("spl"),
            "sna": means.get("sna"),
            "mean_queries": 0.0,
            "episodes": means.get("episodes_evaluated"),
        }
        print(f"[parity] eval goal_only/{sound}: {table[f'goal_only/{sound}']}", flush=True)

    npz = {}
    for tag, (steps, vals) in curves.items():
        safe = tag.replace("/", "__")
        npz[safe + "__steps"] = steps
        npz[safe + "__values"] = vals
    np.savez_compressed(os.path.join(w, "curves.npz"), **npz)

    def final(stage, tag, k=5):
        key = f"{stage}/{tag}"
        if key not in curves or len(curves[key][1]) == 0:
            return None
        return float(np.mean(curves[key][1][-k:]))

    summary = {
        "seed": args.seed,
        "scale": args.scale,
        "recipe": "belief → savi_pretrain → savi_finetune → dialog → speaker → interactive(neural speaker)",
        "ckpt_selection": {
            "protocol": "eval-best over saved checkpoints (run.py find_best_ckpt_idx protocol)",
            "goal_ckpt": os.path.basename(paths["goal_ckpt"]),
            "goal_ckpt_scores": goal_scores,
            "avlen_ckpt": os.path.basename(avlen_ckpt),
            "avlen_ckpt_scores": avlen_scores,
        },
        "savi_finetune": {
            "success": final("savi_finetune", "Metrics/success"),
            "spl": final("savi_finetune", "Metrics/spl"),
            "reward": final("savi_finetune", "Metrics/reward"),
        },
        "interactive": {
            "success": final("interactive", "Metrics/success"),
            "spl": final("interactive", "Metrics/spl"),
            "reward": final("interactive", "Metrics/reward"),
        },
        "eval_table": table,
    }
    with open(os.path.join(w, "summary.json"), "w") as f:
        json.dump(summary, f, indent=2)
    print("[parity] summary:", json.dumps(summary), flush=True)
    return summary


def parse_args(argv: Optional[Sequence[str]] = None):
    p = argparse.ArgumentParser()
    p.add_argument("--workdir", default="runs/parity_r3")
    p.add_argument("--scale", type=float, default=1.0, help="update-count multiplier")
    p.add_argument("--seed", type=int, default=7)
    p.add_argument("--eval-count", type=int, default=100,
                   help="episodes per eval-table cell (reference protocol: full split, "
                   "savi/config/default.py:348-362)")
    p.add_argument("--eval-only", action="store_true",
                   help="skip all training stages; reuse the workdir's saved checkpoints and only "
                   "(re)run checkpoint picking + the eval table")
    p.add_argument("--retrain-interactive", action="store_true",
                   help="reuse stages 0-4 but retrain stage 5 (AVLEN interactive) against the "
                   "freshly-picked goal checkpoint, then rebuild the eval table")
    p.add_argument("--device", choices=["cuda", "cpu"], default="cuda")
    args = p.parse_args(argv)
    if args.retrain_interactive:
        args.eval_only = True  # stages 0-4 reuse the workdir artifacts
    return args


def main(argv: Optional[Sequence[str]] = None) -> Dict[str, Any]:
    """Runs the command line ``argv``; returns the summary."""
    from avlen_tpu_torch.utils.platform import require_device, require_sm90a

    args = parse_args(argv)
    require_device(args.device)
    if args.device == "cuda":
        require_sm90a()
    return run(args)


if __name__ == "__main__":
    main()
