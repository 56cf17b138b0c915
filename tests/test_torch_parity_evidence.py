"""The port's recipe runner (``avlen_tpu_torch/scripts/run_parity_evidence.py``)
against the JAX package's (``scripts/run_parity_evidence.py``, read with
``ast``, never imported or run):

* ``recipe_options(seed, scale)`` equals the JAX script's world and recipe
  options, each list evaluated from the script's own expressions at the
  same seed and scale (checkpoint paths as ``{name}`` fields);
* a shrunken CPU run (a tiny world after the recipe's, scale 0.005) writes
  ``summary.json`` with the JAX script's keys, every table cell finite, and
  ``curves.npz`` with its ``<stage>__<tag>__{steps,values}`` keys;
* ``--eval-only`` reuses the workdir's checkpoints: no stage trains again,
  and the table is rebuilt from the same checkpoints.

The runs draw their weights uniformly (``torch.nn.init.trunc_normal_``
patched for the fixture): the full-width ResNet towers' truncated-normal
draws took over a third of the CPU run, and the runner's plumbing, not the
weights, is under test.
"""

import ast
import json
import math
import os
import types

import numpy as np
import pytest
import torch

from avlen_tpu_torch.scripts import run_parity_evidence as rpe

torch.set_num_threads(1)

JAX_SCRIPT = "scripts/run_parity_evidence.py"


def _jax_main():
    tree = ast.parse(open(JAX_SCRIPT).read())
    return next(n for n in tree.body if isinstance(n, ast.FunctionDef) and n.name == "main")


def _eval(node, ns):
    return eval(compile(ast.Expression(node), JAX_SCRIPT, "eval"), dict(ns))


def _calls(main, name):
    return [n for n in ast.walk(main) if isinstance(n, ast.Call) and isinstance(n.func, ast.Name)
            and n.func.id == name]


def _jax_options(seed, scale, eval_count):
    """What the JAX script hands each get_config and offline stage, its
    checkpoint paths and loop variables as ``{name}`` fields."""
    main = _jax_main()
    args = types.SimpleNamespace(seed=seed, scale=scale, eval_count=eval_count)

    def n(x):
        return str(max(2, int(round(x * scale))))

    ns = {"args": args, "n": n, "str": str, "int": int, "max": max, "round": round,
          **{k: "{" + k + "}" for k in rpe.PATHS + ("qs", "sound", "n_eval")}}
    assigns = {t.id: node.value for node in ast.walk(main) if isinstance(node, ast.Assign)
               for t in node.targets if isinstance(t, ast.Name)}
    for name in ("world", "pretrain_opts", "finetune_opts", "interactive_opts", "eval_count"):
        ns[name] = _eval(assigns[name], ns)
    runs = {c.args[0].value: _eval(c.args[2], ns) for c in _calls(main, "run")}
    pick = next(f for f in ast.walk(main) if isinstance(f, ast.FunctionDef) and f.name == "pick_best_ckpt")
    pick_list = next(c for c in _calls(pick, "get_config")).keywords[0].value.right
    configs = [c.keywords[0].value for c in _calls(main, "get_config")]
    table_list = next(v.right for v in configs if isinstance(v, ast.BinOp) and isinstance(v.right, ast.List)
                      and any(getattr(e, "value", None) == "QS_METHOD" for e in v.right.elts))
    goal_list = next(v.right for v in configs if isinstance(v, ast.BinOp) and isinstance(v.right, ast.List)
                     and any(getattr(e, "value", None) == "RL.PPO.use_belief_predictor" for e in v.right.elts))

    def kwargs(name):
        call = next(iter(_calls(main, name)))
        return {k.arg: _eval(k.value, ns) for k in call.keywords if k.arg not in ("checkpoint_dir",)}

    n_eval_default = pick.args.defaults[-1].value
    return {
        "world": ns["world"],
        "belief": kwargs("train_audiogoal_predictor"),
        "pretrain": ns["pretrain_opts"], "pretrain_train": runs["savi_pretrain"],
        "finetune": ns["finetune_opts"], "finetune_train": runs["savi_finetune"],
        "dialog_train": runs["dialog_pretrain"],
        "speaker": kwargs("train_speaker"),
        "interactive": ns["interactive_opts"], "interactive_train": runs["interactive"],
        "pick_n_eval": n_eval_default,
        "pick_eval": [v.replace(str(n_eval_default), "{n_eval}") if v == str(n_eval_default) else v
                      for v in _eval(pick_list, {**ns, "n_eval": n_eval_default})],
        "eval_count": [("{eval_count}" if v == str(eval_count) else v) for v in ns["eval_count"]],
        "table_eval": _eval(table_list, ns),
        "goal_only_eval": _eval(goal_list, ns),
    }


@pytest.mark.parametrize("seed,scale", [(7, 1.0), (3, 0.25), (11, 0.005)])
def test_recipe_options_equal_the_jax_scripts(seed, scale):
    want = _jax_options(seed, scale, eval_count=37)
    got = rpe.recipe_options(seed, scale)
    assert set(got) == set(want)
    for k in want:
        assert got[k] == want[k], k


# the recipe's world shrunk for the CPU: after the recipe's world in every config
TINY = [
    "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
    "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
    "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
    "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "24",
    "TASK_CONFIG.DATASET.SYNTHETIC.MAX_HOPS", "3",
    "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
    "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "4",
    "NUM_PROCESSES", "2",
    "RL.PPO.num_steps", "3",
    "RL.PPO.ppo_epoch", "1",
    "RL.PPO.hidden_size", "32",
    "RL.PPO.CLIP_WIDTH", "32",
    "RL.PPO.CLIP_LAYERS", "1",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
    "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    "NUM_DIALOG_STEPS", "2",
    "LOG_INTERVAL", "1",
]
ARGS = ["--scale", "0.005", "--seed", "7", "--eval-count", "1", "--device", "cpu"]


def _uniform_(w, mean=0.0, std=1.0, a=-2.0, b=2.0, generator=None):
    with torch.no_grad():
        return w.uniform_(a, b, generator=generator)


@pytest.fixture(scope="module")
def patched():
    """Cheap weights, the interrupted state under the workdir, and the
    recipe's AVLEN stage checkpointing every update (so that its pick
    evaluates two checkpoints)."""
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.nn.init, "trunc_normal_", _uniform_)
        recipe = rpe.recipe_options
        mp.setattr(rpe, "recipe_options", lambda seed, scale: {
            **recipe(seed, scale),
            "interactive_train": recipe(seed, scale)["interactive_train"] + ["CHECKPOINT_INTERVAL", "1"]})
        yield mp


@pytest.fixture(scope="module")
def runs(tmp_path_factory, patched):
    """The shrunken recipe."""
    from avlen_tpu_torch.utils import preemption

    w = tmp_path_factory.mktemp("parity")
    patched.setattr(preemption, "INTERRUPTED_STATE_DIR", str(w / "interrupted"))
    out = {"dir": w, "summary": rpe.run(rpe.parse_args(["--workdir", str(w), *ARGS]), TINY, n_eval=1)}
    out["files"] = {p: os.path.getmtime(p) for p in _checkpoint_files(w)}
    yield out
    for p in _checkpoint_files(w):
        os.remove(p)


@pytest.fixture(scope="module")
def eval_only(runs, patched):
    """``--eval-only`` on the recipe's workdir, every trainer's ``train``
    refused."""
    from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(BaseRLTrainer, "begin_train", lambda self: pytest.fail("--eval-only trained"))
        again = rpe.run(rpe.parse_args(["--workdir", str(runs["dir"]), "--eval-only", *ARGS]), TINY, n_eval=1)
    return {"again": again, "files_after": {p: os.path.getmtime(p) for p in _checkpoint_files(runs["dir"])}}


def _checkpoint_files(w):
    found = []
    for base, _, files in os.walk(str(w)):
        found += [os.path.join(base, f) for f in files if f.endswith(".pth")]
    return sorted(found)


JAX_KEYS = {"seed", "scale", "recipe", "ckpt_selection", "savi_finetune", "interactive", "eval_table"}
CELLS = {f"{qs}/{sound}" for qs in ("ours", "random", "uniform", "jask", "goal_only")
         for sound in ("heard", "unheard")}


def test_summary_has_the_jax_keys_and_finite_cells(runs):
    with open(runs["dir"] / "summary.json") as f:
        summary = json.load(f)
    assert summary == json.loads(json.dumps(runs["summary"]))
    assert set(summary) == JAX_KEYS
    assert set(summary["ckpt_selection"]) == {"protocol", "goal_ckpt", "goal_ckpt_scores", "avlen_ckpt",
                                              "avlen_ckpt_scores"}
    # two updates a stage at this scale: AVLEN's two checkpoints were
    # picked from, SAVi's one was taken as it is
    assert summary["ckpt_selection"]["goal_ckpt_scores"] == {}
    assert set(summary["ckpt_selection"]["avlen_ckpt_scores"]) == {"ckpt.0.pth", "ckpt.1.pth"}
    assert set(summary["eval_table"]) == CELLS
    for cell, row in summary["eval_table"].items():
        assert set(row) == {"success", "spl", "sna", "mean_queries", "episodes"}, cell
        assert all(isinstance(v, float) and math.isfinite(v) for v in row.values()), (cell, row)
        assert row["episodes"] == 1.0, cell
    assert {"success", "spl", "reward"} == set(summary["savi_finetune"]) == set(summary["interactive"])


def test_curves_hold_every_stage(runs):
    curves = np.load(runs["dir"] / "curves.npz")
    for stage, tag in (("savi_pretrain", "Policy__value_loss"), ("savi_finetune", "Metrics__reward"),
                       ("dialog_pretrain", "Policy__dialog_loss"), ("interactive", "Policy__value_loss")):
        steps, values = curves[f"{stage}__{tag}__steps"], curves[f"{stage}__{tag}__values"]
        assert steps.dtype == np.int64 and values.dtype == np.float32 and len(steps) == len(values) >= 1, stage
        assert np.isfinite(values).all(), stage
    for k in curves.files:
        assert k.endswith(("__steps", "__values")), k


def test_eval_only_reuses_the_checkpoints(runs, eval_only):
    assert eval_only["files_after"] == runs["files"]
    assert eval_only["again"]["ckpt_selection"] == runs["summary"]["ckpt_selection"]
    assert eval_only["again"]["eval_table"] == runs["summary"]["eval_table"]
