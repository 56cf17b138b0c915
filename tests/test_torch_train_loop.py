"""The port's training loop, checkpoints, resume, preemption and CLI on a
tiny savi.yaml world on the CPU: ``run.main([... "--device", "cpu"])``
trains two updates (``ckpt.0``, ``ckpt.1``, finite losses), resumes from
the newest checkpoint with the parameters, both Adam states and the LR
decay's step count exactly as saved, starts its loop at update 0 as the
JAX trainer does and writes ``ckpt.2``; a pending preemption saves the
interrupted state, which ``try_to_resume`` then prefers; eval runs on the
folder; the event files read back through TensorBoard's
``EventAccumulator`` with the same tags and values, and
``find_best_ckpt_idx`` agrees with the JAX package's."""

import logging
import os
import sys
import types

import numpy as np
import pytest
import torch
from tensorboard.backend.event_processing.event_accumulator import EventAccumulator

import chip_smoke
from avlen_tpu_torch import run
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils import preemption
from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
from avlen_tpu_torch.utils.logging import logger
from avlen_tpu_torch.utils.tb import TensorboardWriter, read_scalars
from tests.test_torch_slice import OPTS, SAVI

torch.set_num_threads(1)


def _main(model_dir, *args, run_type="train"):
    return run.main(["--run-type", run_type, "--exp-config", SAVI, "--model-dir", str(model_dir),
                     "--device", "cpu", *OPTS, "VIDEO_OPTION", "[]", "LOG_INTERVAL", "1",
                     "CHECKPOINT_INTERVAL", "1", *args])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """Train two updates, resume for two with a preemption signal pending
    before the second, then eval the folder's last checkpoint; each run
    through ``run.main``."""
    d = tmp_path_factory.mktemp("model")
    out = {"dir": d}
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(preemption, "INTERRUPTED_STATE_DIR", str(d / "interrupted"))
        mp.setattr(preemption, "EXIT", {"requested": False, "requeue": False})
        out["trained"] = _main(d, "NUM_UPDATES", "2")
        out["ckpts"] = [os.path.basename(p) for p in list_checkpoints(str(d / "data"))]
        out["saved"] = load_checkpoint(str(d / "data" / "ckpt.1.pth"))

        collect = SaviTrainer.collect
        seen = {}

        def hooked(self, *args, **kwargs):
            if not seen:  # before the resumed run's first update
                seen["diffs"] = chip_smoke.state_differences(self, out["saved"])
                seen["count"], seen["steps"] = self.optimizer.count, self.num_steps_done
                preemption.EXIT["requested"] = True  # a signal arrives during that update
            return collect(self, *args, **kwargs)

        records = []
        handler = logging.Handler(level=logging.INFO)
        handler.emit = lambda r: records.append(r.getMessage())
        logger.addHandler(handler)
        mp.setattr(SaviTrainer, "collect", hooked)
        try:
            out["resumed"] = _main(d, "NUM_UPDATES", "2", "RESUME_CHECKPOINT", "True")
        finally:
            logger.removeHandler(handler)
        mp.setattr(SaviTrainer, "collect", collect)
        out["resume_seen"], out["resume_log"] = seen, records
        out["after_resume"] = [os.path.basename(p) for p in list_checkpoints(str(d / "data"))]
        out["interrupted"] = preemption.load_interrupted_state()
        out["preferred"] = out["resumed"].try_to_resume()
        preemption.EXIT["requested"] = False
        out["evaluated"] = _main(d, "USE_LAST_CKPT", "True", "EVAL.SPLIT", "train", "TEST_EPISODE_COUNT", "8",
                                 run_type="eval")
    yield out
    for p in list_checkpoints(str(d / "data")) + [str(d / "interrupted" / "local.pth")]:
        os.remove(p)


def test_train_writes_checkpoints_with_finite_losses(runs):
    tr = runs["trained"]
    assert runs["ckpts"] == ["ckpt.0.pth", "ckpt.1.pth"]
    assert tr.num_updates_done == 2 and tr.num_steps_done == 2 * 5 * 3
    assert runs["saved"]["extra_state"] == {"step": 30}
    assert runs["saved"]["optim_state"]["count"] == 2 * 1 * 2  # updates x epochs x minibatches
    scalars = read_scalars(str(runs["dir"] / "tb"))
    for name in ("value_loss", "action_loss", "entropy", "belief_loss"):
        values = [v for step, v in scalars[f"Policy/{name}"] if step <= 30]
        assert len(values) == 2 and np.isfinite(values).all(), name
    assert {"Metrics/reward", "Metrics/success", "Metrics/spl"} <= set(scalars)


def test_resume_restores_exactly_and_starts_at_update_zero(runs):
    seen, tr = runs["resume_seen"], runs["resumed"]
    assert seen["diffs"] == {"state_dict": 0.0, "belief_predictor": 0.0, "optim_state": 0.0,
                             "belief_optim_state": 0.0}
    assert seen["count"] == 4 and seen["steps"] == 30  # the LR decay's step count and the frames
    assert any(m.startswith("resuming from") and m.endswith("ckpt.1.pth") for m in runs["resume_log"])
    updates = [m.split()[2] for m in runs["resume_log"] if m.startswith("savi update")]
    assert updates == ["0"]  # the loop starts again at 0, and the preemption stops it at 1
    assert tr.num_updates_done == 1 and tr.num_steps_done == 45
    assert runs["after_resume"] == ["ckpt.0.pth", "ckpt.1.pth", "ckpt.2.pth"]


def test_preemption_saves_the_interrupted_state_and_resume_prefers_it(runs):
    interrupted, preferred = runs["interrupted"], runs["preferred"]
    assert interrupted is not None and interrupted["extra_state"] == {"step": 45}
    assert "_resume_index" not in preferred  # not the newest checkpoint, which carries one
    assert chip_smoke._max_tree_diff(preferred["state_dict"], interrupted["state_dict"]) == 0
    assert chip_smoke.state_differences(runs["resumed"], interrupted) == {
        "state_dict": 0.0, "belief_predictor": 0.0, "optim_state": 0.0, "belief_optim_state": 0.0}


def test_cli_evals_the_trained_folder(runs):
    tr = runs["evaluated"]
    assert tr._last_eval_episode_ids == sorted(set(tr._last_eval_episode_ids)) and len(tr._last_eval_episode_ids) == 8
    scalars = read_scalars(str(runs["dir"] / "tb"))
    assert scalars["val/episodes_evaluated"] == [(2, 8.0)]  # ckpt.2, the folder's last


@pytest.fixture
def tensorboard_without_tensorflow(monkeypatch):
    """TensorBoard's own reader with its TF stub (its no-TensorFlow mode):
    where TensorFlow is installed, importing it takes seconds and reads the
    same files."""
    monkeypatch.setitem(sys.modules, "tensorboard.compat.notf", types.ModuleType("tensorboard.compat.notf"))


def test_event_files_read_back_through_tensorboard(runs, tensorboard_without_tensorflow):
    tb = str(runs["dir"] / "tb")
    acc = EventAccumulator(tb)
    acc.Reload()
    ours = read_scalars(tb)
    assert sorted(acc.Tags()["scalars"]) == sorted(ours)
    for tag, events in ours.items():
        theirs = [(e.step, e.value) for e in acc.Scalars(tag)]
        assert theirs == events, tag


def test_find_best_ckpt_idx_agrees_with_jax(runs, tmp_path, tensorboard_without_tensorflow):
    from avlen_tpu.run import find_best_ckpt_idx as jax_find_best_ckpt_idx

    tb = str(runs["dir"] / "tb")
    assert run.find_best_ckpt_idx(tb) == jax_find_best_ckpt_idx(tb) == 2
    with TensorboardWriter(str(tmp_path)) as writer:
        for step, spl in enumerate([0.1, 0.5, 0.3, 0.5]):
            writer.add_scalar("val/spl", spl, step)
    assert run.find_best_ckpt_idx(str(tmp_path)) == jax_find_best_ckpt_idx(str(tmp_path)) == 1
    assert run.find_best_ckpt_idx(str(tmp_path), "val/success") is None
    assert jax_find_best_ckpt_idx(str(tmp_path), "val/success") is None


def test_unported_trainer_name_raises_the_registry_keyerror(tmp_path):
    with pytest.raises(KeyError, match=r"No trainer registered under 'AVNavTrainer'. Known: \['savi'\]"):
        _main(tmp_path, "TRAINER_NAME", "AVNavTrainer")


def test_cuda_run_without_a_card_raises(tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="--device cpu"):
        run.main(["--run-type", "train", "--exp-config", SAVI, "--model-dir", str(tmp_path)])


def test_reader_leaves_out_a_record_still_being_written(tmp_path):
    with TensorboardWriter(str(tmp_path)) as writer:
        writer.add_scalar("val/spl", 0.25, 1)
        writer.add_scalar("val/spl", 0.75, 2)
    (path,) = tmp_path.iterdir()
    data = path.read_bytes()
    path.write_bytes(data[:-5])  # the last record cut short, as while a writer appends it
    assert read_scalars(str(tmp_path)) == {"val/spl": [(1, 0.25)]}
    path.write_bytes(data[:-5].replace(b"val/spl", b"val/spX"))  # a record whose bytes changed
    with pytest.raises(ValueError, match="CRC"):
        read_scalars(str(tmp_path))
