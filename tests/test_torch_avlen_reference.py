"""AVLEN stage-2 evaluation against the benchmark's plain reference, on a tiny
world on the CPU: the cell ``avlen.eval.e10``'s set-up (checkpoints written
from the seed, ``InteractiveDDPPOTrainer.eval_start``) and its checked
collect through ``eval_collect``, then ``portbench/reference/avlen.py``
follows that collect; π_q's, π_g's and π_l's outputs, the beliefs, every
query's CLIP features, the speaker's logits and the CLIP tokens of its
words fall within the cell's limits. A CLIP layer skipped, the speaker's
attention zeroed or π_l's dialog embedding dropped in the program each
fails its number. The rollout's spans open where the docstring of
``collect_rollout_interactive`` says, the counters agree with the carry and
the speaker's memo, and recording changes no output."""

import time
from types import SimpleNamespace

import pytest
import torch

from avlen_tpu_torch.dialog.speaker.model import AttnDecoderLSTM
from avlen_tpu_torch.models import graphed
from avlen_tpu_torch.models.clip_text import CLIPTextEncoder
from avlen_tpu_torch.models.dialog_encoder import DialogStateEncoder
from avlen_tpu_torch.rl.trainers.interactive import InteractiveEval
from avlen_tpu_torch.utils import profiling
from portbench import harness, program
from portbench import run as pb_run
from portbench.reference.avlen import follow

torch.set_num_threads(1)

CELL = "avlen.eval.e10"
STEPS = 4
# the tiny world of tests/test_torch_interactive_train.py; eval runs 10 envs
TINY = ("TASK_CONFIG.DATASET.SYNTHETIC.SIDE", 4, "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", 20,
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", 2000, "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", 16,
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", 8000, "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", False,
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", 4, "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", 32,
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", 4, "RL.PPO.CLIP_WIDTH", 32, "RL.PPO.CLIP_LAYERS", 2,
        "RL.PPO.num_steps", STEPS)
NUMBERS = {"spectrogram", "option", "goal", "dialog", "belief", "clip", "speaker", "speaker_margin", "tokens"}


@pytest.fixture(scope="module")
def cell(tmp_path_factory):
    d = tmp_path_factory.mktemp("avlen_reference")
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("TMPDIR", str(d))
        drv = harness.driver_module("avlen_eval")
        args = pb_run.parse(["--workload", CELL, "--seed", "2200000017", "--seconds", "0", "--trace", "0"])
        ctx = dict(args=args, config=harness.config_file("avlen"), workload=harness.workload_file(CELL),
                   device=torch.device("cpu"), extra_opts=TINY, t_start=time.perf_counter())
        trainer, ev, theta0, hp, paths, _ = drv.set_up(ctx)
        program.remove_checkpoints(list(paths.values()))
    start = ev.generator.get_state()

    def fresh_eval() -> InteractiveEval:
        """The eval as ``eval_start`` left it: every env at its first
        episode, the generator at its seed, the speaker's memo empty."""
        gen = torch.Generator()
        gen.set_state(start)
        trainer.instr_source._cache.clear()
        return InteractiveEval(carry=ev.carry, consts=ev.consts, generator=gen, count=ev.count, budget=ev.budget)

    def numbers():
        prog, rec, sampled = drv.checked_collect(trainer, fresh_eval(), 2, 1)
        ref = follow(theta0, hp, rec, "cpu")
        return drv.avlen_numbers(prog, rec, ref, program.audio_inputs(trainer.env, sampled), "cpu"), rec

    return SimpleNamespace(trainer=trainer, fresh_eval=fresh_eval, numbers=numbers,
                           limits=harness.workload_file(CELL)["limits"])


def test_the_reference_follows_the_eval_collect(cell):
    numbers, rec = cell.numbers()
    assert set(numbers) == NUMBERS
    # the collect exercised every layer compared: queries, decodes, CLIP
    assert rec["newly"].any() and rec["decodes"] and rec["dones"].any()
    for name, value in numbers.items():
        assert value <= cell.limits[name], (name, value)
    assert numbers["tokens"] == 0


def _skip_a_clip_layer(mp):
    forward = CLIPTextEncoder.forward

    def skipped(self, tokens):
        self.layers -= 1
        try:
            return forward(self, tokens)
        finally:
            self.layers += 1

    mp.setattr(CLIPTextEncoder, "forward", skipped)


def _zero_the_speakers_attention(mp):
    step = AttnDecoderLSTM.step
    mp.setattr(AttnDecoderLSTM, "step", lambda self, carry, word, ctx, mask: step(self, carry, word, 0 * ctx, mask))


def _drop_the_dialog_embedding(mp):
    forward = DialogStateEncoder.forward
    mp.setattr(DialogStateEncoder, "forward",
               lambda self, x_att, mem, valid, emb, step, goal: forward(self, x_att, mem, valid, None, step, goal))


@pytest.mark.parametrize("fault,caught_by", [
    (_skip_a_clip_layer, "clip"),
    (_zero_the_speakers_attention, "speaker"),
    (_drop_the_dialog_embedding, "dialog"),
])
def test_a_fault_in_the_program_fails_its_number(cell, fault, caught_by):
    with pytest.MonkeyPatch.context() as mp:
        fault(mp)
        numbers, _ = cell.numbers()
    assert numbers[caught_by] > cell.limits[caught_by], numbers


def _leaves(tree):
    leaves = []
    graphed.flatten(tree, leaves)
    return leaves


def test_spans_and_counters_of_the_eval_collect(cell):
    tr = cell.trainer
    clip0 = tr.clip_calls
    profiling.enable()
    try:
        traj = tr.eval_collect(cell.fresh_eval())
    finally:
        profiling.disable()
    out = profiling.export()
    clip_calls = tr.clip_calls - clip0
    memo = dict(tr.instr_source._cache)
    plain = tr.eval_collect(cell.fresh_eval())
    on, off = _leaves(traj), _leaves(plain)
    assert len(on) == len(off) and all(torch.equal(a, b) for a, b in zip(on, off))

    by, counters = out["by_name"], out["counters"]
    for name in ("collect.step", "collect.belief", "collect.option", "collect.act", "collect.dialog",
                 "collect.env_step"):
        assert by[name]["count"] == STEPS, name
    for name in ("collect", "collect.bootstrap", "collect.stack"):
        assert by[name]["count"] == 1, name
    newly = traj["queried"] & (traj["rl_mask"] > 0)
    query_steps = set(newly.any(dim=1).nonzero()[:, 0].tolist())
    spans = out["spans"]
    for name in ("collect.clip", "collect.instruction"):
        assert {s for n, s in zip(spans["name"], spans["step"]) if n == name} == query_steps
        assert by[name]["count"] == len(query_steps)
    assert "stream_ns" in by["collect.clip"]
    b = newly.shape[1]
    decoded = [t for t in memo.values() if t is not tr.instr_source._stop_tokens]
    queries = int(newly.sum())
    assert clip_calls == len(query_steps)
    assert {k: counters.get(k, 0) for k in profiling.COUNTER_NAMES} == {
        "clip.rows": b * len(query_steps), "speaker.queries": queries,
        "speaker.cache_hits": queries - len(memo), "speaker.decodes": len(decoded)}
    assert decoded and by["speaker.decode"]["count"] == len(decoded)
