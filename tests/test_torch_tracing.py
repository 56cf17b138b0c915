"""The port's span recorder (``avlen_tpu_torch/utils/profiling.py``) on the
CPU, over the SAVi trainer's superstep in the tiny savi.yaml world of
``tests/test_torch_slice.py``: off it records nothing; on, the spans of the
training path nest as the layers do, with their rounds, steps and self
times; they agree with outside host clocks and with a ``torch.profiler``
trace through the exported clock offset; ``Timings`` keeps its keys and
totals; and ``disable`` takes the collector callback off again."""

import ast
import gc
import re
import time
from pathlib import Path

import pytest
import torch

from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils import profiling

ROOT = Path(__file__).resolve().parent.parent


def slice_world():
    """``SAVI`` and ``OPTS`` of tests/test_torch_slice.py, read from its
    source (importing it would import JAX)."""
    tree = ast.parse((ROOT / "tests" / "test_torch_slice.py").read_text())
    found = {t.id: ast.literal_eval(node.value) for node in tree.body if isinstance(node, ast.Assign)
             for t in node.targets if isinstance(t, ast.Name) and t.id in ("SAVI", "OPTS")}
    return found["SAVI"], found["OPTS"]


@pytest.fixture(scope="module")
def trainer():
    torch.set_num_threads(1)
    savi, opts = slice_world()
    tr = SaviTrainer(get_config(savi, opts=opts), device="cpu")
    tr._setup()
    return tr


def superstep(tr, timings=None):
    timings = profiling.Timings() if timings is None else timings
    return tr.superstep(lambda _, c: tr.collect(c), lambda _, b, k, g: (None, tr.update(b, grad_reduce=g)), timings)


def run_rounds(tr, n, timings=None):
    step = superstep(tr, timings)
    for _ in range(n):
        _, tr.carry, _, _ = step(None, tr.carry)
        tr.carry = tr._refresh_episode_stream(tr.carry)


@pytest.fixture
def traced(trainer):
    """Two rounds recorded (the spans exported, and the Timings)."""
    timings = profiling.Timings()
    profiling.enable()
    try:
        run_rounds(trainer, 2, timings)
    finally:
        profiling.disable()
    return profiling.export(), timings


def test_off_records_nothing_and_span_is_the_shared_noop(trainer):
    profiling.enable()
    profiling.disable()
    assert profiling.span("collect") is profiling.span("update", stream=True, cpu=True, step=3)
    run_rounds(trainer, 1)
    out = profiling.export()
    assert out["spans"]["name"] == [] and out["by_name"] == {} and out["gc"] == [] and out["rounds"] == 0


def test_on_spans_nest_by_layer_with_rounds_and_steps(trainer, traced):
    out, _ = traced
    s = out["spans"]
    names, parents = s["name"], s["parent"]
    parent_of = {}
    for i, p in enumerate(parents):
        parent_of.setdefault(names[i], set()).add(names[p] if p >= 0 else None)
    assert parent_of == {
        "collect_time": {None}, "update_time": {None}, "trainer.refresh_episode_stream": {None},
        "superstep.sync": {"collect_time", "update_time"}, "collect": {"collect_time"},
        "collect.step": {"collect"}, "collect.bootstrap": {"collect"}, "collect.stack": {"collect"},
        "collect.belief": {"collect.step"}, "collect.act": {"collect.step"}, "collect.env_step": {"collect.step"},
        "act.towers": {"collect.act"}, "act.smt": {"collect.act"}, "act.heads": {"collect.act"},
        "env.dynamics": {"collect.env_step"}, "env.audio": {"collect.env_step"}, "env.frames": {"collect.env_step"},
        "update": {"update_time"}, "update.gae": {"update"}, "update.minibatch": {"update"},
        "update.backward": {"update"}, "update.optimizer_step": {"update"}, "update.belief_step": {"update"},
    }
    # every parent opened before its child and closed after it
    for i, p in enumerate(parents):
        if p >= 0:
            assert s["start_ns"][p] <= s["start_ns"][i] <= s["end_ns"][i] <= s["end_ns"][p]
    assert out["rounds"] == 2
    assert sorted(set(s["round"])) == [1, 2]
    t = trainer.num_steps
    for r in (1, 2):
        steps = [s["step"][i] for i, n in enumerate(names) if n == "collect.step" and s["round"][i] == r]
        assert steps == list(range(t))
    # a step's children carry its index; outside the steps it is -1
    for i, n in enumerate(names):
        if n in ("collect.act", "act.smt", "env.audio"):
            assert s["step"][i] == s["step"][parents[i]] >= 0
        if n in ("collect", "collect.bootstrap", "update", "update_time"):
            assert s["step"][i] == -1
    counts = {n: c["count"] for n, c in out["by_name"].items()}
    assert counts["collect.step"] == counts["collect.act"] == counts["env.audio"] == 2 * t
    assert counts["collect"] == counts["update"] == counts["update.belief_step"] == 2
    assert set(out["by_name"]) <= set(profiling.SPAN_NAMES)
    # self time: duration less the direct children's, each name's sum
    dur = [e - b for b, e in zip(s["start_ns"], s["end_ns"])]
    for name, agg in out["by_name"].items():
        own = [i for i, n in enumerate(names) if n == name]
        want = sum(dur[i] - sum(dur[j] for j, p in enumerate(parents) if p == i) for i in own)
        assert agg["total_ns"] == sum(dur[i] for i in own)
        assert abs(agg["self_ns"] - want) <= 0.01 * agg["total_ns"]
    # the stream spans (the host clock on the CPU) and the collect's CPU time
    assert {names[i] for i, _ in out["stream_ns"]} == {"collect_time", "update_time", "update",
                                                       "update.belief_step"}
    assert [names[i] for i, _ in out["cpu_ns"]] == ["collect", "collect"]
    assert all(0 < ns <= 1.05 * dur[i] + 2e6 for i, ns in out["cpu_ns"])


def test_span_totals_match_host_clocks_around_the_same_calls(trainer):
    totals = {"collect.env_step": 0, "collect.act": 0}

    def clocked(obj, attr, key):
        fn = getattr(obj, attr)

        def wrapped(*a, **k):
            t0 = time.perf_counter_ns()
            out = fn(*a, **k)
            totals[key] += time.perf_counter_ns() - t0
            return out
        setattr(obj, attr, wrapped)

    clocked(trainer.env, "step", "collect.env_step")
    clocked(trainer.policy, "act", "collect.act")
    profiling.enable()
    try:
        trainer.collect()
    finally:
        profiling.disable()
        del trainer.env.step, trainer.policy.act
    by_name = profiling.export()["by_name"]
    for key, ns in totals.items():
        assert abs(by_name[key]["total_ns"] - ns) <= 0.02 * ns, key


def test_clock_offset_joins_the_spans_with_the_profiler_trace(trainer):
    from torch.profiler import ProfilerActivity, profile, record_function

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        # a profile's first annotation is stamped up to ~0.1 ms into its entry
        with record_function("profile.first"):
            pass
        profiling.enable(annotate=True)
        try:
            trainer.collect()
        finally:
            profiling.disable()
    out = profiling.export(prof)
    offset = out["clock_offset_ns"]
    assert offset is not None
    theirs = {}
    for name, start in profiling.profiler_starts(prof):
        theirs.setdefault(name, []).append(start)
    s = out["spans"]
    assert sorted(i for i, _ in out["annotated"]) == list(range(len(s["name"])))
    mine = {}
    for i, entry_ns in out["annotated"]:
        mine.setdefault(s["name"][i], []).append((s["start_ns"][i], entry_ns))
    assert profiling.ANCHOR in mine and "collect.act" in mine and "env.audio" in mine
    for name, starts in mine.items():
        assert len(theirs[name]) == len(starts), name
        # the profiler stamps the range inside its entry, which a busy host
        # can stretch (a preempted entry took 283 µs once)
        for (m, entry_ns), t in zip(sorted(starts), sorted(theirs[name])):
            assert abs(m + offset - t) <= 50_000 + entry_ns, name


def test_timings_keys_and_totals_unchanged_by_tracing(trainer, traced):
    out, timings = traced
    assert set(timings.totals) == {"collect_time", "update_time"}
    for key, secs in timings.totals.items():
        assert abs(out["by_name"][key]["total_ns"] / 1e9 - secs) <= 0.01 * secs
    off = profiling.Timings()
    run_rounds(trainer, 1, off)
    assert set(off.totals) == set(timings.totals)
    assert "superstep_time=" not in off.summary() and "collect_time=" in off.summary()


def test_disable_removes_the_gc_callback_and_pauses_are_recorded():
    before = list(gc.callbacks)
    profiling.enable()
    assert len(gc.callbacks) == len(before) + 1
    gc.collect()
    profiling.disable()
    assert gc.callbacks == before
    pauses = profiling.export()["gc"]
    assert pauses and all(g == 2 and ns >= 0 for g, _, ns, _ in pauses)
    gc.collect()
    assert profiling.export()["gc"] == pauses


def test_every_span_the_program_opens_is_listed():
    used = set()
    for path in (ROOT / "avlen_tpu_torch").rglob("*.py"):
        used |= set(re.findall(r"\bspan\(\"([^\"]+)\"", path.read_text()))
    assert used and used | {profiling.ANCHOR} | {"superstep_time", "collect_time", "update_time", "host_time",
                                                  "checkpoint_time"} == set(profiling.SPAN_NAMES)
