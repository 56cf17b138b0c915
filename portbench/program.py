"""What the drivers take from the program, and how they watch it from outside.

The program is ``avlen_tpu_torch``. From it the benchmark takes the system
under test (a trainer built from the configuration), its kernels' names and
launch entries (each named by a roofline file), and its checkpoint format;
everything is wrapped from outside as instance attributes (``Hooks``) that
come off again, so the program runs its own code paths. What belongs to one
configuration lives in its driver.
"""

from __future__ import annotations

import contextlib
import importlib
import os
import time
from typing import Callable, Dict, List, Sequence

from portbench import harness

STATE_KEYS = ("scene", "rot", "node", "goal_node", "sound", "offset", "step_count", "duration")


def build_config(conf: Dict, work: Dict, seed: int, paths: Dict[str, str], extra=()):
    """The configuration as the cell runs it: the config file's yaml, its
    ``opts``, the traffic's ``opts``, the checkpoint paths set-up wrote,
    the seed, and ``extra`` (the tests' tiny world)."""
    from avlen_tpu_torch.config import get_config

    opts: List = []
    for key, value in {**conf["opts"], **work.get("opts", {})}.items():
        opts += [key, value]
    for key, name in conf.get("checkpoints", {}).items():
        if name in paths:
            opts += [key, paths[name]]
    opts += ["SEED", seed % 2**31, "TASK_CONFIG.DATASET.SYNTHETIC.SEED", seed % 2**31]
    opts += list(extra)
    return get_config(conf["exp_config"], opts=opts, run_type=work.get("run_type"))


def to_host(x):
    return x.detach().to("cpu", copy=True)


class Hooks:
    """Wrappers put on the program's objects, taken off again by ``remove``:
    an instance attribute over a method is deleted, anything else (a
    module's function) is put back."""

    def __init__(self):
        self.saved: List = []

    def wrap(self, obj, attr: str, make: Callable):
        own = attr in vars(obj)
        original = getattr(obj, attr)
        setattr(obj, attr, make(original))
        self.saved.append((obj, attr, own, original))

    def remove(self):
        for obj, attr, own, original in reversed(self.saved):
            if own:
                setattr(obj, attr, original)
            else:
                delattr(obj, attr)
        self.saved = []


def checkpoint_dir(ctx: Dict) -> str:
    return os.path.join(os.environ.get("TMPDIR") or "/tmp", f"portbench-{ctx['args'].workload}-{ctx['args'].seed}")


def remove_checkpoints(paths: Sequence[str]) -> None:
    for p in paths:
        os.remove(p)
        folder = os.path.dirname(p)
    if paths and not os.listdir(folder):
        os.rmdir(folder)


def check_loaded(weights: Dict, loaded: Dict) -> None:
    """Every parameter the program holds is the benchmark's, exactly."""
    import torch

    for mod, tensors in weights.items():
        own = loaded[mod]
        if set(tensors) != set(own) or any(not torch.equal(own[n].detach(), t) for n, t in tensors.items()):
            raise RuntimeError(f"portbench: the program's {mod} parameters are not the benchmark's weights")


def step_recorder(sampled: List[Dict], every: int, offset: int):
    """A wrapper for the env's ``step`` that keeps, at the steps ``offset``,
    ``offset + every``, ..., the next state's indices and the spectrogram
    observed there."""
    count = [0]

    def make(step):
        def wrapped(state, actions, *a, **k):
            nxt, out = step(state, actions, *a, **k)
            if count[0] % every == offset:
                sampled.append({**{key: getattr(nxt, key).detach().clone() for key in STATE_KEYS},
                                "spectrogram": out.obs["spectrogram"].detach().clone()})
            count[0] += 1
            return nxt, out
        return wrapped

    return make


def audio_inputs(env, sampled: List[Dict]) -> Dict:
    """The raw inputs of the sampled steps' audio (the padded source
    sounds, the time-domain RIRs, where in the sound each window starts,
    whether it still sounds) and the program's spectrograms there, on the
    host. The world's RIRs and sounds are the data both sides read."""
    import torch

    if not sampled:
        return {}
    if env.config.has_distractor:
        raise NotImplementedError("portbench: the audio check renders the goal's sound alone")
    bank = env.bank
    cat = {k: torch.cat([s[k] for s in sampled]) for k in sampled[0]}
    az = (4 - cat["rot"]) % 4
    rir = torch.cat([bank.rir.gather(cat["scene"][i:i + 256], az[i:i + 256], cat["node"][i:i + 256],
                                     cat["goal_node"][i:i + 256]).cpu() for i in range(0, az.shape[0], 256)])
    secs = bank.sound_secs[cat["sound"]].long()
    index = (cat["offset"] + cat["step_count"]) % torch.clamp(secs, min=1)
    return dict(sound_padded=to_host(bank.sounds_padded[cat["sound"]]), start=to_host(index * bank.sampling_rate),
                rir=rir, active=to_host(cat["step_count"] <= cat["duration"]), sampling_rate=int(bank.sampling_rate),
                spectrogram=to_host(cat["spectrogram"]))


# ----------------------------------------------------------------- timing
class StepTimer:
    """CUDA events on the current stream at each acting-step boundary of a
    collect: its start, then after each env step. ``step_ms`` reads them
    (after the window, with no synchronise added per step)."""

    def __init__(self, device, host_clock: bool = False):
        self.device, self.host_clock = device, host_clock
        self.collects: List[List] = []
        self.env_step_s = 0.0

    def collect(self, fn):
        def wrapped(*a, **k):
            ev = harness.new_event(self.device)
            ev.record()
            self.collects.append([ev])
            return fn(*a, **k)
        return wrapped

    def env_step(self, fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            if self.host_clock:
                self.env_step_s += time.perf_counter() - t0
            ev = harness.new_event(self.device)
            ev.record()
            self.collects[-1].append(ev)
            return out
        return wrapped

    def step_ms(self) -> List[float]:
        return [a.elapsed_time(b) for evs in self.collects for a, b in zip(evs[:-1], evs[1:])]


def events_around(device, store: List):
    def make(fn):
        def wrapped(*a, **k):
            e0, e1 = harness.new_event(device), harness.new_event(device)
            e0.record()
            out = fn(*a, **k)
            e1.record()
            store.append((e0, e1))
            return out
        return wrapped
    return make


def host_clock(totals: Dict, key: str):
    def make(fn):
        def wrapped(*a, **k):
            t0 = time.perf_counter()
            out = fn(*a, **k)
            totals[key] = totals.get(key, 0.0) + time.perf_counter() - t0
            return out
        return wrapped
    return make


def labelled(name: str):
    def make(fn):
        from torch.profiler import record_function

        def wrapped(*a, **k):
            with record_function(name):
                return fn(*a, **k)
        return wrapped
    return make


@contextlib.contextmanager
def recorded_launches(store: Dict[str, List[Dict]]):
    """Each roofline file's kernel launches within the block: the module
    that file names has its ``_launch`` wrapped, and each call's arguments
    are kept as the file's ``shapes`` gives them."""
    saved = []
    for kernel in harness.roofline_names():
        roof = harness.roofline_module(kernel)
        mod = importlib.import_module(roof.MODULE)
        launch = getattr(mod, "_launch", None)
        if launch is None:
            continue
        saved.append((mod, launch))
        store[kernel] = []
        mod._launch = _recording(launch, roof.shapes, store[kernel])
    try:
        yield store
    finally:
        for mod, launch in saved:
            mod._launch = launch


def _recording(launch, shapes: Callable, store: List[Dict]):
    def recorded(*a, **k):
        store.append(shapes(*a, **k))
        return launch(*a, **k)
    return recorded


def profiled(run: Callable, device, labels: Sequence[str]) -> Dict:
    """``run()`` under ``torch.profiler`` (CPU and the card), each custom
    kernel launch's shapes recorded: the reduced trace and the launches."""
    from torch.profiler import ProfilerActivity, profile, record_function

    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    launches: Dict[str, List[Dict]] = {}
    harness.sync(device)
    with recorded_launches(launches), profile(activities=activities) as prof:
        with record_function("portbench.window"):
            run()
        harness.sync(device)
    events = profiler_events(prof)
    mark = [e for e in events if e[0] == "portbench.window" and not e[1]]
    w = (mark[0][2], mark[0][2] + mark[0][3]) if mark else (0.0, 0.0)
    return {"trace": harness.reduce_trace(events, tuple(labels) + ("portbench.window",), w), "launches": launches}


def profiler_events(prof) -> List:
    """(name, on the device, start µs, duration µs, a user annotation) of
    every event, from the profiler's raw results (building its event tree
    would take minutes for a round's events)."""
    try:
        raw = prof.profiler.kineto_results.events()
        return [(e.name(), "CUDA" in str(e.device_type()), e.start_ns() / 1e3, e.duration_ns() / 1e3,
                 bool(e.is_user_annotation())) for e in raw]
    except (AttributeError, TypeError):
        return [(e.name, "CUDA" in str(getattr(e, "device_type", "")), e.time_range.start,
                 e.time_range.elapsed_us(), bool(getattr(e, "is_user_annotation", False))) for e in prof.events()]
