"""The acting forwards' CUDA-graph runner (``avlen_tpu_torch/models/graphed.py``)
on the CPU. ``SMTPolicy.act`` and ``update_beliefs`` take the eager path on
the CPU and under autograd, with today's outputs. The rest runs the runner
with the card's two steps stood in: every call counts as on the card, and a
capture is a plain call of the captured function whose replay calls it
again on the static inputs and copies the result into the static outputs
(as a graph replay overwrites them). So the keys, the bounded cache, the
copies in and out, the counters and a whole collect are exercised here,
and, with stand-in graphs, how a capture breaks at a hand-written kernel's
launch; the graphs themselves run in ``tests/test_torch_act_graph_cuda.py``."""

import gc
from types import SimpleNamespace

import pytest
import torch

from avlen_tpu_torch.config import get_config
from avlen_tpu_torch.models import graphed
from avlen_tpu_torch.models.belief_predictor import (BeliefPredictorNet, _fuse, belief_graphs, fusion_graphs,
                                                     init_belief_state, update_beliefs)
from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy, act_graphs
from avlen_tpu_torch.ops import smt_cuda
from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
from avlen_tpu_torch.utils import profiling
from tests.test_torch_tracing import slice_world

SPEC_HW = (9, 6)


class PlainGraph:
    """A capture stood in on the CPU: a plain call, which also runs the
    work once, as a capture does; ``replay`` calls the function again on
    the static inputs and copies its outputs into the static outputs."""

    def __init__(self, fn, inputs):
        self.fn, self.inputs = fn, inputs
        self.out = fn(*inputs)

    def replay(self):
        new, static = [], []
        graphed.flatten(self.fn(*self.inputs), new)
        graphed.flatten(self.out, static)
        for s, n in zip(static, new):
            s.copy_(n)


def plain_capture(fn, inputs, generator):
    g = PlainGraph(fn, inputs)
    return g, g.out


@pytest.fixture(autouse=True)
def own_registry(monkeypatch):
    """The runners a test makes register their counters in a copy of the
    registry, which goes with the test."""
    monkeypatch.setattr(profiling, "GRAPH_COUNTERS", dict(profiling.GRAPH_COUNTERS))


@pytest.fixture
def card(monkeypatch):
    """Every call counts as on the card; captures are ``PlainGraph``s."""
    monkeypatch.setattr(graphed, "on_card", lambda leaves, generator: bool(leaves))
    monkeypatch.setattr(graphed, "capture", plain_capture)


@pytest.fixture(scope="module")
def policy():
    torch.set_num_threads(1)
    net = AudioNavSMTNet(SPEC_HW, d_model=32, nhead=4, generator=torch.Generator().manual_seed(0))
    return SMTPolicy(net, generator=torch.Generator().manual_seed(1)).eval()


@pytest.fixture(scope="module")
def belief_net():
    return BeliefPredictorNet(generator=torch.Generator().manual_seed(2)).eval()


def act_inputs(policy, b=3, m=5, seed=0):
    g = torch.Generator().manual_seed(seed)
    obs = {
        "rgb": torch.randint(0, 256, (b, 16, 16, 3), generator=g, dtype=torch.uint8),
        "depth": torch.rand(b, 16, 16, 1, generator=g),
        "spectrogram": torch.rand(b, *SPEC_HW, 2, generator=g),
        "pose": torch.randn(b, 4, generator=g),
        "category_belief": torch.rand(b, 21, generator=g),
        "location_belief": torch.randn(b, 2, generator=g),
    }
    prev = torch.randint(0, 4, (b,), generator=g)
    feats = torch.randn(b, m, policy.net.feature_size, generator=g)
    valid = (torch.rand(b, m, generator=g) > 0.3).float()
    return obs, prev, feats, valid


def belief_inputs(b=3, seed=0):
    g = torch.Generator().manual_seed(seed)
    state = init_belief_state(b, device="cpu")
    state = state._replace(has_label=torch.tensor([0.0, 1.0, 1.0][:b]), last_label=torch.rand(b, 21, generator=g))
    obs = {"spectrogram": torch.rand(b, 65, 26, 2, generator=g), "pose": torch.randn(b, 4, generator=g)}
    obs["spectrogram"][0] = 0.0  # a silent step
    return state, obs, torch.tensor([True, False, False][:b])


def counts(runner):
    return dict(runner.counts)


def delta(runner, before):
    return {k: v - before[k] for k, v in counts(runner).items()}


def eager_beliefs(net, state, obs, new_ep):
    spec = obs["spectrogram"]
    return _fuse(state, spec, obs["pose"], new_ep, *net._forward(spec, None), 0.5, False)


def same(a, b):
    la, lb = [], []
    sa, sb = graphed.flatten(a, la), graphed.flatten(b, lb)
    return sa == sb and len(la) == len(lb) and all(torch.equal(x, y) for x, y in zip(la, lb))


@pytest.mark.parametrize("grad", [False, True])
def test_act_and_beliefs_on_the_cpu_are_the_eager_forwards(policy, belief_net, grad):
    """On the CPU (and under autograd) both entry points run today's code:
    equal outputs, the same draws, no capture and no replay."""
    inputs = act_inputs(policy)
    a0, b0, f0 = counts(act_graphs), counts(belief_graphs), counts(fusion_graphs)
    with torch.set_grad_enabled(grad):
        for deterministic in (True, False):
            g1, g2 = torch.Generator().manual_seed(5), torch.Generator().manual_seed(5)
            got = policy.act(*inputs, g1, deterministic)
            want = policy._act(*inputs, g2, deterministic)
            assert same(got, want)
            assert torch.equal(g1.get_state(), g2.get_state())
        state, obs, new_ep = belief_inputs()
        got = update_beliefs(belief_net, state, obs, new_ep, weighting_factor=0.5)
        assert same(got, eager_beliefs(belief_net, state, obs, new_ep))
    assert delta(act_graphs, a0) == {"captures": 0, "replays": 0, "eager_calls": 2}
    assert delta(belief_graphs, b0) == delta(fusion_graphs, f0) == {"captures": 0, "replays": 0, "eager_calls": 1}


def test_autograd_stays_eager_where_a_graph_could_run(card, policy):
    inputs = act_inputs(policy)
    before = counts(act_graphs)
    with torch.enable_grad():
        for _ in range(3):
            policy.act(*inputs, deterministic=True)
    assert delta(act_graphs, before) == {"captures": 0, "replays": 0, "eager_calls": 3}


@torch.no_grad()
def test_first_call_eager_second_captures_then_replays(card, policy, belief_net):
    """The runner's sequence at one key, and what it returns each time:
    today's outputs for the step's own inputs, the generator advanced once
    a call as an eager call advances it."""
    gen, ref_gen = torch.Generator().manual_seed(9), torch.Generator().manual_seed(9)
    a0, b0, f0 = counts(act_graphs), counts(belief_graphs), counts(fusion_graphs)
    state = belief_inputs()[0]
    for step in range(4):
        inputs = act_inputs(policy, seed=step)
        assert same(policy.act(*inputs, gen), policy._act(*inputs, ref_gen, False))
        _, obs, new_ep = belief_inputs(seed=step)
        got = update_beliefs(belief_net, state, obs, new_ep)
        assert same(got, eager_beliefs(belief_net, state, obs, new_ep))
        state = got[0]
    assert torch.equal(gen.get_state(), ref_gen.get_state())
    for runner, before in ((act_graphs, a0), (belief_graphs, b0), (fusion_graphs, f0)):
        assert delta(runner, before) == {"captures": 1, "replays": 2, "eager_calls": 1}


@torch.no_grad()
def test_outputs_are_copies_a_later_replay_leaves_alone(card, policy):
    gen = torch.Generator().manual_seed(3)
    kept = []
    for step in range(5):
        out = policy.act(*act_inputs(policy, seed=step), gen)
        kept.append((out, [t.clone() for t in out]))
    for out, copy in kept:
        assert all(torch.equal(a, b) for a, b in zip(out, copy))
    # the replayed steps' features differ from step to step
    assert not torch.equal(kept[3][0][3], kept[4][0][3])


def run_keyed(runner, module, x, static=(), generator=None):
    return runner(module, lambda x: module(x.float()), (x,), static, generator)


@torch.no_grad()
@pytest.mark.parametrize("change", ["shape", "dtype", "static", "generator", "storage", "structure", "parameter",
                                    "buffer", "submodule", "registered"])
def test_a_new_key_runs_eagerly_and_captures_at_its_second_call(card, change):
    runner = graphed.GraphedCall("keys")
    module = torch.nn.Sequential(torch.nn.Linear(4, 4))
    module.register_buffer("scale", torch.ones(1))
    x, static, gen = torch.randn(2, 4), (True,), torch.Generator()
    for _ in range(3):
        run_keyed(runner, module, x, static, gen)
    assert counts(runner) == {"captures": 1, "replays": 1, "eager_calls": 1}
    if change == "shape":
        x = torch.randn(3, 4)
    elif change == "dtype":
        x = x.double()
    elif change == "static":
        static = (False,)
    elif change == "generator":
        gen = torch.Generator()
    elif change == "storage":
        module[0].weight.data = module[0].weight.data.clone()
    elif change == "parameter":
        module[0].weight = torch.nn.Parameter(module[0].weight.detach().clone())
    elif change == "buffer":
        module._buffers["scale"] = module.scale.clone()  # as ``Module._apply`` replaces a buffer
    elif change == "submodule":
        module[0] = torch.nn.Linear(4, 4)
    elif change == "registered":
        module.register_parameter("extra", torch.nn.Parameter(torch.ones(1)))  # the first of its own
    if change == "structure":
        calls = [runner(module, lambda x, none: module(x), (x, None), static, gen) for _ in range(2)]
    else:
        calls = [run_keyed(runner, module, x, static, gen) for _ in range(2)]
    assert counts(runner) == {"captures": 2, "replays": 1, "eager_calls": 2}
    assert torch.equal(calls[0], calls[1])
    assert torch.equal(calls[1], module(x.float()))


@torch.no_grad()
def test_an_in_place_parameter_update_keeps_replaying_and_is_read(card):
    """An optimizer's in-place step leaves the key as it was: the next call
    replays, and returns what the stepped parameters give."""
    module = torch.nn.Linear(4, 4)
    runner = graphed.GraphedCall("in_place")
    x = torch.randn(2, 4)
    for _ in range(2):
        run_keyed(runner, module, x)
    module.weight.add_(1.0)
    got = run_keyed(runner, module, x)
    assert counts(runner) == {"captures": 1, "replays": 1, "eager_calls": 1}
    assert torch.equal(got, module(x))


@torch.no_grad()
def test_the_cache_keeps_the_newest_keys(card):
    runner = graphed.GraphedCall("bounded")
    module = torch.nn.Linear(4, 4)
    sizes = range(1, graphed.MAX_KEYS + 3)
    for n in sizes:
        for _ in range(2):
            run_keyed(runner, module, torch.randn(n, 4))
    assert len(runner.graphs) == graphed.MAX_KEYS
    assert counts(runner) == {"captures": len(sizes), "replays": 0, "eager_calls": len(sizes)}
    run_keyed(runner, module, torch.randn(sizes[-1], 4))  # kept: replays
    run_keyed(runner, module, torch.randn(1, 4))  # dropped: eager again
    assert counts(runner) == {"captures": len(sizes), "replays": 1, "eager_calls": len(sizes) + 1}
    assert len(runner.graphs) == graphed.MAX_KEYS


@torch.no_grad()
def test_a_freed_module_takes_its_graphs_along(card, monkeypatch):
    # a graph holds no reference to the module it replays (the stand-in
    # above holds its function, so here a capture keeps nothing)
    monkeypatch.setattr(graphed, "capture", lambda fn, inputs, gen: (SimpleNamespace(replay=lambda: None),
                                                                     fn(*inputs)))
    runner = graphed.GraphedCall("freed")
    keep, drop = torch.nn.Linear(4, 4), torch.nn.Linear(4, 4)
    for m in (keep, drop):
        for _ in range(2):
            run_keyed(runner, m, torch.randn(2, 4))
    assert len(runner.graphs) == 2
    del drop, m
    gc.collect()
    assert [k[0] for k in runner.graphs] == [id(keep)]
    assert list(runner.trees) == [id(keep)]


class StandInGraph:
    """``torch.cuda.CUDAGraph`` stood in: a replay is logged, nothing runs."""

    def __init__(self, log):
        self.log, self.n = log, sum(1 for e in log if e == "begin")

    def register_generator_state(self, generator):
        pass

    def pool(self):
        return None

    def replay(self):
        self.log.append(f"replay {self.n}")


class StandInCapture:
    """``torch.cuda.graph`` stood in: the capture's start and end logged."""

    def __init__(self, log, graph, pool=None, capture_error_mode=None):
        self.log = log

    def __enter__(self):
        self.log.append("begin")

    def __exit__(self, *exc):
        self.log.append("end")


@torch.no_grad()
def test_a_capture_breaks_at_each_kernel_launch(monkeypatch):
    """The graphs end before a hand-written kernel's launch and begin after
    it: the launch runs between them through its module's ``_launch``, at
    the capture and at every replay, so that a wrapper put there after the
    capture (a launch record) sees each replay's launch, and its output is
    copied into the tensor the next graph reads."""
    log = []
    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: StandInGraph(log))
    monkeypatch.setattr(torch.cuda, "graph", lambda *a, **k: StandInCapture(log, *a, **k))
    launches = []

    def launch(y):
        launches.append(y)
        log.append("launch")
        return y * 2 + len(launches)

    monkeypatch.setattr(smt_cuda, "_launch", launch)

    def forward(x):
        return smt_cuda._launch(x + 1) - 1  # as ``_SMTEncode.forward`` calls it

    captured, out = graphed.capture(forward, (torch.ones(3),), None)
    assert log == ["begin", "end", "replay 0", "launch", "begin", "end", "replay 1"]
    assert smt_cuda._launch is launch
    assert torch.equal(out, torch.full((3,), 4.0))
    recorded = []
    monkeypatch.setattr(smt_cuda, "_launch", lambda *a: recorded.append(a) or launch(*a))
    log.clear()
    for _ in range(2):
        captured.replay()
    assert log == ["replay 0", "launch", "replay 1"] * 2
    assert len(recorded) == 2 and recorded[0][0] is launches[0]
    # the tensor the second graph reads holds the last replay's launch
    (_, _, _, static), = captured.launches
    assert torch.equal(static[0], torch.full((3,), 2.0 * 2 + 3))


@torch.no_grad()
def test_a_wrapper_of_the_belief_nets_forward_sees_every_refresh(card, belief_net, monkeypatch):
    """The belief towers' graphs run inside ``BeliefPredictorNet.forward``,
    so a wrapper of the instance's ``forward`` (a profiler label) is
    called by every refresh, the replayed ones too."""
    calls = []
    forward = belief_net.forward

    def labelled(*a, **k):
        calls.append(1)
        return forward(*a, **k)

    monkeypatch.setattr(belief_net, "forward", labelled)
    b0 = counts(belief_graphs)
    state = belief_inputs()[0]
    for step in range(4):
        _, obs, new_ep = belief_inputs(seed=step)
        state = update_beliefs(belief_net, state, obs, new_ep)[0]
    d = delta(belief_graphs, b0)
    assert len(calls) == sum(d.values()) == 4
    assert d["replays"] >= 2


@torch.no_grad()
def test_export_reports_the_recordings_graph_counts(card, policy):
    gen = torch.Generator().manual_seed(0)
    policy.act(*act_inputs(policy), gen)  # before the recording
    profiling.enable()
    try:
        for step in range(3):
            policy.act(*act_inputs(policy, seed=step), gen)
    finally:
        profiling.disable()
    got = profiling.export()["graphs"]
    assert got["act"] == {"captures": 1, "replays": 2, "eager_calls": 0}
    assert got["belief"] == got["belief.fusion"] == {"captures": 0, "replays": 0, "eager_calls": 0}


def test_a_collect_with_the_runner_engaged_is_the_eager_collect(monkeypatch):
    """A SAVi collect in the tiny savi.yaml world, with every acting forward
    going through capture and replay, gives the eager collect's batch, step
    for step: the stored actions, features, values, log-probs and beliefs
    are each step's own, not the last replay's."""
    torch.set_num_threads(1)
    savi, opts = slice_world()
    tr = SaviTrainer(get_config(savi, opts=opts), device="cpu")
    tr._setup()
    carry = tr.carry
    batches, gens = [], []
    for engaged in (False, True):
        with monkeypatch.context() as mp:
            if engaged:
                mp.setattr(graphed, "on_card", lambda leaves, generator: bool(leaves))
                mp.setattr(graphed, "capture", plain_capture)
            gen = torch.Generator().manual_seed(11)
            a0 = counts(act_graphs)
            _, batch = tr.collect(carry, generator=gen)
            batches.append(batch)
            gens.append(gen.get_state())
            if engaged:
                assert delta(act_graphs, a0) == {"captures": 1, "replays": tr.num_steps - 2, "eager_calls": 1}
    eager, replayed = batches
    assert torch.equal(gens[0], gens[1])
    for name in ("actions", "log_probs", "values", "rewards", "bootstrap_value"):
        assert torch.equal(getattr(eager, name), getattr(replayed, name)), name
    for k in ("__feature", "category_belief", "location_belief"):
        assert torch.equal(eager.obs[k], replayed.obs[k]), k
