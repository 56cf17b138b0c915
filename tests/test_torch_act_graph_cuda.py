"""The acting forwards' CUDA graphs (``avlen_tpu_torch/models/graphed.py``)
on a CUDA card, at savi.yaml's widths with 32 envs (the benchmark's cell)
and 6 (AVLEN's π_g and belief refresh): a replay gives what the eager
forward gives, bit for bit; a sampled replay draws what an eager call draws
from a copy of the generator's state; after an in-place optimizer step, a
checkpoint load or a move to new storage the next call matches the eager
forward; a host generator keeps every call eager; each replayed act
launches the SMT kernel from the host, through ``smt_cuda._launch``, as
the profiler's kernels and a launch record there both show; and over
150-step collects the graph counters and the SMT kernel's launch count
come out as the steps say, the batch equal to the eager collect's. Run on the card with
``python -m pytest tests/test_torch_act_graph_cuda.py --noconftest``; skips
where there is no card."""

import pytest
import torch

pytestmark = pytest.mark.cuda

FRAME, SPEC_HW, MEMORY = 128, (65, 26), 150


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


@pytest.fixture(scope="module")
def nets(dev):
    from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
    from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy

    g = torch.Generator().manual_seed(0)
    policy = SMTPolicy(AudioNavSMTNet(SPEC_HW, generator=g), generator=g).to(dev).eval()
    belief = BeliefPredictorNet(generator=g).to(dev).eval()
    return policy, belief


def acting_inputs(policy, b, dev, seed):
    """One acting step's inputs at savi.yaml's shapes: 128-px frames, the
    (B, 150, 276) ring, beliefs, a belief state with some slots new."""
    from avlen_tpu_torch.models.belief_predictor import BeliefState

    g = torch.Generator(device=dev).manual_seed(seed)

    def rand(*shape):
        return torch.rand(shape, generator=g, device=dev)

    spec = rand(b, *SPEC_HW, 2)
    spec[0] = 0.0  # a silent slot
    obs = {"rgb": (rand(b, FRAME, FRAME, 3) * 255).to(torch.uint8), "depth": rand(b, FRAME, FRAME, 1),
           "spectrogram": spec, "pose": torch.randn(b, 4, generator=g, device=dev),
           "category_belief": rand(b, 21), "location_belief": torch.randn(b, 2, generator=g, device=dev)}
    prev = torch.randint(0, 4, (b,), generator=g, device=dev)
    feats = torch.randn(b, MEMORY, policy.net.feature_size, generator=g, device=dev)
    valid = (rand(b, MEMORY) > 0.2).float()
    state = BeliefState(torch.randn(b, 2, generator=g, device=dev), (rand(b) > 0.5).float(), rand(b, 21),
                        (rand(b) > 0.5).float())
    new_ep = rand(b) > 0.7
    return obs, prev, feats, valid, state, new_ep


def eager_act(policy, inputs, generator=None, deterministic=True):
    obs, prev, feats, valid = inputs[:4]
    return policy._act(obs, prev, feats, valid, generator, deterministic)


def eager_beliefs(belief, inputs):
    from avlen_tpu_torch.models.belief_predictor import _fuse

    obs, state, new_ep = inputs[0], inputs[4], inputs[5]
    spec = obs["spectrogram"]
    return _fuse(state, spec, obs["pose"], new_ep, *belief._forward(spec, None), 0.5, False)


def run_both(policy, belief, inputs, generator=None, deterministic=True):
    from avlen_tpu_torch.models.belief_predictor import update_beliefs

    obs, prev, feats, valid, state, new_ep = inputs
    return (policy.act(obs, prev, feats, valid, generator, deterministic),
            update_beliefs(belief, state, obs, new_ep, weighting_factor=0.5))


def assert_equal(got, want):
    from avlen_tpu_torch.models.graphed import flatten

    a, b = [], []
    assert flatten(got, a) == flatten(want, b)
    for x, y in zip(a, b):
        assert torch.equal(x, y), (x - y).abs().max()


def counts():
    from avlen_tpu_torch.utils.profiling import GRAPH_COUNTERS

    return {name: dict(c) for name, c in GRAPH_COUNTERS.items()}


def delta(before):
    return {n: {k: v - before[n][k] for k, v in c.items()} for n, c in counts().items()}


@torch.no_grad()
@pytest.mark.parametrize("b", [32, 6])
def test_replays_give_the_eager_outputs(dev, nets, b):
    """Deterministic acts and the belief refresh: eager, capture, then
    replays on new inputs each step, every output equal to the eager
    forward's on the same inputs, and each step's outputs kept intact."""
    policy, belief = nets
    before = counts()
    kept = []
    for step in range(5):
        inputs = acting_inputs(policy, b, dev, seed=100 * b + step)
        act, beliefs = run_both(policy, belief, inputs)
        assert_equal(act, eager_act(policy, inputs))
        assert_equal(beliefs, eager_beliefs(belief, inputs))
        kept.append((act, beliefs, inputs))
    for act, beliefs, inputs in kept:
        assert_equal(act, eager_act(policy, inputs))
        assert_equal(beliefs, eager_beliefs(belief, inputs))
    d = delta(before)
    assert d["act"] == d["belief"] == d["belief.fusion"] == {"captures": 1, "replays": 3, "eager_calls": 1}


@torch.no_grad()
@pytest.mark.parametrize("b", [32, 6])
def test_a_sampled_replay_draws_what_an_eager_call_draws(dev, nets, b):
    """From a generator in a given state, the capture call and each replay
    sample the actions (and log-probs) that an eager call samples from a
    copy of that state, and leave the generator where the eager call
    leaves the copy."""
    policy, _ = nets
    gen = torch.Generator(device=dev).manual_seed(b)
    before = counts()
    draws = 0
    for step in range(6):
        inputs = acting_inputs(policy, b, dev, seed=7 * b + step)
        copy = torch.Generator(device=dev)
        copy.set_state(gen.get_state())
        obs, prev, feats, valid = inputs[:4]
        got = policy.act(obs, prev, feats, valid, gen, False)
        want = eager_act(policy, inputs, copy, deterministic=False)
        assert_equal(got, want)
        assert torch.equal(gen.get_state(), copy.get_state())
        draws += int((got[0] != got[4].argmax(-1)).any())
    assert delta(before)["act"] == {"captures": 1, "replays": 4, "eager_calls": 1}
    assert draws > 0  # the draws are not the greedy actions


@torch.no_grad()
def test_a_host_generator_keeps_the_call_eager(dev, nets):
    """A generator on the host (chip_smoke's interactive reference samples
    on one) cannot be captured: every call runs eagerly."""
    policy, _ = nets
    before = counts()
    inputs = acting_inputs(policy, 6, dev, seed=3)
    gen = torch.Generator(device="cpu").manual_seed(0)
    for _ in range(3):
        assert_equal(policy.act(*inputs[:4], gen, True), eager_act(policy, inputs))
    assert delta(before)["act"] == {"captures": 0, "replays": 0, "eager_calls": 3}


@torch.no_grad()
def test_after_a_step_a_load_and_a_move_the_next_call_matches_eager(dev, nets):
    """An optimizer step and a checkpoint load write the parameters in
    place: the next call still replays, and reads them. A move to new
    storage makes a new key: eager, then a new capture."""
    from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
    from avlen_tpu_torch.models.smt_policy import AudioNavSMTNet, SMTPolicy

    policy, belief = nets
    b = 32
    for step in range(2):
        run_both(policy, belief, acting_inputs(policy, b, dev, seed=step))
    saved = ({k: v.clone() for k, v in policy.state_dict().items()},
             {k: v.clone() for k, v in belief.state_dict().items()})

    # an Adam step on each network, in place
    for module in (policy, belief):
        opt = torch.optim.Adam(module.parameters(), lr=1e-3)
        with torch.enable_grad():
            loss = sum((p.float() ** 2).mean() for p in module.parameters())
            loss.backward()
        opt.step()
        opt.zero_grad(set_to_none=True)
    before = counts()
    inputs = acting_inputs(policy, b, dev, seed=11)
    act, beliefs = run_both(policy, belief, inputs)
    assert_equal(act, eager_act(policy, inputs))
    assert_equal(beliefs, eager_beliefs(belief, inputs))
    assert delta(before)["act"] == {"captures": 0, "replays": 1, "eager_calls": 0}

    # a checkpoint load: other weights copied in place
    g = torch.Generator().manual_seed(1)
    other = SMTPolicy(AudioNavSMTNet(SPEC_HW, generator=g), generator=g).to(dev)
    policy.load_state_dict(other.state_dict())
    belief.load_state_dict(BeliefPredictorNet(generator=g).to(dev).state_dict())
    del other
    before = counts()
    inputs = acting_inputs(policy, b, dev, seed=12)
    act, beliefs = run_both(policy, belief, inputs)
    assert_equal(act, eager_act(policy, inputs))
    assert_equal(beliefs, eager_beliefs(belief, inputs))
    assert delta(before)["belief"] == {"captures": 0, "replays": 1, "eager_calls": 0}
    assert delta(before)["belief.fusion"] == {"captures": 0, "replays": 1, "eager_calls": 0}

    # new storage: a round trip through the host
    policy.cpu().to(dev)
    before = counts()
    for step in range(3):
        inputs = acting_inputs(policy, b, dev, seed=20 + step)
        assert_equal(run_both(policy, belief, inputs)[0], eager_act(policy, inputs))
    assert delta(before)["act"] == {"captures": 1, "replays": 1, "eager_calls": 1}
    policy.load_state_dict(saved[0])
    belief.load_state_dict(saved[1])


@torch.no_grad()
def test_each_replayed_act_launches_the_smt_kernel_from_the_host(dev, nets, monkeypatch):
    """Over replayed acts, the SMT kernel's launches that a record of
    ``smt_cuda._launch`` put in place after the capture sees (as a
    benchmark's launch record does), the wrapper's ``.launches`` and the
    profiler's kernels of the kernel's plan all count one call a step."""
    from torch.profiler import ProfilerActivity, profile

    from avlen_tpu_torch.ops import smt_cuda

    policy, _ = nets
    b, steps = 32, 5
    inputs = [acting_inputs(policy, b, dev, seed=300 + step) for step in range(steps)]
    for step in range(2):  # eager, then the capture
        policy.act(*inputs[step][:4])
    recorded = []
    launch = smt_cuda._launch
    monkeypatch.setattr(smt_cuda, "_launch", lambda *a: recorded.append(a[0].shape) or launch(*a))
    before, launches = counts(), smt_cuda.smt_encode.launches
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for x in inputs:
            policy.act(*x[:4])
        torch.cuda.synchronize()
    assert delta(before)["act"] == {"captures": 0, "replays": steps, "eager_calls": 0}
    entries = (b, MEMORY + 1, policy.net.smt.fusion0.weight.shape[1])  # the ring and the step
    assert recorded == [entries] * steps
    assert smt_cuda.smt_encode.launches - launches == steps
    names = [e.name for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))]
    plan = smt_cuda.smt_plan(*entries, policy.net.d_model, policy.net.smt.nhead)
    for kernel in {x.kernel for x in plan.launches}:
        per_call = sum(1 for x in plan.launches if x.kernel == kernel)
        assert sum(1 for n in names if kernel in n) == per_call * steps, kernel


def test_collects_count_their_replays_and_launches(dev, monkeypatch):
    """Two 150-step collects of a tiny savi.yaml world: the first runs each
    forward eagerly once, captures it, then replays (the belief refresh
    also at the bootstrap); the second replays every step. The SMT kernel
    counts 151 launches a collect (150 acts and the bootstrap's value). An
    eager collect from the same carry and generator state gives the same
    batch, bit for bit."""
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.models import graphed
    from avlen_tpu_torch.ops.smt_cuda import smt_encode
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    cfg = get_config("configs/semantic_audionav/savi/savi.yaml", opts=[
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "4", "RL.PPO.num_steps", "150",
    ])
    tr = SaviTrainer(cfg, device=dev)
    tr._setup()
    t = tr.num_steps
    carry = tr.carry
    gen = torch.Generator(device=dev).manual_seed(5)
    state = gen.get_state()
    with monkeypatch.context() as mp:  # the eager collect
        mp.setattr(graphed, "on_card", lambda leaves, generator: False)
        _, eager = tr.collect(carry, generator=gen)
    eager_state = gen.get_state()
    gen.set_state(state)
    rows = []
    for _ in range(2):
        before, launches = counts(), smt_encode.launches
        carry, batch = tr.collect(carry, generator=gen)
        torch.cuda.synchronize()
        rows.append((delta(before), smt_encode.launches - launches))
        if len(rows) == 1:
            first = batch
            assert torch.equal(gen.get_state(), eager_state)
    (d1, n1), (d2, n2) = rows
    assert d1["act"] == {"captures": 1, "replays": t - 2, "eager_calls": 1}
    assert d1["belief"] == d1["belief.fusion"] == {"captures": 1, "replays": t - 1, "eager_calls": 1}
    assert d2["act"] == {"captures": 0, "replays": t, "eager_calls": 0}
    assert d2["belief"] == d2["belief.fusion"] == {"captures": 0, "replays": t + 1, "eager_calls": 0}
    assert n1 == n2 == t + 1
    for name in ("actions", "log_probs", "values", "rewards", "bootstrap_value"):
        assert torch.equal(getattr(first, name), getattr(eager, name)), name
    for k in ("__feature", "category_belief", "location_belief"):
        assert torch.equal(first.obs[k], eager.obs[k]), k
