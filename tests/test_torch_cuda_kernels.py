"""The port's hand-written CUDA kernels against their plain PyTorch
versions, on a CUDA card (run there with
``python -m pytest tests/test_torch_cuda_kernels.py --noconftest``: the
suite's conftest needs the JAX test setup). Each test builds the kernels
with nvcc at first use and skips where there is no card.
"""

import numpy as np
import pytest
import torch

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device and nvcc")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _irfft_cases():
    """Every cluster size (fft_len 2^14 .. 2^18 → 1 .. 16 CTAs a row) and
    every short row (2^11 .. 2^13, one CTA of 32 .. 128 threads), one row and
    32, windows at 0, at the end and at odd offsets."""
    cases = [(65536, 32, 15999, 16000),  # the savi.yaml audio path
             (16384, 6, 1999, 8000), (32768, 3, 333, 777), (131072, 2, 23999, 44100)]
    for log_n in range(14, 19):
        n = 1 << log_n
        for rows in (1, 32):
            cases += [(n, rows, 0, 4000), (n, rows, n - 4001, 4001), (n, rows, n // 4 - 1, n // 4 + 3)]
    # the short worlds: 1 kHz / 128 taps, 2 kHz / 200 taps, 4 kHz / 400 taps
    cases += [(2048, 32, 127, 1000), (4096, 32, 199, 2000), (8192, 32, 399, 4000)]
    for log_n in range(11, 14):
        n = 1 << log_n
        for rows in (1, 32):
            cases += [(n, rows, 0, n // 2), (n, rows, n // 2 - 1, n // 2 + 1), (n, rows, n // 4 - 1, n // 4 + 3)]
    return cases


@pytest.mark.parametrize("fft_len,rows,out_start,out_len", _irfft_cases())
def test_partial_irfft_matches_plain(dev, fft_len, rows, out_start, out_len):
    from avlen_tpu_torch.ops.irfft_cuda import (irfft_plan, max_active_clusters, partial_irfft,
                                                partial_irfft_plain)

    g = torch.Generator(device=dev).manual_seed(fft_len + out_start)
    spec = torch.fft.rfft(torch.randn(rows, fft_len, generator=g, device=dev), dim=-1)
    before = partial_irfft.launches
    if max_active_clusters(irfft_plan(fft_len, out_start, out_len, rows)) < 1:
        # only a non-portable cluster (16 CTAs, fft_len 2^18) may be refused
        assert fft_len == 1 << 18
        with pytest.raises(ValueError, match="cannot schedule"):
            partial_irfft(spec, fft_len, out_start, out_len)
        return
    torch.cuda.synchronize()
    # a profiler session now and then sees no device event although the
    # calls ran: such a session is taken again, up to five in all
    for sessions in range(1, 6):
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(3):
                got = partial_irfft(spec, fft_len, out_start, out_len)
            torch.cuda.synchronize()
        kernels = [e.name for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))]
        if kernels:
            break
    # one launch per call: nothing but the cluster kernel runs on the card, at
    # most once a call (the profiler may drop an event at a session's edge)
    assert 1 <= len(kernels) <= 3 and all("irfft_cluster" in k for k in kernels), kernels
    want = partial_irfft_plain(spec, fft_len, out_start, out_len)
    assert partial_irfft.launches == before + 3 * sessions
    scale = max(want.abs().max().item(), 1.0)
    assert (got - want).abs().max().item() <= 1e-5 * scale
    with pytest.raises(ValueError):
        partial_irfft(spec[..., :513], 1024, 0, 100)  # below the kernel's range: raises


@pytest.mark.parametrize("fft_len,field,radices,want_rc", [
    (65536, None, None, 0),  # the plan as made: launched
    (65536, "radices_q", (4, 64), 1),  # radix 4 in a 256-thread CTA
    (65536, "radices_q", (8, 32), 1),
    (65536, "radices_p", (16, 16), 1),  # product is not P
    (2048, None, None, 0),
    (2048, "radices_q", (16, 2), 1),  # radix 16 in a short row
])
def test_irfft_entry_refuses_radices_its_instantiation_lacks(dev, fft_len, field, radices, want_rc):
    """The C entry returns cudaErrorInvalidValue (1) for stage radices its
    instantiation does not run, instead of running another transform."""
    import ctypes
    import dataclasses

    from avlen_tpu_torch.ops import irfft_cuda
    from avlen_tpu_torch.utils import cuda_build

    plan = irfft_cuda.irfft_plan(fft_len, 0, 100, 2)
    assert irfft_cuda.max_active_clusters(plan) >= 1
    if field is not None:
        plan = dataclasses.replace(plan, **{field: radices})
    spec = torch.zeros(2, fft_len // 2 + 1, dtype=torch.complex64, device=dev)
    out = torch.empty(2, 100, device=dev)
    rc = irfft_cuda._lib().partial_irfft(spec.data_ptr(), out.data_ptr(), ctypes.byref(irfft_cuda._c_plan(plan)),
                                         cuda_build.current_stream(dev))
    torch.cuda.synchronize()
    assert rc == want_rc


@pytest.mark.parametrize("case,batch,sr,right_scale,silent_row", [
    ("main", 16, 16000, 1.0, None),  # the savi.yaml rollout
    ("bank_rows", 256, 16000, 1.0, None),  # a row block of the spectrogram bank
    ("uneven", 16, 16000, 1e-3, 5),  # quiet right ear (the pack subtracts the left), a silent env
    ("short", 3, 8000, 1.0, None),
])
def test_spectrogram_matches_plain(dev, case, batch, sr, right_scale, silent_row):
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram, spectrogram_plain

    cfg = SpectrogramConfig(sampling_rate=sr)
    g = torch.Generator(device=dev).manual_seed(batch)
    audio = 0.3 * torch.randn(batch, 2, sr, generator=g, device=dev)
    audio[:, 1] *= right_scale
    if silent_row is not None:
        audio[silent_row] = 0
    got = spectrogram(audio, cfg)
    want = spectrogram_plain(audio, cfg)
    assert got.shape == want.shape == (batch,) + cfg.out_shape
    assert (got - want).abs().max().item() <= 1e-4, case
    if silent_row is not None:
        assert not got[silent_row].any()


@pytest.mark.parametrize("n_fft", [64, 128, 256, 1024])
def test_spectrogram_every_n_fft_matches_plain(dev, n_fft):
    """Each instantiation of the kernel (radix 2, 4 or 8 first, then 8s)."""
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram, spectrogram_plain

    cfg = SpectrogramConfig(sampling_rate=8000, n_fft=n_fft, win_length=n_fft * 3 // 4, hop_length=n_fft // 4)
    g = torch.Generator(device=dev).manual_seed(n_fft)
    audio = 0.3 * torch.randn(5, 2, 8000, generator=g, device=dev)
    got = spectrogram(audio, cfg)
    want = spectrogram_plain(audio, cfg)
    assert got.shape == want.shape == (5,) + cfg.out_shape
    assert (got - want).abs().max().item() <= 1e-4


def test_spectrogram_is_one_launch(dev):
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram

    cfg = SpectrogramConfig(sampling_rate=16000)
    audio = torch.randn(16, 2, 16000, device=dev)
    before = spectrogram.launches
    spectrogram(audio, cfg)
    torch.cuda.synchronize()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
        for _ in range(3):
            spectrogram(audio, cfg)
        torch.cuda.synchronize()
    # nothing but the kernel runs on the card, at most once a call (the
    # profiler may drop an event at a session's edge)
    kernels = [e.name for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))]
    assert 1 <= len(kernels) <= 3 and all("spectrogram_kernel" in k for k in kernels), kernels
    assert spectrogram.launches == before + 4


def test_spectrogram_raises_on_what_it_does_not_take(dev):
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram

    audio = torch.randn(2, 2, 16000, device=dev)
    for bad_audio, cfg in (
        (torch.randn(2, 3, 16000, device=dev), SpectrogramConfig()),  # three channels
        (audio.double(), SpectrogramConfig()),
        (audio, SpectrogramConfig(n_fft=2048)),
        (audio, SpectrogramConfig(n_fft=384)),
        (audio, SpectrogramConfig(pad_mode="constant")),
        (audio[..., :200], SpectrogramConfig()),  # too short to reflect-pad by 256
    ):
        with pytest.raises(ValueError):
            spectrogram(bad_audio, cfg)


@pytest.mark.parametrize("b,m,d,nhead,goal,pretraining", [
    (16, 150, 256, 8, True, False),  # the savi.yaml rollout shape
    (16, 150, 256, 8, False, False),
    (16, 150, 256, 8, True, True),
    (5, 37, 64, 4, True, False),
    (3, 300, 128, 2, False, False),
])
def test_smt_encode_matches_plain(dev, b, m, d, nhead, goal, pretraining):
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain

    feat = 276
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat), pretraining=pretraining,
                          generator=torch.Generator().manual_seed(m)).to(dev)
    g = torch.Generator(device=dev).manual_seed(b)
    x = torch.randn(b, feat, generator=g, device=dev)
    mem = torch.randn(b, m, feat, generator=g, device=dev)
    mask = (torch.rand(b, m, generator=g, device=dev) > 0.3).float()
    gl = torch.randn(b, d, generator=g, device=dev) if goal else None
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        p = dict(enc.named_parameters())
        got = smt_encode(p, entries, valid, gl, nhead)
        want = smt_encode_plain(p, entries, valid, gl, nhead)
    assert (got - want).abs().max().item() <= 1e-4


@pytest.mark.parametrize("b,m,d,nhead,goal,scale,feat", [
    (1, 150, 256, 8, True, 1.0, 276),  # one env
    (120, 150, 256, 8, True, 1.0, 276),  # PPO re-evaluation rows: 15 steps x 8 envs a mini-batch
    (4, 36, 64, 8, False, 1.0, 276),  # L = 37, not a multiple of 16, at head width 8
    (16, 150, 256, 8, True, 10.0, 276),  # entries x10: the TF32 split over a wider range
    (3, 40, 128, 4, True, 1.0, 277),  # F = 289: the fusion layer's 4-byte copies
])
def test_smt_encode_more_shapes_match_plain(dev, b, m, d, nhead, goal, scale, feat):
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain

    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat),
                          generator=torch.Generator().manual_seed(m + b)).to(dev)
    g = torch.Generator(device=dev).manual_seed(b + 1)
    x = torch.randn(b, feat, generator=g, device=dev)
    mem = torch.randn(b, m, feat, generator=g, device=dev)
    mask = (torch.rand(b, m, generator=g, device=dev) > 0.3).float()
    gl = torch.randn(b, d, generator=g, device=dev) if goal else None
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        entries = entries * scale
        p = dict(enc.named_parameters())
        got = smt_encode(p, entries, valid, gl, nhead)
        want = smt_encode_plain(p, entries, valid, gl, nhead)
    assert torch.isfinite(got).all()
    assert (got - want).abs().max().item() <= 1e-4


def test_smt_encode_scaled_entries_as_close_to_f64_as_f32_gets(dev):
    """Entries x100 make the encode ill-conditioned (attention logits of ~1e4
    turn the softmax into a near-argmax), so that the plain f32 version is
    itself ~1e-3 from an f64 evaluation: the kernel is held to be no further
    from the f64 result than twice the plain f32 version is."""
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain

    b, m, d, nhead, feat = 16, 150, 256, 8, 276
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat),
                          generator=torch.Generator().manual_seed(m + b)).to(dev)
    g = torch.Generator(device=dev).manual_seed(b + 1)
    x = torch.randn(b, feat, generator=g, device=dev)
    mem = torch.randn(b, m, feat, generator=g, device=dev)
    mask = (torch.rand(b, m, generator=g, device=dev) > 0.3).float()
    gl = torch.randn(b, d, generator=g, device=dev)
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        entries = entries * 100.0
        p = dict(enc.named_parameters())
        got = smt_encode(p, entries, valid, gl, nhead).double()
        want32 = smt_encode_plain(p, entries, valid, gl, nhead).double()
        want64 = smt_encode_plain({k: v.double() for k, v in p.items()}, entries.double(), valid.double(),
                                  gl.double(), nhead)
    err, err32 = (got - want64).abs().max().item(), (want32 - want64).abs().max().item()
    assert torch.isfinite(got).all()
    assert err <= 2 * err32, (err, err32)


def test_smt_encode_runs_the_plans_launches(dev):
    """One call is the plan's six hand-written launches, in its order, every
    one a kernel of csrc/smt_encode.cu (no library GEMM or attention)."""
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_plan

    b, m, d, nhead, feat = 16, 150, 256, 8, 276
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat),
                          generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(0)
    with torch.no_grad():
        entries, valid = enc.entries(torch.randn(b, feat, generator=g, device=dev),
                                     torch.randn(b, m, feat, generator=g, device=dev),
                                     torch.ones(b, m, device=dev))
        goal = torch.randn(b, d, generator=g, device=dev)
        p = dict(enc.named_parameters())
        smt_encode(p, entries, valid, goal, nhead)
        torch.cuda.synchronize()
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(4):
                smt_encode(p, entries, valid, goal, nhead)
            torch.cuda.synchronize()
    names = [e.name for e in sorted((e for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))),
                                    key=lambda e: e.time_range.start)]
    plan = smt_plan(*entries.shape, d, nhead)
    kernels = [x.kernel for x in plan.launches]
    assert len(kernels) == 6
    # the profiler may miss events at the start of a session: read three whole
    # calls from the first fusion launch on, and nothing but them after it
    first = next(i for i, n in enumerate(names) if kernels[0] in n)
    calls = names[first:]
    assert len(calls) >= 3 * 6 and len(names) <= 4 * 6, names
    assert len(calls) % 6 == 0, names
    for i, n in enumerate(calls):
        assert kernels[i % 6] in n, (i, n)


def test_smt_encode_backward_is_the_plain_gradient(dev):
    """The autograd.Function's forward is the kernel; its backward
    recomputes through the plain version, so gradients equal the plain
    path's."""
    from avlen_tpu_torch.models.smt import SMTStateEncoder

    feat, d = 40, 64
    enc = SMTStateEncoder(feat, d, 4, pose_indices=(feat - 4, feat),
                          generator=torch.Generator().manual_seed(0)).to(dev)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn(4, feat, generator=g, device=dev)
    mem = torch.randn(4, 9, feat, generator=g, device=dev)
    mask = (torch.rand(4, 9, generator=g, device=dev) > 0.3).float()
    goal = torch.randn(4, d, generator=g, device=dev, requires_grad=True)

    def grads(fused):
        enc.zero_grad()
        goal.grad = None
        if fused:
            out = enc(x, mem, mask, goal)
        else:
            from avlen_tpu_torch.ops.smt_cuda import smt_encode_plain

            entries, valid = enc.entries(x, mem, mask)
            out = smt_encode_plain(dict(enc.named_parameters()), entries, valid, goal, 4)
        (out**2).sum().backward()
        # the kernel's inputs exclude the decoder self-attention's q/k, whose
        # gradient is zero (softmax over one key); they get none at all
        return {n: p.grad.clone() if p.grad is not None else torch.zeros_like(p)
                for n, p in enc.named_parameters()}, goal.grad.clone()

    gk, ggk = grads(True)
    gp, ggp = grads(False)
    for n in gp:
        np.testing.assert_allclose(gk[n].cpu().numpy(), gp[n].cpu().numpy(), atol=5e-4, rtol=1e-3, err_msg=n)
    np.testing.assert_allclose(ggk.cpu().numpy(), ggp.cpu().numpy(), atol=5e-4, rtol=1e-3)


def test_slice_rollout_on_the_card_matches_the_cpu(dev):
    """A tiny savi.yaml world: the rollout on the card (every kernel) and on
    the CPU (every plain version), same world, weights and greedy actions."""
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.ops.irfft_cuda import partial_irfft
    from avlen_tpu_torch.ops.smt_cuda import smt_encode
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    cfg = get_config("configs/semantic_audionav/savi/savi.yaml", opts=[
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "3", "RL.PPO.num_steps", "6",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "8",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    ])
    batches = {}
    counts = [f.launches for f in (smt_encode, partial_irfft, spectrogram)]
    for d in ("cpu", dev):
        tr = SaviTrainer(cfg, device=d)
        tr._setup()
        _, batches[str(d)] = tr.collect(deterministic=True)
    after = [f.launches for f in (smt_encode, partial_irfft, spectrogram)]
    assert all(a - c >= 7 for a, c in zip(after, counts))  # 6 steps + reset/bootstrap, card only
    ref, got = batches["cpu"], batches[str(dev)]
    # greedy actions agree until a near-tie of logits (if any) flips one
    prefix = int((ref.actions == got.actions.cpu()).all(dim=1).long().cumprod(0).sum())
    assert prefix >= 3
    for k in ("values", "log_probs", "rewards"):
        np.testing.assert_allclose(getattr(got, k).cpu().numpy()[:prefix], getattr(ref, k).numpy()[:prefix],
                                   atol=1e-3, err_msg=k)


def test_update_on_the_card_matches_the_cpu(dev):
    """One SaviTrainer.update on a tiny savi.yaml world's rollout, on the card
    (the SMT kernel forward, its plain-recompute backward) and on the CPU,
    from the same parameters with the same permutations, held as chip_smoke's
    update_reference phase holds it: losses within 1e-3, the gradients in
    each Adam's first moment within 5e-4 + 1e-3·|g|, policy parameters
    within 1e-5, belief parameters within 1e-5 where the gradient fixes the
    sign of Adam's step."""
    import chip_smoke
    from avlen_tpu_torch.config import get_config

    cfg = get_config("configs/semantic_audionav/savi/savi.yaml", opts=[
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "400",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "4", "RL.PPO.num_steps", "10",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "8",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk", "5",
    ])
    fields = chip_smoke.check_update_reference(dev, cfg, n=10)
    assert fields["smt_launches"] == 4 * 2 * 2  # epochs x minibatches x chunks of 5 steps
    assert fields["optimizer_steps"] == 8


def test_train_checkpoint_and_resume_on_the_card(dev, tmp_path, monkeypatch):
    """One update of ``train()`` on a tiny savi.yaml world on the card, its
    checkpoint, and a resume from it: the checkpoint holds exactly the
    trainer's parameters and both Adam states, the resumed trainer holds
    exactly the checkpoint's, and the card's parameters loaded on the CPU
    give the card's act logits within 1e-4."""
    import chip_smoke
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.utils import preemption
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint

    monkeypatch.setattr(preemption, "INTERRUPTED_STATE_DIR", str(tmp_path / "interrupted"))
    opts = [
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000",
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "3", "RL.PPO.num_steps", "6",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "8",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
        "NUM_UPDATES", "1", "CHECKPOINT_INTERVAL", "1",
    ]
    savi = "configs/semantic_audionav/savi/savi.yaml"
    tr = SaviTrainer(get_config(savi, opts=opts, model_dir=str(tmp_path)), device=dev)
    tr.train()
    ckpt = load_checkpoint(str(tmp_path / "data" / "ckpt.0.pth"))
    assert ckpt["optim_state"]["count"] == tr.optimizer.count > 0
    assert all(v == 0 for v in chip_smoke.state_differences(tr, ckpt).values())

    resumed = SaviTrainer(get_config(savi, opts=opts + ["RESUME_CHECKPOINT", "True"], model_dir=str(tmp_path)),
                          device=dev)
    resumed._setup()
    resumed.restore(resumed.try_to_resume())
    assert all(v == 0 for v in chip_smoke.state_differences(resumed, ckpt).values())
    assert resumed.num_steps_done == 6 * 3

    cpu = SaviTrainer(get_config(savi, opts=opts), device="cpu")
    cpu._setup()
    cpu.restore(ckpt)
    c = resumed.carry
    with torch.no_grad():
        *_, want = resumed.policy.act(c.obs, c.prev_action, c.memory.features, c.memory.valid, deterministic=True)
        *_, got = cpu.policy.act({k: v.cpu() for k, v in c.obs.items()}, c.prev_action.cpu(),
                                 c.memory.features.cpu(), c.memory.valid.cpu(), deterministic=True)
    np.testing.assert_allclose(got.numpy(), want.cpu().numpy(), atol=1e-4)


@pytest.mark.parametrize("m,feat,width,pretraining", [
    (150, 276, 288, False), (150, 276, 288, True),  # π_g of the AVLEN step, 6 envs
    (150, 308, 320, False), (150, 308, 320, True),  # π_q: 32-d query state after the pose
    (3, 276, 288, False), (3, 276, 288, True),  # π_l over the 3-step dialog memory: L = 4
])
def test_smt_encode_at_the_interactive_shapes(dev, m, feat, width, pretraining):
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain, smt_plan

    b, d, nhead = 6, 256, 8
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(272, 276), pretraining=pretraining,
                          generator=torch.Generator().manual_seed(m + feat)).to(dev)
    g = torch.Generator(device=dev).manual_seed(feat)
    x = torch.randn(b, feat, generator=g, device=dev)
    mem = torch.randn(b, m, feat, generator=g, device=dev)
    mask = (torch.rand(b, m, generator=g, device=dev) > 0.3).float()
    gl = torch.randn(b, d, generator=g, device=dev)
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        p = dict(enc.named_parameters())
        got = smt_encode(p, entries, valid, gl, nhead)
        want = smt_encode_plain(p, entries, valid, gl, nhead)
    assert tuple(entries.shape) == (b, m + 1, width)
    assert smt_plan(b, m + 1, width, d, nhead).rows_tile == 16
    assert (got - want).abs().max().item() <= 1e-4


def _check_audio_kernels(dev, rows, fft_len, out_start, sampling_rate=16000):
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from avlen_tpu_torch.ops.irfft_cuda import partial_irfft, partial_irfft_plain
    from avlen_tpu_torch.ops.spectrogram_cuda import spectrogram, spectrogram_plain

    g = torch.Generator(device=dev).manual_seed(rows)
    spec = torch.fft.rfft(torch.randn(rows, 2, fft_len, generator=g, device=dev), dim=-1)
    audio = partial_irfft(spec, fft_len, out_start, sampling_rate)
    want = partial_irfft_plain(spec, fft_len, out_start, sampling_rate)
    assert (audio - want).abs().max().item() <= 1e-5 * max(want.abs().max().item(), 1.0)
    cfg = SpectrogramConfig(sampling_rate=sampling_rate)
    audio = 0.3 * audio / audio.abs().max()
    assert (spectrogram(audio, cfg) - spectrogram_plain(audio, cfg)).abs().max().item() <= 1e-4


def test_audio_kernels_at_the_pretraining_batch(dev):
    """Stage 0's batch: 64 rows of 32,768-point convolutions (16 kHz,
    2,000-tap RIRs), then their spectrograms."""
    _check_audio_kernels(dev, 64, 32768, 1999)


def test_audio_kernels_at_the_interactive_step(dev):
    """The AVLEN step's 6 envs: (6,2,32769) spectra at 65,536 points (16 kHz,
    16,000-tap RIRs), then their (6,2,16000) spectrograms."""
    _check_audio_kernels(dev, 6, 65536, 15999)


def test_interactive_collect_on_the_card_matches_the_cpu(dev):
    """chip_smoke's interactive_reference: the tiny-world collect, CUDA vs CPU."""
    import chip_smoke

    fields = chip_smoke.check_interactive_reference(dev)
    assert fields["agreeing_steps"] >= chip_smoke.INTERACTIVE_REF_MIN_AGREEING


@pytest.mark.parametrize("b,m,feat,width", [
    (45, 150, 308, 320),  # π_q's update: 15 steps x 3 envs a minibatch
    (90, 3, 276, 288),  # π_l's replay CE: 15 steps x 6 envs
    (8, 3, 276, 288),  # dialog pretraining's step
    (24, 3, 276, 288),  # dialog pretraining's update: 3 steps x 8 envs
    (10, 150, 276, 288),  # π_g at the interactive eval's 10 envs
    (10, 150, 308, 320),  # π_q at the interactive eval's 10 envs
    (10, 3, 276, 288),  # π_l at the interactive eval's 10 envs
])
def test_smt_encode_at_the_avlen_training_shapes(dev, b, m, feat, width):
    """The SMT kernel against its plain version at AVLEN training's and the
    interactive eval's encodes (1e-4), and at π_q's update rows the gradient
    through ``_SMTEncode`` against plain autograd (5e-4 + 1e-3·|g|; its
    backward is the plain recompute, so this holds the wiring), as
    chip_smoke checks them."""
    import chip_smoke
    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain

    d, nhead = 256, 8
    enc = SMTStateEncoder(feat, d, nhead, pose_indices=(272, 276), generator=torch.Generator().manual_seed(b)).to(dev)
    g = torch.Generator(device=dev).manual_seed(feat + b)
    x = torch.randn(b, feat, generator=g, device=dev)
    mem = torch.randn(b, m, feat, generator=g, device=dev)
    mask = (torch.rand(b, m, generator=g, device=dev) > 0.3).float()
    gl = torch.randn(b, d, generator=g, device=dev)
    with torch.no_grad():
        entries, valid = enc.entries(x, mem, mask)
        p = dict(enc.named_parameters())
        got = smt_encode(p, entries, valid, gl, nhead)
        want = smt_encode_plain(p, entries, valid, gl, nhead)
    assert tuple(entries.shape) == (b, m + 1, width)
    assert (got - want).abs().max().item() <= 1e-4
    if b == 45:
        assert chip_smoke._smt_grad_share(p, entries, valid, gl, nhead, g) <= 1


def test_audio_kernels_at_dialog_pretraining(dev):
    """Dialog pretraining's 8 envs: (8,2,32769) spectra at 65,536 points,
    then their (8,2,16000) spectrograms."""
    _check_audio_kernels(dev, 8, 65536, 15999)


def test_audio_kernels_at_the_interactive_eval(dev):
    """The interactive eval's 10 envs: (10,2,32769) spectra at 65,536
    points, then their (10,2,16000) spectrograms."""
    _check_audio_kernels(dev, 10, 65536, 15999)


def test_interactive_update_on_the_card_matches_the_cpu(dev):
    """chip_smoke's interactive_update_reference: one AVLEN update (π_q's
    PPO and π_l's replay CE) of the tiny world on the card and on the CPU,
    from the same parameters with the same permutations."""
    import chip_smoke

    fields = chip_smoke.check_interactive_update_reference(dev)
    assert fields["smt_launches"] == 2 * 2 * 1 + 1  # π_q: epochs x minibatches x one chunk; π_l: one chunk
    assert fields["optimizer_q_steps"] == 4


@pytest.mark.parametrize("rows", [256, 32])
def test_audio_kernels_at_the_44k_bank_rows(dev, rows):
    """The AV-Nav/AV-WAN world's spectrogram bank: launches of 256 renders
    and the last of 32, (rows,2,32769) spectra at 65,536 points (44.1 kHz,
    2,000-tap RIRs, the window [1999, 46099)), then their (rows,2,44100)
    spectrograms of 276 frames."""
    _check_audio_kernels(dev, rows, 65536, 1999, 44100)


@pytest.mark.parametrize("stack", ["avnav", "avwan"])
def test_baseline_stack_on_the_card_matches_the_cpu(dev, stack):
    """chip_smoke's avnav_reference and avwan_reference: the tiny 44.1 kHz
    world with the bank off, a greedy collect on the card against the CPU
    (actions, dones, masks and AV-WAN's maps exact; logits 1e-5, values
    1e-4 of their peak, spectrograms 1e-4, metrics 1e-6; episodes end),
    then one update of the CPU's rollout with the same permutations (losses
    1e-3, gradients 5e-4 + 1e-3·|g|, parameters 1e-5)."""
    import chip_smoke

    fields = chip_smoke.check_baseline_reference(dev, stack)
    assert fields["update"]["optimizer_steps"] == 2 * 3  # epochs x minibatches
    assert fields["launches"]["partial_irfft"] >= chip_smoke.BASELINE_REF_STEPS
    assert fields["dones"] > 0


def test_avwan_eval_ends_episodes_on_the_card(dev, tmp_path):
    """chip_smoke's avwan_episodes: AV-WAN trained one update on the tiny
    44.1 kHz world, its argmax eval on the card counting 5 episodes once
    each, the CPU's episode ids and ``val/*`` means within 1e-5."""
    import chip_smoke

    fields = chip_smoke.run_avwan_episodes("", root=str(tmp_path))
    assert fields["card"]["ids"] == fields["cpu"]["ids"] and len(fields["card"]["ids"]) == 5
    assert fields["card"]["videos"]["videos"] and fields["card"]["videos"]["tb_video_events"] > 0


def test_speaker_decodes_on_the_card_as_on_the_cpu(dev, tmp_path):
    """A speaker trained a few steps on the card at its CLI's widths
    (hidden 256): the same ``speaker.pth`` served on the card and on the
    CPU gives teacher-forced logits within chip_smoke's SPEAKER_LOGITS_TOL
    and the same greedy and beam-4 words."""
    import chip_smoke
    from avlen_tpu_torch.dialog.speaker.train_speaker import train_speaker
    from avlen_tpu_torch.sim.graph import build_scene_tables
    from avlen_tpu_torch.sim.synthetic import make_grid_scene

    rng = np.random.RandomState(0)
    tables = [build_scene_tables(make_grid_scene(rng, side=8)) for _ in range(2)]
    train_speaker(tables, num_steps=20, checkpoint_dir=str(tmp_path), device=dev)
    out = chip_smoke.check_speaker_devices(str(tmp_path / "speaker.pth"), dev, tables)
    assert out["logits_max_abs_err"] <= chip_smoke.SPEAKER_LOGITS_TOL, out
    assert out["greedy_equal"] and out["beam4_equal"], out


def test_gif_writer_round_trips_on_the_card_machine(dev, tmp_path):
    """Top-down maps of a fogged walk, written by the port's GIF writer as
    an eval writes them, decode back exactly through PIL."""
    import io

    from PIL import Image

    from avlen_tpu_torch.utils import maps, video

    rng = np.random.RandomState(3)
    pos = rng.rand(12, 3).astype(np.float32) * 8
    edges = np.array([[i, i + 1] for i in range(11)], np.int32)
    fog = np.zeros((256, 256), np.uint8)
    frames = []
    for i in range(12):
        fog = maps.reveal_fog_of_war(np.zeros((256, 256), bool), fog, (20 * i, 128), 0.5 * i, max_line_len=40)
        frames.append(maps.draw_top_down_map(pos, edges, i, i % 4, 11, trail=list(range(i + 1)), fog=fog))
    path = video.images_to_video(str(tmp_path / "episode=0_11-ckpt=0.mp4"), frames)
    assert path.endswith(".gif")
    im = Image.open(path)
    assert im.n_frames == len(frames)
    for i, f in enumerate(frames):
        im.seek(i)
        np.testing.assert_array_equal(np.asarray(im.convert("RGB")), f)
