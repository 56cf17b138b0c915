#!/usr/bin/env python3
"""Drive the PyTorch port's main path once on one CUDA card and check it.

    python3 chip_smoke.py        # from the repo root; one NVIDIA GPU and nvcc

Phases, one JSON line each; any fault raises and the script exits non-zero:

1. ``device``: the card, its count and nvidia-smi's name and power limit.
2. ``build``: the three CUDA kernels of ``avlen_tpu_torch/csrc`` compiled in
   parallel (one nvcc each) with ptxas' register and spill report.
3. ``reference``: the whole rollout on a tiny world, CUDA (kernels) against
   CPU (plain versions) with the same world, weights and greedy actions: at
   8 kHz with 2,000-tap RIRs (a 16,384-point convolution) and at 4 kHz with
   400 taps (8,192 points, the irfft's one-CTA plan).
4. ``update_reference``: one ``SaviTrainer.update`` (GAE, PPO with batched
   ring re-evaluation, the belief step) on the 8 kHz tiny world's rollout,
   on the CPU (plain versions) and on the card (kernels), from the same
   parameters with the same minibatch permutations: losses within 1e-3, the
   gradients held in each Adam's first moment within 5e-4 + 1e-3·|g|, policy
   parameters within 1e-5, belief parameters within 1e-5 where the gradient
   fixes the sign of Adam's step.
5. ``rollout``: ``SaviTrainer`` on configs/semantic_audionav/savi/savi.yaml at
   its full widths (16 envs, memory 150, d_model 256, 8 heads, RGB-D 64 px,
   16 kHz audio, 16,000-tap RIRs): reset + one rollout of 150 steps, with
   env-steps/s, the kernels' launch counts (zeroed just before), finiteness,
   and success/SPL.
6. ``update``: the same trainer trains: ``UPDATE_ROUNDS`` rounds of collect +
   update (savi.yaml: 4 epochs x 2 minibatches x 10 chunks of 15 steps, the
   SMT encode at 120 rows, frozen encoders, online belief training), with
   the kernels' launch counts over the rounds (zeroed just before; the
   ``kernels`` line reports these), ms per update split into the SMT
   kernel's forwards, its plain recompute + backward, the belief step and
   the rest (gathers, heads, GAE, optimizer), each from CUDA events on the
   stream; training env-steps/s = T·B / (rollout + update seconds); peak
   device memory. It fails unless the stats are finite, the SMT and heads
   moved, the towers did not, and every update launched the SMT kernel at
   least 80 times at 120 rows.
7. ``kernel``: each kernel against its plain PyTorch version on the card at
   the main path's shapes (the SMT encode with and without goal, in
   pretraining mode and at an unaligned batch; the spectrogram at the
   rollout's 16 envs, at 256 envs as the spectrogram bank renders them, with
   a quiet right ear and a silent env, and at 3 envs of 8 kHz), with max
   error, tolerance, and device times of the kernel, the plain version and,
   where one PyTorch call computes the same function, that call: CUDA events
   around launches enqueued behind a spin kernel, so that the host's enqueue
   does not pace them. The partial irfft also reports its cluster size, how
   many such clusters the card holds at once, its share of the bound, its
   ptxas registers and spills, and its device time read by
   ``torch.profiler``. The SMT encode also reports, at the main shape, its
   launches per call by ``torch.profiler`` (which must be the plan's, in its
   order) with the device time of each, ptxas' registers and spills of every
   kernel, its f32 and 3xTF32 operation bounds and its share of the latter,
   and its time in turns with the SIMT kernel it replaced
   (``SMT_BASELINE_COMMIT``, where the checkout can give its source); and a
   timed case at the PPO re-evaluation rows (B=120). The spectrogram also
   reports, at 16 and 256 envs, its time in turns with the radix-2 kernel
   it replaced (``SPEC_BASELINE_COMMIT``, where the checkout can give its source), one
   ``torch.stft`` of the same audio, kernels per call by ``torch.profiler``
   (which must be 1), both bounds and the share of the larger, and ptxas'
   registers and spills of every instantiation. The partial irfft also at
   the short worlds' lengths (2,048, 4,096 and 8,192 points, one CTA a row),
   each with ptxas' registers and spills of the instantiation it runs.

8. ``train_loop``: the recipe through ``avlen_tpu_torch.run.main`` in this
   process, at full widths, under ``build/chip_smoke_train``: stage 1
   (``savi_pretraining.yaml``, one update) writes ``ckpt.0``; stage 2
   (``savi.yaml`` from that checkpoint, two updates) reports the tensors
   its setup copied and kept fresh, its setup seconds, the loop's
   env-steps/s (``num_steps_done`` over the loop's seconds, the trainer
   log's fps) and ms per update by the trainer's ``Timings``, the
   checkpoint's bytes and its save and load ms; then a resume
   (``RESUME_CHECKPOINT``, one update) must hold, before its first update,
   exactly the parameters and both Adam states of ``ckpt.1`` (max abs
   difference 0) and write ``ckpt.2``.
9. ``eval``: ``--run-type eval`` of the folder's last checkpoint (split
   ``train``, ``TEST_EPISODE_COUNT`` 32, the shipped VIDEO_OPTION): 32
   episodes, no id twice, with success, SPL and seconds, read back from the
   run's event files, and the episode videos it wrote: their names, bytes
   and writer, the tensorboard video events and the host seconds of the
   video hook (``video_report``; every eval below reports the same, and
   fails if its rollouts ended episodes and it wrote no video). Every kernel's launches over these two phases are counted from
   zero; the phases fail unless every kernel ran in each and the SMT
   kernel ran at the PPO re-evaluation's 120 rows in the updates.

10. ``belief_pretrain``: stage 0 (``avlen_tpu_torch.pretraining.
    audiogoal_predictor.main``, 20 steps at batch 64 on its CLI's world:
    32,768-point convolutions), after one sampled batch's irfft and
    spectrogram held against their plain versions; ms a step, examples/s,
    CE/MSE/acc at the first and last step, the checkpoint's bytes, its
    reload, and one launch of each audio kernel a step at 64 rows.
10b. ``speaker_train``: recipe stage 4, ``train_speaker.main`` at its CLI's
    widths (hidden 256, batch 64, vocabulary 79) for SPEAKER_STEPS steps:
    ms a step, loss, token accuracy, the ``speaker.pth`` bytes, BLEU-4
    against the template channel, the same weights on the card and the CPU
    (teacher-forced logits within 1e-3, greedy and beam-4 words equal) and
    the panorama encoder card against CPU.
11. ``interactive``: the AVLEN trainer at full width on
    savi_interactive_1st_stage.yaml (6 envs, memory 150, d_model 256, CLIP
    512 x 12 layers) with its shipped neural speaker (speaker_train's
    checkpoint), π_g from train_loop's last checkpoint and the belief
    predictor from belief_pretrain's: setup (the neural bank's build
    seconds and bytes apart) and two collects of 150 steps; then
    savi_interactive_2nd_stage.yaml (full memory, the neural speaker on the
    host per query) for one collect. Env-steps/s,
    queries, dialog steps, the rl_mask share, CLIP tower calls and every
    kernel launch by shape: three SMT encodes a step at (6,151,288),
    (6,151,320) and (6,4,288), one irfft and one spectrogram. π_g must hold
    its checkpoint exactly.
12. ``interactive_reference``: the interactive collect on a tiny world,
    CUDA against CPU with the same weights and sampling draws: the three
    policies' logits within 1e-3 over at least 8 agreeing steps.
12b. ``precision`` (last, after the kernel checks): TPU.PRECISION on the card.
    savi.yaml at full width at float32 and at bfloat16 (two trainers from
    one seed): one collect of 150 steps and one update each (env-steps/s,
    ms, peak memory, every kernel's launches) and a profiled 10-step
    collect (device ms a step by kernel family, the convolutions among
    them; busy ms and idle share) after a second timed collect each; the
    float32 collect re-evaluated by both
    policies before either update (towers recomputed, the ring pool cast):
    bf16 logits and values within PRECISION_BOUND (0.1) of float32's peak;
    the tiny world's bf16 rollout, card against CPU, within the same bound;
    each kernel against its plain version on its first bf16 launch's
    inputs; one float16 collect + update with finite losses; at bfloat16
    one AVLEN stage-2 collect (CLIP and the dialog encoder at bf16, the
    neural speaker per query) and one AV-Nav collect + update, each beside
    the same at float32.

13. ``dialog_pretrain``: π_l pretraining through ``run.main`` on
    savi_pretraining_dialog_training.yaml at full width (8 envs, 3 steps an
    update, CLIP 512 x 12 layers), 20 updates: ms an update and its split,
    env-steps/s, the CE at the first and last update, the ``vln/ckpt``'s
    bytes, and every kernel launch by shape (per update 3 SMT encodes at
    (8,4,288) and one at (24,4,288), 3 irfft and 3 spectrogram launches).
14. ``interactive_train``: AVLEN's stage 1 (from train_loop's π_g,
    belief_pretrain's belief predictor and dialog_pretrain's π_l) → stage 2
    (resumed exactly, REPLAY_STORE), both with the neural speaker → eval of
    the last checkpoint (24 episodes, the configured query strategy, videos)
    → eval of the ``vln/ckpt``
    (the dialog protocol's accuracy and CE), through ``run.main``; per
    update the collect, π_q's update (the SMT kernel's forwards, their
    plain recompute + backward, the rest) and π_l's update from CUDA
    events, training env-steps/s, checkpoint bytes and save/load ms, eval
    seconds; 40 SMT launches at (45,151,320) each π_q update, 10 at
    (90,4,288) each stage-2 π_l update and none in stage 1.
15. ``interactive_update_reference``: one ``update`` of the tiny world's
    savi_interactive_2nd_stage.yaml trainer on the CPU and on the card from
    the same parameters and permutations: losses within 1e-3, both Adams'
    gradients within 5e-4 + 1e-3·|g|, π_q's and π_l's parameters within 1e-5.

16. ``avnav_reference`` and ``avwan_reference``: each baseline trainer on
    a tiny world at 44.1 kHz with the spectrogram bank off (every step
    renders through the audio kernels), CUDA against CPU with the CPU's
    weights: a greedy collect of 10 steps (actions, dones, masks and, for
    AV-WAN, the action masks and geometric maps exact; logits within 1e-5,
    values within 1e-4 of their peak, the acoustic map within 1e-4 of its
    peak), then one update of the CPU's rollout with the same permutations
    (losses 1e-3, gradients 5e-4 + 1e-3·|g|, parameters 1e-5).
17. ``avnav_train`` and ``avwan_train``: configs/audionav/av_{nav,wan}/
    audiogoal_depth.yaml through ``run.main`` at full width (16 envs;
    AV-Nav hidden 512 and 150 steps, AV-WAN hidden 256 and 20 high-level
    steps of up to 10), train 2 updates → resume (parameters and Adam
    state exact) → train 1 → eval (20 episodes for AV-Nav, sampled; 10 for
    AV-WAN, argmax; each eval's rollout budget bounded, since an AV-WAN
    agent the planner cannot move holds still). Every setup renders the
    default world's 1.61 GB 44.1 kHz spectrogram bank: its seconds and
    bytes, and each audio kernel's launches over the phase, which must
    equal the builds' (352 a build: 351 at 256 renders, 1 at 32), since no
    step launches a kernel; 256 random renders of the bank against the
    plain versions within bf16 rounding (2⁻⁸·|v| + 1e-4). Collect, update
    and training env-steps/s (AV-WAN: high- and low-level steps),
    checkpoint bytes and save/load ms, eval seconds.

18. ``reference_check``: the env over the fixture tree tests/data/
    reference_tree (copied under ``build/chip_smoke_reference``; 4 kHz,
    200-tap RIRs, every RIR from the mmap host store, no spectrogram bank),
    16 envs, a reset and 10 steps of fixed actions on the CPU and on the
    card: spectrograms within 2e-3; rgb, depth, semantic_object,
    mpcat40_index, rewards and dones exact; 11 launches of each audio
    kernel; a step's host-RIR ms (index sync, host read, H2D copy).
19. ``reference_train_avnav`` and ``reference_train_savi``: AVNAV_YAML
    (16 envs, hidden 512, 150 steps) and SAVI_YAML (16 envs, memory 150,
    d_model 256, 8 heads) at full width through ``run.main`` from the
    fixture tree, with the overrides ``reference_overrides`` names (the
    data-path keys, RIR_SAMPLING_RATE 4000, DENSE_RIR_MAX_BYTES 0,
    CACHE_SPECTROGRAMS False): train 2 → resume (exact) → train 1 → eval
    of the tree's 3 episodes; ``bank.rir`` must be a HostRIRStore.
    Env-steps/s, ms an update, a step's host-RIR ms, every kernel's
    launches.
20. ``hostrir_savi``: SAVI_YAML as shipped plus
    DATASET.SYNTHETIC.PACK_HOST_RIRS True (every procedural RIR packed into
    the mmap store: ~8.1 GB for 2 scenes of 89 nodes; one scene where the
    temporary directory cannot hold it, and the phase says so): the pack's
    seconds and bytes, one 150-step collect and one update with every RIR
    read from the host, env-steps/s beside the ``rollout`` phase's, a step's
    host-RIR ms, 151 launches of each audio kernel; then 20 steps of the
    packed env against the procedural env of the same seed (spectrograms
    within 2e-3, rewards and dones exact).

21. ``frame_cache_savi``: savi.yaml uncut plus DATASET.FRAME_CACHE_DIR on
    the banks that ``avlen_tpu_torch.scripts.cache_observations`` writes
    (2 scenes at SIDE 11, 64 px; savi.yaml's own scenes are SIDE 10): one
    150-step collect and one update, every observed rgb and depth (the
    reset's and each step's) equal to the files' frame at the env's node and
    rotation, the kernels launched as in the ``update`` phase (151 of each
    in the collect, 80 SMT in the update); the banks' bytes, the load's ms,
    env-steps/s.
22. ``vln_dialog``: FGR2R / VLN-CE / connectivity files fabricated for the
    reference tree's scene (``write_r2r_fixtures``), aligned by the port's
    ``generate_dialog_dataset`` (min_path_len 2: the 2x2 tree has no path of
    the reference's 7 nodes) into its dialog_approx split; then through
    ``run.main`` from that split, every RIR from the host store: π_l
    pretraining at savi_pretraining_dialog_training.yaml's width (2
    updates, every step served the episode's dataset ``sub_instr``), and
    AVLEN stage 1 at savi_interactive_1st_stage.yaml's (the neural speaker,
    π_g from reference_train_savi's last checkpoint; train 2 → resume exact
    → train 1 → eval of both episodes), every kernel's launches by shape as
    the configs imply.

23. ``aux_modules`` (after ``vln_dialog``): the small modules and the
    offline CLIs on the card (``run_aux_modules``): the sm_90a gate;
    ``benchmark_agent(GoalFollower())`` on savi.yaml's world uncut for 120
    steps (success 1.0, env-steps/s, one launch of each audio kernel a
    step, the first step's rows against the plain versions); the
    ``VectorEnv`` facade over that env for 20 steps with a slot paused for
    10 (its EnvState bit-frozen, the AVLEN RPCs equal to the env's); the
    challenge protocol on a 1-env savi.yaml env, ``local_evaluate`` then
    ``remote_evaluate`` through ``EvaluationServer`` on localhost (the
    same metrics); and card against CPU: the binaural decode (1e-6), the
    interactive demo on 14 scripted keys with ``--record`` (frames exact,
    audio 1e-5 × peak), ``eval_speaker`` (keys; with the CPU's parameters
    the same JSON and decodes) and ``QuesGen``'s ids.

24. ``ddppo`` (after ``aux_modules``): DD-PPO through torchrun
    (``python -m torch.distributed.run --standalone``), each rank running
    ``avlen_tpu_torch.run.main`` inside ``chip_smoke.py --ddppo-rank``,
    which counts every kernel launch by shape, holds each (kernel, shape)
    against its plain version on its first inputs (SMT 1e-4, irfft 1e-5 ×
    peak, spectrogram 1e-4), digests the parameters after each update and
    times each gradient all-reduce: savi.yaml uncut over 2 ranks sharing
    the card on gloo (8 envs a rank, one collect + update), alone; then at
    once AV-Nav, AV-WAN and AVLEN stage 1 at their configs' widths over 2
    ranks (one update each) and savi.yaml (DDPPO_PAIR_STEPS steps) on 1
    rank of NCCL beside the same with no group, with deterministic
    algorithms. A rank's collect and update ms, global training
    env-steps/s, all-reduce ms by buffer size; fails unless the ranks are
    bit-equal after the update, the NCCL run equals the no-group run bit
    for bit, every launch shape is in DDPPO_SHAPES and within its
    tolerance.
25. ``parity_evidence``: the recipe runner (``avlen_tpu_torch.scripts.
    run_parity_evidence.main``, PARITY_ARGS: scale 0.01, 8 episodes a
    cell) through every stage and the Table-1-shaped eval, every launch
    shape held against the plain version; fails unless ``summary.json``
    has the JAX script's keys with every cell finite and fully evaluated
    and ``curves.npz`` every stage.

``native_build`` (after ``build``) compiles the native host libraries
(frame server, graph engine) with g++ into ``build/native/``.

The kernel checks (phase 7) then add ``smt_interactive_shapes``: the SMT
kernel against its plain version at every AVLEN shape (the acting step's
three at 6 envs; π_q's update at (45,151,320), with the gradient through
the kernel's autograd against plain autograd; π_l's replay at (90,4,288);
dialog pretraining at (8,4,288) and (24,4,288)), pretraining off and on,
with both times and the bound; the irfft and spectrogram checks include
dialog pretraining's 8 envs and the 44.1 kHz bank's launches (256 and 32
renders: (·,2,32769) spectra at 65,536 points, the window [1999, 46099);
(·,2,44100) audio) and the reference tree's (16 envs: (16,2,4097)
spectra at 8,192 points, the window [199, 4199); (16,2,4000) audio) and
the ``aux_modules`` phase's 1-env rows (``AUX_AUDIO``: the challenge's
(1,2,32769) spectra at 65,536 points, the demo's (1,2,16385) at 32,768;
(1,2,16000) audio), with the library call's time (``torch.fft.irfft`` + slice; ``torch.stft`` for
the transform alone). Then the ``kernels`` summary line (with each
kernel's launches in every phase), the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import time

PEAK_F32_FLOPS = 67e12  # H100 SXM, f32 outside the tensor cores
PEAK_TF32_FLOPS = 495e12  # H100 SXM, dense TF32 on the tensor cores
PEAK_BYTES = 3.35e12  # H100 SXM HBM3
# The last commit whose csrc/smt_encode.cu is the SIMT design (f32 FMA GEMMs,
# 23 launches a call); chip_smoke times it beside the current kernel when the
# checkout has its git history or build/smt_baseline/smt_encode.cu holds it.
SMT_BASELINE_COMMIT = "2cb719c70bc55cd4500ba1cb0fe62810bc84c798"
# The last commit whose csrc/spectrogram.cu is the radix-2 shared-memory
# design (one block per ear and pooled column, nine barriers), timed beside
# the current kernel from git or build/spectrogram_baseline/.
SPEC_BASELINE_COMMIT = "586889d64898006621b202088dd6d3fa3e2dabf7"
SAVI_YAML = "configs/semantic_audionav/savi/savi.yaml"
STAGE1_YAML = "configs/semantic_audionav/savi/savi_pretraining.yaml"
UPDATE_ROUNDS = 2
TRAIN_DIR = "build/chip_smoke_train"  # model dirs of the train_loop and eval phases
EVAL_EPISODES = 32


EMITTED = {}  # phase -> its last emitted fields, read by later phases


def emit(phase: str, **fields) -> None:
    EMITTED[phase] = fields
    print(json.dumps({"phase": phase, **fields}), flush=True)


_SPIN_CYCLES_PER_MS = []


def spin_cycles_per_ms() -> float:
    """Clock cycles of ``torch.cuda._sleep`` per millisecond on this card."""
    import torch

    if not _SPIN_CYCLES_PER_MS:
        cycles = 20_000_000
        torch.cuda._sleep(1000)
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        torch.cuda._sleep(cycles)
        end.record()
        torch.cuda.synchronize()
        _SPIN_CYCLES_PER_MS.append(cycles / start.elapsed_time(end))
    return _SPIN_CYCLES_PER_MS[0]


def time_ms(fn, iters: int = 50, warmup: int = 5):
    """Device time per call of ``fn``: CUDA events around ``iters`` calls that
    are enqueued behind a spin kernel lasting twice as long as the same calls
    took with a synchronise, so the card runs them back to back and the
    host's enqueue (Python, ctypes, allocation) does not pace the reading.
    Where the spin ends before the last call is enqueued (a call of many
    launches fills the driver's launch queue, and the host waits), ``iters``
    is halved and the reading taken again. A call that waits on the host
    itself (a copy from pageable host memory synchronises the stream) is
    never covered: it gets the device time of its kernels and copies from
    ``torch.profiler`` instead. Returns (ms, how it was measured)."""
    import torch

    for _ in range(warmup):
        fn()
    while True:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        host_ms = (time.perf_counter() - t0) * 1e3
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda._sleep(int(2 * host_ms * spin_cycles_per_ms()))
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        covered = not start.query()  # the spin still ran when the last call was enqueued
        torch.cuda.synchronize()
        if covered:
            return start.elapsed_time(end) / iters, "events behind a spin kernel"
        if iters <= 2:
            return profiled_ms(fn)[0], "profiler device time (the call waits on the host)"
        iters //= 2


def device_events(fn, iters: int = 20, sessions: int = 5):
    """The device events (kernels and copies) of ``iters`` calls of ``fn``
    read by ``torch.profiler`` after one call outside the session, in the
    order they started. A session can lose its trace: it may drop an event
    at its edge, or, now and then, see no device event at all although the
    calls ran. A session whose count is not a whole number per call is
    taken again, up to ``sessions`` in all, and the last one is returned."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    for session in range(sessions):
        fn()
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        events = sorted((e for e in prof.events() if "CUDA" in str(getattr(e, "device_type", ""))),
                        key=lambda e: e.time_range.start)
        if events and len(events) % iters == 0:
            break
        print(f"chip_smoke: profiler session {session + 1} saw {len(events)} device events "
              f"for {iters} calls", file=sys.stderr, flush=True)
    return events


def profiled_ms(fn, kernel: str = "", iters: int = 20):
    """Device time per call of the events whose name holds ``kernel`` (all
    of them by default), their count per call, and the names of all the
    events seen, over ``iters`` calls; a count per call can read a little
    under the truth (``device_events``)."""
    events = device_events(fn, iters)
    us = [e.time_range.elapsed_us() for e in events if kernel in e.name]
    return (sum(us) / iters / 1e3 if us else None), len(us) / iters, {e.name for e in events}


def launch_profile(fn, iters: int = 20):
    """(events per call, [(name, mean µs), ...] by position within a call)
    over ``iters`` calls of ``fn``. Positions are only meaningful when every
    call runs the same launches, which the caller checks with the count."""
    events = device_events(fn, iters)
    n = len(events) // iters
    positions = []
    if n * iters == len(events):
        for i in range(n):
            at = events[i::n]
            positions.append((at[0].name, sum(e.time_range.elapsed_us() for e in at) / iters))
    return len(events) / iters, positions


class KernelLibrary:
    """A shared library built from one CUDA source into ``build/<subdir>/``,
    such as an earlier version of a kernel or a variant of it, so that two
    versions can be timed in one process. Quoted includes resolve beside the
    source first, then in ``avlen_tpu_torch/csrc``."""

    def __init__(self, src: str, tag: str, subdir: str):
        import ctypes
        import hashlib
        import os

        from avlen_tpu_torch.utils import cuda_build

        with open(src, "rb") as f:
            digest = hashlib.sha256(f.read()).hexdigest()[:16]
        out_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)), "build", subdir)
        os.makedirs(out_dir, exist_ok=True)
        path = os.path.join(out_dir, f"lib{tag}-{digest}.so")
        cmd = [cuda_build.nvcc_path(), *cuda_build.NVCC_FLAGS, "-Xptxas", "-v",
               "-I", str(cuda_build.CSRC), "-o", path, src]
        proc = subprocess.run(cmd, capture_output=True, text=True, timeout=600)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed for {src}:\n{proc.stdout}{proc.stderr}")
        self.build_log = proc.stdout + proc.stderr
        self.lib, self.src, self.tag = ctypes.CDLL(path), src, tag


class SmtLibrary(KernelLibrary):
    """An ``smt_encode`` library from any source that keeps the port's C entry
    (``smt_encode``, ``smt_encode_workspace_floats(B, L, D)``)."""

    def __init__(self, src: str, tag: str):
        import ctypes

        super().__init__(src, tag, "smt_variants")
        lib = self.lib
        lib.smt_encode_workspace_floats.argtypes = [ctypes.c_int] * 3
        lib.smt_encode_workspace_floats.restype = ctypes.c_longlong
        lib.smt_encode.argtypes = [ctypes.c_void_p] * 6 + [ctypes.c_int] * 5 + [ctypes.c_void_p]
        lib.smt_encode.restype = ctypes.c_int

    def __call__(self, params, entries, valid, goal, nhead: int):
        import ctypes

        import torch

        from avlen_tpu_torch.ops import smt_cuda
        from avlen_tpu_torch.utils import cuda_build

        b, l, f = entries.shape
        weights = [params[n].contiguous() for n in smt_cuda.KERNEL_WEIGHTS]
        d = weights[0].shape[0]
        dev = entries.device
        ws = torch.empty(self.lib.smt_encode_workspace_floats(b, l, d), dtype=torch.float32, device=dev)
        out = torch.empty((b, d), dtype=torch.float32, device=dev)
        ptrs = (ctypes.c_void_p * len(weights))(*[w.data_ptr() for w in weights])
        rc = self.lib.smt_encode(entries.data_ptr(), valid.data_ptr(),
                                 goal.data_ptr() if goal is not None else None,
                                 ctypes.cast(ptrs, ctypes.c_void_p), out.data_ptr(), ws.data_ptr(),
                                 b, l, f, d, nhead, cuda_build.current_stream(dev))
        cuda_build.check(rc, f"smt_encode ({self.tag})")
        return out


class SpectrogramLibrary(KernelLibrary):
    """A ``spectrogram`` library from any source that keeps the port's C entry
    ``spectrogram(audio, window, [twiddles,] out, batch, T, n_fft, hop,
    n_frames, bf, bt, fprime, tprime, stream)``; the radix-2 design
    (``SPEC_BASELINE_COMMIT``) takes no twiddle table."""

    def __init__(self, src: str, tag: str):
        import ctypes

        super().__init__(src, tag, "spectrogram_variants")
        with open(src) as f:
            entry = f.read().split('extern "C" int spectrogram(', 1)[1]
        self.takes_twiddles = "twiddles" in entry[: entry.index(")")]
        fn = self.lib.spectrogram
        fn.argtypes = [ctypes.c_void_p] * (4 if self.takes_twiddles else 3) + [ctypes.c_int] * 9 + [ctypes.c_void_p]
        fn.restype = ctypes.c_int

    def __call__(self, audio, cfg):
        import torch

        from avlen_tpu_torch.ops import spectrogram_cuda
        from avlen_tpu_torch.ops.audio import device_window
        from avlen_tpu_torch.utils import cuda_build

        b, _, t = audio.shape
        plan = spectrogram_cuda.spectrogram_plan(b, t, cfg)
        dev = audio.device
        window = device_window(dev, plan.n_fft, cfg.win_length)
        tables = [window.data_ptr()]
        if self.takes_twiddles:
            tables.append(spectrogram_cuda.device_twiddles(dev, plan).data_ptr())
        out = torch.empty((b, plan.fprime, plan.tprime, 2), dtype=torch.float32, device=dev)
        rc = self.lib.spectrogram(audio.data_ptr(), *tables, out.data_ptr(), b, t, plan.n_fft, plan.hop,
                                  plan.n_frames, plan.bf, plan.bt, plan.fprime, plan.tprime,
                                  cuda_build.current_stream(dev))
        cuda_build.check(rc, f"spectrogram ({self.tag})")
        return out


def bound(flops: float, nbytes: float, peak_flops: float = PEAK_F32_FLOPS):
    t_ops, t_bytes = flops / peak_flops * 1e3, nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def baseline_source(commit: str, files, subdir: str):
    """Path of ``files[0]`` as it was at ``commit``, written with the rest of
    ``files`` (headers it includes) into ``build/<subdir>/`` from git where
    it is not there yet; None where neither is available."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(root, "build", subdir)
    paths = [os.path.join(out_dir, os.path.basename(f)) for f in files]
    for f, path in zip(files, paths):
        if os.path.exists(path):
            continue
        try:
            src = subprocess.run(["git", "show", f"{commit}:{f}"], cwd=root, capture_output=True,
                                 text=True, timeout=60, check=True).stdout
        except (OSError, subprocess.SubprocessError):
            return None
        os.makedirs(out_dir, exist_ok=True)
        with open(path, "w") as fh:
            fh.write(src)
    return paths[0]


def smt_baseline_source():
    """The SIMT SMT kernel's source (``SMT_BASELINE_COMMIT``) or None."""
    return baseline_source(SMT_BASELINE_COMMIT, ["avlen_tpu_torch/csrc/smt_encode.cu"], "smt_baseline")


def spectrogram_baseline_source():
    """The radix-2 spectrogram kernel's source and header (``SPEC_BASELINE_COMMIT``) or None."""
    return baseline_source(SPEC_BASELINE_COMMIT, ["avlen_tpu_torch/csrc/spectrogram.cu",
                                                  "avlen_tpu_torch/csrc/smem_fft.cuh"],
                           "spectrogram_baseline")


def smt_flops_bytes(entries, valid, goal, params, d: int):
    """f32 operations and bytes (inputs and weights read once, the output
    written once) of one SMT encode."""
    from avlen_tpu_torch.ops import smt_cuda

    b, l, f = entries.shape
    flops = 2 * (b * l * (f * d + 9 * d * d) + 2 * b * l * l * d + 6 * b * d * d + 2 * b * l * d)
    nbytes = 4 * (entries.numel() + valid.numel() + (goal.numel() if goal is not None else 0) + b * d
                  + sum(params[n].numel() for n in smt_cuda.KERNEL_WEIGHTS))
    return flops, nbytes


def check_smt(dev, gen, build_log: str):
    """The SMT encode against its plain version in five cases. At the main
    shape also: its time in turns with the SIMT baseline kernel (baseline,
    kernel, kernel, baseline), the plain version's time, its launches by
    torch.profiler (device time of each in call order, and their count and
    names against the plan), ptxas' registers and spills of each kernel, and
    both operation bounds (f32 on the CUDA cores; 3xTF32 on the tensor cores,
    the least time of a route that holds the tolerance, which the share is
    taken against). At the re-evaluation rows (B=120): its time."""
    import re

    import torch

    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops import smt_cuda

    tol = 1e-4  # f32 in and out; 3xTF32 tensor-core products vs cuBLAS f32
    d, nhead, feat = 256, 8, 276
    baseline_src = smt_baseline_source()
    baseline = SmtLibrary(baseline_src, "baseline") if baseline_src else None
    ptxas = {}
    for name in sorted(set(re.findall(r"Compiling entry function '(\w*smt_\w+)'", build_log))):
        regs, spill_st, spill_ld = ptxas_report(build_log, name)
        ptxas[name[name.index("smt_"):][:40]] = dict(registers=regs, spill_store_bytes=spill_st,
                                                    spill_load_bytes=spill_ld)
    result = None
    for case, b, m, goal_on, pre in (
        ("main", 16, 150, True, False),
        ("no_goal", 16, 150, False, False),
        ("pretraining", 16, 150, True, True),
        ("unaligned_b", 5, 37, True, False),
        ("eval_rows", 120, 150, True, False),  # PPO re-evaluation: 15 steps x 8 envs a mini-batch
    ):
        enc = SMTStateEncoder(feat, d, nhead, pose_indices=(feat - 4, feat), pretraining=pre,
                              generator=torch.Generator().manual_seed(7)).to(dev)
        x = torch.randn(b, feat, generator=gen, device=dev)
        mem = torch.randn(b, m, feat, generator=gen, device=dev)
        mask = (torch.rand(b, m, generator=gen, device=dev) > 0.3).float()
        goal = torch.randn(b, d, generator=gen, device=dev) if goal_on else None
        with torch.no_grad():
            entries, valid = enc.entries(x, mem, mask)
            params = dict(enc.named_parameters())
            got = smt_cuda.smt_encode(params, entries, valid, goal, nhead)
            want = smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead)
            torch.cuda.synchronize()
            err = (got - want).abs().max().item()
            fields = dict(kernel="smt_encode", case=case, shape=list(entries.shape),
                          max_abs_err=err, tol=tol)
            kernel = lambda: smt_cuda.smt_encode(params, entries, valid, goal, nhead)  # noqa: E731
            plain = lambda: smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead)  # noqa: E731
            flops, nbytes = smt_flops_bytes(entries, valid, goal, params, d)
            bound_f32_ms = bound(flops, nbytes)[0]
            bound_ms, bound_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            if case == "main":
                timing = {}
                base_runs = base_err = None
                if baseline is not None:
                    base = lambda: baseline(params, entries, valid, goal, nhead)  # noqa: E731
                    base_err = (base() - want).abs().max().item()
                    t = [time_ms(fn) for fn in (base, kernel, kernel, base)]
                    ms_runs, base_runs = [t[1][0], t[2][0]], [t[0][0], t[3][0]]
                    timing.update(ms=t[1][1], baseline_ms=t[0][1])
                else:
                    ms, timing["ms"] = time_ms(kernel)
                    ms_runs = [ms]
                ms = sum(ms_runs) / len(ms_runs)
                plain_ms, timing["plain_ms"] = time_ms(plain)
                per_call, launches = launch_profile(kernel)
                plan = smt_cuda.smt_plan(*entries.shape, d, nhead)
                want_names = [x.kernel for x in plan.launches]
                fields.update(
                    ms=ms, ms_runs=ms_runs, baseline_ms=base_runs, baseline_max_abs_err=base_err,
                    baseline_source=(f"{SMT_BASELINE_COMMIT[:7]}:avlen_tpu_torch/csrc/smt_encode.cu"
                                     if baseline is not None else "not available"),
                    plain_ms=plain_ms, library_ms=None, bound_ms=bound_ms, bound_by=bound_by,
                    bound_f32_ms=bound_f32_ms, share_of_bound=bound_ms / ms, gflop=flops / 1e9,
                    kernels_per_call=per_call, plan_kernels=want_names,
                    launches_us=[[n[:60], us] for n, us in launches], rows_tile=plan.rows_tile,
                    ptxas=ptxas, timing=timing)
                result = {k: fields[k] for k in (
                    "max_abs_err", "ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_f32_ms",
                    "share_of_bound", "baseline_ms", "kernels_per_call", "timing")}
                names = [n for n, _ in launches]
                if per_call != len(want_names) or not all(k in n for k, n in zip(want_names, names)):
                    emit("kernel", **fields)
                    raise AssertionError(f"smt_encode: {per_call} kernels a call {names}, "
                                         f"the plan's are {want_names}")
            elif case == "eval_rows":
                ms, how = time_ms(kernel)
                plain_ms, plain_how = time_ms(plain)
                fields.update(ms=ms, plain_ms=plain_ms, bound_ms=bound_ms, bound_f32_ms=bound_f32_ms,
                              share_of_bound=bound_ms / ms, timing=dict(ms=how, plain_ms=plain_how))
        emit("kernel", **fields)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"smt_encode {case}: max abs err {err} > {tol}")
    return result


def ptxas_report(log: str, entry: str):
    """(registers, spill store bytes, spill load bytes) of the kernel whose
    mangled name holds ``entry``, from ``nvcc -Xptxas -v`` output."""
    import re

    lines = log.splitlines()
    for i, ln in enumerate(lines):
        if "Compiling entry" in ln and entry in ln:
            block = "\n".join(lines[i : i + 4])
            regs = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", block)
            return (int(regs.group(1)) if regs else None,
                    int(spill.group(1)) if spill else None, int(spill.group(2)) if spill else None)
    raise AssertionError(f"no ptxas report for {entry}")


# the 16 kHz AVLEN paths' env counts (16,000-tap RIRs: 65,536-point
# convolutions): the acting step's 6, dialog pretraining's and its eval's 8,
# and the interactive eval's 10 (get_config's NUM_PROCESSES for an eval)
AVLEN_AUDIO_ENVS = {"interactive": 6, "dialog_pretrain": 8, "interactive_eval": 10}
# the 44.1 kHz spectrogram bank of the AV-Nav/AV-WAN world: a launch of 256
# renders (precompute_spectrogram_bank's batch), and the last launch's 32
BANK_BATCH = 256
BANK_44K_CASES = {"bank_44k": BANK_BATCH, "bank_44k_last": 32}


def check_irfft(dev, gen, build_log: str):
    import torch

    from avlen_tpu_torch.ops import irfft_cuda

    fft_len, out_start, out_len = 65536, 15999, 16000  # 16 kHz, 16,000-tap RIRs
    x = torch.randn(16, 2, fft_len, generator=gen, device=dev)
    spec = torch.fft.rfft(x, dim=-1)
    got = irfft_cuda.partial_irfft(spec, fft_len, out_start, out_len)
    want = irfft_cuda.partial_irfft_plain(spec, fft_len, out_start, out_len)
    torch.cuda.synchronize()
    scale = max(want.abs().max().item(), 1.0)
    err = (got - want).abs().max().item()
    tol = 1e-5 * scale  # f32 radix-8/16 FFT vs cuFFT, relative to the peak sample
    kernel = lambda: irfft_cuda.partial_irfft(spec, fft_len, out_start, out_len)  # noqa: E731
    ms, how = time_ms(kernel)
    plain_ms, plain_how = time_ms(lambda: irfft_cuda.partial_irfft_plain(spec, fft_len, out_start, out_len))
    library_ms, lib_how = time_ms(
        lambda: torch.fft.irfft(spec, n=fft_len, dim=-1)[..., out_start : out_start + out_len])
    prof_ms, per_call, names = profiled_ms(kernel, "irfft_cluster")
    rows = spec.shape[0] * spec.shape[1]
    nbytes = spec.numel() * 8 + got.numel() * 4
    flops = rows * 2.5 * fft_len * math.log2(fft_len)
    bound_ms, bound_by = bound(flops, nbytes)
    plan = irfft_cuda.irfft_plan(fft_len, out_start, out_len, rows)
    regs, spill_st, spill_ld = ptxas_report(build_log, f"irfft_clusterILi{plan.threads}E")
    extra = dict(cluster=plan.cluster, max_active_clusters=irfft_cuda.max_active_clusters(plan),
                 share_of_bound=bound_ms / ms, registers=regs, spill_store_bytes=spill_st,
                 spill_load_bytes=spill_ld, profiler_ms=prof_ms, kernels_per_call=per_call,
                 timing=dict(ms=how, plain_ms=plain_how, library_ms=lib_how))
    emit("kernel", kernel="partial_irfft", case="main", shape=list(spec.shape), max_abs_err=err,
         tol=tol, ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms,
         bound_by=bound_by, **extra)
    if not math.isfinite(err) or err > tol:
        raise AssertionError(f"partial_irfft: max abs err {err} > {tol}")
    if not 0 < per_call <= 1 or any("irfft_cluster" not in n for n in names):
        raise AssertionError(f"partial_irfft: {per_call} kernels per call ({names}), want one launch")
    cases = {}
    # the AVLEN paths' env counts, then the 1, 2 and 4 kHz worlds (128, 200
    # and 400 taps): one CTA a row
    for case, b, n, start, length in (*((c, b, 65536, 15999, 16000) for c, b in AVLEN_AUDIO_ENVS.items()),
                                      ("fft_len_2048", 16, 2048, 127, 1000),
                                      ("fft_len_4096", 16, 4096, 199, 2000),
                                      ("fft_len_8192", 16, 8192, 399, 4000)):
        sp = torch.fft.rfft(torch.randn(b, 2, n, generator=gen, device=dev), dim=-1)
        got_n = irfft_cuda.partial_irfft(sp, n, start, length)
        want_n = irfft_cuda.partial_irfft_plain(sp, n, start, length)
        torch.cuda.synchronize()
        tol_n = 1e-5 * max(want_n.abs().max().item(), 1.0)
        err_n = (got_n - want_n).abs().max().item()
        ms_n, how_n = time_ms(lambda: irfft_cuda.partial_irfft(sp, n, start, length))
        plain_n, _ = time_ms(lambda: irfft_cuda.partial_irfft_plain(sp, n, start, length))
        plan_n = irfft_cuda.irfft_plan(n, start, length, 2 * b)
        bound_n, bound_by_n = bound(2 * b * 2.5 * n * math.log2(n), sp.numel() * 8 + got_n.numel() * 4)
        regs_n, spill_st_n, spill_ld_n = ptxas_report(build_log, f"irfft_clusterILi{plan_n.threads}E")
        cases[case] = dict(max_abs_err=err_n, tol=tol_n, ms=ms_n, plain_ms=plain_n, bound_ms=bound_n,
                           bound_by=bound_by_n, threads=plan_n.threads, registers=regs_n,
                           spill_store_bytes=spill_st_n, spill_load_bytes=spill_ld_n)
        emit("kernel", kernel="partial_irfft", case=case, shape=list(sp.shape), **cases[case],
             cluster=plan_n.cluster, timing=how_n)
        if not math.isfinite(err_n) or err_n > tol_n:
            raise AssertionError(f"partial_irfft {case} {tuple(sp.shape)}: max abs err {err_n} > {tol_n}")
    # the 44.1 kHz spectrogram bank's launches (2,000-tap RIRs: 65,536
    # points, the window [1999, 46099)): 256 renders, and the last launch's 32
    for case, b in ((f"{c}_rows", b) for c, b in BANK_44K_CASES.items()):
        n, start, length = 65536, 1999, 44100
        sp = torch.fft.rfft(torch.randn(b, 2, n, generator=gen, device=dev), dim=-1)
        got_n = irfft_cuda.partial_irfft(sp, n, start, length)
        want_n = irfft_cuda.partial_irfft_plain(sp, n, start, length)
        torch.cuda.synchronize()
        tol_n = 1e-5 * max(want_n.abs().max().item(), 1.0)
        err_n = (got_n - want_n).abs().max().item()
        ms_n, how_n = time_ms(lambda: irfft_cuda.partial_irfft(sp, n, start, length))
        plain_n, _ = time_ms(lambda: irfft_cuda.partial_irfft_plain(sp, n, start, length))
        lib_n, _ = time_ms(lambda: torch.fft.irfft(sp, n=n, dim=-1)[..., start : start + length])
        bound_n, bound_by_n = bound(2 * b * 2.5 * n * math.log2(n), sp.numel() * 8 + got_n.numel() * 4)
        plan_n = irfft_cuda.irfft_plan(n, start, length, 2 * b)
        cases[case] = dict(shape=list(sp.shape), max_abs_err=err_n, tol=tol_n, ms=ms_n, plain_ms=plain_n,
                           library_ms=lib_n, bound_ms=bound_n, bound_by=bound_by_n, share_of_bound=bound_n / ms_n,
                           cluster=plan_n.cluster)
        emit("kernel", kernel="partial_irfft", case=case, **cases[case], timing=how_n)
        if not math.isfinite(err_n) or err_n > tol_n:
            raise AssertionError(f"partial_irfft {case} {tuple(sp.shape)}: max abs err {err_n} > {tol_n}")
        del sp, got_n, want_n
    # the reference tree's 4 kHz audio (200-tap RIRs: 8,192 points, one CTA
    # a row), as reference_check and reference_train launch it
    for case, (b, n, start, length) in LIBRARY_ROWS.items():
        sp = torch.fft.rfft(torch.randn(b, 2, n, generator=gen, device=dev), dim=-1)
        got_n = irfft_cuda.partial_irfft(sp, n, start, length)
        want_n = irfft_cuda.partial_irfft_plain(sp, n, start, length)
        torch.cuda.synchronize()
        tol_n = 1e-5 * max(want_n.abs().max().item(), 1.0)
        err_n = (got_n - want_n).abs().max().item()
        ms_n, how_n = time_ms(lambda: irfft_cuda.partial_irfft(sp, n, start, length))
        plain_n, _ = time_ms(lambda: irfft_cuda.partial_irfft_plain(sp, n, start, length))
        lib_n, _ = time_ms(lambda: torch.fft.irfft(sp, n=n, dim=-1)[..., start : start + length])
        bound_n, bound_by_n = bound(2 * b * 2.5 * n * math.log2(n), sp.numel() * 8 + got_n.numel() * 4)
        plan_n = irfft_cuda.irfft_plan(n, start, length, 2 * b)
        reference = dict(shape=list(sp.shape), max_abs_err=err_n, tol=tol_n, ms=ms_n, plain_ms=plain_n,
                         library_ms=lib_n, bound_ms=bound_n, bound_by=bound_by_n, share_of_bound=bound_n / ms_n,
                         threads=plan_n.threads, cluster=plan_n.cluster)
        emit("kernel", kernel="partial_irfft", case=case, **reference, timing=how_n)
        if not math.isfinite(err_n) or err_n > tol_n:
            raise AssertionError(f"partial_irfft {case} {tuple(sp.shape)}: max abs err {err_n} > {tol_n}")
        cases[f"{case}_rows"] = reference
    ref_rows = {f"{case}_rows": cases.pop(f"{case}_rows") for case in LIBRARY_ROWS}
    bank = {f"{case}_rows": cases.pop(f"{case}_rows") for case in BANK_44K_CASES}
    avlen = {f"{case}_rows": cases.pop(case) for case in AVLEN_AUDIO_ENVS}
    short = {int(case.rsplit("_", 1)[1]): fields for case, fields in cases.items()}
    return dict(max_abs_err=max([err] + [f["max_abs_err"] for f in (*avlen.values(), *bank.values(),
                                                                    *ref_rows.values())]),
                ms=ms, plain_ms=plain_ms, library_ms=library_ms, bound_ms=bound_ms, bound_by=bound_by, **extra,
                **avlen, **bank, **ref_rows, short_rows=short)


def spectrogram_flops_bytes(audio, out, cfg):
    """f32 operations and bytes of one spectrogram call: one n_fft-point
    complex FFT (5 N log2 N) per frame of both ears, the least transform work
    for two real frames; the audio, window and twiddles read once and the
    output written once."""
    b, _, t = audio.shape
    frames = 1 + t // cfg.hop_length
    flops = b * frames * 5 * cfg.n_fft * math.log2(cfg.n_fft)
    nbytes = (audio.numel() + out.numel() + 3 * cfg.n_fft) * 4
    return flops, nbytes


def check_spectrogram(dev, gen, build_log: str):
    """The spectrogram against its plain version in seven cases: ``main``
    (the rollout's 16 envs), ``bank_rows`` (256 envs, a row block of the
    spectrogram bank), ``uneven`` (right ear x1e-3, one silent env),
    ``short`` (3 envs of 8 kHz) and the AVLEN paths' env counts
    (AVLEN_AUDIO_ENVS: ``interactive`` 6, ``dialog_pretrain`` 8,
    ``interactive_eval`` 10), the last three with the kernel's and the
    plain version's times and the bound. At main and bank_rows also: its time in
    turns with the radix-2 kernel it replaced (baseline, kernel, kernel,
    baseline), the plain version's time, one ``torch.stft`` of the same
    audio (``stft_call_ms``, the transform alone), kernels per call by
    torch.profiler (must be 1), and both bounds with the share of the
    larger. ptxas' registers and spills of every instantiation."""
    import re

    import torch

    from avlen_tpu_torch.ops import spectrogram_cuda
    from avlen_tpu_torch.ops.audio import SpectrogramConfig, device_window

    tol = 1e-4  # log1p of pooled f32 magnitudes; radix-8 FFT of the packed ears vs cuFFT per ear
    baseline_src = spectrogram_baseline_source()
    baseline = SpectrogramLibrary(baseline_src, "baseline") if baseline_src else None
    ptxas = {}
    for name in sorted(set(re.findall(r"Compiling entry function '(\w*spectrogram_kernel\w*)'", build_log))):
        regs, spill_st, spill_ld = ptxas_report(build_log, name)
        ptxas[name] = dict(registers=regs, spill_store_bytes=spill_st, spill_load_bytes=spill_ld)
    results = {}
    for case, b, sr, right_scale, silent_row in (
        ("main", 16, 16000, 1.0, None),
        ("bank_rows", 256, 16000, 1.0, None),
        ("uneven", 16, 16000, 1e-3, 5),
        ("short", 3, 8000, 1.0, None),
        *((case, b, 16000, 1.0, None) for case, b in AVLEN_AUDIO_ENVS.items()),
        *((case, b, 44100, 1.0, None) for case, b in BANK_44K_CASES.items()),
        *((case, rows, out_len, 1.0, None) for case, (rows, _, _, out_len) in LIBRARY_ROWS.items()),
    ):
        cfg = SpectrogramConfig(sampling_rate=sr)
        audio = 0.3 * torch.randn(b, 2, sr, generator=gen, device=dev)
        audio[:, 1] *= right_scale
        if silent_row is not None:
            audio[silent_row] = 0
        got = spectrogram_cuda.spectrogram(audio, cfg)
        want = spectrogram_cuda.spectrogram_plain(audio, cfg)
        torch.cuda.synchronize()
        err = (got - want).abs().max().item()
        fields = dict(kernel="spectrogram", case=case, shape=list(audio.shape), max_abs_err=err, tol=tol)
        if case in ("main", "bank_rows"):
            kernel = lambda: spectrogram_cuda.spectrogram(audio, cfg)  # noqa: E731
            timing = {}
            base_runs = base_err = None
            if baseline is not None:
                base = lambda: baseline(audio, cfg)  # noqa: E731
                base_err = (base() - want).abs().max().item()
                t = [time_ms(fn) for fn in (base, kernel, kernel, base)]
                ms_runs, base_runs = [t[1][0], t[2][0]], [t[0][0], t[3][0]]
                timing.update(ms=t[1][1], baseline_ms=t[0][1])
            else:
                ms, timing["ms"] = time_ms(kernel)
                ms_runs = [ms]
            ms = sum(ms_runs) / len(ms_runs)
            plain_ms, timing["plain_ms"] = time_ms(lambda: spectrogram_cuda.spectrogram_plain(audio, cfg))
            window = device_window(dev, cfg.n_fft, cfg.win_length)  # the Hann centred in the frame
            flat = audio.reshape(-1, sr)
            stft_ms, timing["stft_call_ms"] = time_ms(lambda: torch.stft(
                flat, cfg.n_fft, cfg.hop_length, win_length=cfg.n_fft, window=window, center=True,
                pad_mode="reflect", return_complex=True))
            _, per_call, names = profiled_ms(kernel)
            flops, nbytes = spectrogram_flops_bytes(audio, got, cfg)
            t_ops, t_bytes = flops / PEAK_F32_FLOPS * 1e3, nbytes / PEAK_BYTES * 1e3
            bound_ms, bound_by = bound(flops, nbytes)
            fields.update(
                ms=ms, ms_runs=ms_runs, baseline_ms=base_runs, baseline_max_abs_err=base_err,
                baseline_source=(f"{SPEC_BASELINE_COMMIT[:7]}:avlen_tpu_torch/csrc/spectrogram.cu"
                                 if baseline is not None else "not available"),
                plain_ms=plain_ms, library_ms=None, stft_call_ms=stft_ms, bound_ms=bound_ms,
                bound_by=bound_by, bound_bytes_ms=t_bytes, bound_ops_ms=t_ops,
                share_of_bound=bound_ms / ms, gflop=flops / 1e9, mbytes=nbytes / 1e6,
                kernels_per_call=per_call, timing=timing)
            if case == "main":
                fields["ptxas"] = ptxas
            emit("kernel", **fields)
            results[case] = fields
            if not 0 < per_call <= 1 or any("spectrogram_kernel" not in n for n in names):
                raise AssertionError(f"spectrogram {case}: {per_call} kernels per call ({names}), want one launch")
        else:
            if case in AVLEN_AUDIO_ENVS or case in BANK_44K_CASES or case in LIBRARY_ROWS:
                fields["ms"], _ = time_ms(lambda: spectrogram_cuda.spectrogram(audio, cfg))
                fields["plain_ms"], _ = time_ms(lambda: spectrogram_cuda.spectrogram_plain(audio, cfg))
                fields["bound_ms"], fields["bound_by"] = bound(*spectrogram_flops_bytes(audio, got, cfg))
                fields["library_ms"] = None
                if case in BANK_44K_CASES or case in LIBRARY_ROWS:
                    window = device_window(dev, cfg.n_fft, cfg.win_length)
                    flat = audio.reshape(-1, sr)
                    fields["stft_call_ms"], _ = time_ms(lambda: torch.stft(
                        flat, cfg.n_fft, cfg.hop_length, win_length=cfg.n_fft, window=window, center=True,
                        pad_mode="reflect", return_complex=True))
                    fields["share_of_bound"] = fields["bound_ms"] / fields["ms"]
                results[case] = fields
            emit("kernel", **fields)
        if not math.isfinite(err) or err > tol:
            raise AssertionError(f"spectrogram {case}: max abs err {err} > {tol}")
        if silent_row is not None and got[silent_row].any():
            raise AssertionError(f"spectrogram {case}: the silent env's spectrogram is not zero")
        results.setdefault("errors", {})[case] = err
    main, bank = results["main"], results["bank_rows"]
    return dict(
        {k: main[k] for k in ("ms", "plain_ms", "library_ms", "bound_ms", "bound_by", "bound_bytes_ms",
                              "bound_ops_ms", "share_of_bound", "baseline_ms", "stft_call_ms",
                              "kernels_per_call", "timing")},
        max_abs_err=max(results["errors"].values()), max_abs_err_by_case=results["errors"],
        bank_rows={k: bank[k] for k in ("ms", "plain_ms", "baseline_ms", "stft_call_ms", "bound_ms",
                                        "bound_by", "bound_bytes_ms", "bound_ops_ms", "share_of_bound")},
        **{f"{case}_rows": {k: results[case][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                           "bound_by")}
           for case in AVLEN_AUDIO_ENVS},
        **{f"{case}_rows": {k: results[case][k] for k in ("shape", "max_abs_err", "ms", "plain_ms", "library_ms",
                                                           "stft_call_ms", "bound_ms", "bound_by", "share_of_bound")}
           for case in (*BANK_44K_CASES, *LIBRARY_ROWS)},
        ptxas=ptxas)


def tiny_config(sampling_rate: int = 8000, rir_length: int = 2000, extra=()):
    """savi.yaml on a tiny world: 3 envs, memory 8, d_model 32, 4 heads
    (and the ``extra`` options)."""
    from avlen_tpu_torch.config import get_config

    return get_config(SAVI_YAML, opts=[
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", str(rir_length),
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", str(sampling_rate),
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "NUM_PROCESSES", "3",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "8",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
        "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4",
    ] + list(extra))


def check_reference(dev, sampling_rate: int = 8000, rir_length: int = 2000):
    """The whole rollout on a tiny world: CUDA (kernels) vs CPU (plain)."""
    import torch

    from avlen_tpu_torch.ops.irfft_cuda import partial_irfft
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    cfg = tiny_config(sampling_rate, rir_length)
    steps = 12
    batches = {}
    for d in ("cpu", dev):
        trainer = SaviTrainer(cfg, device=d)
        trainer._setup()
        before = partial_irfft.launches
        _, batches[str(d)] = trainer.collect(deterministic=True, n=steps)
        irfft_launches = partial_irfft.launches - before
    fft_len = trainer.env.bank.rir.fft_len
    ref, got = batches["cpu"], batches[str(dev)]
    same = (ref.actions == got.actions.cpu()).all(dim=1)
    prefix = int(same.long().cumprod(0).sum())  # steps before any greedy action differs
    if prefix < 4:
        raise AssertionError(f"reference: greedy actions diverged after {prefix} steps")
    errs = {
        k: (getattr(got, k).cpu()[:prefix] - getattr(ref, k)[:prefix]).abs().max().item()
        for k in ("values", "log_probs")
    }
    spec_err = (got.obs["spectrogram"].cpu()[:prefix] - ref.obs["spectrogram"][:prefix]).abs().max().item()
    tol = 1e-3
    emit("reference", sampling_rate=sampling_rate, rir_length=rir_length, fft_len=fft_len, steps=steps,
         agreeing_steps=prefix, spectrogram_err=spec_err, tol=tol, irfft_launches=irfft_launches, **errs)
    if max(errs.values()) > tol or spec_err > tol:
        raise AssertionError(f"reference: CUDA vs CPU rollout differ {errs} spectrogram {spec_err}")
    if irfft_launches < steps:
        raise AssertionError(f"reference: the irfft kernel ran {irfft_launches} times in {steps} steps")


GRAD_ATOL, GRAD_RTOL = 5e-4, 1e-3  # gradients, as the CPU tests hold them against JAX
POLICY_PARAM_TOL = 1e-5  # policy parameters after an update (the H100 read 6e-8)
SETTLED_GRAD = 2e-3  # |g| above which both devices' Adam steps take the same sign
SETTLED_PARAM_TOL = 1e-5  # belief parameters where |g| > SETTLED_GRAD


def adam_gradients(module, adam):
    """name -> exp_avg / (1 - beta1) of each parameter of ``module`` under the
    torch Adam ``adam``, zeros where it never stepped: after one step the
    gradient that step took, after more the same mix of every step's."""
    import torch

    beta1 = adam.param_groups[0]["betas"][0]
    return {n: adam.state[p]["exp_avg"] / (1 - beta1) if "exp_avg" in adam.state.get(p, {})
            else torch.zeros_like(p) for n, p in module.named_parameters()}


def share_of_tol(got, want, tol) -> float:
    """max |got - want| / tol over the entries (tol a number or a tensor, on
    any device)."""
    tol = tol.cpu() if hasattr(tol, "cpu") else tol
    return ((got.detach().cpu() - want.detach().cpu()).abs() / tol).max().item()


def check_update_reference(dev, cfg=None, n: int = 12):
    """One update on a tiny world's rollout of ``n`` steps (default: the
    8 kHz world): CUDA (the SMT kernel forward, its plain-recompute backward)
    vs CPU (plain), from the same parameters with the same permutations.
    Losses within 1e-3; the gradients each Adam's first moment holds within
    5e-4 + 1e-3·|g|; policy parameters within 1e-5; belief parameters within
    1e-5 where |g| > 2e-3 and within 2·lr + 1e-4 elsewhere (Adam's first
    step, lr·g/(|g| + 1e-8), takes either sign on a gradient near rounding).
    Returns the phase's fields."""
    import torch

    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    cfg = cfg or tiny_config()
    ref_tr, got_tr = SaviTrainer(cfg, device="cpu"), SaviTrainer(cfg, device=dev)
    ref_tr._setup()
    got_tr._setup()
    _, batch = ref_tr.collect(n=n)
    gen = torch.Generator().manual_seed(11)
    b = batch.actions.shape[1]
    perms = [torch.randperm(b, generator=gen) for _ in range(ref_tr.ppo_cfg.ppo_epoch)]
    ref = ref_tr.update(batch, perms=perms)
    before = smt_cuda.smt_encode.launches
    got = got_tr.update(batch.to(dev), perms=perms)
    launches = smt_cuda.smt_encode.launches - before
    loss_err = {k: abs(got[k].item() - ref[k].item()) for k in ref}
    bp_lr = cfg.RL.PPO.BELIEF_PREDICTOR.lr

    def trained(tr):
        return {"policy": (tr.policy, tr.optimizer.adam), "belief": (tr.belief_net, tr.belief_optimizer)}

    errs = {}
    for part, (module, adam) in trained(ref_tr).items():
        got_module, got_adam = trained(got_tr)[part]
        g_ref, g_got = adam_gradients(module, adam), adam_gradients(got_module, got_adam)
        got_params = dict(got_module.named_parameters())
        e = dict(grad_share_of_tol=0.0, param_share_of_tol=0.0, param_max_abs_err=0.0)
        settled = entries = 0
        for name, p in module.named_parameters():
            g = g_ref[name]
            e["grad_share_of_tol"] = max(e["grad_share_of_tol"],
                                         share_of_tol(g_got[name], g, GRAD_ATOL + GRAD_RTOL * g.abs()))
            tol = torch.full_like(p, POLICY_PARAM_TOL)
            if part == "belief":
                firm = g.abs() > SETTLED_GRAD
                tol = torch.where(firm, SETTLED_PARAM_TOL, 2 * bp_lr + 1e-4)
                settled += int(firm.sum())
                entries += p.numel()
                if firm.any():
                    e["param_max_abs_err_settled"] = max(e.get("param_max_abs_err_settled", 0.0),
                                                         share_of_tol(got_params[name][firm], p[firm], 1.0))
            e["param_share_of_tol"] = max(e["param_share_of_tol"], share_of_tol(got_params[name], p, tol))
            e["param_max_abs_err"] = max(e["param_max_abs_err"], share_of_tol(got_params[name], p, 1.0))
        if part == "belief":
            e["settled_share"] = settled / entries
        errs[part] = e
    fields = dict(optimizer_steps=got_tr.optimizer.count, smt_launches=launches,
                  losses={k: [ref[k].item(), got[k].item()] for k in ref}, loss_err=loss_err, loss_tol=1e-3,
                  errors=errs)
    emit("update_reference", **fields)
    if not all(math.isfinite(v) and v <= 1e-3 for v in loss_err.values()):
        raise AssertionError(f"update_reference: CUDA vs CPU losses differ {loss_err}")
    bad = {k: v for k, v in errs.items()
           if not (v["grad_share_of_tol"] <= 1 and v["param_share_of_tol"] <= 1)}
    if bad:
        raise AssertionError(f"update_reference: CUDA vs CPU gradients or parameters differ {bad}")
    if launches < 1:
        raise AssertionError("update_reference: the SMT kernel did not run in the update")
    return fields


def _kernel_wrappers():
    from avlen_tpu_torch.ops import KERNELS

    return {name: getattr(module, name) for name, module in KERNELS.items()}


def run_main_path(dev):
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    wrappers = _kernel_wrappers()
    cfg = get_config(SAVI_YAML)
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    trainer = SaviTrainer(cfg, device=dev)
    trainer._setup()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    _, batch = trainer.collect()
    torch.cuda.synchronize()
    rollout_s = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}

    t_steps, b = batch.actions.shape
    if (t_steps, b) != (cfg.RL.PPO.num_steps, cfg.NUM_PROCESSES):
        raise AssertionError(f"rollout shape {(t_steps, b)}")
    finite = {k: bool(torch.isfinite(getattr(batch, k).float()).all())
              for k in ("rewards", "values", "log_probs", "bootstrap_value")}
    finite["features"] = bool(torch.isfinite(batch.obs["__feature"]).all())
    finite["beliefs"] = bool(torch.isfinite(batch.obs["category_belief"]).all()
                             and torch.isfinite(batch.obs["location_belief"]).all())
    dones = batch.dones
    episodes = int(dones.sum())
    success = float(batch.metrics["success"][dones].mean()) if episodes else None
    spl = float(batch.metrics["spl"][dones].mean()) if episodes else None
    env = trainer.env
    emit(
        "rollout", config=SAVI_YAML, num_envs=b, num_steps=t_steps,
        memory_size=trainer.memory_size, d_model=cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size,
        nhead=cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead, rir_length=env.bank.rir.length,
        fft_len=env.bank.rir.fft_len, spectrogram_bank=env.bank.spec_bank is not None,
        max_nodes=env.bank.max_nodes, setup_s=setup_s, rollout_s=rollout_s,
        env_steps_per_s=t_steps * b / rollout_s, launches=launches, finite=finite,
        episodes=episodes, success=success, spl=spl,
        peak_mem_gb=torch.cuda.max_memory_allocated(dev) / 2**30,
    )
    if not all(finite.values()):
        raise AssertionError(f"non-finite rollout outputs: {finite}")
    need = t_steps + 1  # one per env step (+ reset) and one per act (+ bootstrap)
    short = {k: n for k, n in launches.items() if n < need}
    if short:
        raise AssertionError(f"kernels launched fewer than {need} times on the main path: {short}")
    return trainer, launches


class StreamTimer:
    """CUDA events on the current stream around each call of a function,
    summed after a synchronise: the stream time of that part of a run."""

    def __init__(self):
        self.pairs = []

    def wrap(self, fn):
        import torch

        def timed(*args, **kwargs):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = fn(*args, **kwargs)
            end.record()
            self.pairs.append((start, end))
            return out

        return timed

    def take_ms(self) -> float:
        """Summed ms of the calls since the last take (synchronises)."""
        import torch

        torch.cuda.synchronize()
        ms = sum(a.elapsed_time(b) for a, b in self.pairs)
        self.pairs = []
        return ms


def run_update(trainer, dev, smi: str):
    """UPDATE_ROUNDS rounds of collect + update on savi.yaml's trainer,
    every kernel's launches counted from zero over the rounds."""
    import torch

    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.rollout_smt import ring_eval_chunk

    wrappers = _kernel_wrappers()
    cfg = trainer.config
    ppo_cfg = trainer.ppo_cfg
    t_steps, b = trainer.num_steps, trainer.env.num_envs
    chunk = ring_eval_chunk(cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, t_steps)
    num_mb = min(ppo_cfg.num_mini_batch, b)
    eval_rows = chunk * (b // num_mb)
    want_launches = ppo_cfg.ppo_epoch * num_mb * (t_steps // chunk)

    towers = ("net.visual_encoder.", "net.goal_encoder.", "net.action_encoder.")
    start = {n: p.detach().clone() for n, p in trainer.policy.named_parameters()}
    fwd, bwd, belief = StreamTimer(), StreamTimer(), StreamTimer()
    rows = []

    def counted(launch):
        def run(entries, *args):
            rows.append(entries.shape[0])
            return launch(entries, *args)

        return fwd.wrap(run)

    trainer.belief_train_step = belief.wrap(trainer.belief_train_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats(dev)
    for fn in wrappers.values():
        fn.launches = 0
    rounds = []
    try:
        with smt_cuda.wrapped_passes(counted, bwd.wrap):
            for _ in range(UPDATE_ROUNDS):
                t0 = time.perf_counter()
                _, batch = trainer.collect()
                torch.cuda.synchronize()
                rollout_s = time.perf_counter() - t0
                fwd.take_ms()
                bwd.take_ms()
                rows.clear()
                before = smt_cuda.smt_encode.launches
                t0 = time.perf_counter()
                stats = trainer.update(batch)
                torch.cuda.synchronize()
                update_s = time.perf_counter() - t0
                stats = {k: v.item() for k, v in stats.items()}
                fwd_ms, bwd_ms, belief_ms = fwd.take_ms(), bwd.take_ms(), belief.take_ms()
                n = smt_cuda.smt_encode.launches - before
                rounds.append(dict(
                    rollout_s=rollout_s, update_ms=update_s * 1e3,
                    split_ms=dict(smt_kernel_forward=fwd_ms, smt_plain_recompute_and_backward=bwd_ms,
                                  belief_step=belief_ms, rest=update_s * 1e3 - fwd_ms - bwd_ms - belief_ms),
                    smt_launches=n, eval_rows=eval_rows, smt_launches_at_eval_rows=rows.count(eval_rows),
                    smt_forward_ms_per_call=fwd_ms / max(n, 1),
                    train_env_steps_per_s=t_steps * b / (rollout_s + update_s), stats=stats))
    finally:
        del trainer.belief_train_step
    launches = {k: fn.launches for k, fn in wrappers.items()}
    peak_gb = torch.cuda.max_memory_allocated(dev) / 2**30
    moved = sorted({n.split(".")[1] for n, p in trainer.policy.named_parameters() if not torch.equal(p, start[n])})
    towers_moved = [n for n, p in trainer.policy.named_parameters()
                    if n.startswith(towers) and not torch.equal(p, start[n])]
    emit("update", nvidia_smi=smi, config=SAVI_YAML, rounds=rounds, num_envs=b, num_steps=t_steps, ppo_epoch=ppo_cfg.ppo_epoch,
         num_mini_batch=num_mb, chunk=chunk, eval_rows=eval_rows, want_smt_launches_per_update=want_launches,
         launches=launches, peak_mem_gb=peak_gb, moved=moved, towers_moved=towers_moved,
         optimizer_steps=trainer.optimizer.count)
    for r in rounds:
        if not all(math.isfinite(v) for v in r["stats"].values()):
            raise AssertionError(f"update: non-finite stats {r['stats']}")
        if r["smt_launches_at_eval_rows"] < max(80, want_launches):
            raise AssertionError(f"update: {r['smt_launches_at_eval_rows']} SMT launches at {eval_rows} rows, "
                                 f"want at least {max(80, want_launches)}")
    if "smt" not in moved or "Dense_0" not in moved:
        raise AssertionError(f"update: the SMT and heads did not both move ({moved})")
    if towers_moved:
        raise AssertionError(f"update: frozen tower parameters moved: {towers_moved[:5]}")
    if not all(launches.values()):
        raise AssertionError(f"update: a kernel of the training path never launched: {launches}")
    return launches, rounds


def _max_tree_diff(got, want) -> float:
    """Max abs difference over two nested dicts of arrays of the same paths
    (a list is the map of its indices, as a checkpoint stores it; strings
    differ infinitely or not at all)."""
    import numpy as np

    got, want = (({str(i): v for i, v in enumerate(x)} if isinstance(x, (list, tuple)) else x) for x in (got, want))
    if isinstance(want, str):
        return 0.0 if got == want else math.inf
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"paths differ: {sorted(set(got) ^ set(want))[:5]}")
        return max([_max_tree_diff(got[k], want[k]) for k in want], default=0.0)
    got, want = np.asarray(got), np.asarray(want)
    if got.shape != want.shape:
        raise AssertionError(f"shapes differ: {got.shape} vs {want.shape}")
    return float(np.abs(got.astype(np.float64) - want.astype(np.float64)).max(initial=0.0))


def state_differences(trainer, ckpt):
    """Max abs difference of each part of the trainer's checkpoint payload
    (its parameters and optimizer states, SAVi's or AVLEN's) to ``ckpt``."""
    live = trainer._checkpoint_payload()
    return {k: _max_tree_diff(live[k], ckpt[k]) for k in live if k not in ("config", "extra_state")}


def run_train_loop(smi: str, root: str = TRAIN_DIR):
    """Stage 1 → stage 2 (from stage 1's checkpoint) → resume, through the
    CLI's ``main`` on the card, every kernel's launches counted over them."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    stage1, stage2 = os.path.join(root, "stage1"), os.path.join(root, "stage2")
    stage1_ckpt = os.path.join(stage1, "data", "ckpt.0.pth")
    rows = collections.Counter()

    def counted(launch):
        def run_rows(entries, *args):
            rows[entries.shape[0]] += 1
            return launch(entries, *args)

        return run_rows

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with smt_cuda.wrapped_passes(counted, lambda backward: backward):
        t0 = time.perf_counter()
        tr = run.main(["--run-type", "train", "--exp-config", STAGE1_YAML, "--model-dir", stage1,
                       "NUM_UPDATES", "1", "CHECKPOINT_INTERVAL", "1"])
        stage1_s = time.perf_counter() - t0
        if not os.path.isfile(stage1_ckpt):
            raise AssertionError(f"train_loop: stage 1 wrote no {stage1_ckpt}")
        stage1_fields = dict(seconds=stage1_s, setup_s=tr.setup_seconds, memory_size=tr.memory_size,
                             pretraining=bool(tr.config.RL.PPO.SCENE_MEMORY_TRANSFORMER.pretraining))
        del tr

        transfer = ["RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path", stage1_ckpt]
        t0 = time.perf_counter()
        tr = run.main(["--run-type", "train", "--exp-config", SAVI_YAML, "--model-dir", stage2, *transfer,
                       "NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1"])
        stage2_s = time.perf_counter() - t0
        totals = dict(tr.timings.totals)
        ckpt1 = os.path.join(stage2, "data", "ckpt.1.pth")
        t0 = time.perf_counter()
        saved = load_checkpoint(ckpt1)
        load_ms = (time.perf_counter() - t0) * 1e3
        updates = tr.num_updates_done
        stage2_fields = dict(
            seconds=stage2_s, setup_s=tr.setup_seconds, tensors_copied=tr.pretrained_counts[0],
            tensors_kept_fresh=tr.pretrained_counts[1], updates=updates, num_steps_done=tr.num_steps_done,
            loop_s=tr.train_seconds, loop_env_steps_per_s=tr.num_steps_done / tr.train_seconds,
            ms_per_update=totals["superstep_time"] * 1e3 / updates,
            collect_ms_per_update=totals["collect_time"] * 1e3 / updates,
            update_ms_per_update=totals["update_time"] * 1e3 / updates,
            checkpoint_bytes=os.path.getsize(ckpt1), checkpoint_save_ms=totals["checkpoint_time"] * 1e3 / updates,
            checkpoint_load_ms=load_ms, memory_size=tr.memory_size)
        want_steps = 2 * tr.num_steps * tr.env.num_envs
        del tr

        # resume: before its first update the trainer must hold ckpt.1 exactly
        checked = {}
        collect = SaviTrainer.collect

        def first_collect(self, *args, **kwargs):
            if not checked:
                checked.update(state_differences(self, saved))
                checked["num_steps_done"] = self.num_steps_done
            return collect(self, *args, **kwargs)

        SaviTrainer.collect = first_collect
        try:
            t0 = time.perf_counter()
            tr = run.main(["--run-type", "train", "--exp-config", SAVI_YAML, "--model-dir", stage2, *transfer,
                           "NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True"])
            resume_s = time.perf_counter() - t0
        finally:
            SaviTrainer.collect = collect
        resume_fields = dict(seconds=resume_s, restored_max_abs_diff=checked,
                             ckpt2_written=os.path.isfile(os.path.join(stage2, "data", "ckpt.2.pth")),
                             num_steps_done=tr.num_steps_done)
        del tr
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    emit("train_loop", nvidia_smi=smi, stage1=stage1_fields, stage2=stage2_fields, resume=resume_fields,
         launches=launches, smt_rows=dict(rows))
    if stage2_fields["tensors_copied"] < 1:
        raise AssertionError("train_loop: stage 2 copied no tensor of stage 1's checkpoint")
    if not checked or any(v != 0 for k, v in checked.items() if k != "num_steps_done"):
        raise AssertionError(f"train_loop: resume did not restore ckpt.1 exactly: {checked}")
    if checked["num_steps_done"] != want_steps:
        raise AssertionError(f"train_loop: resume restored {checked['num_steps_done']} steps, want {want_steps}")
    if not resume_fields["ckpt2_written"]:
        raise AssertionError("train_loop: the resumed run wrote no ckpt.2")
    if not all(launches.values()):
        raise AssertionError(f"train_loop: a kernel never launched: {launches}")
    if rows[120] < 80 * 4:  # four updates (1 + 2 + 1), 80 encodes of 120 rows each
        raise AssertionError(f"train_loop: {rows[120]} SMT launches at 120 rows, want at least 320")
    return launches, stage2


def run_eval(smi: str, model_dir: str):
    """``--run-type eval`` of the last checkpoint in ``model_dir``, at the
    shipped VIDEO_OPTION (disk + tensorboard): the episode videos it wrote
    (``video_report``)."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.utils.tb import read_scalars

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with eval_videos_recorded() as rec:
        t0 = time.perf_counter()
        tr = run.main(["--run-type", "eval", "--exp-config", SAVI_YAML, "--model-dir", model_dir,
                       "USE_LAST_CKPT", "True", "EVAL.SPLIT", "train", "TEST_EPISODE_COUNT", str(EVAL_EPISODES)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ids = tr._last_eval_episode_ids
    scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(model_dir, "tb")).items() if k.startswith("val/")}
    fields = dict(nvidia_smi=smi, seconds=seconds, setup_s=tr.setup_seconds, num_envs=tr.env.num_envs,
                  episodes=len(ids), distinct_ids=len(set(ids)), episodes_evaluated=scalars.get("val/episodes_evaluated"),
                  success=scalars.get("val/success"), spl=scalars.get("val/spl"), launches=launches,
                  videos=video_report(tr.config, rec))
    del tr
    torch.cuda.empty_cache()
    emit("eval", **fields)
    check_videos("eval", fields["videos"])
    if fields["episodes"] != EVAL_EPISODES or fields["distinct_ids"] != EVAL_EPISODES:
        raise AssertionError(f"eval: {fields['episodes']} episodes ({fields['distinct_ids']} ids), want {EVAL_EPISODES}")
    if fields["episodes_evaluated"] != EVAL_EPISODES:
        raise AssertionError(f"eval: the event file says {fields['episodes_evaluated']} episodes")
    if not all(math.isfinite(fields[k]) for k in ("success", "spl")):
        raise AssertionError(f"eval: success/spl not finite: {fields}")
    if not all(launches.values()):
        raise AssertionError(f"eval: a kernel never launched: {launches}")
    return launches


@contextlib.contextmanager
def eval_videos_recorded():
    """Within the block, every eval's video hook (``BaseRLTrainer.
    eval_videos``) is timed on the host clock, its copies to the host
    included, and every ``generate_eval_videos`` call counted: the rollouts
    it saw, those that ended an episode and the videos it made."""
    import numpy as np

    from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer

    rec = dict(seconds=0.0, rollouts=0, rollouts_with_dones=0, made=0)
    hook_of, generate = BaseRLTrainer.eval_videos, BaseRLTrainer.generate_eval_videos

    def eval_videos(self, *args, **kwargs):
        hook = hook_of(self, *args, **kwargs)
        if hook is None:
            return None

        def timed(*a):
            t0 = time.perf_counter()
            hook(*a)
            rec["seconds"] += time.perf_counter() - t0

        return timed

    def counted(self, dones, *args, **kwargs):
        made = generate(self, dones, *args, **kwargs)
        rec["rollouts"] += 1
        rec["rollouts_with_dones"] += bool(np.asarray(dones).any())
        rec["made"] += made
        return made

    BaseRLTrainer.eval_videos, BaseRLTrainer.generate_eval_videos = eval_videos, counted
    try:
        yield rec
    finally:
        BaseRLTrainer.eval_videos, BaseRLTrainer.generate_eval_videos = hook_of, generate


def video_events(log_dir: str) -> int:
    """Video (image) summaries in the event files directly in ``log_dir``."""
    from avlen_tpu_torch.utils import tb

    n = 0
    for name in sorted(os.listdir(log_dir)) if os.path.isdir(log_dir) else []:
        if "tfevents" not in name:
            continue
        for payload in tb.read_records(os.path.join(log_dir, name)):
            for number, _, summary in tb._fields(payload):
                if number == 5:
                    n += sum(1 for v_num, _, value in tb._fields(summary) if v_num == 1
                             for f, _, _ in tb._fields(value) if f == 4)
    return n


def video_report(config, rec: dict) -> dict:
    """The videos an eval wrote under ``config.VIDEO_DIR`` (names, bytes,
    the writer: the port's GIF writer for .gif, imageio for .mp4), the
    video events in its TENSORBOARD_DIR and the host seconds of the hook."""
    vdir = config.VIDEO_DIR
    names = sorted(os.listdir(vdir)) if os.path.isdir(vdir) else []
    videos = []
    for n in names:
        with open(os.path.join(vdir, n), "rb") as f:
            head = f.read(6)
        videos.append(dict(name=n, bytes=os.path.getsize(os.path.join(vdir, n)),
                           writer="gif" if n.endswith(".gif") else "imageio", gif89a=head == b"GIF89a"))
    return dict(video_option=list(config.VIDEO_OPTION), videos=videos, tb_video_events=video_events(
        config.TENSORBOARD_DIR), host_s=rec["seconds"], rollouts_seen=rec["rollouts"],
        rollouts_with_dones=rec["rollouts_with_dones"], made=rec["made"])


def check_videos(phase: str, rep: dict) -> None:
    """An eval whose video rule saw a rollout end an episode must have
    written videos, one file and one event each, GIFs whole."""
    if rep["rollouts_with_dones"] and not rep["made"]:
        raise AssertionError(f"{phase}: rollouts ended episodes but no video was written: {rep}")
    if len(rep["videos"]) != rep["made"] or rep["tb_video_events"] != rep["made"]:
        raise AssertionError(f"{phase}: {rep['made']} videos made, {len(rep['videos'])} files, "
                             f"{rep['tb_video_events']} events")
    if not all(v["gif89a"] for v in rep["videos"] if v["writer"] == "gif"):
        raise AssertionError(f"{phase}: a GIF without its header: {rep['videos']}")


SPEAKER_DIR = "build/chip_smoke_speaker"  # speaker.pth of the speaker_train phase
# train_speaker's CLI default is 2,000 steps; its widths (hidden 256, batch
# 64, 2 grid scenes of side 8, vocabulary 79) are kept, only the steps cut
SPEAKER_STEPS = 300
SPEAKER_BLEU_PATHS = 256
# teacher-forced logits of one set of weights on the card and on the CPU (f32,
# TF32 off; 39 decoder steps at hidden 256, logits O(10)); the pano features
# through GN ResNet-18 (cuDNN f32 against the CPU's convolutions)
SPEAKER_LOGITS_TOL, PANO_FEATURES_TOL = 1e-3, 1e-4


def check_speaker_devices(ckpt: str, dev, tables, n: int = 64) -> dict:
    """One ``speaker.pth`` served on the card and on the CPU: teacher-forced
    logits on a fixed batch of ``n`` pairs (max abs difference), greedy and
    beam-4 word ids (equal), and the card's time to decode a bank build's
    batch of 512 paths greedily."""
    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.dialog.instruction_bank import SPEAKER_BATCH
    from avlen_tpu_torch.dialog.instruction_source import speaker_from_config
    from avlen_tpu_torch.dialog.speaker.train_speaker import build_dataset

    cfg = get_config(INTERACTIVE_STAGE1, opts=["SPEAKER.CKPT_PATH", ckpt])
    card = speaker_from_config(cfg, tables, device=dev)
    cpu = speaker_from_config(cfg, tables, device="cpu")
    acts, feats, lens, words = build_dataset(tables, card.vocab, max(n, SPEAKER_BATCH), seed=7)
    batch = (acts[:n], feats[:n], lens[:n])
    with torch.no_grad():
        got = card.model.teacher_logits(*(torch.as_tensor(x).to(dev) for x in batch),
                                        torch.as_tensor(words[:n, :-1]).to(dev)).cpu()
        want = cpu.model.teacher_logits(*(torch.as_tensor(x) for x in batch), torch.as_tensor(words[:n, :-1]))
    out = dict(logits_max_abs_err=float((got - want).abs().max()), logits_peak=float(want.abs().max()),
               logits_tol=SPEAKER_LOGITS_TOL)
    for name, beam in (("greedy", 1), ("beam4", 4)):
        card.beam_size = cpu.beam_size = beam
        ids_card, ids_cpu = card.decode(*batch), cpu.decode(*batch)
        out[f"{name}_equal"] = bool(np.array_equal(ids_card, ids_cpu))
        out[f"{name}_tokens_differing"] = int((ids_card != ids_cpu).sum())
    card.beam_size = 1
    big = (acts[:SPEAKER_BATCH], feats[:SPEAKER_BATCH], lens[:SPEAKER_BATCH])
    card.decode(*big)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        card.decode(*big)
    out["decode_ms_per_512"] = (time.perf_counter() - t0) / 3 * 1e3
    return out


def run_speaker_train(dev, smi: str, root: str = SPEAKER_DIR) -> str:
    """Recipe stage 4: ``train_speaker.main`` on the card at its CLI's widths
    (hidden 256, batch 64, 2 grid scenes of side 8, vocabulary 79) for
    SPEAKER_STEPS steps, writing ``speaker.pth`` under ``root``: ms a step
    (the first apart), the final loss and token accuracy, the checkpoint's
    bytes; BLEU-4 of the card's greedy decodes against the template channel
    on SPEAKER_BLEU_PATHS freshly drawn shortest paths
    (``evaluate_neural_vs_template``, seed 1); the same weights on the card
    and on the CPU (``check_speaker_devices``); and the panorama encoder on
    a frame bank of 2 scenes x 16 nodes x 4 headings of 64 px, card against
    CPU with the same weights. Fails unless the loss is finite, the logits
    agree within SPEAKER_LOGITS_TOL, the greedy and beam-4 words are equal
    and the features agree within PANO_FEATURES_TOL. Returns the
    checkpoint's path."""
    import copy

    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.dialog.instruction_source import speaker_from_config
    from avlen_tpu_torch.dialog.speaker import train_speaker
    from avlen_tpu_torch.dialog.speaker.eval_speaker import evaluate_neural_vs_template
    from avlen_tpu_torch.dialog.speaker.pano_features import PanoramaEncoder, precompute_panorama_features
    from avlen_tpu_torch.dialog.speaker.speaker import Speaker
    from avlen_tpu_torch.sim.graph import build_scene_tables
    from avlen_tpu_torch.sim.synthetic import make_grid_scene

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    stats = train_speaker.main(["--output", root, "--steps", str(SPEAKER_STEPS)])
    seconds = time.perf_counter() - t0
    ckpt = stats["checkpoint"]
    rng = np.random.RandomState(0)  # the CLI's world
    tables = [build_scene_tables(make_grid_scene(rng, side=8)) for _ in range(2)]
    neural = speaker_from_config(get_config(INTERACTIVE_STAGE1, opts=["SPEAKER.CKPT_PATH", ckpt]), tables,
                                 device=dev)
    t0 = time.perf_counter()
    bleu = evaluate_neural_vs_template(neural, Speaker([t.positions for t in tables], backend="template"), tables,
                                       num_paths=SPEAKER_BLEU_PATHS, seed=1)
    bleu_s = time.perf_counter() - t0
    devices = check_speaker_devices(ckpt, dev, tables)

    encoder = PanoramaEncoder(3, generator=torch.Generator().manual_seed(0))
    frames = np.random.RandomState(1).randint(0, 256, (2, 16, 4, 64, 64, 3), np.uint8)
    t0 = time.perf_counter()
    on_card = precompute_panorama_features(frames, copy.deepcopy(encoder), batch=64, device=dev)
    pano_s = time.perf_counter() - t0
    on_cpu = precompute_panorama_features(frames, encoder, batch=64, device="cpu")
    pano_err = float(np.abs(on_card - on_cpu).max())

    steps = stats["steps"]
    fields = dict(
        nvidia_smi=smi, cli_steps_default=2000, steps=steps, batch=stats["batch"], hidden=neural.model.hidden_size,
        vocab=len(neural.vocab), num_pairs=stats["num_pairs"], seconds=seconds,
        first_step_ms=stats["first_step_seconds"] * 1e3,
        ms_per_step=(stats["loop_seconds"] - stats["first_step_seconds"]) / max(steps - 1, 1) * 1e3,
        loss=stats["loss"], token_acc=stats["acc"], checkpoint=os.path.relpath(ckpt),
        checkpoint_bytes=stats["checkpoint_bytes"], bleu=bleu, bleu_s=bleu_s, card_vs_cpu=devices,
        pano=dict(frames=list(frames.shape), card_s=pano_s, max_abs_err=pano_err,
                  peak=float(np.abs(on_cpu).max()), tol=PANO_FEATURES_TOL))
    emit("speaker_train", **fields)
    if not (math.isfinite(fields["loss"]) and 0 <= fields["token_acc"] <= 1 and os.path.isfile(ckpt)):
        raise AssertionError(f"speaker_train: loss {fields['loss']}, acc {fields['token_acc']}, {ckpt}")
    if not devices["logits_max_abs_err"] <= SPEAKER_LOGITS_TOL or not (devices["greedy_equal"]
                                                                      and devices["beam4_equal"]):
        raise AssertionError(f"speaker_train: card and CPU differ: {devices}")
    if not pano_err <= PANO_FEATURES_TOL:
        raise AssertionError(f"speaker_train: pano features differ by {pano_err}")
    return ckpt

INTERACTIVE_STAGE1 = "configs/semantic_audionav/savi/savi_interactive_1st_stage.yaml"
INTERACTIVE_STAGE2 = "configs/semantic_audionav/savi/savi_interactive_2nd_stage.yaml"
PRETRAIN_DIR = "build/chip_smoke_pretrain"  # label_predictor.pth of the belief_pretrain phase
PRETRAIN_STEPS, PRETRAIN_BATCH = 20, 64
INTERACTIVE_REF_STEPS, INTERACTIVE_REF_MIN_AGREEING = 16, 8
# the logits are 0.01-gain projections (|logit| ~1e-2 on the tiny world; the
# H100 read 1.0e-7), the values and SMT states O(1) (SAVi's values: 1.7e-6)
INTERACTIVE_REF_LOGITS_TOL, INTERACTIVE_REF_STATE_TOL = 1e-5, 1e-4


@contextlib.contextmanager
def launch_shapes():
    """Within the block, the inputs' shapes of every kernel launch: Counters
    keyed by (B, L, F) entries for ``smt_encode``, (leading dims..., fft_len)
    for ``partial_irfft`` and (B, 2, T) audio for ``spectrogram``. The
    wrappers' launch counts are untouched."""
    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

    shapes = {k: collections.Counter() for k in ("smt_encode", "partial_irfft", "spectrogram")}
    irfft_launch, spec_launch = irfft_cuda._launch, spectrogram_cuda._launch

    def irfft(spec, fft_len, out_start, out_len):
        shapes["partial_irfft"][tuple(spec.shape[:-1]) + (fft_len,)] += 1
        return irfft_launch(spec, fft_len, out_start, out_len)

    def spectro(audio, config):
        shapes["spectrogram"][tuple(audio.shape)] += 1
        return spec_launch(audio, config)

    def smt(launch):
        def run(entries, *args):
            shapes["smt_encode"][tuple(entries.shape)] += 1
            return launch(entries, *args)

        return run

    irfft_cuda._launch, spectrogram_cuda._launch = irfft, spectro
    try:
        with smt_cuda.wrapped_passes(smt, lambda backward: backward):
            yield shapes
    finally:
        irfft_cuda._launch, spectrogram_cuda._launch = irfft_launch, spec_launch


def _shape_counts(shapes):
    return {k: {"x".join(map(str, s)): n for s, n in c.items()} for k, c in shapes.items()}


def run_belief_pretrain(dev, smi: str, root: str = PRETRAIN_DIR):
    """Stage 0 through its CLI's ``main`` in this process: 20 steps at batch
    64 on the CLI's world (2 scenes, side 8, 16 kHz, 2,000-tap RIRs: 32,768-
    point convolutions). Before the loop, one batch drawn as the sampler
    draws it: the irfft and spectrogram kernels against their plain versions
    on the same tensors (1e-5 x peak, 1e-4 abs), timed beside them (and the
    irfft beside ``torch.fft.irfft`` + slice) with their bounds, and
    ``sample_from_indices`` equal to that kernel path. Fails unless each kernel ran once a step at 64
    rows and 32,768 points, the losses are finite and the checkpoint reloads
    into the port's belief predictor. Returns (launches, checkpoint path)."""
    import numpy as np
    import torch

    from avlen_tpu_torch.models.belief_predictor import BeliefPredictorNet
    from avlen_tpu_torch.ops import irfft_cuda, spectrogram_cuda
    from avlen_tpu_torch.ops.audio import SpectrogramConfig, _product_spectrum
    from avlen_tpu_torch.pretraining import audiogoal_predictor as ag
    from avlen_tpu_torch.sim.synthetic import make_scene_bank
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint
    from avlen_tpu_torch.utils.flax_bridge import load_flax_params, to_flax_params

    b = PRETRAIN_BATCH
    bank, _ = make_scene_bank(np.random.RandomState(0), num_scenes=2, side=8, device=dev)
    sr = bank.sampling_rate
    gen = torch.Generator(device=dev).manual_seed(1)

    def draw(high):
        return torch.randint(0, high, (b,), generator=gen, device=dev)

    scene = draw(2)
    n = bank.tables["num_nodes"][scene].long()
    recv, src, rot, sound = draw(10**6) % n, draw(10**6) % n, draw(4), draw(bank.sounds_padded.shape[0])
    with torch.no_grad():
        rir = bank.rir.gather(scene, (4 - rot) % 4, recv, src)
        prod, taps, fft_len = _product_spectrum(bank.sounds_padded[sound], torch.zeros_like(scene), rir, sr,
                                                None, None, None)
        audio = irfft_cuda.partial_irfft(prod, fft_len, taps - 1, sr)
        audio_plain = irfft_cuda.partial_irfft_plain(prod, fft_len, taps - 1, sr)
        cfg = SpectrogramConfig(sampling_rate=sr)
        spec = spectrogram_cuda.spectrogram(audio, cfg)
        spec_plain = spectrogram_cuda.spectrogram_plain(audio, cfg)
        sampled, _, _ = ag.sample_from_indices(bank, scene, recv, src, rot, sound)
    torch.cuda.synchronize()
    irfft_tol = 1e-5 * max(audio_plain.abs().max().item(), 1.0)
    errs = dict(irfft=(audio - audio_plain).abs().max().item(), spectrogram=(spec - spec_plain).abs().max().item(),
                sample_from_indices_vs_kernels=(sampled - spec).abs().max().item())
    timing = dict(
        irfft=[time_ms(fn)[0] for fn in (
            lambda: irfft_cuda.partial_irfft(prod, fft_len, taps - 1, sr),
            lambda: irfft_cuda.partial_irfft_plain(prod, fft_len, taps - 1, sr),
            lambda: torch.fft.irfft(prod, n=fft_len, dim=-1)[..., taps - 1 : taps - 1 + sr])],
        spectrogram=[time_ms(fn)[0] for fn in (lambda: spectrogram_cuda.spectrogram(audio, cfg),
                                               lambda: spectrogram_cuda.spectrogram_plain(audio, cfg))])
    rows = prod.shape[0] * prod.shape[1]
    bounds = dict(irfft=bound(rows * 2.5 * fft_len * math.log2(fft_len), prod.numel() * 8 + audio.numel() * 4),
                  spectrogram=bound(*spectrogram_flops_bytes(audio, spec, cfg)))
    check = dict(rows=b, fft_len=fft_len, max_abs_err=errs, tol=dict(irfft=irfft_tol, spectrogram=1e-4),
                 ms={k: dict(zip(("kernel", "plain", "library"), v)) for k, v in timing.items()},
                 bound_ms={k: dict(ms=v[0], bound_by=v[1]) for k, v in bounds.items()})
    del bank

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    with launch_shapes() as shapes:
        out = ag.main(["--steps", str(PRETRAIN_STEPS), "--batch", str(b), "--output", root, "--device", "cuda"])
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ckpt = load_checkpoint(out["checkpoint"])
    net = BeliefPredictorNet().to(dev)
    load_flax_params(net, ckpt["state_dict"])
    with torch.no_grad():
        loc, logits = net(spec)
    steps, loop_s = out["steps"], out["loop_seconds"]
    hist = out["history"]
    fields = dict(
        nvidia_smi=smi, steps=steps, batch=b, kernel_check=check, loop_s=loop_s,
        first_step_s=out["first_step_seconds"], ms_per_step=loop_s / steps * 1e3,
        ms_per_step_after_first=(loop_s - out["first_step_seconds"]) / (steps - 1) * 1e3,
        examples_per_s=steps * b / loop_s, first=hist[0], last=hist[-1],
        checkpoint_bytes=os.path.getsize(out["checkpoint"]),
        reload_max_abs_diff=_max_tree_diff(to_flax_params(net), ckpt["state_dict"]),
        reloaded_outputs_finite=bool(torch.isfinite(loc).all() and torch.isfinite(logits).all()),
        launches=launches, shapes=_shape_counts(shapes))
    emit("belief_pretrain", **fields)
    if errs["irfft"] > irfft_tol or errs["spectrogram"] > 1e-4 or errs["sample_from_indices_vs_kernels"] != 0:
        raise AssertionError(f"belief_pretrain: the kernels disagree with their plain versions: {errs}")
    if not all(math.isfinite(v) for h in (hist[0], hist[-1]) for v in h.values()):
        raise AssertionError(f"belief_pretrain: non-finite losses {hist[0]} {hist[-1]}")
    want = {"partial_irfft": {(b, 2, fft_len): steps}, "spectrogram": {(b, 2, sr): steps}}
    for k, w in want.items():
        if launches[k] != steps or dict(shapes[k]) != w:
            raise AssertionError(f"belief_pretrain: {k} launched {dict(shapes[k])}, want {w}")
    if fft_len != 32768 or fields["reload_max_abs_diff"] != 0 or not fields["reloaded_outputs_finite"]:
        raise AssertionError(f"belief_pretrain: fft_len {fft_len}, reload {fields['reload_max_abs_diff']}, "
                             f"finite {fields['reloaded_outputs_finite']}")
    return launches, out["checkpoint"]


# every SMT encode of the AVLEN paths, (policy, B, memory, features, entry
# width): the acting step (6 envs), π_q's update re-evaluation (15 steps x 3
# envs a minibatch), π_l's replay CE (15 steps x 6 envs), dialog pretraining's
# step and update (8 envs, 3 steps) and the interactive eval's step (10 envs)
SMT_AVLEN_CASES = (("goal", 6, 150, 276, 288), ("option", 6, 150, 308, 320), ("dialog", 6, 3, 276, 288),
                   ("option_update", 45, 150, 308, 320), ("dialog_replay", 90, 3, 276, 288),
                   ("dialog_pretrain_step", 8, 3, 276, 288), ("dialog_pretrain_update", 24, 3, 276, 288),
                   ("goal_eval", 10, 150, 276, 288), ("option_eval", 10, 150, 308, 320),
                   ("dialog_eval", 10, 3, 276, 288))


def avlen_checked_shapes():
    """The launch shapes (as ``launch_shapes`` keys them) that the kernel
    checks hold against the plain versions on the AVLEN paths."""
    return {"smt_encode": {(b, m + 1, width) for _, b, m, _, width in SMT_AVLEN_CASES},
            "partial_irfft": {(b, 2, 65536) for b in AVLEN_AUDIO_ENVS.values()}
            | {(b, 2, n) for b, n, _, _ in REFERENCE_AUDIO.values()},
            "spectrogram": {(b, 2, 16000) for b in AVLEN_AUDIO_ENVS.values()}
            | {(b, 2, length) for b, _, _, length in REFERENCE_AUDIO.values()}}


def check_smt_interactive_shapes(dev, gen):
    """The SMT kernel against its plain version (1e-4 abs) at every AVLEN
    encode (SMT_AVLEN_CASES), each with pretraining off and on, with the
    kernel's and the plain version's times and the bound: the acting step's
    three at B = 6 (π_g (6,151,288), π_q (6,151,320): 308-d features with
    the pose at 272-276, π_l over the 3-step dialog memory (6,4,288)) and
    the same three at the eval's B = 10; π_q's update re-evaluation
    (45,151,320); π_l's replay CE (90,4,288); dialog pretraining's step
    (8,4,288) and update (24,4,288). At (45,151,320) also the gradient
    through ``_SMTEncode`` against plain autograd, entries, goal and
    weights, within 5e-4 + 1e-3·|g|: its backward is the plain recompute,
    so this holds the wiring (the saved inputs, the weight order), not the
    kernel's accuracy."""
    import torch

    from avlen_tpu_torch.models.smt import SMTStateEncoder
    from avlen_tpu_torch.ops import smt_cuda

    tol, d, nhead = 1e-4, 256, 8
    results = []
    for policy, b, m, feat, width in SMT_AVLEN_CASES:
        for pre in (False, True):
            enc = SMTStateEncoder(feat, d, nhead, pose_indices=(272, 276), pretraining=pre,
                                  generator=torch.Generator().manual_seed(7)).to(dev)
            x = torch.randn(b, feat, generator=gen, device=dev)
            mem = torch.randn(b, m, feat, generator=gen, device=dev)
            mask = (torch.rand(b, m, generator=gen, device=dev) > 0.3).float()
            goal = torch.randn(b, d, generator=gen, device=dev)
            with torch.no_grad():
                entries, valid = enc.entries(x, mem, mask)
                params = dict(enc.named_parameters())
                got = smt_cuda.smt_encode(params, entries, valid, goal, nhead)
                want = smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead)
                torch.cuda.synchronize()
                err = (got - want).abs().max().item()
                ms, how = time_ms(lambda: smt_cuda.smt_encode(params, entries, valid, goal, nhead))
                plain_ms, plain_how = time_ms(lambda: smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead))
            flops, nbytes = smt_flops_bytes(entries, valid, goal, params, d)
            bound_ms, bound_by = bound(3 * flops, nbytes, PEAK_TF32_FLOPS)
            fields = dict(kernel="smt_encode", case=f"interactive_{policy}" + ("_pretraining" if pre else ""),
                          shape=list(entries.shape), max_abs_err=err, tol=tol, ms=ms, plain_ms=plain_ms,
                          bound_ms=bound_ms, bound_by=bound_by, share_of_bound=bound_ms / ms,
                          rows_tile=smt_cuda.smt_plan(*entries.shape, d, nhead).rows_tile,
                          timing=dict(ms=how, plain_ms=plain_how))
            if policy == "option_update" and not pre:
                fields["grad_share_of_tol"] = _smt_grad_share(params, entries, valid, goal, nhead, gen)
            emit("smt_interactive_shapes", **fields)
            if tuple(entries.shape) != (b, m + 1, width):
                raise AssertionError(f"smt_interactive_shapes: entries {tuple(entries.shape)}, want {(b, m + 1, width)}")
            if not math.isfinite(err) or err > tol:
                raise AssertionError(f"smt_interactive_shapes {fields['case']}: max abs err {err} > {tol}")
            if not fields.get("grad_share_of_tol", 0.0) <= 1:
                raise AssertionError(f"smt_interactive_shapes {fields['case']}: gradients differ "
                                     f"({fields['grad_share_of_tol']} of the tolerance)")
            results.append({k: fields[k] for k in ("case", "shape", "max_abs_err", "ms", "plain_ms", "bound_ms",
                                                   "bound_by", "rows_tile") + (
                ("grad_share_of_tol",) if "grad_share_of_tol" in fields else ())})
    return results


def _smt_grad_share(params, entries, valid, goal, nhead, gen) -> float:
    """max |g_kernel - g_plain| / (5e-4 + 1e-3·|g_plain|) over the gradients
    of one random cotangent with respect to the entries, the goal and the
    weights: ``smt_encode`` (``_SMTEncode``) against plain autograd."""
    import torch

    from avlen_tpu_torch.ops import smt_cuda

    cot = torch.randn(entries.shape[0], goal.shape[1], generator=gen, device=entries.device)
    grads = []
    for fn in (smt_cuda.smt_encode, smt_cuda.smt_encode_plain):
        leaves = {k: v.detach().clone().requires_grad_(True) for k, v in params.items()}
        e, g = entries.detach().clone().requires_grad_(True), goal.detach().clone().requires_grad_(True)
        out = fn(leaves, e, valid, g, nhead)
        inputs = [e, g] + [leaves[k] for k in smt_cuda.KERNEL_WEIGHTS]
        grads.append(torch.autograd.grad(out, inputs, cot, allow_unused=True))
    share = 0.0
    for got, want in zip(*grads):
        if want is None:
            continue
        share = max(share, share_of_tol(got, want, GRAD_ATOL + GRAD_RTOL * want.abs()))
    return share


def _traj_summary(traj, seconds: float):
    """Rates, query statistics and finiteness of one interactive collect."""
    import torch

    t_steps, b = traj["actions"].shape
    queried, rl_mask = traj["queried"], traj["rl_mask"]
    dones = traj["dones"]
    episodes = int(dones.sum())
    finite = {k: bool(torch.isfinite(traj[k].float()).all())
              for k in ("values_option", "log_probs_option", "logits_vln", "rewards", "bootstrap_value",
                        "feat_goal", "feat_option", "feat_vln", "feat_vln_dialog", "dialog_clip")}
    return dict(
        seconds=seconds, env_steps_per_s=t_steps * b / seconds, steps=t_steps, envs=b,
        queries=int((queried & (rl_mask == 1)).sum()), dialog_steps=int(queried.sum()),
        rl_mask_share=float(rl_mask.mean()), episodes=episodes,
        success=float(traj["metrics"]["success"][dones].mean()) if episodes else None,
        finite=finite)


def run_interactive(dev, smi: str, goal_ckpt: str, belief_ckpt: str, speaker_ckpt: str):
    """AVLEN at full width: ``InteractiveDDPPOTrainer`` on
    savi_interactive_1st_stage.yaml (6 envs, memory 150 in SMT pretraining
    mode, d_model 256, CLIP width 512 with 12 layers, 16 kHz, 16,000-tap
    RIRs) with its shipped neural speaker (speaker_train's ``speaker.pth``
    at SPEAKER.CKPT_PATH), the train_loop phase's last SAVi checkpoint as
    π_g and belief_pretrain's checkpoint as the belief predictor, the
    oracle instructions banked (BANK_MODE bank: the world's ~89-node scenes
    are over MAX_BANK_NODES, where auto would call the host speaker; the
    bank is ~63k greedy decodes): setup and two collects of 150 steps. Then
    a fresh trainer on savi_interactive_2nd_stage.yaml (full memory
    history, BANK_MODE auto: the neural speaker on the host per query) for
    one collect. Every kernel's launches are
    counted from zero over each of the two runs, setup included. Fails
    unless π_g and the belief predictor hold their checkpoints exactly, the
    outputs are finite, and per step the SMT kernel ran once at each of
    (6,151,288), (6,151,320) and (6,4,288) (plus π_q's bootstrap value), and
    the irfft and spectrogram once. Returns the two runs' launches."""
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint
    from avlen_tpu_torch.utils.flax_bridge import to_flax_params

    common = ["SPEAKER.CKPT_PATH", speaker_ckpt, "GOAL_CKPT_PATH", goal_ckpt,
              "RL.PPO.BELIEF_PREDICTOR.pretrained_path", belief_ckpt]
    want_goal, want_belief = (load_checkpoint(p)["state_dict"] for p in (goal_ckpt, belief_ckpt))
    wrappers = _kernel_wrappers()
    runs, all_launches = {}, {}
    for stage, config, opts, collects in (("stage1", INTERACTIVE_STAGE1, ["SPEAKER.BANK_MODE", "bank"], 2),
                                          ("stage2", INTERACTIVE_STAGE2, ["RESUME_CHECKPOINT", "False"], 1)):
        cfg = get_config(config, opts=common + opts)
        for fn in wrappers.values():
            fn.launches = 0
        with launch_shapes() as shapes:
            t0 = time.perf_counter()
            tr = InteractiveDDPPOTrainer(cfg, device=dev)
            tr._setup()
            torch.cuda.synchronize()
            setup_s = time.perf_counter() - t0
            rollouts = []
            for _ in range(collects):
                clip0 = tr.clip_calls
                t0 = time.perf_counter()
                _, traj = tr.collect()
                torch.cuda.synchronize()
                rollouts.append(dict(_traj_summary(traj, time.perf_counter() - t0), clip_calls=tr.clip_calls - clip0))
        launches = {k: fn.launches for k, fn in wrappers.items()}
        smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
        b, t_steps, m, sr = tr.env.num_envs, tr.num_steps, tr.memory_size, tr.env.bank.sampling_rate
        source = tr.instr_source
        run = dict(
            config=config, num_envs=b, num_steps=t_steps, memory_size=tr.memory_size, d_model=smt_cfg.hidden_size,
            pretraining=bool(smt_cfg.pretraining), clip_width=cfg.RL.PPO.CLIP_WIDTH,
            clip_layers=cfg.RL.PPO.CLIP_LAYERS, rir_length=tr.env.bank.rir.length, fft_len=tr.env.bank.rir.fft_len,
            max_nodes=tr.env.bank.max_nodes, setup_s=tr.setup_seconds, setup_wall_s=setup_s,
            speaker=cfg.SPEAKER.BACKEND, speaker_served=None if source is None else source.speaker.backend,
            instructions="bank" if source is None else "host speaker", bank_build_s=tr.bank_seconds,
            bank_bytes=tr.bank_bytes, host_speaker_calls=getattr(source, "host_calls", None),
            loaded=sorted(tr.loaded), goal_max_abs_diff=_max_tree_diff(to_flax_params(tr.goal_policy), want_goal),
            belief_max_abs_diff=_max_tree_diff(to_flax_params(tr.belief_net), want_belief),
            collects=rollouts, launches=launches, shapes=_shape_counts(shapes))
        runs[stage] = run
        all_launches[stage] = launches
        del tr
        torch.cuda.empty_cache()
        steps = t_steps * collects
        want = {
            "smt_encode": {(b, length, f): steps + (collects if f == 320 else 0)  # + π_q's bootstrap value
                           for length, f in ((m + 1, 288), (m + 1, 320), (cfg.NUM_DIALOG_STEPS + 1, 288))},
            "partial_irfft": {(b, 2, run["fft_len"]): steps + 1},  # + the reset's first observation
            "spectrogram": {(b, 2, sr): steps + 1},
        }
        bad = {k: dict(shapes[k]) for k, w in want.items() if dict(shapes[k]) != w}
        if bad or any(launches[k] != sum(w.values()) for k, w in want.items()):
            emit("interactive", nvidia_smi=smi, runs=runs)
            raise AssertionError(f"interactive {stage}: kernel launches {bad or launches}, want {want}")
    emit("interactive", nvidia_smi=smi, runs=runs)
    for stage, run in runs.items():
        if run["loaded"] != ["belief", "goal"] or run["goal_max_abs_diff"] != 0 or run["belief_max_abs_diff"] != 0:
            raise AssertionError(f"interactive {stage}: checkpoints not held exactly: {run['loaded']} "
                                 f"{run['goal_max_abs_diff']} {run['belief_max_abs_diff']}")
        for r in run["collects"]:
            if not all(r["finite"].values()):
                raise AssertionError(f"interactive {stage}: non-finite outputs {r['finite']}")
    if runs["stage1"]["bank_bytes"] == 0 or runs["stage2"]["instructions"] != "host speaker":
        raise AssertionError("interactive: stage 1 must bank the instructions and stage 2 call the host speaker")
    if any(r["speaker"] != "neural" for r in runs.values()) or runs["stage2"]["speaker_served"] != "neural":
        raise AssertionError(f"interactive: the shipped neural speaker did not serve: {runs}")
    return all_launches


def interactive_tiny_opts():
    """savi_interactive_2nd_stage.yaml on a tiny world (3 envs, memory 8,
    d_model 32, 4 heads, CLIP width 64 with 2 layers, 8 kHz, 2,000-tap RIRs),
    π_l acting when queried, and the template speaker: these references
    hold the policies' arithmetic on the card against the CPU, so both runs
    must be served the same instruction tokens, which the template's are by
    construction; the neural speaker's own card-against-CPU agreement is
    the speaker_train phase's."""
    return ["TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4", "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
            "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", "2000", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "32",
            "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "8000",
            "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False", "NUM_PROCESSES", "3",
            "RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size", "8", "RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size", "32",
            "RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead", "4", "RL.PPO.CLIP_WIDTH", "64", "RL.PPO.CLIP_LAYERS", "2",
            "SPEAKER.BACKEND", "template", "RESUME_CHECKPOINT", "False", "GOAL_CKPT_PATH", "", "VLN_CKPT_PATH", ""]


@contextlib.contextmanager
def sampling_on_the_generators_device():
    """Within, the three policies draw their actions on the sampling
    generator's device (a CPU generator gives a CUDA run the CPU run's
    draws for the same probabilities) and return them on the logits'
    device. A hook of ``check_interactive_reference`` only; the policies'
    own sampler draws on the logits' device."""
    import torch

    from avlen_tpu_torch.models import dialog_policy, option_policy, smt_policy

    def sample(generator, logits):
        probs = torch.softmax(logits, dim=-1).to(generator.device)
        return torch.multinomial(probs, 1, generator=generator)[..., 0].to(logits.device)

    modules = (smt_policy, option_policy, dialog_policy)
    saved = [m.categorical_sample for m in modules]
    for m in modules:
        m.categorical_sample = sample
    try:
        yield
    finally:
        for m, fn in zip(modules, saved):
            m.categorical_sample = fn


def check_interactive_reference(dev, steps: int = INTERACTIVE_REF_STEPS,
                                min_agreeing: int = INTERACTIVE_REF_MIN_AGREEING):
    """The interactive collect on a tiny world, CUDA (kernels) against CPU
    (plain versions), with the same world and weights (both drawn on the
    CPU from the config seed) and the same sampling draws (one CPU generator
    seeded alike for each run): over the prefix of steps where the three
    policies' sampled actions agree, which must be at least
    ``min_agreeing``, the per-step logits of π_q, π_g and π_l within
    ``INTERACTIVE_REF_LOGITS_TOL``, their values and pre-head states (π_q's
    and π_g's memory entries, π_l's SMT state) within
    ``INTERACTIVE_REF_STATE_TOL`` × max(1, peak), the instruction tokens and
    query flags equal. Returns the phase's fields."""
    import dataclasses

    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer

    cfg = get_config(INTERACTIVE_STAGE2, opts=interactive_tiny_opts())
    runs = {}
    launches = 0
    # policy -> index of its logits and of its pre-head state in act()'s outputs
    outputs = {"option": (4, 3), "goal": (4, 3), "dialog": (5, 4)}
    for d in ("cpu", dev):
        tr = InteractiveDDPPOTrainer(cfg, device=d)
        tr._setup()
        rec = collections.defaultdict(list)
        make_fns = tr.make_fns

        def recording(deterministic=False, generator=None, consts=None, make_fns=make_fns, rec=rec):
            fns = make_fns(deterministic, generator, consts)

            def wrap(name, fn):
                logits_at, state_at = outputs[name]

                def run(*args):
                    out = fn(*args)
                    rec[name].append({"action": out[0].cpu(), "logits": out[logits_at].cpu(),
                                      "value": out[2].cpu(), "state": out[state_at].cpu()})
                    return out

                return run

            return dataclasses.replace(fns, act_option=wrap("option", fns.act_option),
                                       act_goal=wrap("goal", fns.act_goal),
                                       act_dialog=wrap("dialog", fns.act_dialog))

        tr.make_fns = recording
        before = smt_cuda.smt_encode.launches
        with sampling_on_the_generators_device():
            _, traj = tr.collect(n=steps, generator=torch.Generator(device="cpu").manual_seed(7))
        launches = smt_cuda.smt_encode.launches - before
        runs[str(d)] = rec, {k: v.cpu() for k, v in traj.items() if torch.is_tensor(v)}, tr.clip_calls
    (ref, ref_traj, ref_clip), (got, got_traj, got_clip) = runs["cpu"], runs[str(dev)]
    prefix = 0
    while prefix < steps and all(torch.equal(ref[k][prefix]["action"], got[k][prefix]["action"]) for k in ref):
        prefix += 1

    def max_err(key, relative=False):
        errs = {}
        for k in outputs:
            per_step = []
            for t in range(prefix):
                want = ref[k][t][key]
                scale = max(want.abs().max().item(), 1.0) if relative else 1.0
                per_step.append((got[k][t][key] - want).abs().max().item() / scale)
            errs[k] = max(per_step, default=None)
        return errs

    errs = {"logits": max_err("logits"), "values": max_err("value"), "states": max_err("state", relative=True)}
    tols = {"logits": INTERACTIVE_REF_LOGITS_TOL, "values": INTERACTIVE_REF_STATE_TOL,
            "states": INTERACTIVE_REF_STATE_TOL}
    same = {k: bool(torch.equal(ref_traj[k][:prefix], got_traj[k][:prefix]))
            for k in ("dialog", "queried", "rl_mask", "actions")}
    fields = dict(steps=steps, agreeing_steps=prefix, min_agreeing=min_agreeing,
                  logits_max_abs_err=errs["logits"], values_max_abs_err=errs["values"],
                  states_max_err_of_peak=errs["states"], tol=tols,
                  equal_over_prefix=same, queries=int((ref_traj["queried"] & (ref_traj["rl_mask"] == 1)).sum()),
                  clip_calls=[ref_clip, got_clip], smt_launches=launches)
    emit("interactive_reference", **fields)
    if prefix < min_agreeing:
        raise AssertionError(f"interactive_reference: sampled actions diverged after {prefix} steps")
    if any(e is None or not e <= tols[what] for what, by_policy in errs.items() for e in by_policy.values()):
        raise AssertionError(f"interactive_reference: CUDA vs CPU differ: {errs} (limits {tols})")
    if not all(same.values()):
        raise AssertionError(f"interactive_reference: CUDA vs CPU trajectories differ: {same}")
    if launches < 3 * steps:
        raise AssertionError(f"interactive_reference: {launches} SMT launches in {steps} steps")
    return fields


DIALOG_YAML = "configs/semantic_audionav/savi/savi_pretraining_dialog_training.yaml"
DIALOG_DIR = "build/chip_smoke_dialog"  # π_l's vln/ckpt of the dialog_pretrain phase
AVLEN_DIR = "build/chip_smoke_avlen"  # model dir of the interactive_train phase
DIALOG_UPDATES = 20
AVLEN_UPDATES = 2  # per stage
AVLEN_EVAL_EPISODES = 24


def run_dialog_pretrain(smi: str, root: str = DIALOG_DIR):
    """π_l pretraining through ``run.main`` at full width on
    savi_pretraining_dialog_training.yaml (8 envs, 3 steps an update, the
    dialog memory of 3, d_model 256, CLIP 512 x 12 layers, 16 kHz with
    16,000-tap RIRs: 65,536-point convolutions), DIALOG_UPDATES updates and
    one ``vln/ckpt``. Every kernel's launches and shapes are counted from
    zero over the run. Fails unless the CE is finite at the first and last
    update, the checkpoint holds π_l alone, and per update the SMT kernel
    ran 3 times at (8,4,288) (a step each) and once at (24,4,288) (the
    update's re-evaluation of the 3 steps), and the irfft and spectrogram
    3 times (plus the reset's first observation). Returns (launches, the
    checkpoint's path)."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.rl.rollout_smt import ring_eval_chunk
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with launch_shapes() as shapes:
        t0 = time.perf_counter()
        tr = run.main(["--run-type", "train", "--exp-config", DIALOG_YAML, "--model-dir", root,
                       "NUM_UPDATES_DIALOG", str(DIALOG_UPDATES), "CHECKPOINT_INTERVAL_DIALOG", str(DIALOG_UPDATES)])
        torch.cuda.synchronize()
        seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    cfg = tr.config
    ckpt = os.path.join(root, "data", "vln", "ckpt.0.pth")
    totals, n = dict(tr.timings.totals), tr.num_updates_done
    b, t_steps, m = tr.env.num_envs, tr.num_steps, cfg.NUM_DIALOG_STEPS
    fft_len, sr = tr.env.bank.rir.fft_len, tr.env.bank.sampling_rate
    losses = tr.dialog_losses
    keys = sorted(load_checkpoint(ckpt))
    fields = dict(
        nvidia_smi=smi, config=DIALOG_YAML, num_envs=b, num_steps=t_steps, dialog_memory=m,
        d_model=cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size, clip_width=cfg.RL.PPO.CLIP_WIDTH,
        clip_layers=cfg.RL.PPO.CLIP_LAYERS, fft_len=fft_len, updates=n, seconds=seconds, setup_s=tr.setup_seconds,
        loop_s=tr.train_seconds, ms_per_update=totals["superstep_time"] * 1e3 / n,
        collect_ms_per_update=totals["collect_time"] * 1e3 / n, update_ms_per_update=totals["update_time"] * 1e3 / n,
        env_steps_per_s=tr.num_steps_done / tr.train_seconds, dialog_loss_first=losses[0], dialog_loss_last=losses[-1],
        checkpoint=os.path.relpath(ckpt, root), checkpoint_bytes=os.path.getsize(ckpt), checkpoint_keys=keys,
        checkpoint_save_ms=totals["checkpoint_time"] * 1e3,
        instructions="bank" if tr.instr_source is None else "host speaker", clip_calls=tr.clip_calls,
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30, launches=launches, shapes=_shape_counts(shapes))
    del tr
    torch.cuda.empty_cache()
    emit("dialog_pretrain", **fields)
    chunk = ring_eval_chunk(cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, t_steps)
    want = {"smt_encode": {(b, m + 1, 288): n * t_steps, (chunk * b, m + 1, 288): n * (t_steps // chunk)},
            "partial_irfft": {(b, 2, fft_len): n * t_steps + 1}, "spectrogram": {(b, 2, sr): n * t_steps + 1}}
    bad = {k: dict(shapes[k]) for k, w in want.items() if dict(shapes[k]) != w}
    if bad or any(launches[k] != sum(w.values()) for k, w in want.items()):
        raise AssertionError(f"dialog_pretrain: kernel launches {bad or launches}, want {want}")
    if not all(math.isfinite(v) for v in losses) or len(losses) != DIALOG_UPDATES:
        raise AssertionError(f"dialog_pretrain: CE {losses}")
    if keys != ["config", "state_dict"]:
        raise AssertionError(f"dialog_pretrain: the vln checkpoint holds {keys}")
    return launches, ckpt


class ShapeTimers:
    """A ``StreamTimer`` per SMT entries shape: (launches, stream ms) of each
    shape since the last take."""

    def __init__(self):
        self.timers = collections.defaultdict(StreamTimer)

    def wrap(self, shape_of, fn):
        def timed(*args):
            return self.timers[shape_of(*args)].wrap(fn)(*args)

        return timed

    def take(self):
        out = {}
        for shape, t in self.timers.items():
            calls = len(t.pairs)
            out[shape] = (calls, t.take_ms())
        return {s: v for s, v in out.items() if v[0]}


def run_interactive_train(smi: str, goal_ckpt: str, belief_ckpt: str, vln_ckpt: str, speaker_ckpt: str,
                          root: str = AVLEN_DIR):
    """AVLEN training at full width through ``run.main``, under ``root``:
    stage 1 (savi_interactive_1st_stage.yaml, 6 envs, 150 steps, memory 150,
    the oracle instructions banked) from π_g of the train_loop phase, the
    belief predictor of belief_pretrain and π_l of dialog_pretrain, with
    AVLEN_UPDATES updates and a checkpoint each; stage 2 (2nd_stage.yaml:
    RESUME_CHECKPOINT, REPLAY_STORE, the host speaker) resumes stage 1's last
    checkpoint for AVLEN_UPDATES updates; then ``--run-type eval`` of the
    last checkpoint (AVLEN_EVAL_EPISODES episodes of the train split) and of
    dialog_pretrain's ``vln/ckpt`` (the dialog protocol). Per update, from
    CUDA events on the stream: the collect, π_q's update (the SMT kernel's
    forwards, their plain recompute + backward, the rest) and π_l's replay
    update (its own SMT forwards and backward), with training env-steps/s =
    T·B / (collect + update). Every kernel's launches and launch shapes over
    the phase are counted from zero. Fails unless stage 1 loaded all three
    checkpoints and held π_l exactly, stage 2 restored π_q, π_g, π_l and both Adam states
    exactly, each π_q update ran the SMT kernel ppo_epoch x minibatches x
    T/chunk = 40 times at (45,151,320), each stage-2 π_l update T/chunk = 10
    times at (90,4,288) and stage 1 none, the stats are finite, each eval
    counted its episodes once, and no episode asked more queries than
    HOW_MANY_QUERY, and every launch shape is one the kernel checks hold
    against the plain versions (``avlen_checked_shapes``). (The counts are
    worked out from the configs: 2 epochs x 2 minibatches x 150/15 chunks =
    40 and 150/15 = 10 here.) Returns the launches."""
    import numpy as np
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.rollout_smt import ring_eval_chunk
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer as Trainer
    from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
    from avlen_tpu_torch.utils.flax_bridge import to_flax_params
    from avlen_tpu_torch.utils.tb import read_scalars

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    data = os.path.join(root, "data")
    opts = ["SPEAKER.CKPT_PATH", speaker_ckpt, "GOAL_CKPT_PATH", goal_ckpt, "VLN_CKPT_PATH", vln_ckpt,
            "RL.PPO.BELIEF_PREDICTOR.pretrained_path", belief_ckpt]
    train_opts = opts + ["NUM_UPDATES", str(AVLEN_UPDATES), "CHECKPOINT_INTERVAL", "1"]
    want_vln = load_checkpoint(vln_ckpt)["state_dict"]

    collect_t, update_t, dialog_t = StreamTimer(), StreamTimer(), StreamTimer()
    fwd, bwd = ShapeTimers(), ShapeTimers()
    rounds, resume = [], {}
    orig = {k: getattr(Trainer, k) for k in ("collect", "update", "update_dialog")}
    stage = [""]

    def collect(self, *args, **kwargs):
        if stage[0] == "stage2" and not resume:  # before the resumed run's first update
            resume.update(state_differences(self, load_checkpoint(list_checkpoints(data)[AVLEN_UPDATES - 1])))
            resume["num_steps_done"] = self.num_steps_done
        out = collect_t.wrap(orig["collect"])(self, *args, **kwargs)
        fwd.take()
        bwd.take()
        return out

    def update(self, traj, perms=None, **kw):
        t0 = time.perf_counter()
        stats = {k: v.item() for k, v in update_t.wrap(orig["update"])(self, traj, perms, **kw).items()}
        wall_ms = (time.perf_counter() - t0) * 1e3
        update_ms, dialog_ms, collect_ms = update_t.take_ms(), dialog_t.take_ms(), collect_t.take_ms()
        f, g = fwd.take(), bwd.take()
        t_steps, b = traj["actions"].shape
        chunk = ring_eval_chunk(self.config.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, t_steps)
        q_shape = (chunk * (b // min(self.ppo_cfg.num_mini_batch, b)), self.memory_size + 1,
                   self.option_policy.net.feature_size + 12)
        l_shape = (chunk * b, self.config.NUM_DIALOG_STEPS + 1, self.goal_policy.net.feature_size + 12)
        q_fwd, q_bwd = f.pop(q_shape, (0, 0.0)), g.pop(q_shape, (0, 0.0))
        l_fwd, l_bwd = f.pop(l_shape, (0, 0.0)), g.pop(l_shape, (0, 0.0))
        pi_q_ms = update_ms - dialog_ms
        chunks = t_steps // chunk
        rounds.append(dict(
            stage=stage[0], collect_ms=collect_ms, update_ms=update_ms, update_wall_ms=wall_ms,
            want_smt_launches=dict(pi_q=self.ppo_cfg.ppo_epoch * min(self.ppo_cfg.num_mini_batch, b) * chunks,
                                   pi_l=chunks if self.config.REPLAY_STORE else 0),
            pi_q=dict(ms=pi_q_ms, smt_shape=list(q_shape), smt_launches=q_fwd[0], smt_kernel_forward_ms=q_fwd[1],
                      smt_plain_recompute_and_backward_ms=q_bwd[1], rest_ms=pi_q_ms - q_fwd[1] - q_bwd[1]),
            pi_l=dict(ms=dialog_ms, smt_shape=list(l_shape), smt_launches=l_fwd[0], smt_kernel_forward_ms=l_fwd[1],
                      smt_plain_recompute_and_backward_ms=l_bwd[1], rest_ms=dialog_ms - l_fwd[1] - l_bwd[1]),
            other_smt_launches={"x".join(map(str, s)): c for s, (c, _) in f.items()},
            train_env_steps_per_s=t_steps * b / ((collect_ms + update_ms) / 1e3), stats=stats))
        return stats

    def update_dialog(self, traj, replay_only=False, **kw):
        return dialog_t.wrap(orig["update_dialog"])(self, traj, replay_only, **kw)

    with launch_shapes() as shapes:
        wrappers = _kernel_wrappers()
        for fn in wrappers.values():
            fn.launches = 0
        fields = dict(nvidia_smi=smi)
        try:
            for k, fn in (("collect", collect), ("update", update), ("update_dialog", update_dialog)):
                setattr(Trainer, k, fn)
            with smt_cuda.wrapped_passes(
                    lambda launch: fwd.wrap(lambda entries, *a: tuple(entries.shape), launch),
                    lambda backward: bwd.wrap(lambda ctx, grad: tuple(ctx.saved_tensors[0].shape), backward)):
                for name, config, extra in (("stage1", INTERACTIVE_STAGE1, ["SPEAKER.BANK_MODE", "bank"]),
                                            ("stage2", INTERACTIVE_STAGE2, [])):
                    stage[0] = name
                    torch.cuda.reset_peak_memory_stats()
                    t0 = time.perf_counter()
                    tr = run.main(["--run-type", "train", "--exp-config", config, "--model-dir", root,
                                   *train_opts, *extra])
                    seconds = time.perf_counter() - t0
                    totals = dict(tr.timings.totals)
                    last = list_checkpoints(data)[-1]
                    t0 = time.perf_counter()
                    saved = load_checkpoint(last)
                    load_ms = (time.perf_counter() - t0) * 1e3
                    fields[name] = dict(
                        config=config, seconds=seconds, setup_s=tr.setup_seconds, loop_s=tr.train_seconds,
                        num_envs=tr.env.num_envs, num_steps=tr.num_steps, memory_size=tr.memory_size,
                        pretraining=bool(tr.config.RL.PPO.SCENE_MEMORY_TRANSFORMER.pretraining),
                        replay_store=bool(tr.config.REPLAY_STORE), loaded=sorted(tr.loaded),
                        instructions="bank" if tr.instr_source is None else "host speaker",
                        updates=tr.num_updates_done, num_steps_done=tr.num_steps_done,
                        loop_env_steps_per_s=tr.num_updates_done * tr.num_steps * tr.env.num_envs / tr.train_seconds,
                        ms_per_update=totals["superstep_time"] * 1e3 / tr.num_updates_done,
                        checkpoint=os.path.basename(last), checkpoint_bytes=os.path.getsize(last),
                        checkpoint_save_ms=totals["checkpoint_time"] * 1e3 / tr.num_updates_done,
                        checkpoint_load_ms=load_ms, optimizer_q_steps=tr.optimizer_q.count,
                        pi_l_max_abs_diff_to_vln=_max_tree_diff(to_flax_params(tr.dialog_policy), want_vln),
                        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30)
                    del tr, saved
                    torch.cuda.empty_cache()
        finally:
            for k, fn in orig.items():
                setattr(Trainer, k, fn)
        fields["rounds"] = rounds
        fields["resume_max_abs_diff"] = resume

        with eval_videos_recorded() as rec:
            t0 = time.perf_counter()
            ev = run.main(["--run-type", "eval", "--exp-config", INTERACTIVE_STAGE2, "--model-dir", root, *opts,
                           "USE_LAST_CKPT", "True", "EVAL.SPLIT", "train",
                           "TEST_EPISODE_COUNT", str(AVLEN_EVAL_EPISODES)])
            torch.cuda.synchronize()
        ids = ev._last_eval_episode_ids
        sound = ev.config.SOUND_TYPE
        index = len(list_checkpoints(data)) - 1
        queries = np.load(os.path.join(root, f"eval_stats_ckpt{index}_{sound}.npz"))["query_count"]
        scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(root, "tb")).items() if k.startswith("val/")}
        fields["eval"] = dict(
            seconds=time.perf_counter() - t0, setup_s=ev.setup_seconds, num_envs=ev.env.num_envs, episodes=len(ids),
            distinct_ids=len(set(ids)), qs_method=ev.config.QS_METHOD, limit_query=bool(ev.config.LIMIT_QUERY),
            how_many_query=ev.config.HOW_MANY_QUERY, max_queries=float(queries.max(initial=0)),
            mean_queries=float(queries.mean()) if queries.size else None,
            success=scalars.get("val/success"), spl=scalars.get("val/spl"),
            episodes_evaluated=scalars.get("val/episodes_evaluated"), videos=video_report(ev.config, rec))
        how_many = ev.config.HOW_MANY_QUERY
        del ev
        torch.cuda.empty_cache()

        dev_dir = os.path.join(root, "dialog_eval")
        with eval_videos_recorded() as rec:
            t0 = time.perf_counter()
            dv = run.main(["--run-type", "eval", "--exp-config", DIALOG_YAML, "--model-dir", dev_dir,
                           "EVAL_CKPT_PATH_DIR", vln_ckpt, "EVAL.SPLIT", "test",
                           "TEST_EPISODE_COUNT", str(AVLEN_EVAL_EPISODES)])
            torch.cuda.synchronize()
        ids = dv._last_eval_episode_ids
        scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(dev_dir, "tb")).items()}
        fields["dialog_eval"] = dict(
            seconds=time.perf_counter() - t0, num_envs=dv.env.num_envs, episodes=len(ids), distinct_ids=len(set(ids)),
            action_accuracy=scalars.get("val_dialog/action_accuracy"), action_ce=scalars.get("val_dialog/action_ce"),
            success=scalars.get("val_dialog/success"),
            pi_l_max_abs_diff_to_vln=_max_tree_diff(to_flax_params(dv.dialog_policy), want_vln),
            videos=video_report(dv.config, rec))
        del dv
        torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    fields["launches"] = launches
    fields["shapes"] = _shape_counts(shapes)
    checked = avlen_checked_shapes()
    fields["unchecked_shapes"] = {k: sorted(map(list, set(shapes[k]) - checked[k])) for k in checked
                                  if set(shapes[k]) - checked[k]}
    emit("interactive_train", **fields)

    s1, s2 = fields["stage1"], fields["stage2"]
    if s1["loaded"] != ["belief", "dialog", "goal"] or s1["pi_l_max_abs_diff_to_vln"] != 0:
        raise AssertionError(f"interactive_train: stage 1 loaded {s1['loaded']}, π_l moved "
                             f"{s1['pi_l_max_abs_diff_to_vln']} from the vln checkpoint")
    if not resume or any(v != 0 for k, v in resume.items() if k != "num_steps_done"):
        raise AssertionError(f"interactive_train: stage 2 did not resume stage 1 exactly: {resume}")
    if s2["pi_l_max_abs_diff_to_vln"] == 0 or not s2["replay_store"]:
        raise AssertionError("interactive_train: π_l's replay CE did not move π_l in stage 2")
    for r in rounds:
        want = r["want_smt_launches"]
        for who in ("pi_q", "pi_l"):
            if r[who]["smt_launches"] != want[who]:
                raise AssertionError(f"interactive_train {r['stage']}: {who}'s update ran {r[who]['smt_launches']} "
                                     f"SMT launches at {r[who]['smt_shape']}, want {want[who]}")
        if r["other_smt_launches"] or not all(math.isfinite(v) for v in r["stats"].values()):
            raise AssertionError(f"interactive_train: {r['other_smt_launches']} {r['stats']}")
        if ("dialog_loss" in r["stats"]) != (r["stage"] == "stage2"):
            raise AssertionError(f"interactive_train: {r['stage']} stats {sorted(r['stats'])}")
    if len(rounds) != 2 * AVLEN_UPDATES:
        raise AssertionError(f"interactive_train: {len(rounds)} updates, want {2 * AVLEN_UPDATES}")
    for what in ("eval", "dialog_eval"):
        e = fields[what]
        if e["episodes"] != AVLEN_EVAL_EPISODES or e["distinct_ids"] != AVLEN_EVAL_EPISODES:
            raise AssertionError(f"interactive_train {what}: {e['episodes']} episodes ({e['distinct_ids']} ids)")
    if fields["eval"]["max_queries"] > how_many or not fields["eval"]["limit_query"]:
        raise AssertionError(f"interactive_train eval: {fields['eval']['max_queries']} queries > {how_many}")
    d = fields["dialog_eval"]
    if not (0 <= d["action_accuracy"] <= 1 and math.isfinite(d["action_ce"])) or d["pi_l_max_abs_diff_to_vln"]:
        raise AssertionError(f"interactive_train dialog_eval: {d}")
    check_videos("interactive_train eval", fields["eval"]["videos"])
    # π_l's dialog protocol writes no videos, as in the JAX package
    if fields["dialog_eval"]["videos"]["videos"]:
        raise AssertionError(f"interactive_train dialog_eval: videos {fields['dialog_eval']['videos']}")
    if not all(launches.values()):
        raise AssertionError(f"interactive_train: a kernel never launched: {launches}")
    if fields["unchecked_shapes"]:
        raise AssertionError(f"interactive_train: launch shapes no kernel check covers: {fields['unchecked_shapes']}")
    return launches


def _to_device(x, dev):
    """A trajectory (tensors in dicts, tuples and NamedTuples) on ``dev``."""
    if isinstance(x, dict):
        return {k: _to_device(v, dev) for k, v in x.items()}
    if isinstance(x, tuple):
        items = [_to_device(v, dev) for v in x]
        return type(x)(*items) if hasattr(x, "_fields") else tuple(items)
    return x.to(dev)


# π_l's parameters after its one replay step: a tenth of its Adam's lr
# (1e-5), so that a step the card skipped or took wrongly fails (the H100
# read 6e-8); π_q's (lr 2.5e-4) stay at POLICY_PARAM_TOL
DIALOG_PARAM_TOL = 1e-6


@contextlib.contextmanager
def dialog_logits_recorded():
    """Within the block, the π_l logits (T, B, A) each π_l update
    re-evaluates, in call order."""
    from avlen_tpu_torch.rl import ppo_interactive

    seen = []
    names = ("evaluate_dialog_sequence", "evaluate_dialog_sequence_batched")
    orig = {k: getattr(ppo_interactive, k) for k in names}

    def recording(fn):
        def run(*args, **kwargs):
            out = fn(*args, **kwargs)
            seen.append(out.detach().cpu())
            return out

        return run

    for k, fn in orig.items():
        setattr(ppo_interactive, k, recording(fn))
    try:
        yield seen
    finally:
        for k, fn in orig.items():
            setattr(ppo_interactive, k, fn)


def check_interactive_update_reference(dev, n: int = 12):
    """One ``InteractiveDDPPOTrainer.update`` (GAE, π_q's PPO with batched
    ring re-evaluation and the uncertainty CE, then π_l's replay CE) on the
    tiny world's CPU-collected trajectory of ``n`` steps
    (savi_interactive_2nd_stage.yaml, REPLAY_STORE), on the CPU (plain
    versions) and on the card (the SMT kernel forward, its plain-recompute
    backward), from the same parameters with the same permutations. Losses
    within 1e-3; π_l's re-evaluated logits within 1e-5
    (INTERACTIVE_REF_LOGITS_TOL); the gradients each Adam's first moment
    holds within 5e-4 + 1e-3·|g|; π_q's parameters within 1e-5 and π_l's
    within 1e-6, where π_l's step on the CPU must exceed twice that, so a
    skipped step fails. Returns the phase's fields."""
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.ops import smt_cuda
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer

    cfg = get_config(INTERACTIVE_STAGE2, opts=interactive_tiny_opts())
    ref_tr, got_tr = InteractiveDDPPOTrainer(cfg, device="cpu"), InteractiveDDPPOTrainer(cfg, device=dev)
    ref_tr._setup()
    got_tr._setup()

    def learners(tr):
        return {"option": (tr.option_policy, tr.optimizer_q.adam, POLICY_PARAM_TOL),
                "dialog": (tr.dialog_policy, tr.optimizer_l, DIALOG_PARAM_TOL)}

    start = {part: {k: p.detach().clone() for k, p in module.named_parameters()}
             for part, (module, _, _) in learners(ref_tr).items()}
    _, traj = ref_tr.collect(n=n)
    b = traj["actions"].shape[1]
    gen = torch.Generator().manual_seed(11)
    perms = [torch.randperm(b, generator=gen) for _ in range(ref_tr.ppo_cfg.ppo_epoch)]
    with dialog_logits_recorded() as ref_logits:
        ref = ref_tr.update(traj, perms=perms)
    before = smt_cuda.smt_encode.launches
    with dialog_logits_recorded() as got_logits:
        got = got_tr.update(_to_device(traj, dev), perms=perms)
    launches = smt_cuda.smt_encode.launches - before
    loss_err = {k: abs(got[k].item() - ref[k].item()) for k in ref}
    logits_err = share_of_tol(got_logits[0], ref_logits[0], 1.0)

    errs = {}
    for part, (module, adam, param_tol) in learners(ref_tr).items():
        got_module, got_adam, _ = learners(got_tr)[part]
        g_ref, g_got = adam_gradients(module, adam), adam_gradients(got_module, got_adam)
        got_params = dict(got_module.named_parameters())
        e = dict(grad_share_of_tol=0.0, grad_max_abs=0.0, param_tol=param_tol, param_share_of_tol=0.0,
                 param_max_abs_err=0.0, param_step_max=0.0)
        for name, p in module.named_parameters():
            g = g_ref[name]
            e["grad_share_of_tol"] = max(e["grad_share_of_tol"],
                                         share_of_tol(g_got[name], g, GRAD_ATOL + GRAD_RTOL * g.abs()))
            e["grad_max_abs"] = max(e["grad_max_abs"], g.abs().max().item())
            e["param_share_of_tol"] = max(e["param_share_of_tol"], share_of_tol(got_params[name], p, param_tol))
            e["param_max_abs_err"] = max(e["param_max_abs_err"], share_of_tol(got_params[name], p, 1.0))
            e["param_step_max"] = max(e["param_step_max"], share_of_tol(p, start[part][name], 1.0))
        errs[part] = e
    fields = dict(steps=n, envs=b, optimizer_q_steps=got_tr.optimizer_q.count, smt_launches=launches,
                  queried_steps=int(traj["queried"].sum()), losses={k: [ref[k].item(), got[k].item()] for k in ref},
                  loss_err=loss_err, loss_tol=1e-3, dialog_logits_max_abs_err=logits_err,
                  dialog_logits_peak=ref_logits[0].abs().max().item(), dialog_logits_tol=INTERACTIVE_REF_LOGITS_TOL,
                  errors=errs)
    emit("interactive_update_reference", **fields)
    if set(ref) != {"value_loss", "action_loss", "entropy", "unct_loss", "dialog_loss"}:
        raise AssertionError(f"interactive_update_reference: stats {sorted(ref)}")
    if not all(math.isfinite(v) and v <= 1e-3 for v in loss_err.values()):
        raise AssertionError(f"interactive_update_reference: CUDA vs CPU losses differ {loss_err}")
    if len(ref_logits) != 1 or len(got_logits) != 1 or not logits_err <= INTERACTIVE_REF_LOGITS_TOL:
        raise AssertionError(f"interactive_update_reference: π_l's re-evaluated logits differ by {logits_err} "
                             f"({len(ref_logits)} and {len(got_logits)} re-evaluations)")
    bad = {k: v for k, v in errs.items() if not (v["grad_share_of_tol"] <= 1 and v["param_share_of_tol"] <= 1)}
    if bad:
        raise AssertionError(f"interactive_update_reference: CUDA vs CPU gradients or parameters differ {bad}")
    if not errs["dialog"]["param_step_max"] > 2 * DIALOG_PARAM_TOL:
        raise AssertionError(f"interactive_update_reference: π_l's step {errs['dialog']['param_step_max']} "
                             f"is too small for its check to see")
    if launches < 1:
        raise AssertionError("interactive_update_reference: the SMT kernel did not run in the update")
    return fields


# the AV-Nav and AV-WAN stacks (the default world: 2 scenes, up to 53
# nodes, 4 one-second sounds, 44.1 kHz audio, 2,000-tap RIRs, 64 px depth;
# its 1.61 GB spectrogram bank is under the 4 GiB cap, so every setup
# renders it through both audio kernels and no step runs a kernel)
AVNAV_YAML = "configs/audionav/av_nav/audiogoal_depth.yaml"
AVWAN_YAML = "configs/audionav/av_wan/audiogoal_depth.yaml"
BASELINE_DIR = "build/chip_smoke_baselines"  # model dirs of the avnav_train and avwan_train phases
BASELINE_EVAL_EPISODES = {"avnav": 20, "avwan": 10}
# the evals' rollout budgets (the trainers' own allow 2,010 rollouts here):
# AV-Nav's 12 of 150 steps let every env finish its episodes; an AV-WAN
# env whose planner finds no move toward its argmax waypoint holds still,
# its episode never ends (the JAX package's MapNav does the same), and 5
# rollouts of 20 high-level steps bound what such an eval costs
BASELINE_EVAL_ROLLOUTS = {"avnav": 12, "avwan": 5}
BANK_CHECK_RENDERS = 256
BASELINE_REF_STEPS = 10
BASELINE_LOGITS_TOL, BASELINE_VALUE_TOL = 1e-5, 1e-4  # logits abs; values relative to their peak
BASELINE_SPECTROGRAM_TOL = 1e-4  # the rollout's spectrograms, abs: the spectrogram kernel's own limit
BASELINE_METRICS_TOL = 1e-6  # per-step episode metrics, abs (both devices gather the same tables)


def baseline_tiny_opts(sampling_rate: int = 44100, rir_length: int = 2000):
    """A tiny world of the AV-Nav/AV-WAN configs with the spectrogram bank
    off, so that every step renders its audio through the kernels: 3 envs,
    16 px depth, hidden 32, episodes of at most 8 steps, AV-WAN's high-level
    steps of up to 3; two epochs of three one-env minibatches."""
    return [
        "TASK_CONFIG.DATASET.SYNTHETIC.SIDE", "4",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_EPISODES", "20",
        "TASK_CONFIG.DATASET.SYNTHETIC.NUM_SOUNDS", "2",
        "TASK_CONFIG.DATASET.SYNTHETIC.RIR_LENGTH", str(rir_length),
        "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "16",
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", str(sampling_rate),
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
        "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "8",
        "NUM_PROCESSES", "3",
        "PREDICTION_INTERVAL", "3",
        "RL.PPO.num_steps", str(BASELINE_REF_STEPS),
        "RL.PPO.hidden_size", "32",
        "RL.PPO.ppo_epoch", "2",
        "RL.PPO.num_mini_batch", "3",
    ]


def compare_updates(ref_tr, got_tr, batch, perms, dev, param_tol: float = POLICY_PARAM_TOL):
    """One ``update`` of ``batch`` with ``perms`` by the CPU trainer and by
    the card's (the batch moved there), from the same parameters: the loss
    errors, and per trainer the gradients each Adam's first moment holds and
    the parameters after, as shares of their tolerances."""
    ref = ref_tr.update(batch, perms=perms)
    got = got_tr.update(batch.to(dev), perms=perms)
    loss_err = {k: abs(got[k].item() - ref[k].item()) for k in ref}
    g_ref = adam_gradients(ref_tr.policy, ref_tr.optimizer.adam)
    g_got = adam_gradients(got_tr.policy, got_tr.optimizer.adam)
    got_params = dict(got_tr.policy.named_parameters())
    e = dict(grad_share_of_tol=0.0, grad_max_abs=0.0, param_share_of_tol=0.0, param_max_abs_err=0.0)
    for name, p in ref_tr.policy.named_parameters():
        g = g_ref[name]
        e["grad_share_of_tol"] = max(e["grad_share_of_tol"],
                                     share_of_tol(g_got[name], g, GRAD_ATOL + GRAD_RTOL * g.abs()))
        e["grad_max_abs"] = max(e["grad_max_abs"], g.abs().max().item())
        e["param_share_of_tol"] = max(e["param_share_of_tol"], share_of_tol(got_params[name], p, param_tol))
        e["param_max_abs_err"] = max(e["param_max_abs_err"], share_of_tol(got_params[name], p, 1.0))
    return dict(losses={k: [ref[k].item(), got[k].item()] for k in ref}, loss_err=loss_err, loss_tol=1e-3,
                optimizer_steps=got_tr.optimizer.count, errors=e)


def check_baseline_reference(dev, stack: str, cfg=None, n: int = BASELINE_REF_STEPS):
    """The ``stack`` ("avnav" or "avwan") trainer on the tiny world
    (``baseline_tiny_opts``, the bank off) on the CPU (plain versions) and
    on the card (kernels at 44.1 kHz), the card's policy holding the CPU's
    weights: a greedy collect of ``n`` steps, actions, dones and masks
    exact, act logits within 1e-5, values within 1e-4 of their peak, the
    spectrograms within 1e-4 and the per-step episode metrics within 1e-6;
    for AV-WAN also the action masks and the geometric maps (gm, action
    map) exact, the acoustic map within 1e-4 of its peak (it sums
    spectrogram intensities). Episodes must end inside the rollout, so that
    the auto-reset (and AV-WAN's mapper reset and metrics frozen at the done
    step) is compared. Then one update of the CPU's rollout with the same
    permutations: losses within 1e-3, gradients within 5e-4 + 1e-3·|g|,
    parameters within 1e-5. Returns the phase's fields."""
    import torch

    import avlen_tpu_torch.rl.trainers  # noqa: F401  (registers the trainers)
    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.core.registry import registry

    cfg = cfg or get_config(AVNAV_YAML if stack == "avnav" else AVWAN_YAML, opts=baseline_tiny_opts())
    wrappers = _kernel_wrappers()
    trainers, batches, logits, launches = {}, {}, {}, {}
    for side, d in (("ref", "cpu"), ("got", dev)):
        tr = registry.get_trainer(cfg.TRAINER_NAME)(cfg, device=d)
        tr._setup()
        if "ref" in trainers:
            tr.policy.load_state_dict(trainers["ref"].policy.state_dict())
        seen = []
        act = tr.policy.act

        def recording(*args, **kwargs):
            out = act(*args, **kwargs)
            seen.append(out[-1].detach().cpu())
            return out

        tr.policy.act = recording
        before = {k: fn.launches for k, fn in wrappers.items()}
        _, batch = tr.collect(deterministic=True, n=n)
        launches[side] = {k: fn.launches - before[k] for k, fn in wrappers.items()}
        del tr.policy.act
        trainers[side], batches[side], logits[side] = tr, batch.to("cpu"), torch.stack(seen)
    ref, got = batches["ref"], batches["got"]
    exact = {k: bool(torch.equal(getattr(got, k), getattr(ref, k))) for k in ("actions", "dones", "masks")}
    obs_keys = ("__amask", "gm", "action_map") if stack == "avwan" else ()
    exact.update({k: bool(torch.equal(got.obs[k], ref.obs[k])) for k in obs_keys})
    value_peak = max(ref.values.abs().max().item(), 1e-6)
    errs = dict(logits=share_of_tol(logits["got"], logits["ref"], 1.0),
                values=share_of_tol(got.values, ref.values, 1.0) / value_peak,
                spectrogram=share_of_tol(got.obs["spectrogram"], ref.obs["spectrogram"], 1.0),
                metrics=max(share_of_tol(got.metrics[k], v, 1.0) for k, v in ref.metrics.items()))
    if stack == "avwan":
        errs["acoustic_map"] = share_of_tol(got.obs["am"], ref.obs["am"], 1.0) / max(ref.obs["am"].abs().max().item(), 1e-6)
    gen = torch.Generator().manual_seed(11)
    b = ref.actions.shape[1]
    ref_tr, got_tr = trainers["ref"], trainers["got"]
    perms = [torch.randperm(b, generator=gen) for _ in range(ref_tr.ppo_cfg.ppo_epoch)]
    update = compare_updates(ref_tr, got_tr, ref, perms, dev)
    fields = dict(stack=stack, config=cfg.TRAINER_NAME, sampling_rate=cfg.TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE,
                  fft_len=getattr(got_tr.env, "env", got_tr.env).bank.rir.fft_len,
                  steps=n, envs=b, dones=int(ref.dones.sum()), exact=exact, errors=errs,
                  tols=dict(logits=BASELINE_LOGITS_TOL, values=BASELINE_VALUE_TOL, acoustic_map=BASELINE_VALUE_TOL,
                            spectrogram=BASELINE_SPECTROGRAM_TOL, metrics=BASELINE_METRICS_TOL),
                  launches=launches["got"], update=update)
    emit(f"{stack}_reference", **fields)
    if not all(exact.values()):
        raise AssertionError(f"{stack}_reference: CUDA vs CPU differ where they must be equal: {exact}")
    if not (errs["logits"] <= BASELINE_LOGITS_TOL and errs["values"] <= BASELINE_VALUE_TOL
            and errs.get("acoustic_map", 0.0) <= BASELINE_VALUE_TOL
            and errs["spectrogram"] <= BASELINE_SPECTROGRAM_TOL and errs["metrics"] <= BASELINE_METRICS_TOL):
        raise AssertionError(f"{stack}_reference: CUDA vs CPU rollout differs {errs}")
    if not fields["dones"] > 0:
        raise AssertionError(f"{stack}_reference: no episode ended in {n} steps of {b} envs")
    if not all(math.isfinite(v) and v <= 1e-3 for v in update["loss_err"].values()):
        raise AssertionError(f"{stack}_reference: CUDA vs CPU losses differ {update['loss_err']}")
    if not (update["errors"]["grad_share_of_tol"] <= 1 and update["errors"]["param_share_of_tol"] <= 1):
        raise AssertionError(f"{stack}_reference: CUDA vs CPU gradients or parameters differ {update['errors']}")
    audio = ("partial_irfft", "spectrogram")
    if any(launches["got"][k] < n for k in audio):
        raise AssertionError(f"{stack}_reference: the audio kernels ran {launches['got']} times in {n} steps")
    return fields


@contextlib.contextmanager
def plain_audio():
    """Within the block the audio path renders through the plain versions,
    on any device (the kernels' launch counts untouched)."""
    from avlen_tpu_torch.ops import irfft_cuda, spectrogram_cuda

    saved = irfft_cuda.partial_irfft, spectrogram_cuda.spectrogram
    irfft_cuda.partial_irfft = irfft_cuda.partial_irfft_plain
    spectrogram_cuda.spectrogram = spectrogram_cuda.spectrogram_plain
    try:
        yield
    finally:
        irfft_cuda.partial_irfft, spectrogram_cuda.spectrogram = saved


def check_bank_renders(bank, gen, count: int = BANK_CHECK_RENDERS):
    """``count`` random renders of the card-built spectrogram bank against
    the same renders through the plain versions on the card: within bf16
    rounding, 2⁻⁸·|value| + 1e-4."""
    import torch

    from avlen_tpu_torch.ops.audio import SpectrogramConfig, render_audiogoal

    s, k, _, n = bank.spec_bank.shape[:4]
    dev = bank.device
    idx = [torch.randint(0, m, (count,), generator=gen, device=dev) for m in (s, k, 4, n, n)]
    scene, sound, az, recv, src = idx
    with plain_audio():
        _, want = render_audiogoal(
            bank.sounds_padded[sound], torch.zeros_like(sound), None,
            torch.ones(sound.shape, dtype=torch.bool, device=dev), bank.sampling_rate,
            config=SpectrogramConfig(sampling_rate=bank.sampling_rate),
            rir_f=bank.rir.gather_fft(scene, az, recv, src), rir_len=bank.rir.length)
    got = bank.spec_bank[scene, sound, az, recv, src].float()
    share = ((got - want).abs() / (want.abs() * 2.0 ** -8 + 1e-4)).max().item()
    return dict(renders=count, max_abs_err=(got - want).abs().max().item(), share_of_tol=share,
                tol="2^-8*|v| + 1e-4", peak=want.abs().max().item())


def bank_launch_rows(bank, batch: int = BANK_BATCH):
    """{rows: launches} of each audio kernel for one build of ``bank``'s
    spectrogram bank: ``batch`` renders a launch, the last launch the rest."""
    s, k, _, n = bank.spec_bank.shape[:4]
    total = s * k * 4 * n * n
    rows = {batch: total // batch}
    if total % batch:
        rows[total % batch] = 1
    return rows


@contextlib.contextmanager
def bank_builds_recorded():
    """Within the block, every spectrogram-bank build of a trainer setup:
    its seconds (ending in a synchronise), bytes, renders, and the rows of
    each audio-kernel launch it made."""
    import torch

    from avlen_tpu_torch.ops import irfft_cuda, spectrogram_cuda
    from avlen_tpu_torch.sim import builder

    builds, rows = [], {"partial_irfft": collections.Counter(), "spectrogram": collections.Counter()}
    orig = builder.precompute_spectrogram_bank
    launch = {"partial_irfft": irfft_cuda._launch, "spectrogram": spectrogram_cuda._launch}

    def counted(name):
        def run(x, *args):
            rows[name][x.shape[0]] += 1
            return launch[name](x, *args)

        return run

    def timed(bank, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        out = orig(bank, *args, **kwargs)
        torch.cuda.synchronize()
        builds.append(dict(seconds=time.perf_counter() - t0,
                           bytes=None if out is None else out.numel() * out.element_size(),
                           shape=None if out is None else list(out.shape)))
        return out

    builder.precompute_spectrogram_bank = timed
    irfft_cuda._launch, spectrogram_cuda._launch = counted("partial_irfft"), counted("spectrogram")
    try:
        yield builds, rows
    finally:
        builder.precompute_spectrogram_bank = orig
        irfft_cuda._launch, spectrogram_cuda._launch = launch["partial_irfft"], launch["spectrogram"]


def _loop_fields(tr, seconds: float, stack: str):
    """A train run's readings from its trainer: setup and bank-build
    seconds, collect and training env-steps/s, ms per update and its split,
    checkpoint save ms (``Timings``)."""
    totals = dict(tr.timings.totals)
    updates = max(tr.num_updates_done, 1)
    t_steps, b = tr.num_steps, tr.env.num_envs
    collect_s, update_s = totals["collect_time"], totals["update_time"]
    f = dict(seconds=seconds, setup_s=tr.setup_seconds, env_build_s=getattr(tr, "bank_seconds", None),
             updates=tr.num_updates_done,
             num_steps_done=tr.num_steps_done, ms_per_update=(collect_s + update_s) * 1e3 / updates,
             collect_ms_per_update=collect_s * 1e3 / updates, update_ms_per_update=update_s * 1e3 / updates,
             collect_env_steps_per_s=t_steps * b * updates / collect_s,
             train_env_steps_per_s=t_steps * b * updates / (collect_s + update_s),
             checkpoint_save_ms=totals.get("checkpoint_time", 0.0) * 1e3 / updates,
             loop_env_steps_per_s=tr.num_steps_done / tr.train_seconds)
    if stack == "avwan":
        low = int(tr.env.low_level_steps)
        f.update(high_level_steps_per_s=f.pop("collect_env_steps_per_s"), low_level_steps_taken=low,
                 low_level_steps_per_s=low / collect_s,
                 train_env_steps_per_s=low / (collect_s + update_s))
    return f


def run_baseline_train(stack: str, smi: str, root: str = BASELINE_DIR):
    """``stack``'s config (AVNAV_YAML or AVWAN_YAML) through ``run.main``
    at full width, uncut but for the update count: train 2 updates → resume
    (parameters and Adam state exactly ckpt.1's before its first update) →
    train 1 more → eval of the last checkpoint (BASELINE_EVAL_EPISODES,
    split train). Every setup builds the 44.1 kHz spectrogram bank through
    both audio kernels: the launches over the phase, counted from zero,
    must be the builds' (ceil(renders / 256) each, the last at the rest's
    rows), and no step may launch a kernel. On the first setup's bank, 256
    random renders against the plain versions. Returns the phase's
    launches."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.core.registry import registry
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint
    from avlen_tpu_torch.utils.tb import read_scalars

    yaml = AVNAV_YAML if stack == "avnav" else AVWAN_YAML
    model_dir = os.path.abspath(os.path.join(root, stack))
    shutil.rmtree(model_dir, ignore_errors=True)
    ckpt1 = os.path.join(model_dir, "data", "ckpt.1.pth")
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    main = lambda *args, run_type="train": run.main(  # noqa: E731
        ["--run-type", run_type, "--exp-config", yaml, "--model-dir", model_dir, *args])
    fields = dict(nvidia_smi=smi, config=yaml)
    with bank_builds_recorded() as (builds, rows):
        t0 = time.perf_counter()
        tr = main("NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1")
        torch.cuda.synchronize()
        fields["train"] = _loop_fields(tr, time.perf_counter() - t0, stack)
        bank = getattr(tr.env, "env", tr.env).bank
        if bank.spec_bank is None:
            raise AssertionError(f"{stack}_train: no spectrogram bank was built")
        per_build = bank_launch_rows(bank)
        fields["bank"] = dict(shape=list(bank.spec_bank.shape), dtype=str(bank.spec_bank.dtype),
                              launch_rows=per_build, sampling_rate=bank.sampling_rate,
                              rir_length=bank.rir.length, fft_len=bank.rir.fft_len)
        if stack == "avnav":
            fields["bank_renders_vs_plain"] = check_bank_renders(bank, torch.Generator(device=bank.device).manual_seed(3))
        fields["train"]["num_envs"], fields["train"]["num_steps"] = tr.env.num_envs, tr.num_steps
        fields["train"]["hidden_size"] = tr.config.RL.PPO.hidden_size
        del tr, bank
        t0 = time.perf_counter()
        saved = load_checkpoint(ckpt1)
        fields["checkpoint"] = dict(bytes=os.path.getsize(ckpt1), load_ms=(time.perf_counter() - t0) * 1e3)

        checked = {}
        cls = registry.get_trainer("AVNavTrainer" if stack == "avnav" else "AVWanTrainer")
        collect = cls.collect

        def first_collect(self, *args, **kwargs):
            if not checked:
                checked.update(state_differences(self, saved))
                checked["num_steps_done"] = self.num_steps_done
            return collect(self, *args, **kwargs)

        cls.collect = first_collect
        try:
            t0 = time.perf_counter()
            tr = main("NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True")
            torch.cuda.synchronize()
        finally:
            cls.collect = collect
        fields["resume"] = dict(_loop_fields(tr, time.perf_counter() - t0, stack), restored_max_abs_diff=checked,
                                ckpt2_written=os.path.isfile(os.path.join(model_dir, "data", "ckpt.2.pth")))
        want_steps = int(saved["extra_state"]["step"])
        del tr, saved

        count, budget = BASELINE_EVAL_EPISODES[stack], BASELINE_EVAL_ROLLOUTS[stack]
        budgets = []
        own_budget = cls.eval_rollout_budget

        def bounded(self, *args):
            budgets.append(own_budget(self, *args))
            return min(budgets[-1], budget)

        cls.eval_rollout_budget = bounded
        try:
            with eval_videos_recorded() as rec:
                t0 = time.perf_counter()
                tr = main("USE_LAST_CKPT", "True", "EVAL.SPLIT", "train", "TEST_EPISODE_COUNT", str(count),
                          run_type="eval")
                torch.cuda.synchronize()
        finally:
            cls.eval_rollout_budget = own_budget
        ids = tr._last_eval_episode_ids
        scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(model_dir, "tb")).items() if k.startswith("val/")}
        fields["eval"] = dict(seconds=time.perf_counter() - t0, num_envs=tr.env.num_envs, episodes=len(ids),
                              distinct_ids=len(set(ids)), episodes_evaluated=scalars.get("val/episodes_evaluated"),
                              success=scalars.get("val/success"), spl=scalars.get("val/spl"),
                              deterministic=tr.eval_deterministic, rollout_budget=budget,
                              trainer_rollout_budget=budgets[-1], videos=video_report(tr.config, rec))
        if stack == "avwan":
            fields["eval"]["low_level_steps_taken"] = int(tr.env.low_level_steps)
        del tr
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    n_builds = sum(1 for b in builds if b["bytes"])
    want_rows = {r: c * n_builds for r, c in per_build.items()}
    want = sum(want_rows.values())
    fields.update(builds=builds, bank_builds=n_builds, launches=launches, want_launches_per_audio_kernel=want,
                  launch_rows={k: dict(v) for k, v in rows.items()})
    emit(f"{stack}_train", **fields)
    for k in ("partial_irfft", "spectrogram"):
        if launches[k] != want or dict(rows[k]) != want_rows:
            raise AssertionError(f"{stack}_train: {k} launched {launches[k]} times ({dict(rows[k])} by rows), "
                                 f"want {want} ({want_rows}) from {n_builds} bank builds")
    if launches["smt_encode"]:
        raise AssertionError(f"{stack}_train: the SMT kernel ran {launches['smt_encode']} times")
    if checked.get("num_steps_done") != want_steps or any(v != 0 for k, v in checked.items() if k != "num_steps_done"):
        raise AssertionError(f"{stack}_train: resume did not restore ckpt.1 exactly: {checked}")
    if not fields["resume"]["ckpt2_written"]:
        raise AssertionError(f"{stack}_train: the resumed run wrote no ckpt.2")
    if stack == "avnav" and not fields["bank_renders_vs_plain"]["share_of_tol"] <= 1:
        raise AssertionError(f"{stack}_train: bank renders differ from the plain versions "
                             f"{fields['bank_renders_vs_plain']}")
    ev = fields["eval"]
    if ev["distinct_ids"] != ev["episodes"] or ev["episodes_evaluated"] != ev["episodes"]:
        raise AssertionError(f"{stack}_train: eval counted {ev}")
    check_videos(f"{stack}_train eval", ev["videos"])
    if stack == "avnav" and ev["episodes"] != count:
        raise AssertionError(f"{stack}_train: eval finished {ev['episodes']} episodes, want {count}")
    for part in ("train", "resume"):
        if not all(math.isfinite(v) for v in fields[part].values() if isinstance(v, float)):
            raise AssertionError(f"{stack}_train: non-finite readings {fields[part]}")
    return launches


AVWAN_EPISODES = 5  # episodes of the avwan_episodes phase's eval


def run_avwan_episodes(smi: str, root: str = BASELINE_DIR):
    """AV-WAN on the tiny world of ``baseline_tiny_opts`` (44.1 kHz, the
    bank off, episodes of at most 8 low-level steps), where its argmax
    agents do end episodes: ``run.main`` trains one update on the card, then
    evaluates that checkpoint for AVWAN_EPISODES episodes on the card, with
    the trainer's own rollout budget, and again on the CPU. The card's eval
    must count every episode once, the same episode ids as the CPU's, and
    ``val/*`` means within 1e-5 of the CPU's: the episode ends, the mapper
    reset on done and the metrics frozen at the done step, on the card.
    Every low-level step renders through both audio kernels."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.utils.tb import read_scalars

    model_dir = os.path.abspath(os.path.join(root, "avwan_episodes"))
    shutil.rmtree(model_dir, ignore_errors=True)
    opts = baseline_tiny_opts()
    wrappers = _kernel_wrappers()

    def main(run_type, *args):
        return run.main(["--run-type", run_type, "--exp-config", AVWAN_YAML, "--model-dir", model_dir,
                         *args, *opts])

    def evaluate(*device):
        with eval_videos_recorded() as rec:
            t0 = time.perf_counter()
            tr = main("eval", *device, "USE_LAST_CKPT", "True", "EVAL.SPLIT", "train",
                      "TEST_EPISODE_COUNT", str(AVWAN_EPISODES))
            seconds = time.perf_counter() - t0
        tb = os.path.join(model_dir, "tb")
        means = {k: v[-1][1] for k, v in read_scalars(tb).items() if k.startswith("val/")}
        videos = video_report(tr.config, rec)
        shutil.rmtree(tb)
        shutil.rmtree(tr.config.VIDEO_DIR, ignore_errors=True)
        return dict(seconds=seconds, ids=list(tr._last_eval_episode_ids), means=means,
                    low_level_steps=int(tr.env.low_level_steps), num_envs=tr.env.num_envs,
                    deterministic=tr.eval_deterministic, videos=videos)

    main("train", "NUM_UPDATES", "1")
    for fn in wrappers.values():
        fn.launches = 0
    got = evaluate()
    torch.cuda.synchronize()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    ref = evaluate("--device", "cpu")
    means_err = max((abs(got["means"][k] - v) for k, v in ref["means"].items() if k in got["means"]),
                    default=float("inf"))
    fields = dict(nvidia_smi=smi, config=AVWAN_YAML, want_episodes=AVWAN_EPISODES, card=got, cpu=ref,
                  means_max_abs_err=means_err, means_tol=1e-5, launches=launches)
    emit("avwan_episodes", **fields)
    ids = got["ids"]
    if not (len(ids) == AVWAN_EPISODES == len(set(ids)) == got["means"].get("val/episodes_evaluated")):
        raise AssertionError(f"avwan_episodes: the card's eval counted {ids}, "
                             f"episodes_evaluated {got['means'].get('val/episodes_evaluated')}")
    if ids != ref["ids"] or set(got["means"]) != set(ref["means"]) or not means_err <= 1e-5:
        raise AssertionError(f"avwan_episodes: the card's eval differs from the CPU's: {got} vs {ref}")
    check_videos("avwan_episodes", got["videos"])
    names = [[v["name"] for v in r["videos"]["videos"]] for r in (got, ref)]
    if not names[0] or names[0] != names[1]:
        raise AssertionError(f"avwan_episodes: the card's videos {names[0]}, the CPU's {names[1]}")
    # one launch of each audio kernel renders a low-level step of all envs
    steps = -(-got["low_level_steps"] // got["num_envs"])
    if not got["deterministic"] or any(launches[k] < steps for k in ("partial_irfft", "spectrogram")):
        raise AssertionError(f"avwan_episodes: argmax {got['deterministic']}, launches {launches} for "
                             f"{got['low_level_steps']} low-level steps of {got['num_envs']} envs")
    return fields



# ---------------------------------------------------------------------------
# reference-format data: the fixture tree and host-served RIRs
# ---------------------------------------------------------------------------
REFERENCE_TREE = "tests/data/reference_tree"  # one scene of 4 nodes, 4 kHz, 200-tap RIRs, 3 episodes
REFERENCE_DIR = "build/chip_smoke_reference"  # the tree's copy (and its pack) and the model dirs
REFERENCE_ENVS = 16  # reference_check's envs, as the full-width configs of reference_train run
REFERENCE_STEPS = 10
REFERENCE_SPEC_TOL = 2e-3  # the card's spectrograms against the CPU's (test_torch_env.py's limit)
REFERENCE_SENSORS = ("['SPECTROGRAM_SENSOR','CATEGORY','POSE_SENSOR','COLLISION','ORACLE_ACTION_SENSOR',"
                     "'POINTGOAL_WITH_GPS_COMPASS_SENSOR','SEMANTIC_OBJECT_SENSOR','MPCAT40_INDEX_SENSOR']")
REFERENCE_EVAL_EPISODES = 3  # every episode of the tree
# the fixture's audio at the kernels: (rows, fft_len, out_start, out_len) of
# the irfft, 4 kHz audio of the spectrogram
# and vln_dialog's rows on the same tree: π_l pretraining's 8 envs, AVLEN
# stage 1's 6 and its eval's 10
REFERENCE_AUDIO = {"reference_4k": (REFERENCE_ENVS, 8192, 199, 4000), "vln_pretrain_4k": (8, 8192, 199, 4000),
                   "vln_stage1_4k": (6, 8192, 199, 4000), "vln_eval_4k": (10, 8192, 199, 4000)}
# the aux_modules phase's 1-env rows: the challenge's savi.yaml env (16,000-tap
# RIRs) and the interactive demo's world (16 kHz, 2,000-tap RIRs)
AUX_AUDIO = {"challenge_16k": (1, 65536, 15999, 16000), "demo_16k": (1, 32768, 1999, 16000)}
# the rows the irfft and spectrogram checks time beside the library call
LIBRARY_ROWS = {**REFERENCE_AUDIO, **AUX_AUDIO}
HOSTRIR_COMPARE_STEPS = 20


def reference_overrides(tree: str):
    """The overrides of a shipped config that train it from the reference
    tree at ``tree``: the data-path keys, its rate (RIR_SAMPLING_RATE 4000),
    every RIR from the host store (DENSE_RIR_MAX_BYTES 0) and no
    spectrogram bank (CACHE_SPECTROGRAMS False), so that every step runs
    both audio kernels on host-served RIRs."""
    return [
        "TASK_CONFIG.DATASET.SOURCE", "reference",
        "TASK_CONFIG.DATASET.DATA_PATH",
        os.path.join(tree, "datasets", "semantic_audionav", "v1", "train", "train.json.gz"),
        "TASK_CONFIG.SIMULATOR.SCENE_DATASET", "mp3d",
        "TASK_CONFIG.SIMULATOR.AUDIO.METADATA_DIR", os.path.join(tree, "metadata"),
        "TASK_CONFIG.SIMULATOR.AUDIO.BINAURAL_RIR_DIR", os.path.join(tree, "binaural_rirs"),
        "TASK_CONFIG.SIMULATOR.AUDIO.SOURCE_SOUND_DIR", os.path.join(tree, "sounds", "1s_all"),
        "TASK_CONFIG.SIMULATOR.SCENE_OBSERVATION_DIR", os.path.join(tree, "scene_observations"),
        "TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE", "4000",
        "TASK_CONFIG.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES", "0",
        "TASK_CONFIG.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS", "False",
    ]


def copy_reference_tree(root: str = REFERENCE_DIR) -> str:
    """A fresh copy of the fixture tree under ``root`` (git-ignored), without
    any pack: the runs pack it there, never under tests/."""
    tree = os.path.abspath(os.path.join(root, "tree"))
    shutil.rmtree(tree, ignore_errors=True)
    shutil.copytree(REFERENCE_TREE, tree, ignore=shutil.ignore_patterns("_packed"))
    return tree


@contextlib.contextmanager
def host_rir_profile(*stores):
    """Within the block, the gathers of ``stores`` and of every HostRIRStore
    made in it: their index synchronisation and host read (host clock) and
    their copies (CUDA events), in one ``HostRIRStore.profile`` dict."""
    from avlen_tpu_torch.data.reference import HostRIRStore

    prof = {}
    init = HostRIRStore.__init__

    def profiled(self, *args, **kwargs):
        init(self, *args, **kwargs)
        self.profile = prof

    for store in stores:
        store.profile = prof
    HostRIRStore.__init__ = profiled
    try:
        yield prof
    finally:
        HostRIRStore.__init__ = init
        for store in stores:
            store.profile = None


def host_rir_fields(prof: dict, steps: int) -> dict:
    """A step's ms of the host-served RIRs from ``host_rir_profile``:
    ``steps`` env steps (each one gather a step, two with a distractor)."""
    events = prof.get("copy_events", [])
    if events:
        events[-1][1].synchronize()
    calls = prof.get("calls", 0)
    copy_ms = float(sum(start.elapsed_time(end) for start, end in events))
    return dict(gathers=calls, rows=prof.get("rows", 0), steps=steps,
                index_sync_ms_per_step=prof.get("index_sync_s", 0.0) * 1e3 / max(steps, 1),
                host_read_ms_per_step=prof.get("host_read_s", 0.0) * 1e3 / max(steps, 1),
                h2d_copy_ms_per_step=copy_ms / max(steps, 1),
                host_rir_ms_per_step=(prof.get("index_sync_s", 0.0) + prof.get("host_read_s", 0.0)) * 1e3
                / max(steps, 1) + copy_ms / max(steps, 1))


def check_reference_data(dev, root: str = REFERENCE_DIR, steps: int = REFERENCE_STEPS):
    """``reference_check``: the env over the fixture tree (the reference
    overrides; every RIR from the host store, no bank) on the CPU (plain
    versions) and on the card (kernels, RIRs through the pinned staging
    buffers): reset + ``steps`` steps of fixed actions. Spectrograms within
    REFERENCE_SPEC_TOL; rgb, depth, semantic_object, mpcat40_index,
    rewards and dones exact; one launch of each audio kernel a step and
    one at the reset on the card."""
    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.data.reference import HostRIRStore
    from avlen_tpu_torch.sim.builder import construct_batched_env

    tree = copy_reference_tree(root)
    cfg = get_config(SAVI_YAML, opts=reference_overrides(tree) + [
        "TASK_CONFIG.TASK.SENSORS", REFERENCE_SENSORS, "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6",
        "NUM_PROCESSES", str(REFERENCE_ENVS)])
    actions = torch.as_tensor(np.random.RandomState(0).randint(0, 4, (steps, REFERENCE_ENVS)))
    wrappers = _kernel_wrappers()
    runs = {}
    for d in ("cpu", dev):
        env = construct_batched_env(cfg, with_depth=True, with_rgb=True,
                                    extra_sensors=("category_belief", "location_belief", "category"), device=d)
        if not isinstance(env.bank.rir, HostRIRStore) or env.bank.spec_bank is not None:
            raise AssertionError(f"reference_check: RIRs from {type(env.bank.rir).__name__}, bank "
                                 f"{env.bank.spec_bank is not None}")
        for fn in wrappers.values():
            fn.launches = 0
        with host_rir_profile(env.bank.rir) as prof:
            state, obs = env.reset()
            seq = [(obs, None, None)]
            for a in actions:
                state, out = env.step(state, a.to(d))
                seq.append((out.obs, out.reward, out.done))
        launches = {k: fn.launches for k, fn in wrappers.items()}
        runs[str(d)] = (seq, launches, prof)
    (ref, _, _), (got, launches, prof) = runs["cpu"], runs[str(dev)]
    spec_err, exact_diff = 0.0, collections.Counter()
    for (r_obs, r_rew, r_done), (g_obs, g_rew, g_done) in zip(ref, got):
        spec_err = max(spec_err, (g_obs["spectrogram"].cpu() - r_obs["spectrogram"]).abs().max().item())
        for k in ("rgb", "depth", "semantic_object", "mpcat40_index"):
            exact_diff[k] += int(not torch.equal(g_obs[k].cpu(), r_obs[k]))
        if r_rew is not None:
            exact_diff["reward"] += int(not torch.equal(g_rew.cpu(), r_rew))
            exact_diff["done"] += int(not torch.equal(g_done.cpu(), r_done))
    dones = int(sum(int(d.sum()) for _, _, d in ref[1:]))
    fields = dict(tree=REFERENCE_TREE, overrides=reference_overrides("<tree>"),
                  check_overrides=["TASK_CONFIG.TASK.SENSORS", REFERENCE_SENSORS,
                                   "TASK_CONFIG.ENVIRONMENT.MAX_EPISODE_STEPS", "6"], num_envs=REFERENCE_ENVS,
                  steps=steps, dones=dones, spectrogram_max_abs_err=spec_err, spectrogram_tol=REFERENCE_SPEC_TOL,
                  steps_differing=dict(exact_diff), launches=launches,
                  host_rir=host_rir_fields(prof, steps + 1),
                  spectrogram_peak=max(o["spectrogram"].abs().max().item() for o, _, _ in ref))
    emit("reference_check", **fields)
    if spec_err > REFERENCE_SPEC_TOL or any(exact_diff.values()):
        raise AssertionError(f"reference_check: the card differs from the CPU: spectrogram {spec_err}, "
                             f"steps differing {dict(exact_diff)}")
    if any(launches[k] != steps + 1 for k in ("partial_irfft", "spectrogram")) or launches["smt_encode"]:
        raise AssertionError(f"reference_check: launches {launches}, want {steps + 1} of each audio kernel")
    if not dones or not fields["spectrogram_peak"] > 0:
        raise AssertionError(f"reference_check: {dones} episodes ended, spectrogram peak {fields['spectrogram_peak']}")
    return fields


def run_reference_train(stack: str, smi: str, root: str = REFERENCE_DIR):
    """``reference_train``: ``stack``'s shipped config at full width
    (AVNAV_YAML: 16 envs, hidden 512, 150 steps; SAVI_YAML: 16 envs, memory
    150, d_model 256, 8 heads) through ``run.main``, fed by the fixture tree
    with the reference overrides (every RIR from the host store): train 2
    updates → resume (parameters and optimizer states exactly ckpt.1's
    before its first update) → train 1 → eval of every episode of the tree.
    Env-steps/s, ms an update, a step's host-RIR ms (index sync, host read,
    H2D copy) and every kernel's launches, counted from zero over the
    phase."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.core.registry import registry
    from avlen_tpu_torch.data.reference import HostRIRStore
    from avlen_tpu_torch.utils.checkpoint import load_checkpoint
    from avlen_tpu_torch.utils.tb import read_scalars

    yaml = AVNAV_YAML if stack == "avnav" else SAVI_YAML
    tree = copy_reference_tree(root)
    model_dir = os.path.abspath(os.path.join(root, stack))
    shutil.rmtree(model_dir, ignore_errors=True)
    ckpt1 = os.path.join(model_dir, "data", "ckpt.1.pth")
    overrides = reference_overrides(tree)
    main = lambda *args, run_type="train": run.main(  # noqa: E731
        ["--run-type", run_type, "--exp-config", yaml, "--model-dir", model_dir, *overrides, *args])
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    fields = dict(nvidia_smi=smi, config=yaml, overrides=reference_overrides("<tree>"))
    with host_rir_profile() as prof:
        t0 = time.perf_counter()
        tr = main("NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1")
        torch.cuda.synchronize()
        fields["train"] = _loop_fields(tr, time.perf_counter() - t0, stack)
        fields["train"]["host_rir"] = host_rir_fields(prof, tr.num_steps_done // tr.env.num_envs + 1)
        store = tr.env.bank.rir
        fields["store"] = dict(type=type(store).__name__, length=store.length, sampling_rate=store.sampling_rate,
                               num_envs=tr.env.num_envs, num_steps=tr.num_steps, max_nodes=tr.env.bank.max_nodes,
                               sensors=list(tr.env.config.sensors))
        is_store = isinstance(store, HostRIRStore)
        del tr, store
    saved = load_checkpoint(ckpt1)
    fields["checkpoint_bytes"] = os.path.getsize(ckpt1)
    checked = {}
    cls = registry.get_trainer("AVNavTrainer" if stack == "avnav" else "savi")
    collect = cls.collect

    def first_collect(self, *args, **kwargs):
        if not checked:
            checked.update(state_differences(self, saved))
            checked["num_steps_done"] = self.num_steps_done
        return collect(self, *args, **kwargs)

    cls.collect = first_collect
    try:
        t0 = time.perf_counter()
        tr = main("NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True")
        torch.cuda.synchronize()
    finally:
        cls.collect = collect
    fields["resume"] = dict(_loop_fields(tr, time.perf_counter() - t0, stack), restored_max_abs_diff=checked,
                            ckpt2_written=os.path.isfile(os.path.join(model_dir, "data", "ckpt.2.pth")))
    want_steps = int(saved["extra_state"]["step"])
    del tr, saved
    with eval_videos_recorded() as rec:
        t0 = time.perf_counter()
        tr = main("USE_LAST_CKPT", "True", "EVAL.SPLIT", "train", "TEST_EPISODE_COUNT",
                  str(REFERENCE_EVAL_EPISODES), run_type="eval")
        torch.cuda.synchronize()
    ids = tr._last_eval_episode_ids
    scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(model_dir, "tb")).items() if k.startswith("val/")}
    fields["eval"] = dict(seconds=time.perf_counter() - t0, episodes=len(ids), distinct_ids=len(set(ids)),
                          episodes_evaluated=scalars.get("val/episodes_evaluated"), success=scalars.get("val/success"),
                          spl=scalars.get("val/spl"), videos=video_report(tr.config, rec))
    del tr
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    launches = {k: fn.launches for k, fn in wrappers.items()}
    fields["launches"] = launches
    emit(f"reference_train_{stack}", **fields)
    if not is_store:
        raise AssertionError(f"reference_train_{stack}: bank.rir is a {fields['store']['type']}, not a HostRIRStore")
    if checked.get("num_steps_done") != want_steps or any(v != 0 for k, v in checked.items() if k != "num_steps_done"):
        raise AssertionError(f"reference_train_{stack}: resume did not restore ckpt.1 exactly: {checked}")
    if not fields["resume"]["ckpt2_written"]:
        raise AssertionError(f"reference_train_{stack}: the resumed run wrote no ckpt.2")
    ev = fields["eval"]
    if not ev["episodes"] == ev["distinct_ids"] == ev["episodes_evaluated"] == REFERENCE_EVAL_EPISODES:
        raise AssertionError(f"reference_train_{stack}: eval counted {ev}")
    # one launch of each audio kernel a step (and one a reset) in the
    # loops alone: 3 updates of num_steps steps
    least = 3 * fields["store"]["num_steps"]
    if any(launches[k] < least for k in ("partial_irfft", "spectrogram")):
        raise AssertionError(f"reference_train_{stack}: launches {launches}, want at least {least} of each "
                             "audio kernel")
    if (launches["smt_encode"] > 0) != (stack == "savi"):
        raise AssertionError(f"reference_train_{stack}: the SMT kernel launched {launches['smt_encode']} times")
    for part in ("train", "resume"):
        if not all(math.isfinite(v) for v in fields[part].values() if isinstance(v, float)):
            raise AssertionError(f"reference_train_{stack}: non-finite readings {fields[part]}")
    return launches


def run_hostrir_savi(dev, smi: str):
    """``hostrir_savi``: savi.yaml as shipped (2 scenes of up to 89 nodes,
    16 kHz, 16,000-tap RIRs) plus DATASET.SYNTHETIC.PACK_HOST_RIRS True:
    the setup renders every procedural RIR into the mmap store (its seconds
    and bytes), then one 150-step collect and one update, every RIR read
    from the host: env-steps/s beside the procedural ``rollout`` phase, a
    step's host-RIR ms, and 151 launches of each audio kernel from the
    setup's reset through the collect. Then the first
    HOSTRIR_COMPARE_STEPS steps of the packed env against the procedural
    env of the same seed (its analytic spectra): spectrograms within
    REFERENCE_SPEC_TOL. Where the temporary directory cannot hold the pack,
    the world is cut to one scene, and the phase says so."""
    import tempfile

    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.data.reference import HostRIRStore
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.sim import builder

    base = get_config(SAVI_YAML)
    syn = base.TASK_CONFIG.DATASET.SYNTHETIC
    # the largest node count the shipped world can have: a SIDE x SIDE grid
    want_bytes = syn.NUM_SCENES * 4 * (syn.SIDE ** 2) ** 2 * syn.RIR_LENGTH * 2 * 4
    free = shutil.disk_usage(tempfile.gettempdir()).free
    cut = [] if free > 1.1 * want_bytes else ["TASK_CONFIG.DATASET.SYNTHETIC.NUM_SCENES", "1"]
    opts = ["TASK_CONFIG.DATASET.SYNTHETIC.PACK_HOST_RIRS", "True", *cut]
    cfg = get_config(SAVI_YAML, opts=opts)
    packs = []
    pack = builder.pack_synthetic_host_rirs

    def timed_pack(bank, *args, **kwargs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        idx = pack(bank, *args, **kwargs)
        packs.append(dict(seconds=time.perf_counter() - t0, index=idx,
                          bytes=os.path.getsize(idx[: -len(".npz")] + ".bin")))
        return idx

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    builder.pack_synthetic_host_rirs = timed_pack
    try:
        t0 = time.perf_counter()
        tr = SaviTrainer(cfg, device=dev)
        tr._setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
    finally:
        builder.pack_synthetic_host_rirs = pack
    with host_rir_profile(tr.env.bank.rir) as prof:
        t0 = time.perf_counter()
        _, batch = tr.collect()
        torch.cuda.synchronize()
        rollout_s = time.perf_counter() - t0
        host_rir = host_rir_fields(prof, tr.num_steps)
    launches = {k: fn.launches for k, fn in wrappers.items()}
    t0 = time.perf_counter()
    stats = tr.update(batch)
    torch.cuda.synchronize()
    update_ms = (time.perf_counter() - t0) * 1e3
    store = tr.env.bank.rir
    t_steps, b = batch.actions.shape
    fields = dict(nvidia_smi=smi, config=SAVI_YAML, overrides=opts, temp_free_bytes=free, pack_bytes_at_most=want_bytes,
                  cut=cut or None, pack=packs, store=type(store).__name__, rir_length=store.length,
                  max_nodes=tr.env.bank.max_nodes, num_scenes=tr.env.bank.num_scenes,
                  spectrogram_bank=tr.env.bank.spec_bank is not None, setup_s=setup_s, rollout_s=rollout_s,
                  env_steps_per_s=t_steps * b / rollout_s,
                  procedural_rollout_env_steps_per_s=EMITTED.get("rollout", {}).get("env_steps_per_s"),
                  update_ms=update_ms, losses={k: float(v) for k, v in stats.items()}, host_rir=host_rir,
                  launches=launches)

    # the packed env against the procedural env of the same seed
    actions = torch.as_tensor(np.random.RandomState(1).randint(0, 4, (HOSTRIR_COMPARE_STEPS, b)), device=dev)
    ref = builder.construct_batched_env(get_config(SAVI_YAML, opts=cut), num_envs=b, with_depth=True,
                                        with_rgb=True, extra_sensors=("category_belief", "location_belief",
                                                                      "category"), device=dev)
    errs = []
    with torch.no_grad():
        (state, obs), (rstate, robs) = tr.env.reset(), ref.reset()
        errs.append((obs["spectrogram"] - robs["spectrogram"]).abs().max().item())
        for a in actions:
            state, out = tr.env.step(state, a)
            rstate, rout = ref.step(rstate, a)
            errs.append((out.obs["spectrogram"] - rout.obs["spectrogram"]).abs().max().item())
            if not torch.equal(out.reward, rout.reward) or not torch.equal(out.done, rout.done):
                raise AssertionError("hostrir_savi: the packed env's rewards or dones differ from the procedural env's")
    fields.update(compare_steps=HOSTRIR_COMPARE_STEPS, spectrogram_max_abs_err=max(errs),
                  spectrogram_tol=REFERENCE_SPEC_TOL, procedural_uses_spectra=ref.bank.rir.tail_fft is not None)
    pack_dir = os.path.dirname(store.index_path)
    del tr, store, ref, batch
    torch.cuda.empty_cache()
    shutil.rmtree(pack_dir, ignore_errors=True)
    emit("hostrir_savi", **fields)
    if fields["store"] != HostRIRStore.__name__ or fields["spectrogram_bank"] or len(packs) != 1:
        raise AssertionError(f"hostrir_savi: RIRs from {fields['store']}, bank {fields['spectrogram_bank']}, "
                             f"{len(packs)} packs")
    if any(launches[k] != t_steps + 1 for k in ("partial_irfft", "spectrogram")) or launches["smt_encode"] < t_steps + 1:
        raise AssertionError(f"hostrir_savi: launches {launches}, want {t_steps + 1} of each audio kernel")
    if not all(math.isfinite(v) for v in fields["losses"].values()):
        raise AssertionError(f"hostrir_savi: non-finite losses {fields['losses']}")
    if not max(errs) <= REFERENCE_SPEC_TOL:
        raise AssertionError(f"hostrir_savi: spectrograms differ from the procedural env's by {max(errs)}")
    return launches


# ---------------------------------------------------------------------------
# precision: TPU.PRECISION on the card
# ---------------------------------------------------------------------------

VLN_DIR = "build/chip_smoke_vln"  # the tree's copy, its fabricated R2R files, the model dirs
VLN_SCAN = "sceneA"
# one FGR2R trajectory over the tree's 2x2 grid (nodes 1 → 3 → 2 → 0) with two
# sub-instructions (1-based inclusive viewpoint chunks, as FGR2R's chunk_view)
VLN_PATH = (1, 3, 2, 0)
VLN_CHUNKS = ((1, 3), (3, 4))
VLN_SUB_INSTRS = (("go", "forward", "then", "turn", "left", "at", "the", "table"),
                  ("walk", "to", "the", "cushion", "and", "stop"))
VLN_HEADING = 0.0  # MatterSim radians at the path's start
# the reference's bar is 7 nodes on a path (generate_vln_episode.py); the
# 2x2 tree has no path longer than 3, so the alignment is cut to 2
VLN_MIN_PATH_LEN = 2
VLN_EPISODES = 2  # what the CPU aligns from these files (tests/test_torch_reference_dialog.py)


def _mattersim_pose(habitat_pos):
    """A MatterSim pose (row-major 16) whose r_mat transform lands on
    ``habitat_pos``: translation (x_h, -z_h, y_h)."""
    x, y, z = (float(v) for v in habitat_pos)
    return [1, 0, 0, x, 0, 1, 0, -z, 0, 0, 1, y, 0, 0, 0, 1]


def write_r2r_fixtures(tree: str) -> dict:
    """FGR2R, VLN-CE and MatterSim connectivity files for the reference
    tree's scene at ``tree``, in the layout of tests/test_vln_alignment.py's
    ``_write_fixtures``: a viewpoint 1.5 m above each of the scene's nodes,
    connected along the scene graph's edges; one FGR2R trajectory over
    VLN_PATH whose instruction VLN-CE also holds, cut into VLN_SUB_INSTRS by
    VLN_CHUNKS. Returns the paths, under ``tree``/r2r."""
    import gzip

    import numpy as np

    from avlen_tpu_torch.data.reference import load_scene_graph

    graph = load_scene_graph(os.path.join(tree, "metadata", "mp3d", VLN_SCAN))
    views = graph.positions + np.array([0, 1.5, 0], np.float32)
    view_ids = [f"{VLN_SCAN}_v{i}" for i in range(graph.num_nodes)]
    linked = {(int(a), int(b)) for a, b in graph.edges} | {(int(b), int(a)) for a, b in graph.edges}
    conn = [{"image_id": vid, "pose": _mattersim_pose(views[i]), "included": True,
             "unobstructed": [(i, j) in linked for j in range(graph.num_nodes)]}
            for i, vid in enumerate(view_ids)]
    r2r = os.path.join(tree, "r2r")
    paths = dict(connectivity_dir=os.path.join(r2r, "connectivity"), fgr2r=os.path.join(r2r, "FGR2R_train.json"),
                 vlnce=os.path.join(r2r, "R2R_VLNCE_v1-2", "train", "train.json.gz"))
    os.makedirs(paths["connectivity_dir"], exist_ok=True)
    os.makedirs(os.path.dirname(paths["vlnce"]), exist_ok=True)
    with open(os.path.join(paths["connectivity_dir"], f"{VLN_SCAN}_connectivity.json"), "w") as f:
        json.dump(conn, f)
    full = " ".join(w for sub in VLN_SUB_INSTRS for w in sub)
    fgr2r = [{"scan": VLN_SCAN, "path": [view_ids[i] for i in VLN_PATH], "heading": VLN_HEADING,
              "instructions": [full], "new_instructions": repr([[list(sub) for sub in VLN_SUB_INSTRS]]),
              "chunk_view": [[list(c) for c in VLN_CHUNKS]]}]
    with open(paths["fgr2r"], "w") as f:
        json.dump(fgr2r, f)
    vlnce = {"episodes": [{"episode_id": 1, "instruction": {"instruction_text": full},
                           "scene_id": f"mp3d/{VLN_SCAN}/{VLN_SCAN}.glb",
                           "reference_path": [views[i].tolist() for i in VLN_PATH],
                           "start_rotation": [0.0, 0.0, 0.0, 1.0]}]}
    with gzip.open(paths["vlnce"], "wt") as f:
        json.dump(vlnce, f)
    return paths


def align_reference_dialog(tree: str, min_path_len: int = VLN_MIN_PATH_LEN):
    """VLN alignment of ``write_r2r_fixtures``' files onto the tree's scene
    graphs with the port's ``generate_dialog_dataset``, into the tree's
    ``datasets/semantic_audionav_dialog_approx/v1/train`` (the shards under
    ``content/`` and the split-level stub the data path names). Returns
    (the stub's path, the episode count of each scan, seconds)."""
    from avlen_tpu_torch.data.reference import load_scene_graph
    from avlen_tpu_torch.data.vln import generate_dialog_dataset

    paths = write_r2r_fixtures(tree)
    meta = os.path.join(tree, "metadata", "mp3d")
    out = os.path.join(tree, "datasets", "semantic_audionav_dialog_approx", "v1", "train")
    t0 = time.perf_counter()
    counts = generate_dialog_dataset(
        fgr2r_path=paths["fgr2r"], vlnce_paths=[paths["vlnce"]], connectivity_dir=paths["connectivity_dir"],
        scene_graphs={s: load_scene_graph(os.path.join(meta, s)) for s in sorted(os.listdir(meta))},
        audionav_dataset_dir=os.path.join(tree, "datasets", "semantic_audionav", "v1", "train"), output_dir=out,
        min_path_len=min_path_len)
    return os.path.join(out, "dataset.json.gz"), counts, time.perf_counter() - t0


def dialog_overrides(tree: str, data_path: str):
    """``reference_overrides`` with the data path on the aligned dialog
    dataset."""
    opts = reference_overrides(tree)
    opts[opts.index("TASK_CONFIG.DATASET.DATA_PATH") + 1] = data_path
    return opts


def run_native_build():
    """``native_build``: both native host libraries (the frame server and
    the graph engine) compiled by g++ from ``avlen_tpu_torch/native/`` into
    ``build/native/``, each rebuilt here; raises with g++'s output if a
    compile fails."""
    from avlen_tpu_torch.native import build as native_build

    gxx = subprocess.run(["g++", "--version"], capture_output=True, text=True, timeout=60,
                         check=True).stdout.splitlines()[0]
    seconds = native_build.build_native(force=True)
    libs = {name: os.path.relpath(native_build.native_lib_path(name)) for name in native_build.SOURCES}
    emit("native_build", gxx=gxx, flags=list(native_build.CXX_FLAGS), seconds=seconds, libraries=libs,
         bytes={name: os.path.getsize(path) for name, path in libs.items()})
    if set(seconds) != set(native_build.SOURCES) or not all(os.path.isfile(p) for p in libs.values()):
        raise AssertionError(f"native_build: built {sorted(seconds)}, libraries {libs}")


FRAME_CACHE_DIR = "build/chip_smoke_frames"  # the banks of the frame_cache_savi phase
# savi.yaml's two scenes (SIDE 10, seed 0) hold 79 and 89 nodes; the CLI draws
# its own graphs, and at SIDE 11 its banks (96 and 105 nodes) cover both
FRAME_CACHE_ARGS = ("--scenes", "2", "--side", "11", "--res", "64", "--seed", "0")


def read_frame_bank(path: str):
    """A bank file's frames (N, A, H, W, C), read with numpy from its bytes
    (header: magic, N, A, H, W, C, item size), apart from the server."""
    import numpy as np

    _, n, a, h, w, c, size = (int(v) for v in np.fromfile(path, "<i4", count=7))
    return np.fromfile(path, {1: np.uint8, 2: np.uint16}[size], offset=28).reshape(n, a, h, w, c)


def run_frame_cache_savi(dev, smi: str, root: str = FRAME_CACHE_DIR):
    """``frame_cache_savi``: savi.yaml uncut plus DATASET.FRAME_CACHE_DIR on
    banks that ``avlen_tpu_torch.scripts.cache_observations`` writes under
    ``root`` (FRAME_CACHE_ARGS). One collect of 150 steps and one update.
    Fails unless the bank on the card equals the files' frames (depth as
    uint16 / 65535, zero rows past a scene's nodes), every observed rgb and
    depth of the reset and the steps equals the files' frame at the env's
    scene, node and rotation, and the kernels launched as on savi.yaml: T+1
    of each in the setup and collect (the reset's observation, a step each,
    the SMT's bootstrap), ppo_epoch x minibatches x T/chunk SMT launches in
    the update and no audio launch. Emits the banks' bytes, the load's ms
    and env-steps/s."""
    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.rollout_smt import ring_eval_chunk
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.scripts import cache_observations
    from avlen_tpu_torch.sim import builder
    from avlen_tpu_torch.sim.env import BatchedAudioNavEnv

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    t0 = time.perf_counter()
    cache_observations.main(["--output", root, *FRAME_CACHE_ARGS])
    write_s = time.perf_counter() - t0
    files = {name: os.path.getsize(os.path.join(root, name)) for name in sorted(os.listdir(root))}
    want, bank_nodes = {}, {}
    for kind in ("rgb", "depth"):
        banks = [read_frame_bank(os.path.join(root, f"scene{i:03d}_{kind}.avlf")) for i in range(2)]
        bank_nodes[kind] = [b.shape[0] for b in banks]
        frames = np.zeros((2, max(b.shape[0] for b in banks)) + banks[0].shape[1:], banks[0].dtype)
        for i, b in enumerate(banks):
            frames[i, : b.shape[0]] = b
        want[kind] = torch.as_tensor(frames if kind == "rgb" else frames.astype(np.float32) / 65535.0, device=dev)

    seen = dict(observations=0, frames=0)
    wrong = torch.zeros((), dtype=torch.long, device=dev)
    observe, load = BatchedAudioNavEnv._observe, builder._load_frame_banks_via_server
    load_ms = []

    def observed(self, state):
        obs = observe(self, state)
        at = (state.scene, state.node, state.rot)
        for kind in ("rgb", "depth"):
            wrong.add_((obs[kind] != want[kind][at]).flatten(1).any(1).sum())
        seen["observations"] += 1
        seen["frames"] += int(state.node.shape[0])
        return obs

    def timed_load(*args):
        t0 = time.perf_counter()
        load(*args)
        torch.cuda.synchronize()
        load_ms.append((time.perf_counter() - t0) * 1e3)

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    cfg = get_config(SAVI_YAML, opts=["TASK_CONFIG.DATASET.FRAME_CACHE_DIR", root])
    BatchedAudioNavEnv._observe, builder._load_frame_banks_via_server = observed, timed_load
    try:
        t0 = time.perf_counter()
        trainer = SaviTrainer(cfg, device=dev)
        trainer._setup()
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        _, batch = trainer.collect()
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        collect_launches = {k: fn.launches for k, fn in wrappers.items()}
        for fn in wrappers.values():
            fn.launches = 0
        t0 = time.perf_counter()
        stats = {k: v.item() for k, v in trainer.update(batch).items()}
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
        update_launches = {k: fn.launches for k, fn in wrappers.items()}
    finally:
        BatchedAudioNavEnv._observe, builder._load_frame_banks_via_server = observe, load
    env = trainer.env
    tables = env.scene_tables
    bank_equal = {}
    for kind in ("rgb", "depth"):
        got = getattr(env.bank, kind)
        ok = tuple(got.shape[-3:]) == tuple(want[kind].shape[-3:]) and got.device == want[kind].device
        for i, t in enumerate(tables):
            ok = ok and torch.equal(got[i, : t.num_nodes], want[kind][i, : t.num_nodes])
            ok = ok and not bool(got[i, t.num_nodes:].any())
        bank_equal[kind] = ok
    t_steps, b = trainer.num_steps, env.num_envs
    ppo_cfg = trainer.ppo_cfg
    chunk = ring_eval_chunk(cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, t_steps)
    want_update = ppo_cfg.ppo_epoch * min(ppo_cfg.num_mini_batch, b) * (t_steps // chunk)
    fields = dict(
        nvidia_smi=smi, config=SAVI_YAML, cache_args=list(FRAME_CACHE_ARGS), files=files,
        bank_bytes=sum(files.values()), write_s=write_s, load_ms=load_ms,
        scene_nodes=[t.num_nodes for t in tables], bank_nodes=bank_nodes,
        frame_shape=list(env.bank.rgb.shape[-3:]), depth_shape=list(env.bank.depth.shape[-3:]),
        num_envs=b, num_steps=t_steps, setup_s=setup_s, collect_s=collect_s, env_steps_per_s=t_steps * b / collect_s,
        update_ms=update_s * 1e3, train_env_steps_per_s=t_steps * b / (collect_s + update_s),
        observations_checked=seen["observations"], frames_checked=seen["frames"], frames_wrong=int(wrong),
        bank_equal=bank_equal, collect_launches=collect_launches, update_launches=update_launches,
        want_update_smt_launches=want_update, stats=stats)
    del trainer, env, batch
    torch.cuda.empty_cache()
    emit("frame_cache_savi", **fields)
    if not all(bank_equal.values()) or fields["frames_wrong"] or seen["observations"] < t_steps + 1:
        raise AssertionError(f"frame_cache_savi: bank equal {bank_equal}, {fields['frames_wrong']} of "
                             f"{seen['frames']} observed frames differ from the files' over {seen['observations']}")
    if collect_launches != {k: t_steps + 1 for k in collect_launches}:
        raise AssertionError(f"frame_cache_savi: setup + collect launches {collect_launches}, want {t_steps + 1} each")
    if update_launches != {"smt_encode": want_update, "partial_irfft": 0, "spectrogram": 0}:
        raise AssertionError(f"frame_cache_savi: update launches {update_launches}, want {want_update} SMT")
    if len(load_ms) != 1 or not all(math.isfinite(v) for v in stats.values()):
        raise AssertionError(f"frame_cache_savi: {len(load_ms)} bank loads, stats {stats}")
    return {k: collect_launches[k] + update_launches[k] for k in collect_launches}


VLN_PRETRAIN_UPDATES = 2


def run_vln_dialog(smi: str, goal_ckpt: str, belief_ckpt: str, speaker_ckpt: str, root: str = VLN_DIR):
    """``vln_dialog``: VLN alignment → π_l pretraining → AVLEN stage 1 on the
    reference tree, through ``run.main`` at full width. A copy of the tree
    (under ``root``) gets ``write_r2r_fixtures``' FGR2R / VLN-CE /
    connectivity files, aligned by the port's ``generate_dialog_dataset``
    (min_path_len VLN_MIN_PATH_LEN) into its dialog_approx split; with
    ``dialog_overrides`` (every RIR from the host store, no spectrogram
    bank) and that split's data path: (a) savi_pretraining_dialog_training.
    yaml (8 envs, CLIP 512 x 12, d_model 256), VLN_PRETRAIN_UPDATES updates
    and one ``vln/ckpt``; (b) savi_interactive_1st_stage.yaml (6 envs, memory
    150, the shipped neural speaker) from π_g (``goal_ckpt``: SAVi trained on
    the same tree, as reference_train_savi writes it; a π_g's audio encoder
    is sized by the spectrogram, so one trained at 16 kHz does not load at
    the tree's 4 kHz), the belief predictor and (a)'s π_l: train 2 updates
    → resume (ckpt.1 exactly) → train 1 → eval of every episode. Fails
    unless the alignment gives VLN_EPISODES episodes, every pretraining step
    serves each episode's dataset ``sub_instr`` tokens, the CE is finite at
    the first and last update, the resume is exact, each run launched every
    kernel as its config implies (by shape), and the kernel checks cover
    every launch shape."""
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.data.reference import HostRIRStore
    from avlen_tpu_torch.rl.rollout_smt import ring_eval_chunk
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer as Trainer
    from avlen_tpu_torch.sim.env import BatchedAudioNavEnv
    from avlen_tpu_torch.utils.checkpoint import list_checkpoints, load_checkpoint
    from avlen_tpu_torch.utils.tb import read_scalars

    root = os.path.abspath(root)
    tree = copy_reference_tree(root)
    data_path, counts, align_s = align_reference_dialog(tree)
    overrides = dialog_overrides(tree, data_path)
    fields = dict(nvidia_smi=smi, overrides=dialog_overrides("<tree>", "<aligned>/dataset.json.gz"),
                  aligned=dict(counts=counts, seconds=align_s, min_path_len=VLN_MIN_PATH_LEN,
                               cut="min_path_len 7 -> 2: the 2x2 tree has no path of 7 nodes"))
    if counts != {VLN_SCAN: VLN_EPISODES}:
        raise AssertionError(f"vln_dialog: aligned {counts}, the CPU aligns {VLN_EPISODES} from these files")
    _, fft_len, _, sr = REFERENCE_AUDIO["reference_4k"]  # the tree's irfft length and 1 s of 4 kHz audio
    wrappers = _kernel_wrappers()

    def counted(name, fn):
        for w in wrappers.values():
            w.launches = 0
        with launch_shapes() as shapes, host_rir_profile() as prof:
            t0 = time.perf_counter()
            tr = fn()
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
        # one host gather a step (the reset's included): the run's steps
        part = dict(seconds=seconds, setup_s=tr.setup_seconds, num_envs=tr.env.num_envs,
                    store=type(tr.env.bank.rir).__name__, host_rir=host_rir_fields(prof, prof.get("calls", 0)),
                    launches={k: w.launches for k, w in wrappers.items()}, shapes=_shape_counts(shapes))
        if not isinstance(tr.env.bank.rir, HostRIRStore):
            raise AssertionError(f"vln_dialog {name}: bank.rir is a {part['store']}")
        return tr, part, shapes

    covered = avlen_checked_shapes()

    def expect(name, shapes, want):
        bad = {k: dict(shapes[k]) for k, w in want.items() if dict(shapes[k]) != w}
        if bad:
            raise AssertionError(f"vln_dialog {name}: kernel launches {bad}, want {want}")
        unchecked = {k: sorted(set(shapes[k]) - covered[k]) for k in covered if set(shapes[k]) - covered[k]}
        if unchecked:
            raise AssertionError(f"vln_dialog {name}: launch shapes no kernel check covers: {unchecked}")

    # (a) π_l pretraining on the aligned dataset's own instructions
    served = dict(steps=0, dataset_rows=0, wrong=0, speaker_differs=0)
    states = []
    step, update_dialog = BatchedAudioNavEnv.step, Trainer.update_dialog

    def logged_step(self, state, actions, query=None, consts=None):
        if query is None:  # the dialog rollout's no-query steps
            states.append(state)
        return step(self, state, actions, query, consts)

    def checked_update_dialog(self, traj, replay_only=False, **kw):
        t_steps = traj["dialog"].shape[0]
        eps = torch.stack([s.ep_i for s in states[-t_steps:]])
        rows = self.sub_instr_bank[eps]
        has = (rows != 0).any(-1)
        served["steps"] += t_steps
        served["dataset_rows"] += int(has.sum())
        served["wrong"] += int(((traj["dialog"] != rows).any(-1) & has).sum())
        if self.instr_bank is not None:
            spk = torch.stack([self.instr_bank[s.scene, s.node, s.rot, s.goal_node] for s in states[-t_steps:]])
            served["speaker_differs"] += int(((spk != rows).any(-1) & has).sum())
        return update_dialog(self, traj, replay_only, **kw)

    pre_dir = os.path.join(root, "pretrain")
    shutil.rmtree(pre_dir, ignore_errors=True)
    BatchedAudioNavEnv.step, Trainer.update_dialog = logged_step, checked_update_dialog
    try:
        tr, part, shapes = counted("pretrain", lambda: run.main(
            ["--run-type", "train", "--exp-config", DIALOG_YAML, "--model-dir", pre_dir, *overrides,
             "NUM_UPDATES_DIALOG", str(VLN_PRETRAIN_UPDATES), "CHECKPOINT_INTERVAL_DIALOG",
             str(VLN_PRETRAIN_UPDATES)]))
    finally:
        BatchedAudioNavEnv.step, Trainer.update_dialog = step, update_dialog
    cfg = tr.config
    n, b, t_steps, m = tr.num_updates_done, tr.env.num_envs, tr.num_steps, cfg.NUM_DIALOG_STEPS
    totals = dict(tr.timings.totals)
    vln_ckpt = os.path.join(pre_dir, "data", "vln", "ckpt.0.pth")
    episodes = tr.env.episodes
    fields["pretrain"] = dict(
        part, config=DIALOG_YAML, updates=n, num_steps=t_steps, d_model=cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size,
        clip_width=cfg.RL.PPO.CLIP_WIDTH, clip_layers=cfg.RL.PPO.CLIP_LAYERS,
        episodes=[dict(sub_instr=e.sub_instr, start=e.start_node, rot=e.start_rot_idx, goal=e.goal_node,
                       dialog_node=e.dialog_node) for e in episodes],
        sub_instr_rows=int((tr.sub_instr_bank != 0).any(-1).sum()) if tr.sub_instr_bank is not None else 0,
        instructions="bank" if tr.instr_source is None else "host speaker", served=served,
        ms_per_update=totals["superstep_time"] * 1e3 / n, env_steps_per_s=tr.num_steps_done / tr.train_seconds,
        dialog_loss_first=tr.dialog_losses[0], dialog_loss_last=tr.dialog_losses[-1],
        checkpoint_bytes=os.path.getsize(vln_ckpt))
    chunk = ring_eval_chunk(cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, t_steps)
    losses, width = tr.dialog_losses, tr.goal_policy.net.feature_size + 12  # 288 at d_model 256
    del tr
    torch.cuda.empty_cache()
    expect("pretrain", shapes, {
        "smt_encode": {(b, m + 1, width): n * t_steps, (chunk * b, m + 1, width): n * (t_steps // chunk)},
        "partial_irfft": {(b, 2, fft_len): n * t_steps + 1}, "spectrogram": {(b, 2, sr): n * t_steps + 1}})
    pre = fields["pretrain"]
    if pre["sub_instr_rows"] != VLN_EPISODES or len(episodes) != VLN_EPISODES:
        raise AssertionError(f"vln_dialog pretrain: {pre['sub_instr_rows']} sub_instr rows of {len(episodes)}")
    if served["steps"] != n * t_steps or served["dataset_rows"] != n * t_steps * b or served["wrong"]:
        raise AssertionError(f"vln_dialog pretrain: served {served} over {n} updates of {t_steps} x {b}")
    if len(losses) != n or not all(math.isfinite(v) for v in losses):
        raise AssertionError(f"vln_dialog pretrain: CE {losses}")

    # (b) AVLEN stage 1 from the aligned tree: train 2 → resume → train 1 → eval
    model_dir = os.path.join(root, "avlen")
    shutil.rmtree(model_dir, ignore_errors=True)
    data = os.path.join(model_dir, "data")
    opts = ["SPEAKER.CKPT_PATH", speaker_ckpt, "GOAL_CKPT_PATH", goal_ckpt, "VLN_CKPT_PATH", vln_ckpt,
            "RL.PPO.BELIEF_PREDICTOR.pretrained_path", belief_ckpt, "SPEAKER.BANK_MODE", "bank"]

    def main(*args, run_type="train"):
        return run.main(["--run-type", run_type, "--exp-config", INTERACTIVE_STAGE1, "--model-dir", model_dir,
                         *overrides, *opts, *args])

    def stage_fields(tr, part):
        totals = dict(tr.timings.totals)
        return dict(part, updates=tr.num_updates_done, num_steps=tr.num_steps, memory_size=tr.memory_size,
                    loaded=sorted(tr.loaded), instructions="bank" if tr.instr_source is None else "host speaker",
                    speaker=tr.config.SPEAKER.BACKEND, sub_instr_rows=int((tr.sub_instr_bank != 0).any(-1).sum()),
                    ms_per_update=totals["superstep_time"] * 1e3 / tr.num_updates_done,
                    env_steps_per_s=tr.num_updates_done * tr.num_steps * tr.env.num_envs / tr.train_seconds,
                    checkpoint_bytes=os.path.getsize(list_checkpoints(data)[-1]))

    def stage_want(tr, updates: int):
        bb, t, mem, chunk_q = tr.env.num_envs, tr.num_steps, tr.memory_size, ring_eval_chunk(
            tr.config.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk, tr.num_steps)
        num_mb = min(tr.ppo_cfg.num_mini_batch, bb)
        q_rows = chunk_q * (bb // num_mb)
        g, q = tr.goal_policy.net.feature_size + 12, tr.option_policy.net.feature_size + 12  # 288, 320
        act = updates * t + 1  # and the first collect's reset observation
        # a step: π_g, π_q and π_l once each; π_q's bootstrap once a collect;
        # π_q's update ppo_epoch x minibatches x T/chunk times; no π_l update
        return {"smt_encode": {(bb, mem + 1, g): updates * t, (bb, mem + 1, q): updates * (t + 1),
                               (bb, tr.config.NUM_DIALOG_STEPS + 1, g): updates * t,
                               (q_rows, mem + 1, q): updates * tr.ppo_cfg.ppo_epoch * num_mb * (t // chunk_q)},
                "partial_irfft": {(bb, 2, fft_len): act}, "spectrogram": {(bb, 2, sr): act}}

    stats, update = [], Trainer.update

    def recorded_update(self, traj, perms=None, **kw):
        out = update(self, traj, perms, **kw)
        stats.append({k: v.item() for k, v in out.items()})
        return out

    Trainer.update = recorded_update
    try:
        tr, part, shapes = counted("stage1", lambda: main("NUM_UPDATES", "2", "CHECKPOINT_INTERVAL", "1"))
    finally:
        Trainer.update = update
    fields["stage1"] = dict(stage_fields(tr, part), stats=stats[:])
    want1 = stage_want(tr, 2)
    del tr
    torch.cuda.empty_cache()
    expect("stage1", shapes, want1)
    saved = load_checkpoint(os.path.join(data, "ckpt.1.pth"))
    checked = {}
    collect = Trainer.collect

    def first_collect(self, *args, **kwargs):
        if not checked:
            checked.update(state_differences(self, saved))
            checked["num_steps_done"] = self.num_steps_done
        return collect(self, *args, **kwargs)

    Trainer.collect, Trainer.update = first_collect, recorded_update
    try:
        tr, part, shapes = counted("resume", lambda: main("NUM_UPDATES", "1", "RESUME_CHECKPOINT", "True"))
    finally:
        Trainer.collect, Trainer.update = collect, update
    fields["resume"] = dict(stage_fields(tr, part), stats=stats[2:], restored_max_abs_diff=checked,
                            ckpt2_written=os.path.isfile(os.path.join(data, "ckpt.2.pth")))
    want_steps = int(saved["extra_state"]["step"])
    want2 = stage_want(tr, 1)
    del tr, saved
    torch.cuda.empty_cache()
    expect("resume", shapes, want2)
    with eval_videos_recorded() as rec:
        ev, part, shapes = counted("eval", lambda: main("USE_LAST_CKPT", "True", "EVAL.SPLIT", "train",
                                                       "TEST_EPISODE_COUNT", str(VLN_EPISODES), run_type="eval"))
    expect("eval", shapes, {})
    ids = ev._last_eval_episode_ids
    scalars = {k: v[-1][1] for k, v in read_scalars(os.path.join(model_dir, "tb")).items() if k.startswith("val/")}
    fields["eval"] = dict(part, episodes=len(ids), distinct_ids=len(set(ids)),
                          episodes_evaluated=scalars.get("val/episodes_evaluated"),
                          success=scalars.get("val/success"), spl=scalars.get("val/spl"),
                          videos=video_report(ev.config, rec))
    del ev
    torch.cuda.empty_cache()
    launches = {k: sum(fields[p]["launches"][k] for p in ("pretrain", "stage1", "resume", "eval")) for k in wrappers}
    fields["launches"] = launches
    emit("vln_dialog", **fields)
    s1 = fields["stage1"]
    if (s1["loaded"], s1["speaker"], s1["sub_instr_rows"]) != (["belief", "dialog", "goal"], "neural", VLN_EPISODES):
        raise AssertionError(f"vln_dialog stage1: loaded {s1['loaded']}, speaker {s1['speaker']}, "
                             f"{s1['sub_instr_rows']} sub_instr rows")
    if checked.get("num_steps_done") != want_steps or any(v != 0 for k, v in checked.items() if k != "num_steps_done"):
        raise AssertionError(f"vln_dialog: resume did not restore ckpt.1 exactly: {checked}")
    if not fields["resume"]["ckpt2_written"]:
        raise AssertionError("vln_dialog: the resumed run wrote no ckpt.2")
    e = fields["eval"]
    if not e["episodes"] == e["distinct_ids"] == e["episodes_evaluated"] == VLN_EPISODES:
        raise AssertionError(f"vln_dialog eval: {e}")
    check_videos("vln_dialog eval", e["videos"])
    for p in ("stage1", "resume"):
        if not all(math.isfinite(v) for v in fields[p].values() if isinstance(v, float)):
            raise AssertionError(f"vln_dialog {p}: non-finite readings {fields[p]}")
    if len(stats) != 3 or not all(math.isfinite(v) for st in stats for v in st.values()):
        raise AssertionError(f"vln_dialog: π_q's update stats {stats}")
    if not all(launches.values()):
        raise AssertionError(f"vln_dialog: a kernel never launched: {launches}")
    return launches


AUX_DIR = "build/chip_smoke_aux"  # the CLIs' inputs and outputs of the aux_modules phase
AUX_BENCH_STEPS = 120  # benchmark_agent's batched steps on savi.yaml (at least 100)
AUX_VENV_STEPS = 20
AUX_PAUSED = (5, 15)  # the facade's slot AUX_PAUSED_SLOT is paused over steps [5, 15)
AUX_PAUSED_SLOT = 3
AUX_CHALLENGE_EPISODES = 3
# ≥ 10 demo keys: turns, moves, an unknown key, STOP (which ends an
# episode) and moves in the next episode
AUX_DEMO_KEYS = ("d", "w", "w", "a", "x", "w", "d", "w", "s", "w", "a", "w", "w", "q")
AUX_AMBI_TOL = 1e-6  # the binaural decode, card against CPU, abs
AUX_DEMO_AUDIO_TOL = 1e-5  # the demo's audio, card against CPU, × its peak
AUX_SPEAKER_ARGS = ("--steps", "2", "--scenes", "1", "--side", "4", "--num-paths", "16")


class ObservedOracleAgent:
    """A challenge agent that acts on its observations alone: it follows the
    ORACLE_ACTION_SENSOR reading (savi.yaml's task has that sensor)."""

    def reset(self):
        pass

    def act(self, observations):
        return int(observations["oracle_action"][0])


def _demo_run(device: str, record: str):
    """The port's interactive demo on ``device``, its keys AUX_DEMO_KEYS
    from a patched ``input``: (stdout lines, frames, audio, the kernels'
    launches). The recorder writes its GIF + WAV as well."""
    import builtins
    import io

    import numpy as np

    from avlen_tpu_torch.scripts import interactive_demo

    wrappers = _kernel_wrappers()
    feed = iter(AUX_DEMO_KEYS)
    rec = {}
    writer, ask, out = interactive_demo.images_to_video_with_audio, builtins.input, sys.stdout

    def capture(path, images, audio, sampling_rate=16000, fps=10):
        rec.update(images=[np.array(i) for i in images], audio=np.array(audio))
        return writer(path, images, audio, sampling_rate, fps)

    for fn in wrappers.values():
        fn.launches = 0
    text = io.StringIO()
    interactive_demo.images_to_video_with_audio, builtins.input = capture, (lambda prompt="": next(feed))
    sys.stdout = text
    try:
        interactive_demo.main(["--record", record, "--device", device])
    finally:
        interactive_demo.images_to_video_with_audio, builtins.input, sys.stdout = writer, ask, out
    launches = {k: fn.launches for k, fn in wrappers.items()}
    return text.getvalue().splitlines(), rec["images"], rec["audio"], launches


def _eval_speaker_run(device: str, output: str, params=None):
    """``eval_speaker.main`` on ``device`` at AUX_SPEAKER_ARGS: (the JSON it
    wrote, its greedy decodes, the speaker's parameters). With ``params``
    (train_speaker's return of another run) it decodes those in place of
    its own training."""
    from avlen_tpu_torch.dialog.speaker import eval_speaker as lib
    from avlen_tpu_torch.scripts import eval_speaker

    trained, decodes = {}, []
    train, score = eval_speaker.train_speaker, lib.evaluate_speaker

    def record_train(*a, **k):
        trained["out"] = params if params is not None else train(*a, **k)
        return trained["out"]

    def record_decodes(speaker, items, refs, **kw):
        decodes.extend(o["words"] for o in speaker.generate_instr(items))
        return score(speaker, items, refs, **kw)

    eval_speaker.train_speaker, lib.evaluate_speaker = record_train, record_decodes
    try:
        eval_speaker.main([*AUX_SPEAKER_ARGS, "--output", output, "--device", device])
    finally:
        eval_speaker.train_speaker, lib.evaluate_speaker = train, score
    with open(output) as f:
        return json.load(f), decodes, trained["out"]


def run_aux_modules(dev, smi: str, root: str = AUX_DIR):
    """``aux_modules``: the port's small modules and offline CLIs on the card.

    (a) the sm_90a gate passes; (b) ``benchmark_agent(GoalFollower())`` on
    savi.yaml's world uncut (16 envs, 2 scenes, no spectrogram bank: both
    audio kernels run every step) for AUX_BENCH_STEPS steps: success 1.0,
    env-steps/s, each kernel's launches (one a step and one for the reset),
    the first step's audio rows against the plain versions (irfft 1e-5 ×
    peak, spectrogram 1e-4); (c) the ``VectorEnv`` facade over the same env
    for AUX_VENV_STEPS oracle steps with slot AUX_PAUSED_SLOT paused over
    AUX_PAUSED: its EnvState bit-equal across the pause, the AVLEN RPCs equal
    to the batched env's; (d) ``Benchmark.local_evaluate`` of an agent that
    acts on its observations over AUX_CHALLENGE_EPISODES episodes of a
    1-env savi.yaml env, then ``remote_evaluate`` through an
    ``EvaluationServer`` on localhost: the same metrics (where grpc is not
    installed, a line says the remote half was not run); (e) the CLIs on the
    card against the CPU: the binaural decode within 1e-6, the demo's frames
    exact and its audio within 1e-5 × peak on AUX_DEMO_KEYS, eval_speaker's
    JSON keys (and, with the CPU's parameters, its JSON and decodes), and
    ``QuesGen``'s ids at hidden 32. Returns each kernel's launches by part."""
    import numpy as np
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.core.challenge import Benchmark, EvaluationServer
    from avlen_tpu_torch.core.vector_env import VectorEnv
    from avlen_tpu_torch.dialog.ques_gen import QuesGen, ques_vocabulary
    from avlen_tpu_torch.scripts import ambisonic_to_binaural
    from avlen_tpu_torch.sim.builder import construct_batched_env
    from avlen_tpu_torch.sim.simple_agents import GoalFollower, benchmark_agent
    from avlen_tpu_torch.utils.platform import require_sm90a

    t_phase = time.perf_counter()
    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    wrappers = _kernel_wrappers()
    audio_kernels = ("partial_irfft", "spectrogram")
    launches = {}

    def zero():
        for fn in wrappers.values():
            fn.launches = 0

    def counts():
        return {k: fn.launches for k, fn in wrappers.items()}

    # (a) the gate
    require_sm90a(dev)
    fields = dict(nvidia_smi=smi, capability=list(torch.cuda.get_device_capability(dev)))

    # (b) benchmark_agent(GoalFollower()) on savi.yaml's world
    cfg = get_config(SAVI_YAML)
    t0 = time.perf_counter()
    env = construct_batched_env(cfg, device=dev)
    torch.cuda.synchronize()
    build_s = time.perf_counter() - t0
    b = env.num_envs
    ends = []
    step = env.step

    def counted(state, actions, *a, **k):
        state, out = step(state, actions, *a, **k)
        ends.append(out.done.sum())
        return state, out

    env.step = counted
    zero()
    with first_kernel_inputs(skip=1) as seen:  # the reset's render, then the first step's
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        stats = benchmark_agent(env, GoalFollower(), num_episodes=b * AUX_BENCH_STEPS, max_steps=AUX_BENCH_STEPS)
        torch.cuda.synchronize()
        bench_s = time.perf_counter() - t0
    del env.step
    launches["benchmark_agent"] = counts()
    kernels_at = check_kernels_at(seen)
    steps = len(ends)
    fields["benchmark_agent"] = dict(
        config=SAVI_YAML, num_envs=b, scenes=len(env.scene_tables), spectrogram_bank=env.bank.spec_bank is not None,
        rir_length=env.bank.rir.length, fft_len=env.bank.rir.fft_len, build_s=build_s, steps=steps,
        episodes=int(sum(int(e) for e in ends)), seconds=bench_s, env_steps_per_s=steps * b / bench_s,
        stats=stats, launches=launches["benchmark_agent"], kernels_at_first_step=kernels_at)

    # (c) the VectorEnv facade over the same env
    zero()
    venv = VectorEnv(env)
    venv.reset()
    rpc_ok, frozen, alive_counts = True, None, []
    slot = AUX_PAUSED_SLOT
    for t in range(AUX_VENV_STEPS):
        if t == AUX_PAUSED[0]:
            venv.pause_at(slot)
            before = [f.clone() for f in venv._state]
        if t == AUX_PAUSED[1]:
            frozen = all(torch.equal(old[slot], new[slot]) for old, new in zip(before, venv._state))
            venv.resume_all()
        alive = [i for i in range(b) if i not in venv._paused]
        st = env.agent_state_host(venv._state)
        rpc_ok = rpc_ok and all(
            all(np.array_equal(got[k], st[k][i]) for k in st) for got, i in zip(venv.agent_state(), alive))
        flags = venv._state.new_episode.cpu().numpy()
        rpc_ok = rpc_ok and venv.is_new_episode() == [bool(flags[i]) for i in alive]
        acts = venv.compute_oracle_actions()
        oracle = env.oracle_action(venv._state).cpu().numpy()
        rpc_ok = rpc_ok and acts == [int(oracle[i]) for i in alive]
        alive_counts.append(len(venv.step(acts)))
    torch.cuda.synchronize()
    launches["vector_env"] = counts()
    fields["vector_env"] = dict(steps=AUX_VENV_STEPS, paused_slot=slot, paused_steps=list(AUX_PAUSED),
                                paused_state_frozen=frozen, rpcs_equal=rpc_ok, alive=alive_counts,
                                launches=launches["vector_env"])
    del venv, env
    torch.cuda.empty_cache()

    # (d) the challenge protocol, local then remote
    zero()
    agent = ObservedOracleAgent()
    t0 = time.perf_counter()
    local = Benchmark(config=cfg, device=dev).local_evaluate(agent, AUX_CHALLENGE_EPISODES)
    torch.cuda.synchronize()
    local_s = time.perf_counter() - t0
    remote, remote_s, grpc_version = None, None, None
    try:
        import grpc
    except ImportError as e:
        print(f"aux_modules: grpc is not installed on this machine ({e}); the remote half of the "
              f"challenge was not run", flush=True)
    else:
        grpc_version = grpc.__version__
        t0 = time.perf_counter()
        server = EvaluationServer(cfg, port=0, num_episodes=AUX_CHALLENGE_EPISODES, device=dev).start()
        addr = os.environ.get("EVALENV_ADDPORT")
        os.environ["EVALENV_ADDPORT"] = f"localhost:{server.port}"
        try:
            remote = Benchmark(eval_remote=True).evaluate(agent)
        finally:
            server.stop(0)
            if addr is None:
                del os.environ["EVALENV_ADDPORT"]
            else:
                os.environ["EVALENV_ADDPORT"] = addr
        torch.cuda.synchronize()
        remote_s = time.perf_counter() - t0
    launches["challenge"] = counts()
    fields["challenge"] = dict(episodes=AUX_CHALLENGE_EPISODES, local=local, local_s=local_s, grpc=grpc_version,
                               remote=remote, remote_s=remote_s, submitted=remote is not None,
                               launches=launches["challenge"])
    torch.cuda.empty_cache()

    # (e) the CLIs and QuesGen, card against CPU
    ambi = np.random.RandomState(0).randn(8, 4, 16000).astype(np.float32)
    np.save(os.path.join(root, "ambi.npy"), ambi)
    for device in ("cuda", "cpu"):
        ambisonic_to_binaural.main(["--input", os.path.join(root, "ambi.npy"), "--output",
                                    os.path.join(root, f"binaural_{device}"), "--device", device])
    ambi_err = max(float(np.abs(np.load(os.path.join(root, "binaural_cuda", f"{a}.npy"))
                                - np.load(os.path.join(root, "binaural_cpu", f"{a}.npy"))).max())
                   for a in (0, 90, 180, 270))
    t0 = time.perf_counter()
    text_c, frames_c, audio_c, launches["demo"] = _demo_run("cuda", os.path.join(root, "demo_cuda.gif"))
    demo_s = time.perf_counter() - t0
    text_p, frames_p, audio_p, _ = _demo_run("cpu", os.path.join(root, "demo_cpu.gif"))
    peak = float(np.abs(audio_p).max())
    moves = sum(k in "wads" for k in AUX_DEMO_KEYS)
    demo = dict(keys="".join(AUX_DEMO_KEYS), seconds=demo_s, frames=len(frames_c),
                frames_equal=len(frames_c) == len(frames_p) and all(np.array_equal(x, y)
                                                                    for x, y in zip(frames_c, frames_p)),
                audio_shape=list(audio_c.shape), audio_peak=peak,
                audio_max_abs_err=float(np.abs(audio_c - audio_p).max()) if audio_c.shape == audio_p.shape else None,
                episode_ended="=== episode finished:" in "\n".join(text_c),
                text_equal=[ln for ln in text_c if not ln.startswith("recorded")]
                == [ln for ln in text_p if not ln.startswith("recorded")], launches=launches["demo"],
                files={f: os.path.getsize(os.path.join(root, f)) for f in sorted(os.listdir(root))
                       if f.startswith("demo_")})
    cpu_json, cpu_words, cpu_params = _eval_speaker_run("cpu", os.path.join(root, "speaker_cpu.json"))
    card_json, _, _ = _eval_speaker_run("cuda", os.path.join(root, "speaker_cuda.json"))
    same_json, same_words, _ = _eval_speaker_run("cuda", os.path.join(root, "speaker_cuda_cpu_params.json"),
                                                 params=cpu_params)
    speaker = dict(cpu=cpu_json, cuda=card_json, cuda_with_cpu_params=same_json,
                   keys_equal=list(card_json) == list(cpu_json), json_equal=same_json == cpu_json,
                   decodes=len(cpu_words), decodes_equal=same_words == cpu_words)
    vocab = ques_vocabulary()
    qg = QuesGen(len(vocab), hidden_size=32, max_len=5, generator=torch.Generator().manual_seed(0))
    rgb = torch.as_tensor((np.random.RandomState(1).rand(8, 32, 32, 3) * 255).astype(np.uint8))
    ids_cpu = qg(rgb)
    ids_card = qg.to(dev)(rgb.to(dev)).cpu()
    fields["clis"] = dict(ambisonic_max_abs_err=ambi_err, demo=demo, eval_speaker=speaker,
                          ques_gen=dict(shape=list(ids_cpu.shape), ids_equal=bool(torch.equal(ids_cpu, ids_card))))
    fields["launches"] = launches
    fields["seconds"] = time.perf_counter() - t_phase
    emit("aux_modules", **fields)

    fails = []
    bench = fields["benchmark_agent"]
    if bench["spectrogram_bank"] or stats.get("success") != 1.0 or steps < 100:
        fails.append(f"benchmark_agent: bank {bench['spectrogram_bank']}, success {stats.get('success')}, "
                     f"{steps} steps")
    if launches["benchmark_agent"] != {"smt_encode": 0, **{k: steps + 1 for k in audio_kernels}}:
        fails.append(f"benchmark_agent launches {launches['benchmark_agent']}, want {steps + 1} of each audio kernel")
    if set(kernels_at) != set(audio_kernels) or not all(r["ok"] for r in kernels_at.values()):
        fails.append(f"benchmark_agent: the first step's kernels against their plain versions {kernels_at}")
    if not frozen or not rpc_ok or launches["vector_env"] != {"smt_encode": 0, **{k: AUX_VENV_STEPS + 1
                                                                                 for k in audio_kernels}}:
        fails.append(f"vector_env: frozen {frozen}, RPCs equal {rpc_ok}, launches {launches['vector_env']}")
    if local.get("success") != 1.0 or (remote is not None and remote != local):
        fails.append(f"challenge: local {local}, remote {remote}")
    if not all(launches["challenge"][k] > AUX_CHALLENGE_EPISODES for k in audio_kernels):
        fails.append(f"challenge launches {launches['challenge']}")
    if ambi_err > AUX_AMBI_TOL:
        fails.append(f"ambisonic_to_binaural: card against CPU {ambi_err}")
    if not (demo["frames_equal"] and demo["episode_ended"] and demo["audio_max_abs_err"]
            is not None and demo["audio_max_abs_err"] <= AUX_DEMO_AUDIO_TOL * peak):
        fails.append(f"interactive_demo: {demo}")
    if launches["demo"] != {"smt_encode": 0, **{k: moves + 1 for k in audio_kernels}}:
        fails.append(f"interactive_demo launches {launches['demo']}, want {moves + 1} of each audio kernel")
    if not (speaker["keys_equal"] and speaker["json_equal"] and speaker["decodes_equal"]):
        fails.append(f"eval_speaker: {speaker}")
    if not fields["clis"]["ques_gen"]["ids_equal"]:
        fails.append("ques_gen: card ids differ from the CPU's")
    if fails:
        raise AssertionError("aux_modules: " + "; ".join(fails))
    return {part: {k: c[k] for k in wrappers} for part, c in launches.items()}


PRECISION_BOUND = 0.1  # logits and values: max|low - reference| <= 0.1 * max|reference| (PERF.md §6)
PRECISION_PROFILE_STEPS = 10  # the profiled collect of each precision's convolution split
PRECISION_AVLEN_STEPS = 20  # the AVLEN stage-2 collect at each precision
PRECISION_AGAIN_STEPS = 60  # the second timed SAVi collect at each precision
# each kernel against its plain version on the bf16 path's own inputs, the
# limits of the kernel phase: SMT abs, irfft relative to the output's peak,
# spectrogram abs
PRECISION_KERNEL_TOL = {"smt_encode": 1e-4, "partial_irfft": 1e-5, "spectrogram": 1e-4}


@contextlib.contextmanager
def first_kernel_inputs(skip: int = 0):
    """Within the block, clones of the inputs of each kernel's first launch
    after its first ``skip``: {"smt_encode": (entries, valid, goal, weights,
    nhead), "partial_irfft": (spec, fft_len, out_start, out_len),
    "spectrogram": (audio, config)}, for the kernels the block launches.
    The launches themselves and their counts are untouched."""
    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

    seen = {}
    calls = collections.Counter()
    irfft_launch, spec_launch = irfft_cuda._launch, spectrogram_cuda._launch

    def keep(name, args):
        calls[name] += 1
        if name not in seen and calls[name] > skip:
            seen[name] = tuple(a.clone() if hasattr(a, "clone") else
                               [w.detach().clone() for w in a] if isinstance(a, (list, tuple)) else a for a in args)

    def irfft(*args):
        keep("partial_irfft", args)
        return irfft_launch(*args)

    def spectro(*args):
        keep("spectrogram", args)
        return spec_launch(*args)

    def smt(launch):
        def run(*args):
            keep("smt_encode", args)
            return launch(*args)

        return run

    irfft_cuda._launch, spectrogram_cuda._launch = irfft, spectro
    try:
        with smt_cuda.wrapped_passes(smt, lambda backward: backward):
            yield seen
    finally:
        irfft_cuda._launch, spectrogram_cuda._launch = irfft_launch, spec_launch


def check_kernels_at(seen):
    """Each captured kernel against its plain version on its inputs
    (``check_kernel_input``)."""
    return {name: check_kernel_input(name, args) for name, args in seen.items()}


def profile_collect(trainer, steps: int = PRECISION_PROFILE_STEPS, sessions: int = 3):
    """One collect of ``steps`` steps under ``torch.profiler``: device ms a
    step by kernel family (``scripts/profile_torch_rollout.family``), device
    busy ms a step and the idle share of the window. A session that sees no
    device event (it happens, PERF.md §7) is taken again, up to
    ``sessions`` in all."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    from scripts.profile_torch_rollout import family

    for attempt in range(sessions):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            trainer.collect(n=steps)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
        fams, intervals = collections.Counter(), []
        for ev in prof.events():
            dt = getattr(ev, "device_type", None)
            if dt is not None and "CUDA" in str(dt) and ev.time_range.elapsed_us() > 0 \
                    and not ev.name.startswith("Mem"):
                fams[family(ev.name)] += ev.time_range.elapsed_us()
                intervals.append((ev.time_range.start, ev.time_range.end))
        if intervals:
            break
        print(f"profile_collect: session {attempt + 1} saw no device event", file=sys.stderr, flush=True)
    else:
        raise AssertionError(f"precision: {sessions} profiler sessions saw no device event")
    intervals.sort()
    busy, cur_s, cur_e = 0.0, None, None
    for s, e in intervals:
        if cur_e is None or s > cur_e:
            busy += 0.0 if cur_e is None else cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    return dict(steps=steps, host_ms_per_step=wall * 1e3 / steps, device_busy_ms_per_step=busy / 1e3 / steps,
                device_idle_share=1.0 - busy / 1e6 / wall,
                device_ms_per_step_by_family={k: v / 1e3 / steps for k, v in fams.most_common()})


def policy_outputs(trainer, batch):
    """(logits, values) of every step of ``batch`` under the trainer's
    policy: the towers recomputed at its precision, the ring views gathered
    from a pool cast to it, the SMT kernel (PPO's re-evaluation path)."""
    import torch

    from avlen_tpu_torch.rl.rollout_smt import evaluate_sequence_smt_batched

    with torch.no_grad():
        values, _, _, logits = evaluate_sequence_smt_batched(
            trainer.policy.evaluate_step, batch.obs, batch.initial_hidden, batch.masks, batch.actions,
            chunk=trainer.config.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk,
            compute_dtype=trainer.compute_dtype())
    return logits, values


def share_of_peak(got, want) -> float:
    """max|got - want| / max|want|."""
    return ((got.float().cpu() - want.float().cpu()).abs().max() / want.float().cpu().abs().max()).item()


def check_precision_reference(dev, n: int = 8):
    """The tiny world at bfloat16 (with savi.yaml's 64 px frames: on 16-32
    px frames the towers' last GroupNorms see a handful of values each and
    magnify any rounding), the card against the CPU: the CPU's rollout
    re-evaluated on both devices from the same weights, logits and values
    within PRECISION_BOUND of the CPU's peak."""
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    cfg = tiny_config(extra=("TPU.PRECISION", "bfloat16", "TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES", "64"))
    ref_tr, got_tr = SaviTrainer(cfg, device="cpu"), SaviTrainer(cfg, device=dev)
    ref_tr._setup()
    got_tr._setup()
    _, batch = ref_tr.collect(n=n)
    ref, got = policy_outputs(ref_tr, batch), policy_outputs(got_tr, batch.to(dev))
    return {"logits_share_of_peak": share_of_peak(got[0], ref[0]),
            "values_share_of_peak": share_of_peak(got[1], ref[1]), "steps": n}


def _finite(stats) -> bool:
    return all(math.isfinite(float(v)) for v in stats.values())


def _savi_round(trainer, capture: bool = False, between=None):
    """One timed collect and update of a set-up SAVi trainer, every
    kernel's launches counted from zero over the two; with ``capture`` the
    kernels' first inputs too; ``between(batch)`` runs after the collect,
    before the update, untimed and uncounted."""
    import torch

    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    torch.cuda.reset_peak_memory_stats()
    with first_kernel_inputs() if capture else contextlib.nullcontext({}) as seen:
        t0 = time.perf_counter()
        _, batch = trainer.collect()
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        if between is not None:
            counts = {k: fn.launches for k, fn in wrappers.items()}
            between(batch)
            for k, fn in wrappers.items():
                fn.launches = counts[k]
        t0 = time.perf_counter()
        stats = {k: v.item() for k, v in trainer.update(batch).items()}
        torch.cuda.synchronize()
        update_s = time.perf_counter() - t0
    t_steps, b = batch.actions.shape
    return dict(steps=t_steps, envs=b, collect_s=collect_s, collect_env_steps_per_s=t_steps * b / collect_s, update_ms=update_s * 1e3,
                train_env_steps_per_s=t_steps * b / (collect_s + update_s), stats=stats,
                launches={k: fn.launches for k, fn in wrappers.items()},
                peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30), batch, seen


def run_precision(dev, smi: str, goal_ckpt: str, belief_ckpt: str, speaker_ckpt: str):
    """TPU.PRECISION on the card (phase ``precision``). SAVi at savi.yaml's
    full width: a float32 and a bfloat16 trainer from the same seed (equal
    weights), each warmed up by 5 steps, then one collect of 150 steps and
    one update each (env-steps/s, update ms, peak memory, every kernel's
    launches), a second timed collect of 60 steps each in the other order
    (bf16 first), then a profiled 10-step collect each (device ms a step by
    kernel family, convolutions among them; busy ms, idle share). Before
    the updates the float32 collect is re-evaluated by both policies (towers
    recomputed, ring pool cast): logits and values at bfloat16 within
    PRECISION_BOUND of float32's peak; the tiny world's bf16 rollout, card
    against CPU, within the same bound. Each kernel against its plain
    version on the inputs of its first bf16 launch. One float16 SAVi
    collect + update (finite losses, no loss scaling, as JAX). At bfloat16:
    one AVLEN stage-2 collect of PRECISION_AVLEN_STEPS steps
    (savi_interactive_2nd_stage.yaml, 6 envs, CLIP 512 x 12 and the dialog
    encoder, the neural speaker per query) and one AV-Nav collect + update
    (audiogoal_depth.yaml, its bank rendered at setup), each beside the
    same run at float32 and after a short warm-up collect. Returns each
    run's kernel launches."""
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.rl.trainers.avnav import AVNavTrainer
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    t_phase = time.perf_counter()
    trainers, fields = {}, {"nvidia_smi": smi, "config": SAVI_YAML, "bound": PRECISION_BOUND}
    for prec in ("float32", "bfloat16"):
        t0 = time.perf_counter()
        tr = SaviTrainer(get_config(SAVI_YAML, opts=["TPU.PRECISION", prec]), device=dev)
        tr._setup()
        tr.collect(n=5)  # warm-up: cuDNN's algorithm choice, the allocator
        torch.cuda.synchronize()
        trainers[prec] = (tr, time.perf_counter() - t0)
    f32, low = trainers["float32"][0], trainers["bfloat16"][0]
    same = all(torch.equal(a, b) for a, b in zip(f32.policy.state_dict().values(), low.policy.state_dict().values()))

    def compare(batch):  # the float32 collect, before either update: equal weights
        ref, got = policy_outputs(f32, batch), policy_outputs(low, batch)
        fields["bf16_vs_f32"] = {"logits_share_of_peak": share_of_peak(got[0], ref[0]),
                                 "values_share_of_peak": share_of_peak(got[1], ref[1]),
                                 "rows": int(batch.actions.numel()), "weights_equal": same}

    runs, seen = {}, {}
    for prec, (tr, setup_s) in trainers.items():
        run, _, captured = _savi_round(tr, capture=prec == "bfloat16",
                                       between=compare if prec == "float32" else None)
        seen.update(captured)
        run["setup_and_warmup_s"] = setup_s
        runs[prec] = run
    for prec in ("bfloat16", "float32"):  # a second collect each, in the other order: the host's pace spreads
        tr = trainers[prec][0]
        t0 = time.perf_counter()
        tr.collect(n=PRECISION_AGAIN_STEPS)
        torch.cuda.synchronize()
        runs[prec]["collect_env_steps_per_s_again"] = (PRECISION_AGAIN_STEPS * tr.env.num_envs
                                                       / (time.perf_counter() - t0))
    for prec, (tr, _) in trainers.items():  # after the timed runs: a profiler session can slow what follows it
        runs[prec]["profile"] = profile_collect(tr)
    del trainers, f32, low, tr
    torch.cuda.empty_cache()
    fields["bf16_cpu_vs_card"] = check_precision_reference(dev)
    fields["kernels_at_bf16_inputs"] = check_kernels_at(seen)

    tr = SaviTrainer(get_config(SAVI_YAML, opts=["TPU.PRECISION", "float16"]), device=dev)
    tr._setup()
    tr.collect(n=5)
    runs["float16"] = _savi_round(tr)[0]
    del tr
    torch.cuda.empty_cache()

    wrappers = _kernel_wrappers()
    for prec in ("float32", "bfloat16"):
        tr = InteractiveDDPPOTrainer(get_config(INTERACTIVE_STAGE2, opts=[
            "SPEAKER.CKPT_PATH", speaker_ckpt, "GOAL_CKPT_PATH", goal_ckpt,
            "RL.PPO.BELIEF_PREDICTOR.pretrained_path", belief_ckpt, "RESUME_CHECKPOINT", "False",
            "TPU.PRECISION", prec]), device=dev)
        tr._setup()
        tr.collect(n=3)
        for fn in wrappers.values():
            fn.launches = 0
        clip0 = tr.clip_calls
        t0 = time.perf_counter()
        _, traj = tr.collect(n=PRECISION_AVLEN_STEPS)
        torch.cuda.synchronize()
        runs[f"avlen_{prec}"] = dict(_traj_summary(traj, time.perf_counter() - t0),
                                     clip_calls=tr.clip_calls - clip0, clip_dtype=str(tr.dialog_policy.net.clip.dtype),
                                     launches={k: fn.launches for k, fn in wrappers.items()})
        del tr, traj
        torch.cuda.empty_cache()

    for prec in ("float32", "bfloat16"):
        for fn in wrappers.values():
            fn.launches = 0
        tr = AVNavTrainer(get_config(AVNAV_YAML, opts=["TPU.PRECISION", prec]), device=dev)
        tr._setup()  # renders the spectrogram bank: the kernels' launches
        tr.collect(n=5)
        t0 = time.perf_counter()
        _, batch = tr.collect()
        torch.cuda.synchronize()
        collect_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        stats = {k: v.item() for k, v in tr.update(batch).items()}
        torch.cuda.synchronize()
        t_steps, b = batch.actions.shape
        runs[f"avnav_{prec}"] = dict(collect_env_steps_per_s=t_steps * b / collect_s,
                                     update_ms=(time.perf_counter() - t0) * 1e3, stats=stats,
                                     launches={k: fn.launches for k, fn in wrappers.items()})
        del tr, batch
        torch.cuda.empty_cache()

    fields["runs"] = runs
    fields["seconds"] = time.perf_counter() - t_phase
    emit("precision", **fields)
    bad = [k for k in ("float32", "bfloat16", "float16", "avnav_float32", "avnav_bfloat16")
           if not _finite(runs[k]["stats"])]
    bad += [k for k in ("avlen_float32", "avlen_bfloat16") if not all(runs[k]["finite"].values())]
    if bad:
        raise AssertionError(f"precision: non-finite losses or outputs in {bad}")
    if not same:
        raise AssertionError("precision: the float32 and bfloat16 trainers' weights differ")
    for key in ("bf16_vs_f32", "bf16_cpu_vs_card"):
        shares = {k: v for k, v in fields[key].items() if k.endswith("share_of_peak")}
        if not all(v <= PRECISION_BOUND for v in shares.values()):
            raise AssertionError(f"precision: {key} {shares} over the bound {PRECISION_BOUND}")
    if set(fields["kernels_at_bf16_inputs"]) != set(_kernel_wrappers()):
        raise AssertionError(f"precision: kernels checked on bf16 inputs {sorted(fields['kernels_at_bf16_inputs'])}")
    off = {k: r for k, r in fields["kernels_at_bf16_inputs"].items() if not r["ok"]}
    if off:
        raise AssertionError(f"precision: kernels disagree with their plain versions on bf16 inputs: {off}")
    for prec in ("float32", "bfloat16", "float16"):  # one launch of each a step at least
        short = {k: n for k, n in runs[prec]["launches"].items() if n < runs[prec]["steps"]}
        if short:
            raise AssertionError(f"precision {prec}: kernels launched fewer than once a step: {short}")
    avlen = runs["avlen_bfloat16"]
    if not all(avlen["launches"].values()) or avlen["clip_dtype"] != "torch.bfloat16" or not avlen["clip_calls"]:
        raise AssertionError(f"precision: AVLEN at bfloat16 {avlen}")
    return {k: r["launches"] for k, r in runs.items()}


DDPPO_DIR = "build/chip_smoke_ddppo"  # the rank files and model dirs of the ddppo phase
DDPPO_TIMEOUT = 420  # seconds a launch may take
DDPPO_PAIR_STEPS = 30  # the NCCL / no-group SAVi pair's rollout (savi.yaml's 150, cut)
# every per-rank launch shape the ddppo phase may give a kernel (as
# launch_shapes keys them); each is held against the plain version in the
# rank that launched it, on its first inputs
DDPPO_SHAPES = {
    # savi.yaml over 2 ranks: 8 envs a rank, memory 150 (151 entries of 288),
    # the update's rows 15 steps x 8 // 2 minibatches; its 1-rank pair at 16
    # envs and 120 rows; AVLEN stage 1 over 2 ranks: 3 envs a rank, π_g's,
    # π_q's and π_l's entries, π_q's update rows 15 x 3 // 2
    "smt_encode": {(8, 151, 288), (60, 151, 288), (16, 151, 288), (120, 151, 288),
                   (3, 151, 288), (3, 151, 320), (3, 4, 288), (15, 151, 320)},
    # 16 kHz rows of 65,536 points; AV-Nav's and AV-WAN's 44.1 kHz bank renders
    "partial_irfft": {(8, 2, 65536), (16, 2, 65536), (3, 2, 65536), (256, 2, 65536), (32, 2, 65536)},
    "spectrogram": {(8, 2, 16000), (16, 2, 16000), (3, 2, 16000), (256, 2, 44100), (32, 2, 44100)},
}
PARITY_DIR = "build/chip_smoke_parity"  # the recipe runner's workdir
PARITY_ARGS = ("--scale", "0.01", "--eval-count", "8", "--seed", "7")


@contextlib.contextmanager
def launch_inputs_by_shape():
    """Within the block, every kernel launch's shape counted (as
    ``launch_shapes`` keys them) and clones of the inputs of the first
    launch of each (kernel, shape): yields (shapes, {(kernel, shape):
    args})."""
    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

    shapes = {k: collections.Counter() for k in ("smt_encode", "partial_irfft", "spectrogram")}
    inputs = {}
    irfft_launch, spec_launch = irfft_cuda._launch, spectrogram_cuda._launch

    def keep(name, shape, args):
        shapes[name][shape] += 1
        if (name, shape) not in inputs:
            inputs[(name, shape)] = tuple(
                a.detach().clone() if hasattr(a, "clone") else
                [w.detach().clone() for w in a] if isinstance(a, (list, tuple)) else a for a in args)

    def irfft(spec, fft_len, out_start, out_len):
        keep("partial_irfft", tuple(spec.shape[:-1]) + (fft_len,), (spec, fft_len, out_start, out_len))
        return irfft_launch(spec, fft_len, out_start, out_len)

    def spectro(audio, config):
        keep("spectrogram", tuple(audio.shape), (audio, config))
        return spec_launch(audio, config)

    def smt(launch):
        def run(entries, *args):
            keep("smt_encode", tuple(entries.shape), (entries, *args))
            return launch(entries, *args)

        return run

    irfft_cuda._launch, spectrogram_cuda._launch = irfft, spectro
    try:
        with smt_cuda.wrapped_passes(smt, lambda backward: backward):
            yield shapes, inputs
    finally:
        irfft_cuda._launch, spectrogram_cuda._launch = irfft_launch, spec_launch


def check_kernel_input(name: str, args) -> dict:
    """One kernel against its plain version on ``args`` (its launch's
    inputs), within PRECISION_KERNEL_TOL (the irfft's × the output's peak)."""
    import torch

    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

    with torch.no_grad():
        if name == "smt_encode":
            entries, valid, goal, weights, nhead = args
            params = dict(zip(smt_cuda.KERNEL_WEIGHTS, weights))
            got = smt_cuda.smt_encode(params, entries, valid, goal, nhead)
            want = smt_cuda.smt_encode_plain(params, entries, valid, goal, nhead)
            r = dict(shape=list(entries.shape), entries_dtype=str(entries.dtype))
        elif name == "partial_irfft":
            spec, fft_len, start, length = args
            got = irfft_cuda.partial_irfft(spec, fft_len, start, length)
            want = irfft_cuda.partial_irfft_plain(spec, fft_len, start, length)
            r = dict(shape=list(spec.shape), fft_len=fft_len, peak=want.abs().max().item())
        else:
            audio, config = args
            got = spectrogram_cuda.spectrogram(audio, config)
            want = spectrogram_cuda.spectrogram_plain(audio, config)
            r = dict(shape=list(audio.shape))
    r["max_abs_err"] = (got - want).abs().max().item()
    r["tol"] = PRECISION_KERNEL_TOL[name] * (r["peak"] if name == "partial_irfft" else 1.0)
    r["ok"] = r["max_abs_err"] <= r["tol"]
    return r


def check_launch_inputs(inputs) -> dict:
    """``check_kernel_input`` of every captured (kernel, shape), keyed
    "kernel:BxLxF"."""
    return {f"{name}:{'x'.join(map(str, shape))}": check_kernel_input(name, args)
            for (name, shape), args in inputs.items()}


def param_digest(trainer) -> str:
    """sha256 of every parameter of the trainer's trained modules, in order."""
    import hashlib

    h = hashlib.sha256()
    for m in trainer.trained_modules():
        if m is not None:
            for p in m.parameters():
                h.update(p.detach().cpu().numpy().tobytes())
    return h.hexdigest()


def check_collectives(trainer):
    """Every collective of ``parallel/ddppo.py`` once over the whole process
    group, on tensors on the trainer's device, each held to what it must
    give: ``all_reduce_mean_grads`` of gradients equal on every rank (the
    parameters, which the run kept bit-equal) gives them back bit for bit,
    ``broadcast_modules`` leaves the equal parameters as they are,
    ``gather_pytree`` concatenates the ranks' time-major (T, B/n, 3) blocks
    and env-leading (B/n,) vectors in rank order, ``any_rank`` is true on
    every rank when the last says so and false when none does, and
    ``barrier`` returns. Returns the backend, the world size and
    {collective: ok}."""
    import torch
    import torch.distributed as dist

    from avlen_tpu_torch.parallel import ddppo
    from avlen_tpu_torch.parallel.mesh import make_mesh

    mesh = make_mesh()
    n, rank, dev = mesh.world_size, mesh.rank, trainer.device
    ok = {}
    params = [p for m in trainer.trained_modules() if m is not None for p in m.parameters()]
    before, grads = param_digest(trainer), [p.grad for p in params]
    for p in params:
        p.grad = p.detach().clone()
    ddppo.all_reduce_mean_grads(params, mesh)
    ok["all_reduce_mean_grads"] = all(p.grad.device == p.device and torch.equal(p.grad, p.detach()) for p in params)
    for p, g in zip(params, grads):
        p.grad = g
    ddppo.broadcast_modules(trainer.trained_modules(), mesh)
    ok["broadcast_modules"] = param_digest(trainer) == before
    t, b = trainer.num_steps, trainer.env.num_envs

    def block(r):
        return {"x": torch.arange(t * b * 3, dtype=torch.float32, device=dev).reshape(t, b, 3) + 1e4 * r,
                "m": torch.full((b,), float(r), device=dev)}

    tree = block(rank)
    got = ddppo.gather_pytree(tree, ddppo.infer_env_specs(tree, b, t), mesh)
    blocks = [block(r) for r in range(n)]
    want = {"x": torch.cat([x["x"] for x in blocks], 1), "m": torch.cat([x["m"] for x in blocks])}
    ok["gather_pytree"] = all(got[k].device == want[k].device and torch.equal(got[k], want[k]) for k in want)
    ok["any_rank"] = ddppo.any_rank(rank == n - 1, mesh, dev) and not ddppo.any_rank(False, mesh, dev)
    ddppo.barrier(mesh)
    ok["barrier"] = True
    return dict(backend=dist.get_backend(), world_size=n, device=str(dev), ok=ok)


def ddppo_rank_main(argv) -> int:
    """The rank program of the ``ddppo`` phase: ``chip_smoke.py
    --ddppo-rank OUT_DIR [--deterministic] -- RUN_ARGV`` runs
    ``avlen_tpu_torch.run.main(RUN_ARGV)`` (under torchrun each rank joins
    the group first, so that it outlives the run) with every kernel launch
    counted by shape, the first inputs of each (kernel, shape) held against
    the plain version after the run, the trained parameters' digest after
    each update, the host ms of each gradient all-reduce (synchronised on
    both sides), and, under the launcher, ``check_collectives`` over the
    group after the run; writes ``OUT_DIR/rank{RANK}.json``.
    ``--deterministic``: cuDNN's and torch's deterministic algorithms, for
    runs compared bit for bit."""
    sep = argv.index("--")
    out_dir, flags, run_argv = argv[0], argv[1:sep], argv[sep + 1:]
    if "--deterministic" in flags:
        os.environ.setdefault("CUBLAS_WORKSPACE_CONFIG", ":4096:8")
    import torch

    from avlen_tpu_torch import run
    from avlen_tpu_torch.parallel import ddppo
    from avlen_tpu_torch.parallel.mesh import backend_for, joined_process_group
    from avlen_tpu_torch.rl.trainers.base import BaseRLTrainer

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    if "--deterministic" in flags:
        torch.backends.cudnn.deterministic = True
        torch.use_deterministic_algorithms(True, warn_only=True)
    rank = int(os.environ.get("RANK", "0"))
    digests, reduces = [], []
    refresh, reduce = BaseRLTrainer._refresh_episode_stream, ddppo.all_reduce_mean_grads

    def after_update(self, carry):
        digests.append(param_digest(self))
        return refresh(self, carry)

    def sync():
        if torch.cuda.is_available():
            torch.cuda.synchronize()

    def timed_reduce(params, mesh):
        sync()
        t0 = time.perf_counter()
        reduce(params, mesh)
        sync()
        reduces.append((sum(p.grad.numel() for p in params if p.grad is not None),
                        (time.perf_counter() - t0) * 1e3))

    BaseRLTrainer._refresh_episode_stream = after_update
    ddppo.all_reduce_mean_grads = timed_reduce
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    under_launcher = "WORLD_SIZE" in os.environ
    device_type = run_argv[run_argv.index("--device") + 1] if "--device" in run_argv else "cuda"
    with joined_process_group(device_type) if under_launcher else contextlib.nullcontext():
        t0 = time.perf_counter()
        with launch_inputs_by_shape() as (shapes, inputs):
            tr = run.main(run_argv)
        seconds = time.perf_counter() - t0
        ddppo.all_reduce_mean_grads = reduce
        collectives = check_collectives(tr) if under_launcher and not tr.sits_out else None
    launches = {k: fn.launches for k, fn in wrappers.items()}
    totals = dict(tr.timings.totals)
    record = dict(
        rank=rank, world_size=int(os.environ.get("WORLD_SIZE", "1")),
        backend=backend_for("cuda") if under_launcher else None, device=str(tr.device),
        mesh=tr.mesh is not None, sits_out=tr.sits_out, local_envs=tr.env.num_envs, num_steps=tr.num_steps,
        updates=tr.num_updates_done, num_steps_done=tr.num_steps_done, seconds=seconds,
        setup_s=tr.setup_seconds, train_s=tr.train_seconds,
        collect_ms=totals["collect_time"] * 1e3 / max(tr.num_updates_done, 1),
        update_ms=totals["update_time"] * 1e3 / max(tr.num_updates_done, 1),
        digests=digests, all_reduces=reduces, collectives=collectives, launches=launches,
        shapes=_shape_counts(shapes),
        kernel_checks=check_launch_inputs(inputs),
        peak_mem_gb=torch.cuda.max_memory_allocated() / 2**30 if torch.cuda.is_available() else None)
    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(record, f)
    return 0


def _start_ranks(name: str, config: str, opts, nproc: int, launcher: bool = True, deterministic: bool = False):
    """One update of ``config`` + ``opts`` through ``run.main`` under
    ``ddppo_rank_main`` on ``nproc`` ranks through torchrun (or one process
    with no launcher), in the background; returns (Popen, out_dir)."""
    repo = os.path.dirname(os.path.abspath(__file__))
    out_dir = os.path.join(repo, DDPPO_DIR, name)
    shutil.rmtree(out_dir, ignore_errors=True)
    os.makedirs(out_dir)
    argv = ["--run-type", "train", "--device", "cuda", "--exp-config", config,
            "--model-dir", os.path.join(out_dir, "model"), "NUM_UPDATES", "1", *opts]
    prog = [os.path.join(repo, "chip_smoke.py"), "--ddppo-rank", out_dir,
            *(["--deterministic"] if deterministic else []), "--", *argv]
    cmd = ([sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc_per_node", str(nproc), *prog]
           if launcher else [sys.executable, *prog])
    with open(os.path.join(out_dir, "log.txt"), "w") as log:
        proc = subprocess.Popen(cmd, stdout=log, stderr=subprocess.STDOUT, cwd=repo)
    return proc, out_dir


def _finish_ranks(started, timeout: float = DDPPO_TIMEOUT):
    """Wait for every started launch (killing all on a timeout or a
    failure) and read their rank files: {name: [rank records]}."""
    out, deadline = {}, time.perf_counter() + timeout
    try:
        for name, (proc, out_dir, nproc) in started.items():
            rc = proc.wait(timeout=max(deadline - time.perf_counter(), 1))
            if rc != 0:
                with open(os.path.join(out_dir, "log.txt")) as f:
                    tail = f.read()[-4000:]
                raise AssertionError(f"ddppo: {name} exited {rc}:\n{tail}")
            out[name] = []
            for r in range(nproc):
                with open(os.path.join(out_dir, f"rank{r}.json")) as f:
                    out[name].append(json.load(f))
    finally:
        for proc, _, _ in started.values():
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    return out


def run_ddppo(smi: str, ckpts=None):
    """DD-PPO on the card through torchrun (``ddppo_rank_main`` around
    ``avlen_tpu_torch.run.main`` on each rank): savi.yaml uncut over 2 ranks
    (8 envs each, gloo over CUDA tensors on the one card) for one collect +
    update, alone; then at once: AV-Nav, AV-WAN and AVLEN stage 1 at full
    width over 2 ranks for one update each, and savi.yaml
    (DDPPO_PAIR_STEPS steps) on 1 rank of NCCL through the launcher beside
    the same with no process group, both with deterministic algorithms.
    ``ckpts`` (goal, belief, vln, speaker) feed AVLEN as in
    ``run_interactive_train``; without them it starts fresh on the template
    speaker. Fails unless every launch exits 0, each 2-rank run's ranks
    hold bit-equal parameters after each update (and they moved), the pair
    is bit-equal, every collective of ``parallel/ddppo.py`` gives what it
    must over each launched group (``check_collectives``: on the NCCL run,
    over NCCL on the card, since a 1-rank run trains without a mesh and
    so without a collective), every launch shape is in DDPPO_SHAPES and within its
    tolerance of the plain version on its first inputs, and each run
    launched the kernels its path runs. Returns the launches over every
    rank of every run."""
    shutil.rmtree(DDPPO_DIR, ignore_errors=True)
    if ckpts:
        avlen = ["SPEAKER.CKPT_PATH", ckpts["speaker"], "GOAL_CKPT_PATH", ckpts["goal"],
                 "VLN_CKPT_PATH", ckpts["vln"], "RL.PPO.BELIEF_PREDICTOR.pretrained_path", ckpts["belief"],
                 "SPEAKER.BANK_MODE", "bank"]
    else:
        avlen = ["SPEAKER.BACKEND", "template", "GOAL_CKPT_PATH", "", "VLN_CKPT_PATH", "",
                 "RL.PPO.BELIEF_PREDICTOR.pretrained_path", ""]
    pair = ["RL.PPO.num_steps", str(DDPPO_PAIR_STEPS)]
    runs = {"savi_2rank": (dict(config=SAVI_YAML, opts=[], nproc=2),),
            "concurrent": (dict(name="avnav_2rank", config=AVNAV_YAML, opts=[], nproc=2),
                           dict(name="avwan_2rank", config=AVWAN_YAML, opts=[], nproc=2),
                           dict(name="avlen_2rank", config=INTERACTIVE_STAGE1, opts=avlen, nproc=2),
                           dict(name="savi_nccl_1rank", config=SAVI_YAML, opts=pair, nproc=1, deterministic=True),
                           dict(name="savi_no_group", config=SAVI_YAML, opts=pair, nproc=1, launcher=False,
                                deterministic=True))}
    results, walls = {}, {}
    for group, specs in runs.items():
        started = {}
        t0 = time.perf_counter()
        for spec in specs:
            name = spec.get("name", group)
            proc, out_dir = _start_ranks(name, spec["config"], spec["opts"], spec["nproc"],
                                         spec.get("launcher", True), spec.get("deterministic", False))
            started[name] = (proc, out_dir, spec["nproc"])
        results.update(_finish_ranks(started))
        walls[group] = time.perf_counter() - t0

    fields, bad, launches = dict(nvidia_smi=smi, wall_s=walls), [], {k: 0 for k in DDPPO_SHAPES}
    for name, ranks in results.items():
        r0 = ranks[0]
        for r in ranks:
            for k, n in r["launches"].items():
                launches[k] += n
            for k, shapes in r["shapes"].items():
                unlisted = [s for s in shapes if tuple(map(int, s.split("x"))) not in DDPPO_SHAPES[k]]
                if unlisted:
                    bad.append(f"{name} rank {r['rank']}: {k} launched at unlisted shapes {unlisted}")
            for key, c in r["kernel_checks"].items():
                if not c["ok"]:
                    bad.append(f"{name} rank {r['rank']}: {key} off its plain version {c}")
            coll = r["collectives"]
            if r["backend"] is not None and not (coll and all(coll["ok"].values())
                                                 and coll["backend"] == r["backend"]
                                                 and coll["world_size"] == len(ranks)):
                bad.append(f"{name} rank {r['rank']}: collectives wrong: {coll}")
        f = dict(ranks=len(ranks), backend=r0["backend"], mesh=r0["mesh"], local_envs=r0["local_envs"],
                 num_steps=r0["num_steps"], updates=r0["updates"], num_steps_done=r0["num_steps_done"],
                 setup_s=[r["setup_s"] for r in ranks], collect_ms=[r["collect_ms"] for r in ranks],
                 update_ms=[r["update_ms"] for r in ranks], seconds=[r["seconds"] for r in ranks],
                 peak_mem_gb=[r["peak_mem_gb"] for r in ranks], launches=[r["launches"] for r in ranks],
                 shapes=[r["shapes"] for r in ranks],
                 kernel_checks={k: max(r["kernel_checks"].get(k, {"max_abs_err": 0.0})["max_abs_err"]
                                       for r in ranks) for k in r0["kernel_checks"]},
                 collectives=r0["collectives"])
        slowest_s = max((r["collect_ms"] + r["update_ms"]) / 1e3 for r in ranks)
        f["train_env_steps_per_s"] = r0["num_steps"] * r0["local_envs"] * len(ranks) / slowest_s
        if len(ranks) > 1:
            # by the flat buffer's size: the policy's (once a minibatch) and
            # the belief predictor's or π_l's (once an update); the first of
            # a process includes the gloo pair's set-up
            by_numel = collections.defaultdict(list)
            for r in ranks:
                for n, ms in r["all_reduces"]:
                    by_numel[n].append(ms)
            f["all_reduce"] = {str(n): dict(calls_per_rank=len(v) // len(ranks), mb=n * 4 / 1e6,
                                            ms_median=sorted(v)[len(v) // 2], ms_min=min(v), ms_max=max(v))
                               for n, v in sorted(by_numel.items())}
            f["digests_equal"] = all(r["digests"] == r0["digests"] for r in ranks)
            if not (r0["mesh"] and r0["backend"] == "gloo" and r0["updates"] == 1 and len(r0["digests"]) == 1
                    and f["digests_equal"] and r0["all_reduces"]):
                bad.append(f"{name}: ranks not data-parallel or not bit-equal: {f}")
        fields[name] = f
    nccl, plain = results["savi_nccl_1rank"][0], results["savi_no_group"][0]
    fields["pair_bit_equal"] = nccl["digests"] == plain["digests"] and len(nccl["digests"]) == 1
    if not (fields["pair_bit_equal"] and nccl["backend"] == "nccl" and plain["backend"] is None
            and not nccl["mesh"] and not nccl["all_reduces"]):
        bad.append(f"ddppo: the single-rank NCCL run differs from the no-group run: {nccl['digests']} "
                   f"vs {plain['digests']} (backend {nccl['backend']})")
    if not (nccl["collectives"] and nccl["collectives"]["backend"] == "nccl"
            and nccl["collectives"]["device"].startswith("cuda")):
        bad.append(f"ddppo: the NCCL collectives did not run on the card: {nccl['collectives']}")
    need = {"savi_2rank": DDPPO_SHAPES, "avlen_2rank": DDPPO_SHAPES,
            "avnav_2rank": ("partial_irfft", "spectrogram"), "avwan_2rank": ("partial_irfft", "spectrogram")}
    for name, kernels in need.items():
        short = [k for k in kernels for r in results[name] if r["launches"][k] < 1]
        if short:
            bad.append(f"{name}: kernels not launched on some rank: {short}")
    fields["launches"] = launches
    emit("ddppo", **fields)
    if bad:
        raise AssertionError("ddppo: " + "; ".join(bad))
    shutil.rmtree(DDPPO_DIR, ignore_errors=True)
    return launches


def run_parity_evidence(smi: str, root: str = PARITY_DIR):
    """The recipe runner on the card (``avlen_tpu_torch.scripts.
    run_parity_evidence.main`` in this process, PARITY_ARGS): every stage
    of the recipe at the JAX script's world and widths, its update counts
    and offline steps scaled by PARITY_ARGS' scale, then the table of
    query strategies x heard/unheard and the goal-only row at its eval
    count. Every kernel launch is counted by shape and each (kernel, shape)
    held against its plain version on its first inputs. Fails unless the
    summary has the JAX script's keys with every table cell finite and
    every cell's episodes evaluated, ``curves.npz`` holds every stage's
    curves, and every kernel ran. Returns the launches."""
    import numpy as np

    from avlen_tpu_torch.scripts import run_parity_evidence as rpe

    root = os.path.abspath(root)
    shutil.rmtree(root, ignore_errors=True)
    wrappers = _kernel_wrappers()
    for fn in wrappers.values():
        fn.launches = 0
    t0 = time.perf_counter()
    with launch_inputs_by_shape() as (shapes, inputs):
        summary = rpe.main(["--workdir", root, "--device", "cuda", *PARITY_ARGS])
    seconds = time.perf_counter() - t0
    launches = {k: fn.launches for k, fn in wrappers.items()}
    checks = check_launch_inputs(inputs)
    curves = np.load(os.path.join(root, "curves.npz"))
    stages = sorted({k.split("__")[0] for k in curves.files})
    eval_count = int(PARITY_ARGS[PARITY_ARGS.index("--eval-count") + 1])
    table = summary["eval_table"]
    finite = all(isinstance(v, (int, float)) and math.isfinite(v) for row in table.values() for v in row.values())
    ckpt_bytes = sum(os.path.getsize(os.path.join(b, f)) for b, _, fs in os.walk(root) for f in fs
                     if f.endswith(".pth"))
    emit("parity_evidence", nvidia_smi=smi, args=list(PARITY_ARGS), seconds=seconds, summary=summary,
         curve_stages=stages, launches=launches, shapes=_shape_counts(shapes),
         kernel_checks={k: c["max_abs_err"] for k, c in checks.items()}, checkpoint_bytes=ckpt_bytes)
    bad = [k for k, c in checks.items() if not c["ok"]]
    if set(summary) != {"seed", "scale", "recipe", "ckpt_selection", "savi_finetune", "interactive",
                        "eval_table"} or len(table) != 10 or not finite:
        bad.append(f"summary keys or cells: {sorted(summary)}, {table}")
    if any(row["episodes"] != eval_count for row in table.values()):
        bad.append("a cell evaluated fewer episodes than asked")
    if stages != ["dialog_pretrain", "interactive", "savi_finetune", "savi_pretrain"]:
        bad.append(f"curves of {stages}")
    if min(launches.values()) < 1:
        bad.append(f"kernels not launched: {launches}")
    shutil.rmtree(root, ignore_errors=True)
    if bad:
        raise AssertionError("parity_evidence: " + "; ".join(map(str, bad)))
    return launches


def main() -> int:
    import torch

    from avlen_tpu_torch.utils import cuda_build

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the card only", file=sys.stderr)
        return 1
    dev = torch.device("cuda:0")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()[0]
    emit("device", kind=kind, count=count, nvidia_smi=smi, torch=torch.__version__,
         cuda=torch.version.cuda)

    t0 = time.perf_counter()
    built = cuda_build.build(cuda_build.KERNELS, verbose=True)
    ptxas = [ln.strip() for _, _, log in built for ln in log.splitlines()
             if "registers" in ln or "spill" in ln or "Compiling entry" in ln]
    emit("build", seconds=time.perf_counter() - t0,
         per_kernel={name: secs for name, secs, _ in built}, ptxas=ptxas)
    logs = {name: log for name, _, log in built}
    run_native_build()

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("tf32", cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    check_reference(dev)
    check_reference(dev, sampling_rate=4000, rir_length=400)
    check_update_reference(dev)
    trainer, rollout_launches = run_main_path(dev)
    launches, rounds = run_update(trainer, dev, smi)
    del trainer
    torch.cuda.empty_cache()
    train_launches, model_dir = run_train_loop(smi)
    eval_launches = run_eval(smi, model_dir)
    pretrain_launches, belief_ckpt = run_belief_pretrain(dev, smi)
    from avlen_tpu_torch.utils.checkpoint import list_checkpoints

    goal_ckpt = list_checkpoints(os.path.join(model_dir, "data"))[-1]
    speaker_ckpt = run_speaker_train(dev, smi)
    interactive_launches = run_interactive(dev, smi, goal_ckpt, belief_ckpt, speaker_ckpt)
    dialog_launches, vln_ckpt = run_dialog_pretrain(smi)
    avlen_launches = run_interactive_train(smi, goal_ckpt, belief_ckpt, vln_ckpt, speaker_ckpt)
    check_interactive_reference(dev)
    check_interactive_update_reference(dev)
    check_baseline_reference(dev, "avnav")
    check_baseline_reference(dev, "avwan")
    baseline_launches = {stack: run_baseline_train(stack, smi) for stack in ("avnav", "avwan")}
    run_avwan_episodes(smi)
    reference_launches = {"reference_check": check_reference_data(dev)["launches"]}
    for stack in ("avnav", "savi"):
        reference_launches[f"reference_train_{stack}"] = run_reference_train(stack, smi)
    reference_launches["hostrir_savi"] = run_hostrir_savi(dev, smi)
    reference_launches["frame_cache_savi"] = run_frame_cache_savi(dev, smi)
    tree_goal_ckpt = list_checkpoints(os.path.join(REFERENCE_DIR, "savi", "data"))[-1]
    reference_launches["vln_dialog"] = run_vln_dialog(smi, tree_goal_ckpt, belief_ckpt, speaker_ckpt)
    aux_launches = run_aux_modules(dev, smi)
    torch.cuda.empty_cache()
    ddppo_launches = run_ddppo(smi, dict(goal=goal_ckpt, belief=belief_ckpt, vln=vln_ckpt, speaker=speaker_ckpt))
    parity_launches = run_parity_evidence(smi)
    torch.cuda.empty_cache()
    # the kernel checks come after the rollout, so that their torch.profiler
    # session (check_irfft) cannot touch the host-bound rollout's launches
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {
        "smt_encode": check_smt(dev, gen, logs["smt_encode"]),
        "partial_irfft": check_irfft(dev, gen, logs["partial_irfft"]),
        "spectrogram": check_spectrogram(dev, gen, logs["spectrogram"]),
    }
    results["smt_encode"]["interactive_shapes"] = check_smt_interactive_shapes(dev, gen)
    # last: its long profiler sessions made later sessions of the kernel
    # checks lose events (on an H100, 97 of 120 for 20 SMT calls, five
    # sessions running)
    precision_launches = run_precision(dev, smi, goal_ckpt, belief_ckpt, speaker_ckpt)

    meta = {
        "smt_encode": ("avlen_tpu_torch/csrc/smt_encode.cu", "avlen_tpu/ops/pallas_smt.py:305"),
        "partial_irfft": ("avlen_tpu_torch/csrc/partial_irfft.cu", "avlen_tpu/ops/pallas_irfft.py:204"),
        "spectrogram": ("avlen_tpu_torch/csrc/spectrogram.cu", "avlen_tpu/ops/pallas_spectrogram.py:100"),
    }
    results["smt_encode"]["in_update"] = dict(
        launches_per_update=[r["smt_launches"] for r in rounds],
        rows=rounds[0]["eval_rows"],
        forward_ms_per_call=[r["smt_forward_ms_per_call"] for r in rounds])
    kernels = [
        {"name": name, "route": "cuda", "source": meta[name][0], "replaces": meta[name][1],
         "launches": launches[name], "launches_rollout": rollout_launches[name],
         "launches_train_loop": train_launches[name], "launches_eval": eval_launches[name],
         "launches_belief_pretrain": pretrain_launches[name],
         "launches_interactive_stage1": interactive_launches["stage1"][name],
         "launches_interactive_stage2": interactive_launches["stage2"][name],
         "launches_dialog_pretrain": dialog_launches[name], "launches_interactive_train": avlen_launches[name],
         "launches_avnav_train": baseline_launches["avnav"][name],
         "launches_avwan_train": baseline_launches["avwan"][name],
         **{f"launches_{phase}": counts[name] for phase, counts in reference_launches.items()},
         "launches_precision": {run: counts[name] for run, counts in precision_launches.items()},
         "launches_aux_modules": {part: counts[name] for part, counts in aux_launches.items()},
         "launches_ddppo": ddppo_launches[name], "launches_parity_evidence": parity_launches[name],
         **results[name],
         "status": "ok"}
        for name in meta
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ddppo-rank"]:
        sys.exit(ddppo_rank_main(sys.argv[2:]))
    sys.exit(main())
