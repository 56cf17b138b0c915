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

Then the ``kernels`` summary line, the nvidia-smi line, and last
``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
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
UPDATE_ROUNDS = 2


def emit(phase: str, **fields) -> None:
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
    short = {}
    # the 1, 2 and 4 kHz worlds (128, 200 and 400 taps): one CTA a row
    for n, start, length in ((2048, 127, 1000), (4096, 199, 2000), (8192, 399, 4000)):
        sp = torch.fft.rfft(torch.randn(16, 2, n, generator=gen, device=dev), dim=-1)
        got_n = irfft_cuda.partial_irfft(sp, n, start, length)
        want_n = irfft_cuda.partial_irfft_plain(sp, n, start, length)
        torch.cuda.synchronize()
        tol_n = 1e-5 * max(want_n.abs().max().item(), 1.0)
        err_n = (got_n - want_n).abs().max().item()
        ms_n, how_n = time_ms(lambda: irfft_cuda.partial_irfft(sp, n, start, length))
        plain_n, _ = time_ms(lambda: irfft_cuda.partial_irfft_plain(sp, n, start, length))
        plan_n = irfft_cuda.irfft_plan(n, start, length, 32)
        bound_n, bound_by_n = bound(32 * 2.5 * n * math.log2(n), sp.numel() * 8 + got_n.numel() * 4)
        regs_n, spill_st_n, spill_ld_n = ptxas_report(build_log, f"irfft_clusterILi{plan_n.threads}E")
        short[n] = dict(max_abs_err=err_n, tol=tol_n, ms=ms_n, plain_ms=plain_n, bound_ms=bound_n,
                        bound_by=bound_by_n, threads=plan_n.threads, registers=regs_n,
                        spill_store_bytes=spill_st_n, spill_load_bytes=spill_ld_n)
        emit("kernel", kernel="partial_irfft", case=f"fft_len_{n}", shape=list(sp.shape), **short[n],
             cluster=plan_n.cluster, timing=how_n)
        if not math.isfinite(err_n) or err_n > tol_n:
            raise AssertionError(f"partial_irfft at fft_len {n}: max abs err {err_n} > {tol_n}")
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, library_ms=library_ms,
                bound_ms=bound_ms, bound_by=bound_by, **extra, short_rows=short)


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
    """The spectrogram against its plain version in four cases: ``main``
    (the rollout's 16 envs), ``bank_rows`` (256 envs, a row block of the
    spectrogram bank), ``uneven`` (right ear x1e-3, one silent env) and
    ``short`` (3 envs of 8 kHz). At main and bank_rows also: its time in
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
        ptxas=ptxas)


def tiny_config(sampling_rate: int = 8000, rir_length: int = 2000):
    """savi.yaml on a tiny world: 3 envs, memory 8, d_model 32, 4 heads."""
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
    ])


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
    """max |got - want| / tol over the entries (tol a number or a tensor)."""
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


def run_main_path(dev):
    import torch

    from avlen_tpu_torch.config import get_config
    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda
    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer

    wrappers = {
        "smt_encode": smt_cuda.smt_encode,
        "partial_irfft": irfft_cuda.partial_irfft,
        "spectrogram": spectrogram_cuda.spectrogram,
    }
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

    from avlen_tpu_torch.ops import irfft_cuda, smt_cuda, spectrogram_cuda

    wrappers = {
        "smt_encode": smt_cuda.smt_encode,
        "partial_irfft": irfft_cuda.partial_irfft,
        "spectrogram": spectrogram_cuda.spectrogram,
    }
    cfg = trainer.config
    smt_cfg = cfg.RL.PPO.SCENE_MEMORY_TRANSFORMER
    ppo_cfg = trainer.ppo_cfg
    t_steps, b = trainer.num_steps, trainer.env.num_envs
    chunk = smt_cfg.batched_eval_chunk
    while t_steps % chunk:
        chunk -= 1
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

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    emit("precision", cudnn_allow_tf32=torch.backends.cudnn.allow_tf32,
         matmul_allow_tf32=torch.backends.cuda.matmul.allow_tf32)

    check_reference(dev)
    check_reference(dev, sampling_rate=4000, rir_length=400)
    check_update_reference(dev)
    trainer, rollout_launches = run_main_path(dev)
    launches, rounds = run_update(trainer, dev, smi)
    del trainer
    # the kernel checks come after the rollout, so that their torch.profiler
    # session (check_irfft) cannot touch the host-bound rollout's launches
    gen = torch.Generator(device=dev).manual_seed(0)
    results = {
        "smt_encode": check_smt(dev, gen, logs["smt_encode"]),
        "partial_irfft": check_irfft(dev, gen, logs["partial_irfft"]),
        "spectrogram": check_spectrogram(dev, gen, logs["spectrogram"]),
    }

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
         "launches": launches[name], "launches_rollout": rollout_launches[name], **results[name],
         "status": "ok"}
        for name in meta
    ]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(smi, flush=True)
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
