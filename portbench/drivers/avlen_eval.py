"""AVLEN evaluation cells: the program's interactive eval driven collect by collect, as its eval loop drives it.

Set-up writes the configuration's checkpoints from the seed (π_g, π_l, the
belief predictor, the neural speaker, and the eval checkpoint of π_q, π_g,
π_l and the belief predictor, whose saved config is the cell's own), builds
``InteractiveDDPPOTrainer``, starts the eval of that checkpoint
(``eval_start``: the eval split dealt exactly once, π_g and π_q sampling
from a generator seeded SEED + 13), checks that every parameter the
program loaded (four networks and the speaker) is the benchmark's, and runs
the first collect through ``eval_collect``, the method the program's eval
loop calls. That checked collect records what the reference needs: every
step's observations, executed actions, episode ends, query starts and CLIP
tokens; what each policy's act returned; each CLIP call's tokens and
features; each speaker decode's path features, words, logits and tokens;
and the simulator state of sampled steps for the audio check. It also warms
up every shape of the window (the act graphs are captured in it).

The window then runs whole collects through ``eval_collect`` while the
longest so far says the next one ends within ``--seconds``, in passes: each
a fresh eval of the checkpoint as a new process starts it (``eval_start``:
the split dealt exactly once from its start, the generator at SEED + 13;
the speaker's memo empty), run, as ``_eval_checkpoint`` runs it, until its
episodes are counted or its rollout budget is spent. The window starts with
a fresh pass; starting a pass is left off its clock. ``step_ms_p95`` is the
95th percentile of every acting step of the window, each the interval
between CUDA events recorded on the stream at successive acting-step
boundaries (a collect's first step from the collect's start). Each pass's
collects, episodes counted, queries, speaker decodes and memo hits go to
standard error.

With ``--trace 1`` the program's span recorder is on over the window
(``utils/profiling.py``: the policies' acts, the CLIP tower's stream time,
the host speaker, and the counters of CLIP rows and speaker decodes), and
one more collect after it runs under ``torch.profiler`` with each SMT
launch's shapes recorded. After the window the program is freed, the
reference (``reference/avlen.py``) follows the checked collect, and
``avlen_numbers`` compares the two.
"""

from __future__ import annotations

import gc
import os
import time
from typing import Dict, List

from portbench import compare, harness, program
from portbench.compare import peak_gap
from portbench.program import to_host
from portbench.reference import audio as ref_audio
from portbench.reference.avlen import avlen_modules, follow, model_flops

OBS_KEYS = ("rgb", "depth", "spectrogram", "pose")
# the spans that name the profiled collect's idle gaps (a handful an acting step)
LABELS = ("collect.belief", "collect.option", "collect.act", "collect.instruction", "collect.clip", "collect.dialog",
          "collect.env_step", "collect.bootstrap", "collect.stack")
# each network's name in the benchmark's weights → the program's module
NETWORKS = {"option": "option_policy", "goal": "goal_policy", "dialog": "dialog_policy", "belief": "belief_net"}


def run(ctx: Dict) -> Dict:
    import torch

    from avlen_tpu_torch.dialog.instruction_source import HostSpeakerInstructionSource
    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
    from avlen_tpu_torch.utils import profiling

    if not hasattr(InteractiveDDPPOTrainer, "eval_collect"):
        raise SystemExit("portbench: this program's InteractiveDDPPOTrainer has no eval_collect to drive")
    args, work, dev, t_start = ctx["args"], ctx["workload"], ctx["device"], ctx["t_start"]
    trainer, ev, theta0, hp, paths, t_setup = set_up(ctx)
    program.remove_checkpoints([p for name, p in paths.items() if name != "eval"])
    t_steps, b = trainer.num_steps, trainer.env.num_envs

    # ---- the checked collect: the reference follows it after the window
    every = min(int(work.get("audio_every", 10)), t_steps)  # a step of every ``every``, from the seed
    t0 = time.perf_counter()
    prog, rec_ref, sampled = checked_collect(trainer, ev, every, args.seed % every)
    harness.sync(dev)
    collect_s = time.perf_counter() - t0
    query_steps = int(rec_ref["newly"].any(dim=1).sum())

    # ---- the window's passes: each a fresh eval of the checkpoint, as a new
    # process gives it (the split dealt exactly once from its start, the
    # generator at SEED + 13, the speaker's memo empty), run until its
    # episodes are counted or its rollout budget is spent; starting one is
    # left off the window's clock
    passes: List[Dict] = []
    paused = [0.0]
    decodes = [0]
    hooks = program.Hooks()
    hooks.wrap(trainer.instr_source.speaker, "decode", counted(decodes))

    def summary(p: Dict) -> Dict:
        """A pass's collects, episodes counted, queries, decodes and memo
        hits (queries less the memo's keys), while its source is the one in
        use."""
        return dict(collects=p["collects"], episodes=len(p["ev"].seen), queries=p["queries"],
                    decodes=decodes[0] - p["decodes0"], memo_hits=p["queries"] - len(trainer.instr_source._cache))

    def fresh_pass():
        t0 = time.perf_counter()
        if passes:
            passes[-1]["summary"] = summary(passes[-1])
        src = trainer.instr_source
        trainer.instr_source = HostSpeakerInstructionSource(src.speaker, src.tables, src.context_length)
        passes.append(dict(ev=trainer.eval_start(paths["eval"]), collects=0, queries=0, decodes0=decodes[0]))
        harness.sync(dev)
        paused[0] += time.perf_counter() - t0

    def next_collect():
        p = passes[-1]
        if p["ev"].done or p["collects"] >= p["ev"].budget:
            fresh_pass()
            p = passes[-1]
        out = trainer.eval_collect(p["ev"])
        p["collects"] += 1
        p["queries"] += int((out["queried"] & (out["rl_mask"] > 0)).sum())
        return out

    fresh_pass()
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # ---- the window
    trace = bool(args.trace)
    timer = program.StepTimer(dev, host_clock=trace)
    hooks.wrap(trainer, "collect", timer.collect)
    hooks.wrap(trainer.env, "step", timer.env_step)
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failed = [0]

    def one_collect():
        out = next_collect()
        failed[0] += int(not all(bool(torch.isfinite(out[k]).all()) for k in FINITE))

    round_times, window_s = [], 0.0
    clip0 = trainer.clip_calls
    if trace:
        profiling.enable()
    if ctx.get("window", True):  # the control's readings need no window
        round_times, window_s = harness.whole_rounds(one_collect, args.seconds, sync=lambda: harness.sync(dev),
                                                     clock=lambda: time.perf_counter() - paused[0])
    if trace:
        profiling.disable()
    collects = len(round_times)
    hooks.remove()
    step_ms = timer.step_ms()
    window_passes = [p.get("summary") or summary(p) for p in passes]
    rec = dict(cell=args.workload, rounds=collects, window_s=window_s, acting_steps=collects * t_steps, num_envs=b,
               step_ms=step_ms, peak_mem_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if trace and collects:
        spans = profiling.export()
        counters = dict(spans["counters"], **{"clip.calls": trainer.clip_calls - clip0})
        rec.update(span_totals=spans["by_name"], counters=counters)
        fl = model_flops(hp)
        rec["flops_window"] = (rec["acting_steps"] * b * fl["act"] + counters.get("clip.rows", 0) * fl["clip"]
                               + counters.get("speaker.decodes", 0) * fl["decode"])
        profiling.enable(annotate=True)
        try:
            rec.update(program.profiled(next_collect, dev, LABELS))
        finally:
            profiling.disable()
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    program.remove_checkpoints([paths["eval"]])

    # ---- the raw audio inputs of the sampled steps; then the program is freed
    audio_in = program.audio_inputs(trainer.env, sampled)
    del trainer, ev, passes
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    harness.precision_guard()

    t_ref = time.perf_counter()
    ref = follow(theta0, hp, rec_ref, dev)
    numbers = avlen_numbers(prog, rec_ref, ref, audio_in, dev)
    compared = compare.with_limits(numbers, work["limits"])
    t_ref = time.perf_counter() - t_ref
    e2e = {"setup_s": {"value": setup_s, "unit": "s"}}
    if step_ms:
        e2e["step_ms_p95"] = {"value": harness.quantile(step_ms, 0.95), "unit": "ms"}
    info = dict(step_ms_median=harness.quantile(step_ms, 0.5) if step_ms else None, step_samples=len(step_ms),
                collects=collects, checked_collect_s=collect_s, round_s=round_times, window_s=window_s,
                setup_s=setup_s, setup_parts_s=t_setup, reference_s=t_ref, checked_query_steps=query_steps,
                checked_clip_calls=len(prog["clip_calls"]), checked_decodes=len(prog["decodes"]),
                passes=window_passes, counters=rec.get("counters"), diag={})
    return dict(rec=rec, e2e=e2e, compared=compared, attempted=collects, failed=failed[0],
                memory_peak_bytes=memory_peak, info=info)


def set_up(ctx: Dict):
    """Writes the checkpoints from the seed, builds the trainer, starts the
    eval and checks what the program loaded: (trainer, eval, the weights on
    the host, the reference's hyperparameters, the checkpoints' paths, the
    seconds of the weights and of the program's set-up)."""
    import torch

    from avlen_tpu_torch.rl.trainers.interactive import InteractiveDDPPOTrainer
    from avlen_tpu_torch.utils.checkpoint import save_checkpoint
    from portbench.weights import flax_tree, make_weights

    args, conf, work, dev = ctx["args"], ctx["config"], ctx["workload"], ctx["device"]
    folder = program.checkpoint_dir(ctx)
    paths = {name: os.path.join(folder, f"{name}.pth") for name in (*conf["checkpoints"].values(), "eval")}
    cfg = program.build_config(conf, work, args.seed, paths, extra=ctx.get("extra_opts", ()))
    hp = hyperparameters(cfg, conf, args.seed)
    modules = avlen_modules(hp, "meta")
    weights = make_weights(modules, args.seed, dev)
    for name in ACTION_HEADS:  # the published init's scale: every seed's policies start near uniform
        weights[name]["action_head.Dense_0.weight"] *= HEAD_GAIN
        weights[name]["action_head.Dense_0.bias"].zero_()
    trees = {name: flax_tree(m, weights[name], hp["nhead"]) for name, m in modules.items()}
    save_checkpoint(folder, "goal.pth", {"state_dict": trees["goal"]})
    save_checkpoint(folder, "dialog.pth", {"state_dict": trees["dialog"]})
    save_checkpoint(folder, "belief.pth", {"state_dict": trees["belief"]})
    save_checkpoint(folder, "speaker.pth", {"state_dict": trees["speaker"], "vocab": hp["speaker_words"],
                                            "hidden_size": hp["speaker_hidden"], "word_emb": hp["speaker_word_emb"],
                                            "world_feat_dim": hp["speaker_feat_dim"]})
    save_checkpoint(folder, "eval.pth", {"state_dict": trees["option"], "state_dict_goal": trees["goal"],
                                         "state_dict_vln": trees["dialog"], "belief_predictor": trees["belief"],
                                         "config": cfg.to_dict()})
    del trees
    if ctx.get("program_tf32"):  # the control: the program computes at TF32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    t_weights = time.perf_counter() - ctx["t_start"]
    trainer = InteractiveDDPPOTrainer(cfg, device=dev)
    ev = trainer.eval_start(paths["eval"])
    t_program = time.perf_counter() - ctx["t_start"]
    loaded = {name: dict(getattr(trainer, attr).named_parameters()) for name, attr in NETWORKS.items()}
    loaded["speaker"] = dict(trainer.instr_source.speaker.model.named_parameters())
    program.check_loaded(weights, loaded)
    theta0 = {mod: {n: to_host(t) for n, t in ts.items()} for mod, ts in weights.items()}
    return trainer, ev, theta0, hp, paths, [t_weights, t_program]


def checked_collect(trainer, ev, every: int, offset: int):
    """One collect through ``eval_collect``, recording what the reference
    needs: (the program's outputs, the reference's inputs, the sampled
    steps' simulator state for the audio check, from step ``offset`` every
    ``every``)."""
    import torch

    speaker = trainer.instr_source.speaker
    hooks = program.Hooks()
    acts: Dict[str, List] = {"option": [], "goal": [], "dialog": []}
    clip_calls: List[Dict] = []
    decodes: List[Dict] = []
    for name in acts:
        hooks.wrap(getattr(trainer, NETWORKS[name]), "act", returned(acts[name]))
    hooks.wrap(trainer.dialog_policy, "clip_embed", clip_recorder(clip_calls))
    hooks.wrap(speaker, "decode", decode_recorder(decodes))
    hooks.wrap(speaker.model.decoder, "step", logits_recorder(decodes))
    hooks.wrap(trainer.instr_source, "_lookup", token_recorder(decodes))
    sampled: List[Dict] = []
    hooks.wrap(trainer.env, "step", program.step_recorder(sampled, every, offset))
    try:
        traj = trainer.eval_collect(ev)
    finally:
        hooks.remove()
    t_steps = traj["actions"].shape[0]
    newly = traj["queried"] & (traj["rl_mask"] > 0)
    rec_ref = dict(obs={k: to_host(traj["obs"][k]) for k in OBS_KEYS}, actions=to_host(traj["actions"]),
                   dones=to_host(traj["dones"]), newly=to_host(newly), tokens=to_host(traj["dialog"]),
                   decodes=decodes)
    prog = dict(category_belief=to_host(traj["obs"]["category_belief"]),
                location_belief=to_host(traj["obs"]["location_belief"]), clip_calls=clip_calls, decodes=decodes,
                **{f"{name}_{out}": torch.stack([to_host(call[i]) for call in calls[:t_steps]])
                   for name, calls in acts.items() for out, i in OUTPUTS[name].items()})
    return prog, rec_ref, sampled


# π_q's, π_g's and π_l's action heads at the gain of the policies' own
# init (CategoricalNet's orthogonal init, gain 0.01, zero bias), so that
# every seed's policies start near uniform: with heads of unit scale each
# seed's draw would set how often π_g stops and π_q queries, and with it the
# work of a step (the queries' CLIP calls and speaker decodes)
ACTION_HEADS = ("option", "goal", "dialog")
HEAD_GAIN = 0.01

# what each policy's act returns that is compared: logits and value, π_q's
# uncertainty logits, π_l's SMT state
OUTPUTS = {"option": {"logits": 4, "value": 2, "unct": 5}, "goal": {"logits": 4, "value": 2},
           "dialog": {"logits": 5, "value": 2, "x_att": 4}}
FINITE = ("values_option", "logits_vln")


def hyperparameters(cfg, conf: Dict, seed: int) -> Dict:
    """What the reference needs of the configuration, as plain numbers."""
    from avlen_tpu_torch.dialog.speaker.speaker import GEOM_DIM, MAX_PATH_LEN, NUM_CATEGORIES
    from avlen_tpu_torch.dialog.speaker.vocab import Vocabulary
    from avlen_tpu_torch.ops.audio import SpectrogramConfig

    p = cfg.RL.PPO
    smt = p.SCENE_MEMORY_TRANSFORMER
    widths = conf["widths"]
    return dict(
        seed=seed % 2**31, frame_res=cfg.TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES,
        spectrogram_hw=list(SpectrogramConfig(sampling_rate=cfg.TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE)
                            .out_shape[:2]),
        num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), d_model=smt.hidden_size, nhead=smt.nhead,
        memory_size=smt.memory_size, qc_emb=cfg.QUERY_COUNT_EMB_SIZE, num_dialog_steps=cfg.NUM_DIALOG_STEPS,
        weighting_factor=p.BELIEF_PREDICTOR.weighting_factor, clip_width=p.CLIP_WIDTH, clip_layers=p.CLIP_LAYERS,
        clip_heads=widths["clip_heads"], clip_embed=widths["clip_projection"], speaker_hidden=widths["speaker_hidden"],
        speaker_word_emb=widths["speaker_word_emb"], speaker_words=list(Vocabulary().idx2word),
        speaker_feat_dim=GEOM_DIM + NUM_CATEGORIES,
        path_steps=MAX_PATH_LEN, decode_steps=widths["speaker_decode_steps"])


# ----------------------------------------------------------------- recorders
def counted(n: List[int]):
    def make(fn):
        def wrapped(*a, **k):
            n[0] += 1
            return fn(*a, **k)
        return wrapped
    return make


def returned(store: List):
    def make(fn):
        def wrapped(*a, **k):
            out = fn(*a, **k)
            store.append(out)
            return out
        return wrapped
    return make


def clip_recorder(store: List):
    def make(fn):
        def wrapped(tokens):
            out = fn(tokens)
            store.append({"tokens": to_host(tokens), "features": to_host(out)})
            return out
        return wrapped
    return make


def decode_recorder(store: List):
    """The speaker's ``decode``: its inputs and words; the logits of each
    step come from ``step_recorder``."""
    import torch

    def make(fn):
        def wrapped(acts, feats, lens):
            store.append({"acts": torch.as_tensor(acts).clone(), "feats": torch.as_tensor(feats).clone(),
                          "lens": torch.as_tensor(lens).clone(), "logits": []})
            ids = fn(acts, feats, lens)
            store[-1]["ids"] = torch.as_tensor(ids).clone()
            store[-1]["logits"] = to_host(torch.stack(store[-1]["logits"], 1))
            return ids
        return wrapped
    return make


def logits_recorder(store: List):
    def make(fn):
        def wrapped(*a, **k):
            carry, logits = fn(*a, **k)
            store[-1]["logits"].append(logits.detach().clone())
            return carry, logits
        return wrapped
    return make


def token_recorder(store: List):
    """The host source's lookup: the CLIP tokens of the words a decode gave."""
    def make(fn):
        def wrapped(*a, **k):
            before = len(store)
            toks = fn(*a, **k)
            if len(store) > before:
                store[-1]["tokens"] = toks.copy()
            return toks
        return wrapped
    return make


# ----------------------------------------------------------------- numbers
def avlen_numbers(prog: Dict, rec: Dict, ref: Dict, audio_in: Dict, device) -> Dict[str, float]:
    """The numbers compared, all of the checked collect, which both sides
    run from the same weights and inputs: the sampled steps' audio; π_q's
    logits, value and uncertainty logits, π_g's logits and value, π_l's
    logits, value and SMT state, each by its peak; the beliefs; the CLIP
    features of every query; the speaker's logits at every decode step,
    teacher-forced on the program's words, by their peak, and how far the
    word the program chose falls below the reference's best (relative to
    the decode's peak logit); and the CLIP token ids that differ from the
    reference's tokenization of the program's words."""
    import torch

    out: Dict[str, float] = {}
    if audio_in:
        spec = ref_audio.observe(audio_in["sound_padded"].to(device), audio_in["start"].to(device),
                                 audio_in["rir"].to(device), audio_in["active"].to(device), audio_in["sampling_rate"])
        out["spectrogram"] = peak_gap(audio_in["spectrogram"].to(device), spec)
    for name, outputs in OUTPUTS.items():
        out[name] = max(peak_gap(prog[f"{name}_{o}"], ref[f"{name}_{o}"]) for o in outputs)
    out["belief"] = max(peak_gap(prog["category_belief"], ref["category_belief"]),
                        peak_gap(prog["location_belief"], ref["location_belief"]))
    # each CLIP call is a step where some query starts; its query rows
    newly = rec["newly"]
    steps = newly.any(dim=1).nonzero()[:, 0].tolist()
    if len(steps) != len(prog["clip_calls"]):
        raise RuntimeError(f"portbench: {len(prog['clip_calls'])} CLIP calls for {len(steps)} steps with a query")
    got = [call["features"][newly[t]] for t, call in zip(steps, prog["clip_calls"])]
    out["clip"] = peak_gap(torch.cat(got), ref["query_clip"]) if got else 0.0
    speaker, margin, tokens = 0.0, 0.0, 0
    for d, want, want_tokens in zip(prog["decodes"], ref["speaker_logits"], ref["speaker_tokens"]):
        want = want.double().cpu()
        speaker = max(speaker, peak_gap(d["logits"], want))
        chosen = want.gather(-1, d["ids"].long()[..., None])[..., 0]
        margin = max(margin, float((want.max(-1).values - chosen).max() / want.abs().max()))
        tokens += int((torch.as_tensor(d["tokens"]).long() != want_tokens.long()).sum())
    out.update(speaker=speaker, speaker_margin=margin, tokens=float(tokens))
    return out
