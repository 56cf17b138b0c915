"""SAVi training cells: the program's trainer driven round by round, as its train loop drives it.

Set-up writes the configuration's checkpoints from the seed, builds the
trainer, checks that every parameter it loaded is the benchmark's, and runs
the first round through the very superstep that ``SaviTrainer.train``
builds (``collect`` then ``update``, each ending in a device synchronise),
recording what the reference needs: the round's trajectory, its losses, the
optimizers' first moments after their first step, the parameters after its
update, and the simulator state of sampled steps for the audio check. That
round also warms up every shape of the window.

The window then runs whole rounds while the longest so far says the next
one ends within ``--seconds``. ``train_env_steps_per_s`` is the window's
env-steps over its wall time, which ends in a synchronise; ``step_ms_p95``
is the 95th percentile of every acting step of the window, each the
interval between CUDA events recorded on the stream at successive
acting-step boundaries (a collect's first step from the collect's start).

With ``--trace 1`` the window also times each update and belief step with
CUDA events, the env step and the policy's act on the host clock, and one
more round after the window runs under ``torch.profiler`` with the host
phases labelled and each kernel launch's shapes recorded. After the window
the program's state is freed, the reference (``reference/savi.py``)
follows the checked round, and ``savi_numbers`` compares the two.
"""

from __future__ import annotations

import gc
import statistics
import time
from typing import Dict, List

from portbench import compare, harness, program
from portbench.compare import leaf_gaps, peak_gap, rel, still_leaves
from portbench.program import to_host
from portbench.reference import audio as ref_audio
from portbench.reference.savi import follow, model_flops

TRAJ_KEYS = ("rgb", "depth", "spectrogram", "pose", "pointgoal_with_gps_compass")
LABELS = ("collect.env_step", "collect.act", "collect.belief", "update", "update.evaluate",
          "update.optimizer_step", "update.belief_step")


def run(ctx: Dict) -> Dict:
    import torch

    from avlen_tpu_torch.rl.trainers.savi import SaviTrainer
    from avlen_tpu_torch.utils.checkpoint import save_checkpoint
    from avlen_tpu_torch.utils.profiling import Timings
    from portbench.weights import flax_tree

    args, conf, work, dev = ctx["args"], ctx["config"], ctx["workload"], ctx["device"]
    t_start, seed = ctx["t_start"], args.seed

    # ---- the checkpoints the configuration loads, from the seed
    weights, probe, spec_hw, modules = savi_weights(ctx)
    nhead = probe.RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead
    folder = program.checkpoint_dir(ctx)
    paths = {name: save_checkpoint(folder, f"{name}.pth", {"state_dict": flax_tree(m, weights[name], nhead)})
             for name, m in modules.items()}
    cfg = program.build_config(conf, work, seed, paths, extra=ctx.get("extra_opts", ()))
    if ctx.get("program_tf32"):  # the control: the program computes at TF32
        torch.backends.cudnn.allow_tf32 = torch.backends.cuda.matmul.allow_tf32 = True
    t_weights = time.perf_counter() - t_start
    trainer = SaviTrainer(cfg, device=dev)
    trainer._setup()
    t_program = time.perf_counter() - t_start
    program.remove_checkpoints(list(paths.values()))
    program.check_loaded(weights, {"policy": dict(trainer.policy.named_parameters()),
                                   "belief": dict(trainer.belief_net.named_parameters())})
    theta0 = {mod: {n: to_host(t) for n, t in ts.items()} for mod, ts in weights.items()}
    del weights
    hp = hyperparameters(cfg, spec_hw, seed)
    t_steps, b = trainer.num_steps, trainer.env.num_envs

    # the superstep exactly as SaviTrainer.train builds it
    def collect(_, carry):
        return trainer.collect(carry)

    def update(_, batch, key, grad_reduce):
        return None, trainer.update(batch, grad_reduce=grad_reduce)

    superstep = trainer.superstep(collect, update, Timings())

    # ---- the checked round: the reference follows it after the window
    hooks = program.Hooks()
    first: Dict[str, Dict] = {}

    def first_moment(name, opt_of):
        def make(step):
            def wrapped(*a, **k):
                out = step(*a, **k)
                if name not in first:  # Adam's m after one step is 0.1 × the gradient it got
                    opt, module = opt_of()
                    ids = {id(p): n for n, p in module.named_parameters()}
                    first[name] = {ids[id(p)]: to_host(s["exp_avg"]) / 0.1 for p, s in opt.state.items()
                                   if "exp_avg" in s}
                return out
            return wrapped
        return make

    hooks.wrap(trainer.optimizer, "step", first_moment("policy", lambda: (trainer.optimizer.adam, trainer.policy)))
    hooks.wrap(trainer.belief_optimizer, "step",
               first_moment("belief", lambda: (trainer.belief_optimizer, trainer.belief_net)))
    first_loss: Dict[str, float] = {}

    def first_losses(loss_fn):
        def wrapped(*a, **k):
            loss, aux = loss_fn(*a, **k)
            if not first_loss:  # the first minibatch's, before any step
                first_loss.update({key: float(v.detach()) for key, v in aux.items()})
            return loss, aux
        return wrapped

    from avlen_tpu_torch.rl import ppo

    hooks.wrap(ppo, "ppo_loss", first_losses)
    sampled: List[Dict] = []
    every = min(int(work.get("audio_every", 10)), t_steps)  # a step of every ``every``, from the seed
    hooks.wrap(trainer.env, "step", program.step_recorder(sampled, every, seed % every))
    carry = trainer.carry
    t0 = time.perf_counter()
    _, carry, batch, stats = superstep(None, carry)
    round_s = time.perf_counter() - t0
    trainer.carry = carry = trainer._refresh_episode_stream(carry)
    traj = dict(obs={k: to_host(batch.obs[k]) for k in TRAJ_KEYS}, actions=to_host(batch.actions),
                rewards=to_host(batch.rewards), dones=to_host(batch.dones), masks=to_host(batch.masks),
                next_obs={k: to_host(carry.obs[k]) for k in TRAJ_KEYS if k != "pointgoal_with_gps_compass"})
    prog_round = dict(stats={k: float(v) for k, v in stats.items()}, values=to_host(batch.values),
                      log_probs=to_host(batch.log_probs), category_belief=to_host(batch.obs["category_belief"]),
                      location_belief=to_host(batch.obs["location_belief"]))
    del batch
    hooks.remove()
    prog_params = {"policy": {n: to_host(p) for n, p in trainer.policy.named_parameters()},
                   "belief": {n: to_host(p) for n, p in trainer.belief_net.named_parameters()}}
    harness.sync(dev)
    setup_s = time.perf_counter() - t_start
    setup_peak = torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0

    # ---- the window
    trace = bool(args.trace)
    timer = program.StepTimer(dev, host_clock=trace)
    update_events, belief_events, host = [], [], {}
    hooks.wrap(trainer, "collect", timer.collect)
    hooks.wrap(trainer.env, "step", timer.env_step)
    if trace:
        hooks.wrap(trainer, "update", program.events_around(dev, update_events))
        hooks.wrap(trainer, "belief_train_step", program.events_around(dev, belief_events))
        hooks.wrap(trainer.policy, "act", program.host_clock(host, "act_s"))
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
    failed = [0]

    def one_round():
        nonlocal carry
        _, carry, batch, stats = superstep(None, carry)
        trainer.carry = carry = trainer._refresh_episode_stream(carry)
        failed[0] += int(not all(harness.finite(float(v)) for v in stats.values()))

    round_times, window_s = [], 0.0
    if ctx.get("window", True):  # the control's readings need no window
        round_times, window_s = harness.whole_rounds(one_round, args.seconds, sync=lambda: harness.sync(dev))
    rounds = len(round_times)
    hooks.remove()
    step_ms = timer.step_ms()
    rec = dict(cell=args.workload, rounds=rounds, window_s=window_s, env_steps=rounds * t_steps * b,
               acting_steps=rounds * t_steps, step_ms=step_ms, num_envs=b, num_steps=t_steps,
               peak_mem_bytes=torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)
    if trace and rounds:
        rec.update(update_ms=[a.elapsed_time(e) for a, e in update_events],
                   belief_ms=[a.elapsed_time(e) for a, e in belief_events],
                   env_step_host_ms=timer.env_step_s * 1e3 / rec["acting_steps"],
                   act_host_ms=host.get("act_s", 0.0) * 1e3 / rec["acting_steps"])
        for name, target, attr in (("collect.env_step", trainer.env, "step"), ("collect.act", trainer.policy, "act"),
                                   ("collect.belief", trainer.belief_net, "forward"), ("update", trainer, "update"),
                                   ("update.evaluate", trainer, "evaluate_actions"),
                                   ("update.optimizer_step", trainer.optimizer, "step"),
                                   ("update.belief_step", trainer, "belief_train_step")):
            hooks.wrap(target, attr, program.labelled(name))
        try:
            rec.update(program.profiled(lambda: superstep(None, carry), dev, LABELS))
        finally:
            hooks.remove()
        fl = model_flops(hp)
        rec["flops_per_round"] = (t_steps + 1) * b * fl["act"] + t_steps * b * (3 * hp["ppo_epoch"] * fl["smt"]
                                                                               + 3 * fl["loc"])
    memory_peak = max(setup_peak, torch.cuda.max_memory_allocated(dev) if dev.type == "cuda" else 0)

    # ---- the raw audio inputs of the sampled steps; then the program is freed
    audio_in = program.audio_inputs(trainer.env, sampled)
    del trainer, superstep, carry
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    harness.precision_guard()

    t_ref = time.perf_counter()
    ref = follow(theta0, hp, traj, dev)
    numbers, diag = savi_numbers(prog_round, prog_params, first, first_loss, ref, theta0, audio_in, hp, dev)
    compared = compare.with_limits(numbers, work["limits"])
    t_ref = time.perf_counter() - t_ref
    e2e = {"setup_s": {"value": setup_s, "unit": "s"}}
    if step_ms:
        e2e["train_env_steps_per_s"] = {"value": rec["env_steps"] / window_s, "unit": "env-steps/s"}
        e2e["step_ms_p95"] = {"value": harness.quantile(step_ms, 0.95), "unit": "ms"}
    info = dict(step_ms_median=harness.quantile(step_ms, 0.5) if step_ms else None, step_samples=len(step_ms),
                rounds=rounds, warm_round_s=round_s, round_s=round_times, window_s=window_s, setup_s=setup_s,
                setup_parts_s=[t_weights, t_program], reference_s=t_ref, diag=diag)
    return dict(rec=rec, e2e=e2e, compared=compared, attempted=rounds, failed=failed[0],
                memory_peak_bytes=memory_peak, info=info)


def hyperparameters(cfg, spectrogram_hw, seed: int) -> Dict:
    """What the reference needs of the configuration, as plain numbers."""
    p = cfg.RL.PPO
    smt = p.SCENE_MEMORY_TRANSFORMER
    return dict(
        seed=seed % 2**31, spectrogram_hw=list(spectrogram_hw), frame_res=cfg.TASK_CONFIG.DATASET.SYNTHETIC.FRAME_RES,
        num_actions=len(cfg.TASK_CONFIG.TASK.POSSIBLE_ACTIONS), d_model=smt.hidden_size, nhead=smt.nhead,
        memory_size=smt.memory_size, chunk=smt.batched_eval_chunk, lr=p.lr, eps=p.eps,
        belief_lr=p.BELIEF_PREDICTOR.lr, weighting_factor=p.BELIEF_PREDICTOR.weighting_factor,
        clip_param=p.clip_param, ppo_epoch=p.ppo_epoch, num_mini_batch=p.num_mini_batch,
        value_loss_coef=p.value_loss_coef, entropy_coef=p.entropy_coef, max_grad_norm=p.max_grad_norm,
        gamma=p.gamma, tau=p.tau, use_normalized_advantage=p.use_normalized_advantage,
        use_linear_lr_decay=p.use_linear_lr_decay)


def savi_weights(ctx: Dict):
    """The benchmark's SAVi weights from the seed, on the card: (weights,
    the configuration without checkpoint paths that shapes them, the
    spectrogram's (H, W), the reference's modules on the meta device)."""
    from avlen_tpu_torch.ops.audio import SpectrogramConfig
    from portbench.reference.nets import savi_modules
    from portbench.weights import make_weights

    args, conf, work, dev = ctx["args"], ctx["config"], ctx["workload"], ctx["device"]
    probe = program.build_config(conf, work, args.seed, {}, extra=ctx.get("extra_opts", ()))
    smt_cfg = probe.RL.PPO.SCENE_MEMORY_TRANSFORMER
    spec_hw = SpectrogramConfig(sampling_rate=probe.TASK_CONFIG.SIMULATOR.AUDIO.RIR_SAMPLING_RATE).out_shape[:2]
    modules = dict(zip(("policy", "belief"), savi_modules(spec_hw, len(probe.TASK_CONFIG.TASK.POSSIBLE_ACTIONS),
                                                          smt_cfg.hidden_size, smt_cfg.nhead, device="meta")))
    return make_weights(modules, args.seed, dev), probe, spec_hw, modules


def acting_gaps(p: Dict, r: Dict) -> Dict[str, float]:
    """The round's acting outputs: values and beliefs by peak, log-probs
    absolute."""
    return {
        "value": peak_gap(p["values"], r["values"]),
        "log_prob": float((p["log_probs"].double().cpu() - r["log_probs"].double().cpu()).abs().max()),
        "belief": max(peak_gap(p["category_belief"], r["category_belief"]),
                      peak_gap(p["location_belief"], r["location_belief"])),
    }


def savi_numbers(prog_round, prog_params, prog_first, prog_first_loss, ref, theta0, audio_in, hp, device):
    """The numbers compared, all of the checked round, which both sides run
    from the same weights: the sampled steps' audio; the acting values,
    log-probabilities and beliefs; the losses of the first minibatch and of
    the belief step; the first gradient as each optimizer got it, by its
    worst leaf; and the parameters' change after the round's update
    (``ppo_epoch`` × ``num_mini_batch`` Adam steps and the belief step), by
    the worst leaf of either network over the leaves the reference trains
    (those whose reference gradient is under ``STILL_LEAF`` of the median
    leaf's are left out: Adam moves them by round-off alone).
    ``frozen_moved`` counts the leaves without a reference gradient that the
    program moved. Also, for the log, each network's median leaf of the
    change."""
    import torch

    out: Dict[str, float] = {}
    if audio_in:
        spec = ref_audio.observe(audio_in["sound_padded"].to(device), audio_in["start"].to(device),
                                 audio_in["rir"].to(device), audio_in["active"].to(device), audio_in["sampling_rate"])
        out["spectrogram"] = peak_gap(audio_in["spectrogram"].to(device), spec)
    out.update(acting_gaps(prog_round, ref["round"]))
    # the first minibatch's losses (before any step; the action loss inside
    # the total, since its mean over the advantages can sit near nought) and
    # the belief step's
    p, r = prog_first_loss, ref["first_losses"]

    def total(x):
        return x["value_loss"] * hp["value_loss_coef"] + x["action_loss"] - x["entropy"] * hp["entropy_coef"]

    out["loss"] = max(rel(p["value_loss"], r["value_loss"]), rel(p["entropy"], r["entropy"]), rel(total(p), total(r)),
                      rel(prog_round["stats"]["belief_loss"], ref["round"]["stats"]["belief_loss"]))
    grads, changes, moved_frozen, medians = [], [], 0, {}
    for mod in ("policy", "belief"):
        want = ref["first_grads"][mod] or {}
        grads += leaf_gaps(prog_first.get(mod, {}), want)
        # the leaves the reference trains: a gradient, and not a still one
        trained = set(want) - set(still_leaves(want))
        d_prog = {n: prog_params[mod][n] - theta0[mod][n] for n in trained}
        d_ref = {n: ref["params"][mod][n].cpu() - theta0[mod][n] for n in trained}
        gaps = leaf_gaps(d_prog, d_ref)
        changes += gaps
        medians[mod] = statistics.median(gaps) if gaps else 0.0
        # and no other leaf may move in the program
        frozen = [n for n in theta0[mod] if n not in want]
        moved_frozen += sum(not torch.equal(prog_params[mod][n], theta0[mod][n]) for n in frozen)
    out["first_grad"] = max(grads)
    out["param_change"] = max(changes)
    out["frozen_moved"] = float(moved_frozen)
    return out, {"param_change_median_leaf": medians}
