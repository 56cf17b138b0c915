"""Plain SAVi training rounds, followed step by step from a recorded trajectory.

``SaviFollower`` holds the reference's own policy, belief predictor, their
Adam states, ring memory and beliefs, starting from the benchmark's
weights. ``round(traj)`` takes what the environment produced in one round
of the program's training (observations, actions, rewards, dones, the
observation after the round) and works out again everything the program
derived from it: the tower features, the beliefs, the ring memory each step
acted on, the acting values and log-probabilities, GAE, the PPO update
(ppo_epoch × num_mini_batch minibatches of env slots, permutations drawn
from ``torch.Generator().manual_seed(seed + 1)``, the clipped surrogate and
value losses, the entropy bonus, global-norm clipping applied only at or
above ``max_grad_norm``, Adam) and the belief predictor's online location
regression. It runs in chunks of rows, so it fits beside nothing else on
the card, and imports nothing of the program.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from portbench.reference.nets import (
    belief_ema,
    init_belief_state,
    savi_modules,
)

ROWS = 480  # rows of one chunk of tower or SMT work


class SaviFollower:
    def __init__(self, weights: Dict[str, Dict[str, torch.Tensor]], hp: Dict, device):
        if hp["use_linear_lr_decay"] or hp["use_normalized_advantage"]:
            raise NotImplementedError("portbench: the reference follows savi.yaml's PPO: a constant learning rate "
                                      "and raw advantages")
        self.hp, self.device = hp, torch.device(device)
        self.policy, self.belief = savi_modules(tuple(hp["spectrogram_hw"]), hp["num_actions"], hp["d_model"],
                                                hp["nhead"], device=self.device)
        for module, name in ((self.policy, "policy"), (self.belief, "belief")):
            with torch.no_grad():
                for n, p in module.named_parameters():
                    p.copy_(weights[name][n].to(self.device))
        # savi.yaml's freeze_encoders: the towers and the action embedding are
        # frozen, so PPO trains the SMT and the heads; the belief step trains
        # the location predictor
        self.trained = [p for n, p in self.policy.named_parameters() if n.startswith(("net.smt.", "action_head.", "critic."))]
        self.adam = torch.optim.Adam(self.trained, lr=hp["lr"], eps=hp["eps"])
        self.belief_adam = torch.optim.Adam(self.belief.parameters(), lr=hp["belief_lr"])
        self.perm_gen = torch.Generator().manual_seed(hp["seed"] + 1)
        self.first_grads: Optional[Dict[str, torch.Tensor]] = None
        self.first_belief_grads: Optional[Dict[str, torch.Tensor]] = None
        self.first_losses: Optional[Dict[str, float]] = None
        self.memory = self.valid = self.idx = None
        self.beliefs = None
        self.prev_action = None

    # ------------------------------------------------------------ acting
    @torch.no_grad()
    def features(self, obs: Dict[str, torch.Tensor], prev: torch.Tensor) -> torch.Tensor:
        net = self.policy.net
        out = []
        for s in range(0, prev.shape[0], ROWS):
            sl = slice(s, s + ROWS)
            out.append(net.features(obs["rgb"][sl].to(self.device), obs["depth"][sl].to(self.device),
                                    obs["spectrogram"][sl].to(self.device), prev[sl], obs["pose"][sl].to(self.device)))
        return torch.cat(out)

    @torch.no_grad()
    def belief_outputs(self, spec: torch.Tensor):
        loc, lab = [], []
        for s in range(0, spec.shape[0], ROWS):
            x = spec[s:s + ROWS].to(self.device)
            loc.append(self.belief.predictor(x))
            lab.append(self.belief.classifier(x))
        return torch.cat(loc), torch.cat(lab)

    def smt(self, x, memory, valid, goal):
        att = self.policy.net.smt(x, memory, valid, goal)
        return self.policy.heads(att)

    def _start(self, b: int, m: int, f: int):
        dev = self.device
        self.memory = torch.zeros((b, m, f), device=dev)
        self.valid = torch.zeros((b, m), device=dev)
        self.idx = torch.zeros((b,), dtype=torch.long, device=dev)
        self.beliefs = init_belief_state(b, dev)
        self.prev_action = torch.zeros((b,), dtype=torch.long, device=dev)

    def _refresh(self, new_ep, loc, lab, spec, pose):
        """Memory cleared and beliefs refreshed where an episode starts;
        returns the SMT's goal vector."""
        keep = (~new_ep).float()
        self.memory = self.memory * keep[:, None, None]
        self.valid = self.valid * keep[:, None]
        self.idx = torch.where(new_ep, torch.zeros_like(self.idx), self.idx)
        has_audio = (spec.abs().sum(dim=(1, 2, 3)) != 0).float()
        self.beliefs, cat, pg = belief_ema(self.beliefs, loc, lab, has_audio, pose, new_ep, self.hp["weighting_factor"])
        return cat, pg

    def _insert(self, x):
        onehot = F.one_hot(self.idx, self.memory.shape[1]).float()
        self.memory = self.memory * (1 - onehot)[..., None] + onehot[..., None] * x[:, None, :]
        self.valid = torch.maximum(self.valid, onehot)
        self.idx = (self.idx + 1) % self.memory.shape[1]

    @torch.no_grad()
    def act(self, traj):
        """Acting over the round: (features, memory snapshots, goals, values,
        log-probs, beliefs) per step, and the bootstrap value."""
        obs, actions, masks = traj["obs"], traj["actions"].to(self.device), traj["masks"].to(self.device)
        t_len, b = actions.shape
        m, f = self.hp["memory_size"], self.policy.net.feature_size
        if self.memory is None:
            self._start(b, m, f)
        prev_seq = torch.cat([self.prev_action[None], actions[:-1]])
        prev_seq = torch.where(masks == 0, torch.zeros_like(prev_seq), prev_seq)
        flat = {k: v.reshape((t_len * b,) + v.shape[2:]) for k, v in obs.items()}
        feats = self.features(flat, prev_seq.reshape(-1)).reshape(t_len, b, f)
        loc, lab = self.belief_outputs(flat["spectrogram"])
        loc, lab = loc.reshape(t_len, b, 2), lab.reshape(t_len, b, -1)
        snaps = torch.empty((t_len, b, m, f), device=self.device)
        snap_valid = torch.empty((t_len, b, m), device=self.device)
        cats, pgs = [], []
        for t in range(t_len):
            cat, pg = self._refresh(masks[t] == 0, loc[t], lab[t], obs["spectrogram"][t].to(self.device),
                                    obs["pose"][t].to(self.device))
            cats.append(cat)
            pgs.append(pg)
            snaps[t], snap_valid[t] = self.memory, self.valid
            self._insert(feats[t])
        cats, pgs = torch.stack(cats), torch.stack(pgs)
        goals = torch.stack([self.policy.net.goal(c, p) for c, p in zip(cats, pgs)])
        rows = t_len * b
        values, logps = [], []
        for s in range(0, rows, ROWS):
            sl = slice(s, s + ROWS)
            logits, v = self.smt(feats.reshape(rows, f)[sl], snaps.reshape(rows, m, f)[sl],
                                 snap_valid.reshape(rows, m)[sl], goals.reshape(rows, -1)[sl])
            values.append(v)
            logps.append(torch.log_softmax(logits, -1).gather(-1, actions.reshape(-1)[sl, None])[:, 0])
        values = torch.cat(values).reshape(t_len, b)
        logps = torch.cat(logps).reshape(t_len, b)

        # the bootstrap value, from the observation after the round
        nxt = {k: v.to(self.device) for k, v in traj["next_obs"].items()}
        new_ep = traj["dones"][-1].to(self.device).bool()
        last = torch.where(new_ep, torch.zeros_like(actions[-1]), actions[-1])
        xb = self.features(nxt, last)
        lb, bb = self.belief_outputs(nxt["spectrogram"])
        saved = (self.beliefs, self.memory, self.valid, self.idx)
        cat, pg = self._refresh(new_ep, lb, bb, nxt["spectrogram"], nxt["pose"])
        _, boot = self.smt(xb, self.memory, self.valid, self.policy.net.goal(cat, pg))
        self.beliefs, self.memory, self.valid, self.idx = saved
        self.prev_action = actions[-1]
        return dict(feats=feats, snaps=snaps, snap_valid=snap_valid, goals=goals, values=values, log_probs=logps,
                    category_belief=cats, location_belief=pgs, bootstrap=boot)

    # ------------------------------------------------------------ update
    def gae(self, rewards, values, boot, dones):
        g, tau = self.hp["gamma"], self.hp["tau"]
        nm = 1.0 - dones.float()
        adv = torch.zeros_like(values)
        gae = torch.zeros_like(boot)
        nv = boot
        for t in range(values.shape[0] - 1, -1, -1):
            delta = rewards[t] + g * nv * nm[t] - values[t]
            gae = delta + g * tau * nm[t] * gae
            adv[t] = gae
            nv = values[t]
        return adv, adv + values

    def ppo(self, acted, traj, adv, ret) -> Dict[str, float]:
        hp = self.hp
        actions = traj["actions"].to(self.device)
        t_len, b = actions.shape
        num_mb = min(hp["num_mini_batch"], b)
        mbs = b // num_mb
        chunk = hp["chunk"]
        m, f = acted["snaps"].shape[2:]
        sums = {"value_loss": 0.0, "action_loss": 0.0, "entropy": 0.0}
        for _ in range(hp["ppo_epoch"]):
            perm = torch.randperm(b, generator=self.perm_gen).to(self.device)
            for mb in range(num_mb):
                idx = perm[mb * mbs:(mb + 1) * mbs]
                n = t_len * mbs
                self.adam.zero_grad(set_to_none=True)
                parts = {k: 0.0 for k in sums}
                for s in range(0, t_len, chunk):
                    sel = (slice(s, s + chunk), idx)
                    rows = min(chunk, t_len - s) * mbs
                    logits, v = self.smt(acted["feats"][sel].reshape(rows, f), acted["snaps"][sel].reshape(rows, m, f),
                                         acted["snap_valid"][sel].reshape(rows, m),
                                         acted["goals"][sel].reshape(rows, -1))
                    logp_all = torch.log_softmax(logits, -1)
                    lp = logp_all.gather(-1, actions[sel].reshape(-1, 1))[:, 0]
                    ent = -(logp_all.exp() * logp_all).sum(-1)
                    a = adv[sel].reshape(-1)
                    ratio = torch.exp(lp - acted["log_probs"][sel].reshape(-1))
                    surr = torch.minimum(ratio * a, torch.clamp(ratio, 1 - hp["clip_param"], 1 + hp["clip_param"]) * a)
                    old_v, r = acted["values"][sel].reshape(-1), ret[sel].reshape(-1)
                    vc = old_v + torch.clamp(v - old_v, -hp["clip_param"], hp["clip_param"])
                    vl = 0.5 * torch.maximum((v - r) ** 2, (vc - r) ** 2)
                    vsum, asum, esum = vl.sum() / n, -surr.sum() / n, ent.sum() / n
                    (vsum * hp["value_loss_coef"] + asum - esum * hp["entropy_coef"]).backward()
                    parts["value_loss"] += vsum.item()
                    parts["action_loss"] += asum.item()
                    parts["entropy"] += esum.item()
                grads = [p.grad for p in self.trained if p.grad is not None]
                norm = torch.linalg.vector_norm(torch.stack([torch.linalg.vector_norm(g) for g in grads]))
                if norm >= hp["max_grad_norm"]:
                    for g in grads:
                        g.mul_(hp["max_grad_norm"] / norm)
                if self.first_grads is None:
                    self.first_grads = {n: p.grad.detach().clone() for n, p in self.policy.named_parameters()
                                        if p.grad is not None}
                self.adam.step()
                for k in sums:
                    sums[k] += parts[k]
                if self.first_losses is None:
                    self.first_losses = dict(parts)
        k = hp["ppo_epoch"] * num_mb
        return {name: v / k for name, v in sums.items()}

    def belief_step(self, traj) -> float:
        """One Adam step of the location regression over the round's steps
        whose spectrogram is not silent."""
        spec = traj["obs"]["spectrogram"]
        spec = spec.reshape((-1,) + spec.shape[2:])
        target = traj["obs"]["pointgoal_with_gps_compass"].reshape(-1, 2)
        n_heard = float((spec.abs().sum(dim=(1, 2, 3)) != 0).sum().clamp(min=1))
        self.belief_adam.zero_grad(set_to_none=True)
        total = 0.0
        for s in range(0, spec.shape[0], ROWS):
            x = spec[s:s + ROWS].to(self.device)
            w = (x.abs().sum(dim=(1, 2, 3)) != 0).float()
            err = ((self.belief.predictor(x) - target[s:s + ROWS].to(self.device)) ** 2).sum(-1) * w
            loss = err.sum() / n_heard
            loss.backward()
            total += loss.item()
        if self.first_belief_grads is None:
            self.first_belief_grads = {n: p.grad.detach().clone() for n, p in self.belief.named_parameters()
                                       if p.grad is not None}
        self.belief_adam.step()
        return total

    def round(self, traj) -> Dict:
        """One round of collect + update on ``traj``: the acting outputs
        (values, log-probs, beliefs, each (T, B)) and the update's losses."""
        acted = self.act(traj)
        adv, ret = self.gae(traj["rewards"].to(self.device), acted["values"], acted["bootstrap"],
                            traj["dones"].to(self.device))
        stats = self.ppo(acted, traj, adv, ret)
        stats["belief_loss"] = self.belief_step(traj)
        return dict(stats=stats, values=acted["values"], log_probs=acted["log_probs"],
                    category_belief=acted["category_belief"], location_belief=acted["location_belief"])

    def params(self) -> Dict[str, Dict[str, torch.Tensor]]:
        return {"policy": {n: p.detach() for n, p in self.policy.named_parameters()},
                "belief": {n: p.detach() for n, p in self.belief.named_parameters()}}


def follow(weights, hp, traj: Dict, device) -> Dict:
    """The reference over the recorded round: its outputs, the first
    minibatch's losses and gradients, and the parameters after its
    update."""
    ref = SaviFollower(weights, hp, device)
    return dict(round=ref.round(traj), first_grads={"policy": ref.first_grads, "belief": ref.first_belief_grads},
                first_losses=ref.first_losses, params=ref.params())


def model_flops(hp: Dict) -> Dict[str, float]:
    """Model FLOPs counted on the reference's modules at the cell's shapes,
    per row: ``act`` (towers, audio CNN, SMT and heads, both belief
    towers), ``smt`` (the SMT and heads over stored features) and ``loc``
    (the belief location tower)."""
    from torch.utils.flop_counter import FlopCounterMode

    policy, belief = savi_modules(tuple(hp["spectrogram_hw"]), hp["num_actions"], hp["d_model"], hp["nhead"],
                                  device="meta")
    f, m, (sh, sw), d = policy.net.feature_size, hp["memory_size"], hp["spectrogram_hw"], hp["d_model"]
    res = int(hp["frame_res"])
    rows = 8

    def count(fn) -> float:
        with torch.no_grad(), torch.device("meta"), FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops() / rows

    def act():
        spec = torch.zeros(rows, sh, sw, 2)
        x = policy.net.features(torch.zeros(rows, res, res, 3), torch.zeros(rows, res, res, 1), spec,
                                torch.zeros(rows, dtype=torch.long), torch.zeros(rows, 4))
        policy.heads(policy.net.smt(x, torch.zeros(rows, m, f), torch.zeros(rows, m), torch.zeros(rows, d)))
        belief.predictor(spec)
        belief.classifier(spec)

    def smt():
        policy.heads(policy.net.smt(torch.zeros(rows, f), torch.zeros(rows, m, f), torch.zeros(rows, m),
                                    torch.zeros(rows, d)))

    return {"act": count(act), "smt": count(smt), "loc": count(lambda: belief.predictor(torch.zeros(rows, sh, sw, 2)))}
