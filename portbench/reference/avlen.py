"""Plain AVLEN stage-2 evaluation, followed step by step from a recorded collect.

AVLEN (Paul et al., NeurIPS 2022, arXiv 2210.07940) acts through three
policies each step: π_q (the option policy: its own SMT over its memory of
step features with the query-count encodings, a 2-way option head, a
critic and an uncertainty head), π_g (the SAVi goal policy) and π_l (the
language policy: its own SMT over the dialog window's memory, the frozen
CLIP text embedding of the window's instruction projected by
``dialog_layer``, and the ``DialogStateEncoder`` over the window's SMT
states). This module holds plain float32 copies of π_q and π_l (π_g and the
belief predictor are ``nets.py``'s, CLIP and the speaker ``clip.py``'s and
``speaker.py``'s), written with ``torch.nn`` and ``torch.nn.functional``
alone, with the program's parameter names. It imports nothing of the
program.

``follow(weights, hp, rec, device)`` takes what the program's collect
produced and was given (observations, the actions the env executed, the
episode ends, the steps where each env's query started and the CLIP tokens
of those queries, the speaker's inputs and words) and works out again what
the program derived from them: the beliefs; each policy's step features;
the four memories (π_g's, π_q's, π_l's and π_l's state memory) with the
resets of ``rl/rollout_interactive.py`` (an episode's start clears all
four; the end of a dialog window, ``NUM_DIALOG_STEPS`` steps after its
query, clears π_l's two); the query track (in the window or not, the step
within it, the episode step, the step and count of the last query) and its
sinusoidal query-count encodings; the CLIP embedding each query starts and
carries through its window; and each policy's logits and value (π_q's
uncertainty logits, π_l's SMT state). Which env's query starts at a step,
and which action the env executed, are the program's: π_q's and π_g's
samples come from the program's generator and are not drawn again.

Where it departs from the published model, as the program does: the
encodings are those of the port (``models/``); LayerNorms use eps 1e-6;
attention masks add -1e9; the CLIP tower and the speaker as their modules
say; the weights are the benchmark's, drawn from the seed.
"""

from __future__ import annotations

import math
from typing import Dict, List

import torch
import torch.nn as nn
import torch.nn.functional as F

from portbench.reference.clip import CLIPTextEncoder
from portbench.reference.clip import tokenize as clip_tokenize
from portbench.reference.nets import (
    AudioNavSMTNet,
    BeliefPredictorNet,
    DecoderLayer,
    EncoderLayer,
    Head,
    SMTPolicy,
    SMTStateEncoder,
    attention,
    belief_ema,
    init_belief_state,
)
from portbench.reference.speaker import Speaker

ROWS = 480  # rows of one chunk of tower or SMT work
PE_MAX = 151  # rows of the query-count table
DIALOG_PE = 100  # rows of the dialog window's step table


def sinusoidal(rows: int, dim: int, device="cpu") -> torch.Tensor:
    pos = torch.arange(rows, dtype=torch.float64)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float64) * (-math.log(10000.0) / dim))
    pe = torch.zeros((rows, dim), dtype=torch.float64)
    pe[:, 0::2], pe[:, 1::2] = torch.sin(pos * div), torch.cos(pos * div)
    return pe.float().to(device)


# ---------------------------------------------------------------- π_q
class OptionPolicy(nn.Module):
    """π_q: π_g's step features (visual, action, audio, pose: 276) then the
    query-state encoding, through its own SMT (the pose re-encoded in the
    middle of the entry); heads: 2 options, the critic, the uncertainty."""

    def __init__(self, spectrogram_hw, num_actions: int, d_model: int, nhead: int, qc_emb: int):
        super().__init__()
        self.net = AudioNavSMTNet(spectrogram_hw, num_actions, d_model, nhead)
        base = self.net.feature_size
        self.net.smt = SMTStateEncoder(base + qc_emb, d_model, nhead)
        self.net.smt.pi, self.net.smt.pj = base - 4, base
        self.action_head = Head(d_model, 2)
        self.critic = Head(d_model, 1)
        self.uncertainty = nn.Linear(d_model, 2)

    def heads(self, att):
        return self.action_head.Dense_0(att), self.critic.Dense_0(att)[..., 0], self.uncertainty(att)


# ---------------------------------------------------------------- π_l
class DialogStateEncoder(nn.Module):
    """One encoder layer over the window's SMT states and the current one,
    each fused with the projected instruction and offset by the window
    step's sinusoidal encoding; one decoder layer whose query is the goal."""

    def __init__(self, d_model: int, nhead: int):
        super().__init__()
        self.nhead = nhead
        self.fusion0 = nn.Linear(2 * d_model, d_model)
        self.fusion1 = nn.Linear(d_model, d_model)
        self.enc0 = EncoderLayer(d_model)
        self.dec0 = DecoderLayer(d_model)

    def forward(self, x_att, state_memory, state_valid, dialog_emb, agent_step, goal):
        b, m, _ = state_memory.shape
        valid = torch.cat([state_valid, torch.ones_like(state_valid[:, :1])], 1)
        h = torch.cat([state_memory, x_att[:, None, :]], 1)
        d = dialog_emb[:, None, :].expand(b, m + 1, dialog_emb.shape[-1])
        h = self.fusion1(F.relu(self.fusion0(torch.cat([h, d], -1))))
        pe = sinusoidal(DIALOG_PE, h.shape[-1], h.device)
        h = h + pe[agent_step.long().clamp(0, DIALOG_PE - 1)][:, None, :]
        enc, dec = self.enc0, self.dec0
        h = enc.LayerNorm_0(h + attention(enc.MultiHeadAttention_0, self.nhead, h, h, valid))
        h = enc.LayerNorm_1(h + enc.Dense_1(F.relu(enc.Dense_0(h))))
        tgt = goal[:, None, :]
        tgt = dec.LayerNorm_0(tgt + dec.self_attn.out(dec.self_attn.v(tgt)))
        tgt = dec.LayerNorm_1(tgt + attention(dec.cross_attn, self.nhead, tgt, h, valid))
        tgt = dec.LayerNorm_2(tgt + dec.Dense_1(F.relu(dec.Dense_0(tgt))))
        return tgt[:, 0, :]


class DialogNet(nn.Module):
    def __init__(self, spectrogram_hw, num_actions: int, d_model: int, nhead: int, clip_width: int,
                 clip_layers: int, clip_heads: int, clip_embed: int):
        super().__init__()
        self.smt_net = AudioNavSMTNet(spectrogram_hw, num_actions, d_model, nhead)
        self.clip = CLIPTextEncoder(clip_width, clip_layers, clip_heads, clip_embed)
        self.dialog_layer = nn.Linear(clip_embed, d_model)
        self.dialog_state_encoder = DialogStateEncoder(d_model, nhead)


class DialogPolicy(nn.Module):
    def __init__(self, net: DialogNet):
        super().__init__()
        self.net = net
        self.action_head = Head(net.smt_net.d_model, net.smt_net.num_actions)
        self.critic = Head(net.smt_net.d_model, 1)

    def heads(self, att):
        return self.action_head.Dense_0(att), self.critic.Dense_0(att)[..., 0]


def avlen_modules(hp: Dict, device="cpu") -> Dict[str, nn.Module]:
    """π_q, π_g, π_l, the belief predictor and the speaker at the
    configuration's widths."""
    hw, na, d, h = tuple(hp["spectrogram_hw"]), hp["num_actions"], hp["d_model"], hp["nhead"]
    with torch.device(device):
        return {
            "option": OptionPolicy(hw, na, d, h, hp["qc_emb"]),
            "goal": SMTPolicy(AudioNavSMTNet(hw, na, d, h)),
            "dialog": DialogPolicy(DialogNet(hw, na, d, h, hp["clip_width"], hp["clip_layers"], hp["clip_heads"],
                                             hp["clip_embed"])),
            "belief": BeliefPredictorNet(),
            "speaker": Speaker(len(hp["speaker_words"]), hp["speaker_hidden"], hp["speaker_feat_dim"],
                               hp["speaker_word_emb"]),
        }


# ---------------------------------------------------------------- memories
class Ring:
    """A per-env ring of the last ``m`` entries with their validity."""

    def __init__(self, b: int, m: int, f: int, device):
        self.features = torch.zeros((b, m, f), device=device)
        self.valid = torch.zeros((b, m), device=device)
        self.idx = torch.zeros((b,), dtype=torch.long, device=device)

    def reset(self, where: torch.Tensor):
        keep = (~where).float()
        self.features = self.features * keep[:, None, None]
        self.valid = self.valid * keep[:, None]
        self.idx = torch.where(where, torch.zeros_like(self.idx), self.idx)

    def insert(self, x: torch.Tensor):
        onehot = F.one_hot(self.idx, self.features.shape[1]).float()
        self.features = self.features * (1 - onehot)[..., None] + onehot[..., None] * x[:, None, :]
        self.valid = torch.maximum(self.valid, onehot)
        self.idx = (self.idx + 1) % self.features.shape[1]


def _chunked(fn, *xs):
    outs = [fn(*(x[s:s + ROWS] for x in xs)) for s in range(0, xs[0].shape[0], ROWS)]
    if isinstance(outs[0], tuple):
        return tuple(torch.cat(parts) for parts in zip(*outs))
    return torch.cat(outs)


class AvlenFollower:
    def __init__(self, weights: Dict[str, Dict[str, torch.Tensor]], hp: Dict, device):
        self.hp, self.device = hp, torch.device(device)
        self.m = {k: m.to_empty(device=self.device) for k, m in avlen_modules(hp, "meta").items()}
        with torch.no_grad():
            for name, module in self.m.items():
                for n, p in module.named_parameters():
                    p.copy_(weights[name][n].to(self.device))
        self.pe = sinusoidal(PE_MAX, hp["qc_emb"], self.device)

    @torch.no_grad()
    def features(self, net: AudioNavSMTNet, obs: Dict[str, torch.Tensor], prev: torch.Tensor) -> torch.Tensor:
        dev = self.device
        return _chunked(lambda rgb, depth, spec, pa, pose: net.features(rgb.to(dev), depth.to(dev), spec.to(dev),
                                                                        pa, pose.to(dev)),
                        obs["rgb"], obs["depth"], obs["spectrogram"], prev, obs["pose"])

    @torch.no_grad()
    def clip(self, tokens: torch.Tensor) -> torch.Tensor:
        return _chunked(self.m["dialog"].net.clip, tokens.to(self.device))

    def encodings(self, count, total, last):
        diff = torch.where(count >= 2, total - last, torch.full_like(total, PE_MAX - 1))
        return self.pe[count.clamp(0, PE_MAX - 1)], self.pe[diff.clamp(0, PE_MAX - 1)]

    @torch.no_grad()
    def act(self, rec: Dict) -> Dict[str, torch.Tensor]:
        """Every step's outputs of the three policies and the beliefs, each
        (T, B, ...), from a collect that starts every env's first episode."""
        hp, dev = self.hp, self.device
        obs = rec["obs"]
        actions, dones = rec["actions"].to(dev), rec["dones"].to(dev).bool()
        newly, tokens = rec["newly"].to(dev).bool(), rec["tokens"].to(dev)
        t_len, b = actions.shape
        masks = torch.cat([torch.zeros_like(dones[:1]), ~dones[:-1]]).float()
        prev = torch.cat([torch.zeros_like(actions[:1]), actions[:-1]])
        prev = torch.where(masks == 0, torch.zeros_like(prev), prev).reshape(-1)
        flat = {k: v.reshape((t_len * b,) + v.shape[2:]) for k, v in obs.items()}
        goal_p, option_p, dialog_p = self.m["goal"], self.m["option"], self.m["dialog"]
        f_goal = self.features(goal_p.net, flat, prev).reshape(t_len, b, -1)
        f_opt = self.features(option_p.net, flat, prev).reshape(t_len, b, -1)
        f_vln = self.features(dialog_p.net.smt_net, flat, prev).reshape(t_len, b, -1)
        belief = self.m["belief"]
        loc, lab = _chunked(lambda s: (belief.predictor(s.to(dev)), belief.classifier(s.to(dev))), flat["spectrogram"])
        loc, lab = loc.reshape(t_len, b, 2), lab.reshape(t_len, b, -1)
        # the queries' embeddings, in step order
        q_steps, q_rows = newly.nonzero(as_tuple=True)
        q_clip = self.clip(tokens[q_steps, q_rows]) if q_steps.numel() else None

        m, qc, n_dialog = hp["memory_size"], hp["qc_emb"], hp["num_dialog_steps"]
        rings = {"goal": Ring(b, m, f_goal.shape[-1], dev), "option": Ring(b, m, f_opt.shape[-1] + qc, dev),
                 "vln": Ring(b, n_dialog, f_vln.shape[-1], dev)}
        snaps = {k: [] for k in rings}
        zero = torch.zeros((b,), dtype=torch.long, device=dev)
        queried = torch.zeros((b,), dtype=torch.bool, device=dev)
        dialog_step, total, last, count = zero, zero, zero, zero
        clip_now = torch.zeros((b, hp["clip_embed"]), device=dev)
        masks_vln = torch.zeros((b,), device=dev)
        beliefs = init_belief_state(b, dev)
        cats, pgs, qstates, agent_steps, clips, vln_resets = [], [], [], [], [], []
        k = 0
        for t in range(t_len):
            new_ep = masks[t] == 0
            queried = queried & ~new_ep
            dialog_step, total, last, count = (torch.where(new_ep, zero, x) for x in (dialog_step, total, last, count))
            clip_now = torch.where(new_ep[:, None], 0.0, clip_now)
            vln_reset = new_ep | (masks_vln == 0)
            rings["goal"].reset(new_ep)
            rings["option"].reset(new_ep)
            rings["vln"].reset(vln_reset)
            spec = obs["spectrogram"][t].to(dev)
            has_audio = (spec.abs().sum(dim=(1, 2, 3)) != 0).float()
            beliefs, cat, pg = belief_ema(beliefs, loc[t], lab[t], has_audio, obs["pose"][t].to(dev), new_ep,
                                          hp["weighting_factor"])
            qs, lqi = self.encodings(count, total, last)
            for key, ring in rings.items():
                snaps[key].append((ring.features, ring.valid))
            now = newly[t]
            queried = queried | now
            count = count + now.long()
            last = torch.where(now, total, last)
            if now.any():
                n = int(now.sum())
                clip_now = clip_now.clone()
                clip_now[now] = q_clip[k:k + n]
                k += n
            cats.append(cat)
            pgs.append(pg)
            qstates.append(qs)
            agent_steps.append(dialog_step)
            clips.append(clip_now)
            vln_resets.append(vln_reset)
            rings["goal"].insert(f_goal[t])
            rings["option"].insert(torch.cat([f_opt[t], lqi], -1))
            rings["vln"].insert(f_vln[t])
            step2 = torch.where(queried, dialog_step + 1, dialog_step)
            over = queried & (step2 >= n_dialog)
            clip_now = torch.where(over[:, None], 0.0, clip_now)
            queried = queried & ~over
            dialog_step = torch.where(over, zero, step2)
            total = torch.where(dones[t], zero, total + 1)
            masks_vln = (~(over | dones[t])).float()

        cats, pgs = torch.stack(cats), torch.stack(pgs)
        goals = torch.stack([goal_p.net.goal(c, p) for c, p in zip(cats, pgs)]).reshape(t_len * b, -1)
        rows = t_len * b

        def smt(net, x, key):
            feats = torch.stack([f for f, _ in snaps[key]]).reshape((rows,) + snaps[key][0][0].shape[1:])
            valid = torch.stack([v for _, v in snaps[key]]).reshape(rows, -1)
            return _chunked(net.smt, x.reshape(rows, -1), feats, valid, goals)

        out = {"category_belief": cats, "location_belief": pgs}
        logits, value = goal_p.heads(smt(goal_p.net, f_goal, "goal"))
        out.update(goal_logits=logits.reshape(t_len, b, -1), goal_value=value.reshape(t_len, b))
        att = smt(option_p.net, torch.cat([f_opt, torch.stack(qstates)], -1), "option")
        logits, value, unct = option_p.heads(att)
        out.update(option_logits=logits.reshape(t_len, b, -1), option_value=value.reshape(t_len, b),
                   option_unct=unct.reshape(t_len, b, -1))

        # π_l: the SMT state of every step, then its state memory over them
        x_att = smt(dialog_p.net.smt_net, f_vln, "vln").reshape(t_len, b, -1)
        ring = Ring(b, n_dialog, x_att.shape[-1], dev)
        state_f, state_v = [], []
        for t in range(t_len):
            ring.reset(vln_resets[t])
            state_f.append(ring.features)
            state_v.append(ring.valid)
            ring.insert(x_att[t])
        net = dialog_p.net
        emb = net.dialog_layer(torch.stack(clips).reshape(rows, -1))
        att = _chunked(net.dialog_state_encoder, x_att.reshape(rows, -1),
                       torch.stack(state_f).reshape(rows, n_dialog, -1), torch.stack(state_v).reshape(rows, n_dialog),
                       emb, torch.stack(agent_steps).reshape(rows), goals)
        logits, value = dialog_p.heads(att)
        out.update(dialog_logits=logits.reshape(t_len, b, -1), dialog_value=value.reshape(t_len, b), dialog_x_att=x_att,
                   query_clip=q_clip)
        return out

    @torch.no_grad()
    def speaker_logits(self, decodes: List[Dict]) -> List[torch.Tensor]:
        """Each decode's (1, T, V) logits, teacher-forced on the program's words."""
        sp, bos = self.m["speaker"], self.hp["speaker_words"].index("<BOS>")
        out = []
        for d in decodes:
            ids = d["ids"].to(self.device).long()
            words = torch.cat([torch.full_like(ids[:, :1], bos), ids[:, :-1]], 1)
            out.append(sp.teacher_logits(d["acts"].to(self.device), d["feats"].to(self.device),
                                         d["lens"].to(self.device), words))
        return out


def words_text(ids, words: List[str]) -> str:
    """The speaker's text of a row of word ids: start and padding words
    skipped, cut at the end word."""
    out = []
    for i in ids:
        w = words[int(i)] if 0 <= int(i) < len(words) else "<UNK>"
        if w == "<EOS>":
            break
        if w not in ("<PAD>", "<BOS>"):
            out.append(w)
    return " ".join(out)


def follow(weights, hp: Dict, rec: Dict, device) -> Dict:
    """The reference over the recorded collect: the policies' and beliefs'
    outputs, the CLIP features of each query, the speaker's teacher-forced
    logits of each decode and the CLIP tokens of its words."""
    ref = AvlenFollower(weights, hp, device)
    out = ref.act(rec)
    out["speaker_logits"] = ref.speaker_logits(rec["decodes"])
    out["speaker_tokens"] = [clip_tokenize([words_text(d["ids"][0], hp["speaker_words"])])[0] for d in rec["decodes"]]
    return out


def model_flops(hp: Dict) -> Dict[str, float]:
    """Model FLOPs counted on the reference's modules at the cell's shapes:
    ``act`` per env row of an acting step (π_q, π_g and π_l with full
    memories, both belief towers), ``clip`` per row the tower embeds, and
    ``decode`` per speaker decode (its path encoder and every decoder step)."""
    from torch.utils.flop_counter import FlopCounterMode

    mods = avlen_modules(hp, "meta")
    goal_p, option_p, dialog_p, belief, sp = (mods[k] for k in ("goal", "option", "dialog", "belief", "speaker"))
    (sh, sw), res, m, d = hp["spectrogram_hw"], int(hp["frame_res"]), hp["memory_size"], hp["d_model"]
    n_dialog, rows = hp["num_dialog_steps"], 8

    def count(fn, per: int) -> float:
        with torch.no_grad(), torch.device("meta"), FlopCounterMode(display=False) as fc:
            fn()
        return fc.get_total_flops() / per

    def act():
        spec, pose = torch.zeros(rows, sh, sw, 2), torch.zeros(rows, 4)
        rgb, depth, pa = torch.zeros(rows, res, res, 3), torch.zeros(rows, res, res, 1), torch.zeros(rows).long()
        goal = torch.zeros(rows, d)
        x = goal_p.net.features(rgb, depth, spec, pa, pose)
        goal_p.heads(goal_p.net.smt(x, torch.zeros(rows, m, x.shape[-1]), torch.zeros(rows, m), goal))
        x = dialog_p.net.smt_net.features(rgb, depth, spec, pa, pose)
        xq = option_p.net.features(rgb, depth, spec, pa, pose)
        xq = torch.cat([xq, torch.zeros(rows, hp["qc_emb"])], -1)
        option_p.heads(option_p.net.smt(xq, torch.zeros(rows, m, xq.shape[-1]), torch.zeros(rows, m), goal))
        x_att = dialog_p.net.smt_net.smt(x, torch.zeros(rows, n_dialog, x.shape[-1]), torch.zeros(rows, n_dialog), goal)
        emb = dialog_p.net.dialog_layer(torch.zeros(rows, hp["clip_embed"]))
        dialog_p.heads(dialog_p.net.dialog_state_encoder(x_att, torch.zeros(rows, n_dialog, d),
                                                         torch.zeros(rows, n_dialog), emb, torch.zeros(rows).long(), goal))
        belief.predictor(spec)
        belief.classifier(spec)

    def decode():
        path = hp["path_steps"]
        sp.teacher_logits(torch.zeros(1, path).long(), torch.zeros(1, path, hp["speaker_feat_dim"]),
                          torch.ones(1).long(), torch.zeros(1, hp["decode_steps"]).long())

    return {"act": count(act, rows), "clip": count(lambda: dialog_p.net.clip(torch.zeros(rows, 77).long()), rows),
            "decode": count(decode, 1)}
