"""Plain float32 networks of the SAVi policy and its belief predictor.

A frozen copy of what the port runs (the GroupNorm ResNet-18 towers, the
spectrogram CNN, the Scene Memory Transformer with its pose encoding, the
actor and critic heads, the belief predictor and its EMA), written with
``torch.nn`` and ``torch.nn.functional`` alone. It imports nothing of the
program. Parameter names are the program's, so the benchmark's weights load
into both by the same names. No dtype plumbing: the reference computes in
float32 throughout, with TF32 off (``portbench/harness.py`` sets it).
"""

from __future__ import annotations

import math
from typing import NamedTuple, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

GN_EPS = 1e-6
LN_EPS = 1e-6
NEG_INF = -1e9
NUM_CATEGORIES = 21


# ---------------------------------------------------------------- towers
class BasicBlock(nn.Module):
    def __init__(self, cin: int, cout: int, stride: int, groups: int = 16):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, cout, 3, stride, 1, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(groups, cout, eps=GN_EPS)
        self.Conv_1 = nn.Conv2d(cout, cout, 3, 1, 1, bias=False)
        self.GroupNorm_1 = nn.GroupNorm(groups, cout, eps=GN_EPS)
        self.project = cin != cout or stride != 1
        if self.project:
            self.Conv_2 = nn.Conv2d(cin, cout, 1, stride, 0, bias=False)
            self.GroupNorm_2 = nn.GroupNorm(groups, cout, eps=GN_EPS)

    def forward(self, x):
        y = F.relu(self.GroupNorm_0(self.Conv_0(x)))
        y = self.GroupNorm_1(self.Conv_1(y))
        res = self.GroupNorm_2(self.Conv_2(x)) if self.project else x
        return F.relu(res + y)


class ResNet18(nn.Module):
    """NHWC in; stages (2, 2, 2, 2) of widths 64..512, mean pool, a head."""

    def __init__(self, cin: int, num_outputs: int = 0, width: int = 64, groups: int = 16):
        super().__init__()
        self.Conv_0 = nn.Conv2d(cin, width, 7, 2, 3, bias=False)
        self.GroupNorm_0 = nn.GroupNorm(groups, width, eps=GN_EPS)
        c, k = width, 0
        for i in range(4):
            feats = width * 2**i
            for b in range(2):
                setattr(self, f"BasicBlock_{k}", BasicBlock(c, feats, 2 if i > 0 and b == 0 else 1, groups))
                c, k = feats, k + 1
        if num_outputs:
            self.Dense_0 = nn.Linear(c, num_outputs)

    def forward(self, x):
        x = F.relu(self.GroupNorm_0(self.Conv_0(x.float().permute(0, 3, 1, 2))))
        x = F.max_pool2d(x, 3, 2, 1)
        for k in range(8):
            x = getattr(self, f"BasicBlock_{k}")(x)
        x = x.mean(dim=(2, 3))
        return self.Dense_0(x) if hasattr(self, "Dense_0") else x


class ConvEncoder(nn.Module):
    """VALID convs (kernels clamped to the map) → NHWC flatten → Linear → ReLU."""

    def __init__(self, cin: int, hw: Tuple[int, int], out: int, kernels, strides, channels=(32, 64, 64)):
        super().__init__()
        h, w = hw
        for i, (k, s, c) in enumerate(zip(kernels, strides, channels)):
            k = (min(k[0], h), min(k[1], w))
            setattr(self, f"Conv_{i}", nn.Conv2d(cin, c, k, s))
            h, w = (h - k[0]) // s[0] + 1, (w - k[1]) // s[1] + 1
            cin = c
        self.n = len(kernels)
        self.Dense_0 = nn.Linear(cin * h * w, out)

    def forward(self, x):
        x = x.float().permute(0, 3, 1, 2)
        for i in range(self.n):
            x = getattr(self, f"Conv_{i}")(x)
            if i < self.n - 1:
                x = F.relu(x)
        return F.relu(self.Dense_0(x.permute(0, 2, 3, 1).reshape(x.shape[0], -1)))


class AudioCNN(nn.Module):
    def __init__(self, out: int, hw: Tuple[int, int], cin: int = 2):
        super().__init__()
        if hw[0] < 30 or hw[1] < 30:
            kernels, strides = [(5, 5), (3, 3), (3, 3)], [(2, 2), (2, 2), (1, 1)]
        else:
            kernels, strides = [(8, 8), (4, 4), (3, 3)], [(4, 4), (2, 2), (1, 1)]
        self.ConvEncoder_0 = ConvEncoder(cin, hw, out, kernels, strides)

    def forward(self, x):
        return self.ConvEncoder_0(x)


def center_crop(x, size: int = 64):
    h, w = x.shape[1], x.shape[2]
    if h <= size and w <= size:
        return x
    top, left = max((h - size) // 2, 0), max((w - size) // 2, 0)
    return x[:, top:top + min(size, h), left:left + min(size, w), :]


class SMTCNN(nn.Module):
    def __init__(self):
        super().__init__()
        self.rgb_tower = ResNet18(3, 64)
        self.depth_tower = ResNet18(1, 64)

    def forward(self, rgb, depth):
        return torch.cat([self.rgb_tower(center_crop(rgb.float() / 255.0)),
                          self.depth_tower(center_crop(depth.float()))], dim=-1)


# ------------------------------------------------------- scene memory transformer
class MultiHeadAttention(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.q, self.k, self.v, self.out = (nn.Linear(d, d) for _ in range(4))


class EncoderLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d)
        self.LayerNorm_0 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, d)
        self.Dense_1 = nn.Linear(d, d)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=LN_EPS)


class DecoderLayer(nn.Module):
    def __init__(self, d: int):
        super().__init__()
        self.self_attn = MultiHeadAttention(d)
        self.LayerNorm_0 = nn.LayerNorm(d, eps=LN_EPS)
        self.cross_attn = MultiHeadAttention(d)
        self.LayerNorm_1 = nn.LayerNorm(d, eps=LN_EPS)
        self.Dense_0 = nn.Linear(d, d)
        self.Dense_1 = nn.Linear(d, d)
        self.LayerNorm_2 = nn.LayerNorm(d, eps=LN_EPS)


def attention(m: MultiHeadAttention, nhead: int, q, kv, key_valid):
    b, lq, d = q.shape
    dh = d // nhead
    qh = m.q(q).view(b, lq, nhead, dh)
    kh = m.k(kv).view(b, kv.shape[1], nhead, dh)
    vh = m.v(kv).view(b, kv.shape[1], nhead, dh)
    logits = torch.einsum("bqhd,bkhd->bhqk", qh, kh) / math.sqrt(dh)
    logits = logits + torch.where(key_valid[:, None, None, :] != 0, 0.0, NEG_INF)
    out = torch.einsum("bhqk,bkhd->bqhd", torch.softmax(logits, dim=-1), vh)
    return m.out(out.reshape(b, lq, d))


def relative_pose(a, b):
    """Pose b (x, y, heading) in pose a's frame."""
    ha, hb = -a[..., 2], -b[..., 2]
    r = torch.linalg.norm(a[..., :2] - b[..., :2], dim=-1)
    phi = torch.atan2(b[..., 1] - a[..., 1], b[..., 0] - a[..., 0]) - ha
    h = hb - ha
    h = torch.atan2(torch.sin(h), torch.cos(h))
    return torch.stack([r * torch.cos(phi), r * torch.sin(phi), -h], dim=-1)


def format_pose(p):
    x, y, h, t = p.unbind(-1)
    return torch.stack([x, y, torch.cos(h), torch.sin(h), torch.exp(-t)], dim=-1)


class SMTStateEncoder(nn.Module):
    """One encoder layer over memory ⊕ the current step, one decoder layer
    whose query is the goal (belief) vector."""

    def __init__(self, input_size: int, d: int = 256, nhead: int = 8):
        super().__init__()
        self.nhead = nhead
        self.pi, self.pj = input_size - 4, input_size
        self.pose_encoder = nn.Linear(5, 16)
        self.fusion0 = nn.Linear(input_size - 4 + 16, d)
        self.fusion1 = nn.Linear(d, d)
        self.enc0 = EncoderLayer(d)
        self.dec0 = DecoderLayer(d)

    def entries(self, x, memory, memory_valid):
        pi, pj = self.pi, self.pj
        valid = torch.cat([memory_valid, torch.ones_like(memory_valid[:, :1])], dim=1)
        xp, mp = x[:, pi:pj], memory[:, :, pi:pj]
        agent = format_pose(torch.cat([relative_pose(xp[:, :3], xp[:, :3]), xp[:, 3:4]], -1))
        mem = format_pose(torch.cat([relative_pose(xp[:, None, :3], mp[..., :3]), mp[..., 3:4]], -1))
        x = torch.cat([x[:, :pi], self.pose_encoder(agent), x[:, pj:]], dim=-1)
        memory = torch.cat([memory[..., :pi], self.pose_encoder(mem), memory[..., pj:]], dim=-1)
        return torch.cat([memory, x[:, None, :]], dim=1), valid

    def forward(self, x, memory, memory_valid, goal):
        e, valid = self.entries(x, memory, memory_valid)
        h = self.fusion1(F.relu(self.fusion0(e)))
        enc = self.enc0
        h = enc.LayerNorm_0(h + attention(enc.MultiHeadAttention_0, self.nhead, h, h, valid))
        h = enc.LayerNorm_1(h + enc.Dense_1(F.relu(enc.Dense_0(h))))
        dec = self.dec0
        tgt = goal[:, None, :]
        # one query: its self-attention's softmax over one key is exactly 1
        tgt = dec.LayerNorm_0(tgt + dec.self_attn.out(dec.self_attn.v(tgt)))
        tgt = dec.LayerNorm_1(tgt + attention(dec.cross_attn, self.nhead, tgt, h, valid))
        tgt = dec.LayerNorm_2(tgt + dec.Dense_1(F.relu(dec.Dense_0(tgt))))
        return tgt[:, 0, :]


class AudioNavSMTNet(nn.Module):
    """Features: visual 128 ⊕ action embedding 16 ⊕ audio 128 ⊕ pose 4."""

    def __init__(self, spectrogram_hw: Tuple[int, int], num_actions: int = 4, d_model: int = 256, nhead: int = 8):
        super().__init__()
        self.num_actions, self.d_model = num_actions, d_model
        self.goal_encoder = AudioCNN(128, spectrogram_hw)
        self.visual_encoder = SMTCNN()
        self.action_encoder = nn.Linear(num_actions, 16)
        self.smt = SMTStateEncoder(self.feature_size, d_model, nhead)

    feature_size = 128 + 16 + 128 + 4

    def features(self, rgb, depth, spectrogram, prev_actions, pose):
        return torch.cat([
            self.visual_encoder(rgb, depth),
            self.action_encoder(F.one_hot(prev_actions.long(), self.num_actions).float()),
            self.goal_encoder(spectrogram),
            pose,
        ], dim=-1)

    def goal(self, category_belief, location_belief):
        g = torch.zeros((category_belief.shape[0], self.d_model), device=category_belief.device)
        g[:, :NUM_CATEGORIES] = category_belief
        g[:, NUM_CATEGORIES:NUM_CATEGORIES + 2] = location_belief
        return g


class Head(nn.Module):
    def __init__(self, cin: int, cout: int):
        super().__init__()
        self.Dense_0 = nn.Linear(cin, cout)


class SMTPolicy(nn.Module):
    def __init__(self, net: AudioNavSMTNet):
        super().__init__()
        self.net = net
        self.action_head = Head(net.d_model, net.num_actions)
        self.critic = Head(net.d_model, 1)

    def heads(self, att):
        """(logits, value) of the attended state."""
        return self.action_head.Dense_0(att), self.critic.Dense_0(att)[..., 0]


# ------------------------------------------------------------ belief predictor
class BeliefPredictorNet(nn.Module):
    def __init__(self):
        super().__init__()
        self.predictor = ResNet18(2, 2)
        self.classifier = ResNet18(2, NUM_CATEGORIES)


class BeliefState(NamedTuple):
    last_pointgoal: torch.Tensor
    has_pointgoal: torch.Tensor
    last_label: torch.Tensor
    has_label: torch.Tensor


def init_belief_state(b: int, device) -> BeliefState:
    z = lambda *s: torch.zeros(s, device=device)  # noqa: E731
    return BeliefState(z(b, 2), z(b), z(b, NUM_CATEGORIES), z(b))


def base_to_odom(pg, pose):
    angle = -pose[:, 2]
    d = torch.linalg.norm(pg, dim=-1)
    th = torch.atan2(pg[:, 1], pg[:, 0])
    return torch.stack([pose[:, 0] + d * torch.cos(th + angle), pose[:, 1] + d * torch.sin(th + angle)], -1)


def odom_to_base(pg, pose):
    angle = -pose[:, 2]
    delta = pg - pose[:, :2]
    dth = torch.atan2(delta[:, 1], delta[:, 0]) - angle
    d = torch.linalg.norm(delta, dim=-1)
    return torch.stack([d * torch.cos(dth), d * torch.sin(dth)], -1)


def belief_ema(state: BeliefState, location, label_logits, has_audio, pose, new_episode, w: float = 0.5):
    """One refresh of the beliefs from this step's predictions: an EMA in the
    odometry frame while the goal is heard, the last belief while it is
    silent. Returns (state, category belief, location belief)."""
    b = pose.shape[0]
    has_pg = torch.where(new_episode, 0.0, state.has_pointgoal)
    has_lb = torch.where(new_episode, 0.0, state.has_label)
    heard = has_audio[:, None] > 0
    pg = torch.stack([-location[:, 1], location[:, 0]], -1)
    last = odom_to_base(state.last_pointgoal, pose)
    pg_audio = torch.where(has_pg[:, None] > 0, (1 - w) * pg + w * last, pg)
    pg_silent = torch.where(has_pg[:, None] > 0, last, torch.full((b, 2), 10.0, device=pose.device))
    pg_avg = torch.where(heard, pg_audio, pg_silent)
    new_pg = torch.where(heard, base_to_odom(pg_avg, pose), state.last_pointgoal)
    lb_audio = torch.where(has_lb[:, None] > 0, (1 - w) * label_logits + w * state.last_label, label_logits)
    lb_silent = torch.where(has_lb[:, None] > 0, state.last_label, torch.full_like(label_logits, 1.0 / NUM_CATEGORIES))
    lb_avg = torch.where(heard, lb_audio, lb_silent)
    new_lb = torch.where(heard, lb_avg, state.last_label)
    new = BeliefState(new_pg, torch.maximum(has_pg, has_audio), new_lb, torch.maximum(has_lb, has_audio))
    return new, lb_avg, pg_avg


def savi_modules(spectrogram_hw: Tuple[int, int], num_actions: int = 4, d_model: int = 256, nhead: int = 8,
                 device="cpu") -> Tuple[SMTPolicy, BeliefPredictorNet]:
    with torch.device(device):
        return SMTPolicy(AudioNavSMTNet(spectrogram_hw, num_actions, d_model, nhead)), BeliefPredictorNet()
