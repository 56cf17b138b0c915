"""Scene Memory Transformer state encoder.

PyTorch counterpart of ``avlen_tpu/models/smt.py`` (reference
smt_state_encoder.py:23-281): fusion MLP → transformer encoder over the
external memory plus the current step → decoder whose single query is the
goal (belief) vector, or the current entry when there is none. Each memory
entry's (x, y, heading, t) pose slice is re-expressed in the current agent
frame and formatted as (x, y, cosθ, sinθ, e^{-t}) → Linear(5→16) before
fusion. Pretraining mode masks all memory except the current step.

With one encoder and one decoder layer (every config of the repo) the
transformer runs as ``ops/smt_cuda.smt_encode``: the hand-written kernel on
a CUDA device, its plain version on the CPU. Other layer counts run the
plain layers. Submodule names follow the Flax parameter tree.

``dtype`` is the JAX module's. The kernel computes in float32 at every
precision, on float32 entries and goal, as JAX's fused path
(``avlen_tpu/models/smt.py:152-169``) does: a lower precision reaches it
only through the towers' rounded features. The plain layers of other layer
counts compute at ``dtype`` and return float32, as JAX's non-fused layers.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn

from avlen_tpu_torch.models.init import linear
from avlen_tpu_torch.ops.smt_cuda import smt_encode, smt_encode_plain


def compute_relative_pose(pose_a: torch.Tensor, pose_b: torch.Tensor) -> torch.Tensor:
    """pose_b in pose_a's frame; poses (..., 3) = (x, y, heading)
    (smt_state_encoder.py:238-264)."""
    heading_a = -pose_a[..., 2]
    heading_b = -pose_b[..., 2]
    r = torch.linalg.norm(pose_a[..., :2] - pose_b[..., :2], dim=-1)
    phi = torch.atan2(pose_b[..., 1] - pose_a[..., 1], pose_b[..., 0] - pose_a[..., 0]) - heading_a
    x = r * torch.cos(phi)
    y = r * torch.sin(phi)
    heading = heading_b - heading_a
    heading = torch.atan2(torch.sin(heading), torch.cos(heading))
    return torch.stack([x, y, -heading], dim=-1)


def format_pose(pose: torch.Tensor) -> torch.Tensor:
    """(x, y, heading, t) → (x, y, cosθ, sinθ, e^{-t}) (smt_state_encoder.py:266-274)."""
    x, y, heading, t = pose.unbind(-1)
    return torch.stack([x, y, torch.cos(heading), torch.sin(heading), torch.exp(-t)], dim=-1)


class MultiHeadAttention(nn.Module):
    """q/k/v/out projections; Flax DenseGeneral (D, H, dh) kernels become
    Linear (H·dh, D) weights."""

    def __init__(self, d_model: int, generator=None):
        super().__init__()
        self.q = linear(d_model, d_model, generator)
        self.k = linear(d_model, d_model, generator)
        self.v = linear(d_model, d_model, generator)
        self.out = linear(d_model, d_model, generator)


def _layer_norm(d_model: int) -> nn.LayerNorm:
    return nn.LayerNorm(d_model, eps=1e-6)


class TransformerEncoderLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, generator=None):
        super().__init__()
        self.MultiHeadAttention_0 = MultiHeadAttention(d_model, generator)
        self.LayerNorm_0 = _layer_norm(d_model)
        self.Dense_0 = linear(d_model, dim_feedforward, generator)
        self.Dense_1 = linear(dim_feedforward, d_model, generator)
        self.LayerNorm_1 = _layer_norm(d_model)


class TransformerDecoderLayer(nn.Module):
    def __init__(self, d_model: int, dim_feedforward: int, generator=None):
        super().__init__()
        self.self_attn = MultiHeadAttention(d_model, generator)
        self.LayerNorm_0 = _layer_norm(d_model)
        self.cross_attn = MultiHeadAttention(d_model, generator)
        self.LayerNorm_1 = _layer_norm(d_model)
        self.Dense_0 = linear(d_model, dim_feedforward, generator)
        self.Dense_1 = linear(dim_feedforward, d_model, generator)
        self.LayerNorm_2 = _layer_norm(d_model)


class SMTStateEncoder(nn.Module):
    def __init__(
        self,
        input_size: int,
        d_model: int = 256,
        nhead: int = 8,
        num_encoder_layers: int = 1,
        num_decoder_layers: int = 1,
        pose_indices: Optional[Tuple[int, int]] = None,
        pretraining: bool = False,
        generator: Optional[torch.Generator] = None,
        dtype: torch.dtype = torch.float32,
    ):
        super().__init__()
        self.d_model, self.nhead, self.dtype = d_model, nhead, dtype
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.pose_indices = pose_indices
        self.pretraining = pretraining
        fused_in = input_size
        if pose_indices is not None:
            self.pose_encoder = linear(5, 16, generator)
            fused_in = input_size - (pose_indices[1] - pose_indices[0]) + 16
        self.fusion0 = linear(fused_in, d_model, generator)
        self.fusion1 = linear(d_model, d_model, generator)
        for i in range(num_encoder_layers):
            setattr(self, f"enc{i}", TransformerEncoderLayer(d_model, d_model, generator))
        for i in range(num_decoder_layers):
            setattr(self, f"dec{i}", TransformerDecoderLayer(d_model, d_model, generator))

    def entries(self, x, memory, memory_masks):
        """The transformer's inputs: (B, M+1, F') entries (memory then the
        current step, pose re-encoded) and their (B, M+1) validity."""
        b = memory.shape[0]
        if self.pretraining:
            memory_masks = torch.zeros_like(memory_masks)
        valid = torch.cat([memory_masks, torch.ones((b, 1), dtype=memory_masks.dtype, device=memory_masks.device)], dim=1)
        if self.pose_indices is not None:
            pi, pj = self.pose_indices
            x_pose = x[:, pi:pj]  # (B, 4): x, y, heading, t
            mem_pose = memory[:, :, pi:pj]
            agent_rel = compute_relative_pose(x_pose[:, :3], x_pose[:, :3])
            agent_fmt = format_pose(torch.cat([agent_rel, x_pose[:, 3:4]], -1))
            mem_rel = compute_relative_pose(x_pose[:, None, :3], mem_pose[..., :3])
            mem_fmt = format_pose(torch.cat([mem_rel, mem_pose[..., 3:4]], -1))
            x = torch.cat([x[:, :pi], self.pose_encoder(agent_fmt), x[:, pj:]], dim=-1)
            memory = torch.cat([memory[..., :pi], self.pose_encoder(mem_fmt), memory[..., pj:]], dim=-1)
        return torch.cat([memory, x[:, None, :]], dim=1), valid

    def forward(self, x, memory, memory_masks, goal: Optional[torch.Tensor] = None) -> torch.Tensor:
        """x (B, F) current step features, memory (B, M, F), memory_masks
        (B, M) 1 = valid, goal (B, d_model) or None → (B, d_model)."""
        entries, valid = self.entries(x, memory, memory_masks)
        params = dict(self.named_parameters())
        goal = None if goal is None else goal.float()
        if self.num_encoder_layers == 1 and self.num_decoder_layers == 1:
            return smt_encode(params, entries.float(), valid.float(), goal, self.nhead)
        return smt_encode_plain(params, entries, valid, goal, self.nhead,
                                self.num_encoder_layers, self.num_decoder_layers, self.dtype)
