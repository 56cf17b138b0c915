"""Dialog state encoder (the second transformer of π_l).

PyTorch counterpart of ``avlen_tpu/models/dialog_encoder.py`` (reference
DialogStateEncoder, ss_baselines/savi/models/dialog_state_encoder.py:43-249):
attends over the short state memory of past SMT states within the dialog
window plus the current one, each entry concatenated with the projected
CLIP dialog embedding and fused to d_model, offset by the sinusoidal
encoding of the agent's dialog-window step, through one encoder and one
decoder layer whose query is the belief vector. The JAX package runs these
layers plain, not through its fused SMT kernel, and so does the port: the
plain layers of ``ops/smt_cuda.py`` on either device.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn

from avlen_tpu_torch.models.init import linear
from avlen_tpu_torch.models.smt import TransformerDecoderLayer, TransformerEncoderLayer
from avlen_tpu_torch.ops.smt_cuda import dec_layer_plain, enc_layer_plain


def sinusoidal_table(max_len: int, d_model: int) -> np.ndarray:
    position = np.arange(max_len)[:, None]
    div = np.exp(np.arange(0, d_model, 2) * (-np.log(10000.0) / d_model))
    pe = np.zeros((max_len, d_model), np.float32)
    pe[:, 0::2] = np.sin(position * div)
    pe[:, 1::2] = np.cos(position * div)
    return pe


class DialogStateEncoder(nn.Module):
    def __init__(
        self,
        state_size: int,
        dialog_emb_size: int,
        d_model: int = 256,
        nhead: int = 8,
        num_encoder_layers: int = 1,
        num_decoder_layers: int = 1,
        max_len: int = 100,
        generator: Optional[torch.Generator] = None,
    ):
        super().__init__()
        self.d_model, self.nhead, self.max_len = d_model, nhead, max_len
        self.num_encoder_layers, self.num_decoder_layers = num_encoder_layers, num_decoder_layers
        self.fusion0 = linear(state_size + dialog_emb_size, d_model, generator)
        self.fusion1 = linear(d_model, d_model, generator)
        for i in range(num_encoder_layers):
            setattr(self, f"enc{i}", TransformerEncoderLayer(d_model, d_model, generator))
        for i in range(num_decoder_layers):
            setattr(self, f"dec{i}", TransformerDecoderLayer(d_model, d_model, generator))
        self.register_buffer("pe", torch.from_numpy(sinusoidal_table(max_len, d_model)), persistent=False)

    def forward(self, x_att, memory_state, memory_masks, dialog_emb, agent_step, goal) -> torch.Tensor:
        """x_att (B, S) current SMT state, memory_state (B, M, S) past
        states, memory_masks (B, M), dialog_emb (B, E) or None, agent_step
        (B,) step within the dialog window, goal (B, d_model) → (B, d_model)."""
        b, m, _ = memory_state.shape
        valid = torch.cat([memory_masks, torch.ones((b, 1), dtype=memory_masks.dtype, device=memory_masks.device)], 1)
        h = torch.cat([memory_state, x_att[:, None, :]], dim=1)  # (B, M+1, S)
        if dialog_emb is not None:
            d = dialog_emb[:, None, :].expand(b, m + 1, dialog_emb.shape[-1])
            h = self.fusion1(torch.relu(self.fusion0(torch.cat([h, d], dim=-1))))
        h = h + self.pe[torch.clamp(agent_step.long(), 0, self.max_len - 1)][:, None, :]
        p = dict(self.named_parameters())
        for i in range(self.num_encoder_layers):
            h = enc_layer_plain(p, f"enc{i}", self.nhead, h, valid)
        tgt = goal[:, None, :]
        for i in range(self.num_decoder_layers):
            tgt = dec_layer_plain(p, f"dec{i}", self.nhead, tgt, h, valid)
        return tgt[:, 0, :].float()
