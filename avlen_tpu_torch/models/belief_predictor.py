"""Goal-descriptor (belief) predictor.

PyTorch counterpart of ``avlen_tpu/models/belief_predictor.py`` (reference
belief_predictor.py:56-230): ResNet-18 towers over the 2-channel
spectrogram predicting a 21-way category belief and a 2-d relative goal
location, fused across steps by an EMA in the odometry frame.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple, Union

import torch
import torch.nn as nn

from avlen_tpu_torch.models.resnet import ResNet18


class BeliefState(NamedTuple):
    last_pointgoal: torch.Tensor  # (B, 2) odom frame
    has_pointgoal: torch.Tensor  # (B,) f32
    last_label: torch.Tensor  # (B, 21)
    has_label: torch.Tensor  # (B,) f32


def init_belief_state(batch: int, num_categories: int = 21,
                      device: Union[str, torch.device] = "cuda") -> BeliefState:
    def z(*shape):
        return torch.zeros(shape, dtype=torch.float32, device=device)

    return BeliefState(z(batch, 2), z(batch), z(batch, num_categories), z(batch))


class BeliefPredictorNet(nn.Module):
    """Location regressor + category classifier towers."""

    def __init__(self, num_categories: int = 21, predict_label: bool = True,
                 predict_location: bool = True, has_distractor_sound: bool = False,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.has_distractor_sound = has_distractor_sound
        if predict_location:
            in_ch = 2 + (num_categories if has_distractor_sound else 0)
            self.predictor = ResNet18(in_ch, 2, generator=generator)
        if predict_label:
            self.classifier = ResNet18(2, num_categories, generator=generator)

    def forward(self, spectrogram: torch.Tensor, category: Optional[torch.Tensor] = None):
        """spectrogram (B, F, T, 2); category (B, 21) one-hot for distractor
        mode → (location (B, 2) | None, label logits (B, 21) | None)."""
        label = self.classifier(spectrogram) if hasattr(self, "classifier") else None
        return self.location(spectrogram, category), label

    def location(self, spectrogram: torch.Tensor, category: Optional[torch.Tensor] = None):
        """The location head alone: (B, 2), or None without one."""
        if not hasattr(self, "predictor"):
            return None
        x = spectrogram
        if self.has_distractor_sound and category is not None:
            cat_maps = category[:, None, None, :].expand(*x.shape[:3], category.shape[-1])
            x = torch.cat([x, cat_maps], dim=-1)
        return self.predictor(x)


def base_to_odom(pg_base: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(B,2) base-frame pointgoal → odom frame (belief_predictor.py:214-221)."""
    angle = -pose[:, 2]
    d = torch.linalg.norm(pg_base, dim=-1)
    theta = torch.atan2(pg_base[:, 1], pg_base[:, 0])
    return torch.stack([pose[:, 0] + d * torch.cos(theta + angle), pose[:, 1] + d * torch.sin(theta + angle)], -1)


def odom_to_base(pg_odom: torch.Tensor, pose: torch.Tensor) -> torch.Tensor:
    """(belief_predictor.py:223-230)."""
    angle = -pose[:, 2]
    delta = pg_odom - pose[:, :2]
    delta_theta = torch.atan2(delta[:, 1], delta[:, 0]) - angle
    d = torch.linalg.norm(delta, dim=-1)
    return torch.stack([d * torch.cos(delta_theta), d * torch.sin(delta_theta)], -1)


def update_beliefs(
    net: BeliefPredictorNet,
    belief_state: BeliefState,
    obs: dict,
    new_episode: torch.Tensor,  # (B,) bool — clears the EMA like dones do
    weighting_factor: float = 0.5,
    current_pred_only: bool = False,
) -> Tuple[BeliefState, torch.Tensor, torch.Tensor]:
    """One belief refresh (BeliefPredictor.update, belief_predictor.py:141-206).
    Returns (state, category_belief (B,21), location_belief (B,2))."""
    spec = obs["spectrogram"]
    pose = obs["pose"]
    b = spec.shape[0]
    has_audio = (spec.abs().sum(dim=(1, 2, 3)) != 0).float()

    location, label_logits = net(spec, obs.get("category"))
    w = weighting_factor
    has_pg = torch.where(new_episode, 0.0, belief_state.has_pointgoal)
    has_lb = torch.where(new_episode, 0.0, belief_state.has_label)

    # ---- location belief: predicted frame (X right, -Y forward) → base frame
    pg_base = torch.stack([-location[:, 1], location[:, 0]], -1)
    last_in_base = odom_to_base(belief_state.last_pointgoal, pose)
    if current_pred_only:
        pg_avg_audio = pg_base
    else:
        pg_avg_audio = torch.where(has_pg[:, None] > 0, (1 - w) * pg_base + w * last_in_base, pg_base)
    pg_avg_silent = torch.where(has_pg[:, None] > 0, last_in_base, torch.full((b, 2), 10.0, device=spec.device))
    pg_avg = torch.where(has_audio[:, None] > 0, pg_avg_audio, pg_avg_silent)
    new_last_pg = torch.where(has_audio[:, None] > 0, base_to_odom(pg_avg, pose), belief_state.last_pointgoal)
    new_has_pg = torch.maximum(has_pg, has_audio)

    # ---- label belief
    lb = label_logits
    if current_pred_only:
        lb_avg_audio = lb
    else:
        lb_avg_audio = torch.where(has_lb[:, None] > 0, (1 - w) * lb + w * belief_state.last_label, lb)
    uniform = torch.full_like(lb, 1.0 / lb.shape[-1])
    lb_avg_silent = torch.where(has_lb[:, None] > 0, belief_state.last_label, uniform)
    lb_avg = torch.where(has_audio[:, None] > 0, lb_avg_audio, lb_avg_silent)
    new_last_lb = torch.where(has_audio[:, None] > 0, lb_avg, belief_state.last_label)
    new_has_lb = torch.maximum(has_lb, has_audio)

    new_state = BeliefState(new_last_pg, new_has_pg, new_last_lb, new_has_lb)
    return new_state, lb_avg, pg_avg
