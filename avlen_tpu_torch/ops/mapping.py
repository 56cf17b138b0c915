"""Batched mapping ops for AV-WAN: egomap projection, map registration,
egocentric crops and grid planning.

PyTorch counterpart of ``avlen_tpu/ops/mapping.py``, which holds no Pallas
kernel, so these are plain torch:

* ``depth_to_egomap``: the EgoMap sensor (soundspaces/tasks/nav.py:
  236-406), depth → egocentric top-down [obstacle, explored] map, one
  max-scatter over the point cloud of the whole env batch;
* ``register_egomap`` / ``egocentric_crop``: the Mapper's ego ↔ allocentric
  transforms (ss_baselines/av_wan/models/mapper.py:27-345) as quarter-turn
  rotations and gathers on (B, G, G, C) maps;
* ``distance_field`` / ``next_action_from_field``: the Planner's graph
  search (av_wan/models/planner.py:19-209) as min-plus BFS relaxations
  over the occupancy grid and a greedy step down the field.

Integer outputs (cells, actions) and the 0/1 maps equal the JAX package's.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F


def depth_to_egomap(
    depth: torch.Tensor,  # (B, H, W, 1) normalized [0, 1]
    map_size: int = 31,
    resolution: float = 0.5,
    hfov_deg: float = 90.0,
    max_depth: float = 10.0,
    height_low: float = 0.2,
    height_high: float = 1.5,
    camera_height: float = 1.25,
) -> torch.Tensor:
    """(B, map_size, map_size, 2): [obstacle, explored] egocentric top-down
    map, the agent at the bottom-centre row facing up the map."""
    b, h, w, _ = depth.shape
    dev = depth.device
    d = depth[..., 0].float() * max_depth  # meters
    f = float(np.float32((w / 2.0) / np.tan(np.deg2rad(hfov_deg / 2.0))))
    us = (torch.arange(w, device=dev) - w / 2.0 + 0.5) / f
    vs = (torch.arange(h, device=dev) - h / 2.0 + 0.5) / f
    x = d * us[None, None, :]  # rightward
    y = -d * vs[None, :, None] + camera_height  # height above the floor
    z = d  # forward

    valid = (d > 0.1) & (d < max_depth * 0.99)
    obstacle = valid & (y > height_low) & (y < height_high)
    explored = valid & (y <= height_high)

    half = map_size // 2
    # .to(int) truncates toward zero, as the JAX astype does (x < 0 left of the agent)
    col = torch.clamp((x / resolution).to(torch.int64) + half, 0, map_size - 1)
    row = torch.clamp(map_size - 1 - (z / resolution).to(torch.int64), 0, map_size - 1)
    flat = (row * map_size + col).reshape(b, -1)

    def scatter(mask):
        m = torch.zeros((b, map_size * map_size), dtype=torch.float32, device=dev)
        m.scatter_reduce_(1, flat, mask.float().reshape(b, -1), "amax", include_self=True)
        return m.reshape(b, map_size, map_size)

    return torch.stack([scatter(obstacle), scatter(explored)], dim=-1)


def _rot90_batch(m: torch.Tensor, k: torch.Tensor) -> torch.Tensor:
    """Per-env rot90 by k[i] quarter turns (any sign); m (B, G, G, C)."""
    stacked = torch.stack([torch.rot90(m, i, dims=(1, 2)) for i in range(4)])  # (4, B, G, G, C)
    return stacked[k % 4, torch.arange(m.shape[0], device=m.device)]


def register_egomap(
    allo_map: torch.Tensor,  # (B, G, G, C)
    ego_map: torch.Tensor,  # (B, E, E, C)
    row: torch.Tensor,  # (B,) agent row in the allocentric map
    col: torch.Tensor,  # (B,)
    rot: torch.Tensor,  # (B,) quarter turns CCW of the heading vs map-up
) -> torch.Tensor:
    """Paste the egomap (agent at bottom-centre facing up) into the
    allocentric map at the agent's pose, max-combined (mapper.py:116-160)."""
    b, g = allo_map.shape[:2]
    e = ego_map.shape[1]
    half = e // 2
    dev = allo_map.device
    rotated = _rot90_batch(ego_map, rot)
    # the agent's cell in the ego map rotated CCW by rot
    ar = torch.tensor([e - 1, half, 0, half], device=dev)[rot % 4]
    ac = torch.tensor([half, e - 1, half, 0], device=dev)[rot % 4]
    top, left = row - ar, col - ac
    gi = torch.arange(g, device=dev)
    ei = gi[None, :, None] - top[:, None, None]  # (B, G, 1)
    ej = gi[None, None, :] - left[:, None, None]  # (B, 1, G)
    inb = (ei >= 0) & (ei < e) & (ej >= 0) & (ej < e)  # (B, G, G)
    eis = torch.clamp(ei, 0, e - 1).expand(b, g, g)
    ejs = torch.clamp(ej, 0, e - 1).expand(b, g, g)
    bidx = torch.arange(b, device=dev)[:, None, None]
    vals = torch.where(inb[..., None], rotated[bidx, eis, ejs], 0.0)
    return torch.maximum(allo_map, vals)


def egocentric_crop(
    allo_map: torch.Tensor,  # (B, G, G, C)
    row: torch.Tensor,
    col: torch.Tensor,
    rot: torch.Tensor,
    size: int,
) -> torch.Tensor:
    """The (size, size) window centred on the agent, rotated so that the
    agent faces up (mapper.get_egocentric_* semantics)."""
    b, g = allo_map.shape[:2]
    dev = allo_map.device
    half = size // 2
    si = torch.arange(size, device=dev)
    gi = torch.clamp(row[:, None, None] - half + si[None, :, None], 0, g - 1).expand(b, size, size)
    gj = torch.clamp(col[:, None, None] - half + si[None, None, :], 0, g - 1).expand(b, size, size)
    bidx = torch.arange(b, device=dev)[:, None, None]
    return _rot90_batch(allo_map[bidx, gi, gj], -rot)


_BIG = 1e6


def distance_field(
    occupancy: torch.Tensor,  # (B, G, G), 1 = blocked
    goal_row: torch.Tensor,  # (B,)
    goal_col: torch.Tensor,  # (B,)
    num_iters: int = 64,
) -> torch.Tensor:
    """Min-plus BFS distances from the goal over free cells (the planner's
    Dijkstra with unit weights on the 4-neighbourhood), ``num_iters``
    relaxations; blocked and unreached cells hold 1e6."""
    b = occupancy.shape[0]
    blocked = occupancy > 0.5
    dist = torch.full(occupancy.shape, _BIG, dtype=torch.float32, device=occupancy.device)
    dist[torch.arange(b, device=occupancy.device), goal_row, goal_col] = 0.0
    d = torch.where(blocked, _BIG, dist)
    for _ in range(num_iters):
        p = F.pad(d, (1, 1, 1, 1), value=_BIG)
        best = torch.minimum(torch.minimum(p[:, 2:, 1:-1], p[:, :-2, 1:-1]),
                             torch.minimum(p[:, 1:-1, 2:], p[:, 1:-1, :-2])) + 1.0
        d = torch.where(blocked, _BIG, torch.minimum(d, best))
    return d


def next_action_from_field(
    dist: torch.Tensor,  # (B, G, G)
    row: torch.Tensor,
    col: torch.Tensor,
    orientation: torch.Tensor,  # (B,) quarter turns: 0 up (-row), 1 left, 2 down, 3 right
) -> torch.Tensor:
    """Greedy next low-level action down the field (planner.plan,
    planner.py:89-118): turn to face the best neighbour, then forward; STOP
    (0) where no neighbour is nearer. The first of equal neighbours wins; a
    neighbour behind turns right."""
    b, g = dist.shape[:2]
    bi = torch.arange(b, device=dist.device)
    here = dist[bi, row, col]
    nbrs = torch.stack([
        dist[bi, torch.clamp(row - 1, min=0), col],  # up
        dist[bi, row, torch.clamp(col - 1, min=0)],  # left
        dist[bi, torch.clamp(row + 1, max=g - 1), col],  # down
        dist[bi, row, torch.clamp(col + 1, max=g - 1)],  # right
    ], dim=-1)
    best_dir = torch.argmin(nbrs, dim=-1)
    improves = nbrs.gather(1, best_dir[:, None])[:, 0] < here
    delta = (best_dir - orientation) % 4
    action = torch.where(delta == 0, 1, torch.where(delta == 1, 2, 3))  # fwd / left / right (180° → right)
    return torch.where(improves, action, 0)
