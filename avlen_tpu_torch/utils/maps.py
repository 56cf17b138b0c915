"""Top-down map rendering for eval videos and debugging.

A copy of ``avlen_tpu/utils/maps.py`` (numpy only), kept in the port so
that it imports nothing of the JAX package. Capability match for habitat's
visualization stack (habitat/utils/visualizations/maps.py:439 +
fog_of_war.py and plot_top_down_map, ss_baselines/common/utils.py:239-288):
draws the scene graph, the agent pose, the goal, and the visited trail as
an RGB image, pixel for pixel as the JAX package draws it.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import numpy as np

AGENT_COLOR = (40, 80, 240)
GOAL_COLOR = (40, 200, 60)
NODE_COLOR = (190, 190, 190)
TRAIL_COLOR = (250, 160, 60)
BG_COLOR = (255, 255, 255)


def _to_px(positions: np.ndarray, size: int, pad: int = 10) -> Tuple[np.ndarray, float, np.ndarray]:
    xz = positions[:, [0, 2]]
    lo = xz.min(axis=0)
    hi = xz.max(axis=0)
    scale = (size - 2 * pad) / max(float((hi - lo).max()), 1e-6)
    px = ((xz - lo) * scale + pad).astype(np.int32)
    return px, scale, lo


def _disk(img: np.ndarray, center, radius: int, color) -> None:
    x0, y0 = int(center[0]), int(center[1])
    h, w = img.shape[:2]
    for dy in range(-radius, radius + 1):
        for dx in range(-radius, radius + 1):
            if dx * dx + dy * dy <= radius * radius:
                x, y = x0 + dx, y0 + dy
                if 0 <= x < w and 0 <= y < h:
                    img[y, x] = color


def reveal_fog_of_war(
    obstacle_map: np.ndarray,
    fog: np.ndarray,
    agent_yx: Tuple[int, int],
    heading_rad: float,
    fov_deg: float = 90.0,
    max_line_len: int = 100,
    rays_per_deg: float = 1.0,
) -> np.ndarray:
    """Ray-cast field-of-view reveal (habitat fog_of_war.py:reveal_fog_of_war):
    marches rays from the agent cell across the fov cone, marking traversed
    cells visible until the first obstacle (which is itself revealed).
    ``obstacle_map`` (H, W) bool/int, ``fog`` (H, W) uint8 accumulator;
    returns the updated fog (in place semantics like the reference).

    ``heading_rad`` follows the map convention of draw_top_down_map:
    0 points up the image (-y), increasing CCW."""
    h, w = fog.shape
    y0, x0 = int(agent_yx[0]), int(agent_yx[1])
    num_rays = max(int(fov_deg * rays_per_deg), 3)
    angles = heading_rad + np.deg2rad(np.linspace(-fov_deg / 2, fov_deg / 2, num_rays))
    for a in angles:
        dy, dx = -np.cos(a), -np.sin(a)  # heading 0 = up the image
        for t in range(max_line_len):
            y = int(round(y0 + dy * t))
            x = int(round(x0 + dx * t))
            if not (0 <= y < h and 0 <= x < w):
                break
            fog[y, x] = 1
            if obstacle_map[y, x]:
                break
    return fog


def apply_fog_to_image(img: np.ndarray, fog: np.ndarray, dim: float = 0.35) -> np.ndarray:
    """Dim unrevealed pixels (the reference composites fog as the
    MAP_INVALID/MAP_VALID overlay in colorize_draw_agent_and_fit_to_height)."""
    out = img.astype(np.float32)
    mask = fog.astype(np.float32)[..., None]
    out = out * (mask + (1.0 - mask) * dim)
    return out.astype(np.uint8)


def draw_top_down_map(
    positions: np.ndarray,
    edges: np.ndarray,
    agent_node: int,
    agent_rot: int,
    goal_node: int,
    trail: Optional[Sequence[int]] = None,
    size: int = 256,
    fog: Optional[np.ndarray] = None,
) -> np.ndarray:
    """(size, size, 3) uint8 top-down view of the scene graph state.
    ``fog``: optional (size, size) uint8 fog-of-war accumulator — pass the
    running per-episode fog (see reveal_fog_of_war) to dim unexplored area."""
    img = np.full((size, size, 3), BG_COLOR, np.uint8)
    px, scale, _ = _to_px(positions, size)

    for a, b in edges:
        pa, pb = px[a], px[b]
        n = max(abs(int(pb[0]) - int(pa[0])), abs(int(pb[1]) - int(pa[1])), 1)
        for t in range(n + 1):
            x = int(round(pa[0] + (pb[0] - pa[0]) * t / n))
            y = int(round(pa[1] + (pb[1] - pa[1]) * t / n))
            img[y, x] = NODE_COLOR
    for p in px:
        _disk(img, p, 2, NODE_COLOR)
    if trail:
        for node in trail:
            _disk(img, px[node], 2, TRAIL_COLOR)
    _disk(img, px[goal_node], 4, GOAL_COLOR)
    _disk(img, px[agent_node], 4, AGENT_COLOR)
    # heading tick: rotation_angle = rot*90 CCW, forward in -Z at rot 0
    th = np.deg2rad(agent_rot * 90)
    fwd = np.array([-np.sin(th), -np.cos(th)])  # (x, z)
    tip = px[agent_node] + (fwd * 8).astype(np.int32)
    _disk(img, tip, 1, AGENT_COLOR)
    if fog is not None:
        img = apply_fog_to_image(img, fog)
    return img


def top_down_map_measure(
    metrics,
    scene_tables,
    t: int,
    b: int,
    trail: Optional[Sequence[int]] = None,
    fog: Optional[np.ndarray] = None,
    size: int = 256,
) -> dict:
    """The TopDownMap *measure* payload for env slot ``b`` at rollout step
    ``t`` (habitat/tasks/nav/nav.py:705-957 info["top_down_map"] contract):
    {"map", "fog_of_war_mask", "agent_map_coord", "agent_angle"}.

    The batched env records the agent trace in its step metrics
    (EnvConfig.record_pose_info, enabled by TASK.MEASUREMENTS TOP_DOWN_MAP);
    rendering is host-side per episode — maps never ride the device hot path.
    """
    metrics = {k: np.asarray(v) for k, v in metrics.items()}
    scene = int(metrics["agent_scene"][t, b])
    tbl = scene_tables[scene]
    node = int(metrics["agent_node"][t, b])
    rot = int(metrics["agent_rot"][t, b])
    goal = int(metrics["goal_node"][t, b])
    edges = np.array(
        [[u, v] for u in range(tbl.num_nodes) for v in tbl.neighbors[u] if v >= 0],
        np.int32,
    )
    img = draw_top_down_map(
        tbl.positions, edges, node, rot, goal, trail=trail, size=size, fog=fog
    )
    px, _, _ = _to_px(tbl.positions, size)
    return {
        "map": img,
        "fog_of_war_mask": fog if fog is not None else np.ones((size, size), np.uint8),
        "agent_map_coord": (int(px[node][1]), int(px[node][0])),
        "agent_angle": float(np.deg2rad(rot * 90)),
    }
