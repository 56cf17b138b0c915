"""Environment construction from config.

PyTorch counterpart of ``avlen_tpu/sim/builder.py``: ONE batched env whose
episode packing deals scenes round-robin across env slots, over a world from
either source: ``DATASET.SOURCE "synthetic"`` (procedural worlds, their RIRs
optionally re-served from the host, ``DATASET.SYNTHETIC.PACK_HOST_RIRS``) or
``"reference"`` (the reference's on-disk tree, ``data/reference.py``).
Cached frame banks (``DATASET.FRAME_CACHE_DIR``) belong to a later slice of
the port and raise ``NotImplementedError``.
"""

from __future__ import annotations

import atexit
import os
import shutil
import tempfile
from typing import Optional, Tuple, Union

import numpy as np
import torch

from avlen_tpu_torch.config.node import ConfigNode
from avlen_tpu_torch.core.episodes import EpisodeStreamer, pack_episodes
from avlen_tpu_torch.sim.env import BatchedAudioNavEnv, EnvConfig, RewardConfig
from avlen_tpu_torch.sim.scene import precompute_sound_fft_bank, precompute_spectrogram_bank
from avlen_tpu_torch.sim.synthetic import make_episodes, make_scene_bank


def reward_config_from(config: ConfigNode) -> RewardConfig:
    rl = config.RL
    return RewardConfig(
        success_reward=rl.SUCCESS_REWARD,
        slack_reward=rl.SLACK_REWARD,
        with_time_penalty=rl.WITH_TIME_PENALTY,
        with_distance_reward=rl.WITH_DISTANCE_REWARD,
        distance_reward_scale=rl.DISTANCE_REWARD_SCALE,
        with_query_constraint=rl.WITH_QUERY_CONSTRAINT,
        num_total_query=rl.NUM_TOTAL_QUERY,
        query_reward=rl.QUERY_REWARD,
        soft_query_reward=rl.SOFT_QUERY_REWARD,
        consecutive_constraint_reward=rl.CONSECUTIVE_CONSTRAINT_REWARD,
        with_distance_constraint=rl.WITH_DISTANCE_CONSTRAINT,
        query_reward_distance=rl.QUERY_REWARD_DISTANCE,
    )


def sensors_from_task(tc: ConfigNode) -> Tuple[str, ...]:
    mapping = {
        "SPECTROGRAM_SENSOR": "spectrogram",
        "AUDIOGOAL_SENSOR": "audiogoal",
        "CATEGORY": "category",
        "CATEGORY_BELIEF": "category_belief",
        "LOCATION_BELIEF": "location_belief",
        "POSE_SENSOR": "pose",
        "COLLISION": "collision",
        "ORACLE_ACTION_SENSOR": "oracle_action",
        "POINTGOAL_WITH_GPS_COMPASS_SENSOR": "pointgoal_with_gps_compass",
        "SEMANTIC_OBJECT_SENSOR": "semantic_object",
        "EGOMAP_SENSOR": "egomap",
        "MPCAT40_INDEX_SENSOR": "mpcat40_index",
    }
    sensors = [mapping[s] for s in tc.TASK.SENSORS if s in mapping]
    if not sensors:
        sensors = ["spectrogram", "pose", "category", "collision", "oracle_action"]
    return tuple(sensors)


def build_world_from_config(
    config: ConfigNode,
    with_rgb: bool = False,
    with_depth: bool = True,
    seed: Optional[int] = None,
    device: Union[str, torch.device] = "cuda",
):
    """(bank, tables, episodes) from either asset source (module doc)."""
    tc = config.TASK_CONFIG
    if tc.DATASET.SOURCE == "reference":
        from avlen_tpu_torch.data.reference import ReferenceDataConfig, build_reference_scene_bank

        audio = tc.SIMULATOR.AUDIO
        content = list(tc.DATASET.CONTENT_SCENES)
        data_path = tc.DATASET.DATA_PATH.format(version=tc.DATASET.VERSION, split=tc.DATASET.SPLIT)
        ref_cfg = ReferenceDataConfig(
            metadata_dir=f"{audio.METADATA_DIR}/{tc.SIMULATOR.SCENE_DATASET}",
            binaural_rir_dir=f"{audio.BINAURAL_RIR_DIR}/{tc.SIMULATOR.SCENE_DATASET}",
            source_sound_dir=audio.SOURCE_SOUND_DIR,
            data_path=data_path,
            scene_observations_dir=(
                f"{tc.SIMULATOR.SCENE_OBSERVATION_DIR}/{tc.SIMULATOR.SCENE_DATASET}"
                if tc.SIMULATOR.USE_RENDERED_OBSERVATIONS else None
            ),
            sampling_rate=audio.RIR_SAMPLING_RATE,
            grid_size=tc.SIMULATOR.GRID_SIZE,
            max_rir_length=audio.MAX_RIR_LENGTH,
            scenes=None if content == ["*"] else content,
            dense_rir_max_bytes=int(audio.DENSE_RIR_MAX_BYTES),
        )
        return build_reference_scene_bank(ref_cfg, device=device)

    syn = tc.DATASET.SYNTHETIC
    if tc.DATASET.FRAME_CACHE_DIR:
        raise NotImplementedError(
            "DATASET.FRAME_CACHE_DIR (frame banks served by the native frame server) is not ported "
            "yet: ROADMAP Queue 1 item 4"
        )
    rng = np.random.RandomState(seed if seed is not None else syn.SEED)
    bank, tables = make_scene_bank(
        rng,
        num_scenes=syn.NUM_SCENES,
        side=syn.SIDE,
        grid_size=tc.SIMULATOR.GRID_SIZE,
        sampling_rate=tc.SIMULATOR.AUDIO.RIR_SAMPLING_RATE,
        rir_length=syn.RIR_LENGTH,
        num_sounds=syn.NUM_SOUNDS,
        sound_secs=syn.SOUND_SECS,
        frame_res=syn.FRAME_RES,
        with_frames=with_rgb or with_depth,
        device=device,
    )
    episodes = make_episodes(
        rng,
        tables,
        syn.NUM_EPISODES,
        grid_size=tc.SIMULATOR.GRID_SIZE,
        num_sounds=syn.NUM_SOUNDS,
        min_hops=syn.MIN_HOPS,
        max_hops=syn.MAX_HOPS,
        with_distractor=tc.SIMULATOR.AUDIO.HAS_DISTRACTOR_SOUND,
    )
    if syn.PACK_HOST_RIRS:
        pack_synthetic_host_rirs(bank, tc.SIMULATOR.AUDIO.RIR_SAMPLING_RATE)
    return bank, tables, episodes


PACK_HOST_RIRS_MAX_BYTES = 16 << 30


@torch.no_grad()
def pack_synthetic_host_rirs(bank, sampling_rate: int, pack_dir: Optional[str] = None,
                             chunk: int = 1024) -> str:
    """Render every procedural RIR and re-serve them all through the mmap
    ``HostRIRStore``, as ingested reference data is served: the config-only
    route (DATASET.SYNTHETIC.PACK_HOST_RIRS) onto the host-served audio path
    at any synthetic scale. The RIRs go to the file chunk by chunk, under
    ``pack_dir`` (default: a temporary directory removed at exit). Returns
    the index path; ``bank.rir`` becomes the store."""
    from avlen_tpu_torch.data.reference import HostRIRStore, pack_dense_rir_chunks

    s_count = bank.num_scenes
    n = bank.max_nodes
    length = bank.rir.length
    total_bytes = s_count * 4 * n * n * length * 2 * 4
    if total_bytes > PACK_HOST_RIRS_MAX_BYTES:
        raise ValueError(
            f"PACK_HOST_RIRS would render a {total_bytes / 2**30:.1f} GB dense "
            "bank; shrink SYNTHETIC.SIDE/RIR_LENGTH (real reference data is "
            "already served host-side without densification)"
        )
    combos = np.stack(
        np.meshgrid(np.arange(s_count), np.arange(4), np.arange(n), np.arange(n), indexing="ij"), -1,
    ).reshape(-1, 4)
    combos = torch.as_tensor(combos, device=bank.device)

    def chunks():
        for i in range(0, combos.shape[0], chunk):
            part = combos[i : i + chunk]
            yield bank.rir.gather(part[:, 0], part[:, 1], part[:, 2], part[:, 3]).float().cpu().numpy()

    if pack_dir is None:
        pack_dir = tempfile.mkdtemp(prefix="avlen_packed_rirs_")
        atexit.register(shutil.rmtree, pack_dir, ignore_errors=True)
    idx = pack_dense_rir_chunks(chunks(), (s_count, 4, n, n), length, os.path.join(pack_dir, "rirs"),
                                sampling_rate)
    bank.rir = HostRIRStore(idx, device=bank.device)
    return idx


def construct_batched_env(
    config: ConfigNode,
    num_envs: Optional[int] = None,
    with_rgb: bool = False,
    with_depth: bool = True,
    seed: Optional[int] = None,
    extra_sensors: Tuple[str, ...] = (),
    device: Union[str, torch.device] = "cuda",
) -> BatchedAudioNavEnv:
    tc = config.TASK_CONFIG
    b = num_envs or config.NUM_PROCESSES
    bank, tables, episodes = build_world_from_config(
        config, with_rgb=with_rgb, with_depth=with_depth, seed=seed, device=device
    )
    # heard/unheard split: no train episode may use a held-out sound
    sound_split = None
    held = list(tc.DATASET.HELD_OUT_SOUNDS)
    if held:
        names = getattr(bank, "sound_names", None)
        held_ids = set()
        for h in held:
            if isinstance(h, str) and not h.lstrip("-").isdigit():
                if names is None or h not in names:
                    raise ValueError(f"HELD_OUT_SOUNDS entry {h!r} not in the sound set")
                held_ids.add(names.index(h))
            else:
                held_ids.add(int(h))
        num_sounds = int(bank.sounds_padded.shape[0])
        train_ids = [i for i in range(num_sounds) if i not in held_ids]
        if not train_ids:
            raise ValueError("HELD_OUT_SOUNDS holds out every sound; nothing to train on")
        for ep in episodes:
            if ep.sound_id in held_ids:
                ep.sound_id = train_ids[ep.sound_id % len(train_ids)]
            if ep.distractor_sound_id in held_ids:
                ep.distractor_sound_id = train_ids[ep.distractor_sound_id % len(train_ids)]
        sound_split = (train_ids, sorted(held_ids))

    it_opts = tc.ENVIRONMENT.ITERATOR_OPTIONS
    if 0 < it_opts.NUM_EPISODE_SAMPLE < len(episodes):
        rng_s = np.random.RandomState(config.SEED)
        keep = sorted(rng_s.choice(len(episodes), it_opts.NUM_EPISODE_SAMPLE, replace=False))
        episodes = [episodes[i] for i in keep]
    packed = pack_episodes(episodes, num_envs=b)
    streamer = None
    if it_opts.SHUFFLE or it_opts.MAX_SCENE_REPEAT_EPISODES > 0:
        streamer = EpisodeStreamer(
            episodes, b, int(packed["order"].shape[1]),
            shuffle=it_opts.SHUFFLE,
            group_by_scene=it_opts.GROUP_BY_SCENE,
            max_scene_repeat_episodes=it_opts.MAX_SCENE_REPEAT_EPISODES,
            seed=config.SEED,
        )
        packed["order"] = streamer.initial_order()

    sensors = list(sensors_from_task(tc))
    if with_depth and "depth" not in sensors:
        sensors.append("depth")
    if with_rgb and "rgb" not in sensors:
        sensors.append("rgb")
    if config.RL.PPO.use_belief_predictor or config.RL.PPO.policy_type in ("smt", "dialog", "interactive"):
        extra_sensors = tuple(extra_sensors) + ("category_belief", "location_belief", "category")
    for s in extra_sensors:
        if s not in sensors:
            sensors.append(s)
    if bank.rgb is None:
        sensors = [s for s in sensors if s != "rgb"]
    if bank.depth is None:
        sensors = [s for s in sensors if s not in ("depth", "egomap")]
    if bank.semantic is None:
        sensors = [s for s in sensors if s != "semantic_object"]

    env_cfg = EnvConfig(
        max_episode_steps=tc.ENVIRONMENT.MAX_EPISODE_STEPS,
        success_distance=tc.TASK.SUCCESS_DISTANCE,
        grid_size=tc.SIMULATOR.GRID_SIZE,
        sensors=tuple(sensors),
        reward=reward_config_from(config),
        has_distractor=tc.SIMULATOR.AUDIO.HAS_DISTRACTOR_SOUND,
        record_pose_info=bool(config.VIDEO_OPTION) or "TOP_DOWN_MAP" in tc.TASK.MEASUREMENTS,
    )
    # the spectrogram bank renders through whatever serves the RIRs, the
    # host store included (JAX skips it only for its chunked host-prefetch
    # cache, which the port has no use for: a torch step reads the host
    # directly, so TPU.HOST_PREFETCH changes nothing here)
    audio_cfg = tc.SIMULATOR.AUDIO
    if audio_cfg.CACHE_SPECTROGRAMS and not env_cfg.has_distractor:
        bank.spec_bank = precompute_spectrogram_bank(bank, max_bytes=audio_cfg.SPECTROGRAM_CACHE_MAX_BYTES)
    if audio_cfg.CACHE_SOUND_FFTS and bank.spec_bank is None:
        bank.sound_fft_bank = precompute_sound_fft_bank(bank)

    env = BatchedAudioNavEnv(bank, packed, env_cfg)
    env.scene_tables = tables
    env.episodes = episodes
    env.streamer = streamer
    env.sound_split = sound_split
    return env
