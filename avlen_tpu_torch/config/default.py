"""Default configuration tree.

Mirrors the config surface of the reference experiment config
(ss_baselines/savi/config/default.py:31-283) and its embedded habitat task
config (habitat-lab-dialog/habitat/config/default.py + soundspaces
extensions, savi/config/default.py:186-283), with the same two-level layout:
an experiment config ``_C`` holding a task config under ``TASK_CONFIG``.
Merge semantics follow the reference's get_config
(savi/config/default.py:298-369): defaults ← yaml ← trailing CLI opts, with
model-dir derived output paths and eval-time episode-count overrides.

This is a copy of the JAX package's tree, key for key, so that one yaml gives
the same config in both packages. The ``TPU`` section is kept for that
reason; the PyTorch port reads none of its keys (the device is chosen by the
caller, and a CUDA tensor always takes the hand-written kernels).
"""

from __future__ import annotations

import os
from typing import List, Optional, Union

from avlen_tpu_torch.config.node import CN, ConfigNode

CONFIG_FILE_SEPARATOR = ","

# ---------------------------------------------------------------------------
# Experiment config
# ---------------------------------------------------------------------------
_C = CN()
_C.SEED = 0
_C.BASE_TASK_CONFIG_PATH = ""
_C.TASK_CONFIG = CN()
_C.CMD_TRAILING_OPTS = []
_C.TRAINER_NAME = "AVNavTrainer"
_C.ENV_NAME = "AudioNavRLEnv"
_C.VIDEO_OPTION = ["disk", "tensorboard"]
_C.VISUALIZATION_OPTION = ["top_down_map"]
_C.TENSORBOARD_DIR = "tb"
_C.VIDEO_DIR = "video_dir"
_C.TEST_EPISODE_COUNT = 2
_C.EVAL_CKPT_PATH_DIR = "data/checkpoints"
_C.NUM_PROCESSES = 16  # number of parallel env slots (device-batched, not processes)
_C.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
_C.CHECKPOINT_FOLDER = "data/checkpoints"
_C.MODEL_DIR = "data/models/output"
_C.NUM_UPDATES = 10000
_C.NUM_UPDATES_DIALOG = 30000
_C.LOG_INTERVAL = 10
_C.LOG_FILE = "train.log"
_C.CHECKPOINT_INTERVAL = 50000
_C.CHECKPOINT_INTERVAL_DIALOG = 1000
_C.USE_VECENV = True
_C.USE_SYNC_VECENV = False
_C.EXTRA_RGB = False
_C.DEBUG = False
_C.USE_LAST_CKPT = False
_C.DISPLAY_RESOLUTION = 128
_C.RESUME_CHECKPOINT = False
_C.ORACLE_WHEN_QUERIED = False
_C.REPLAY_STORE = False
_C.SOUND_TYPE = "unheard"

# TPU execution (new; replaces SIMULATOR_GPU_ID / TORCH_GPU_ID / GLOO-NCCL)
_C.TPU = CN()
_C.TPU.MESH_AXES = ["data"]
_C.TPU.MESH_SHAPE = [-1]  # -1 = all available devices on the axis
# compute dtype for every tower/transformer (params stay f32). float32 by
# default so CPU tests and cross-device parity checks are bit-stable; TPU
# recipes and bench.py set bfloat16 (MXU-native).
_C.TPU.PRECISION = "float32"
_C.TPU.DONATE_ROLLOUTS = True  # donate superstep carry buffers (no copy)
# chunked rollout execution (parallel/chunked.py): scan length per chunk on
# the callback-free host data path. 0 = auto (≈num_steps/6, a divisor).
_C.TPU.ROLLOUT_CHUNK = 0
# host-prefetch audio serving of the JAX package (its data/host_prefetch.py,
# for backends without host callbacks). A torch step reads the mmap
# HostRIRStore on the host directly (data/reference.py), so the audio path
# ignores it; "on" with host-served RIRs is where SPEAKER.BANK_MODE cached
# is allowed, as in JAX (dialog/instruction_source.py).
_C.TPU.HOST_PREFETCH = "auto"
# fused SMT-encode Pallas kernel (ops/pallas_smt.py): "auto" engages it on
# TPU backends (the Mosaic kernel), "on" forces it everywhere (interpreter
# off-TPU — tests only), "off" keeps the plain-XLA transformer stack.
_C.TPU.PALLAS_SMT = "auto"

# -- EVAL -------------------------------------------------------------------
_C.EVAL = CN()
_C.EVAL.SPLIT = "val"
_C.EVAL.USE_CKPT_CONFIG = True

# -- RL reward shaping (semantics: ss_baselines/common/environments.py:98-135)
_C.RL = CN()
_C.RL.SUCCESS_REWARD = 10.0
_C.RL.SLACK_REWARD = -0.01
_C.RL.WITH_TIME_PENALTY = True
_C.RL.WITH_DISTANCE_REWARD = True
_C.RL.DISTANCE_REWARD_SCALE = 1.0
_C.RL.TIME_DIFF = False  # schema parity; dead in the reference too (grep: only declared)
_C.RL.QUERY_REWARD = -1.0
_C.RL.CONSECUTIVE_REWARD = -0.5
_C.RL.CONSECUTIVE_CONSTRAINT_REWARD = False
_C.RL.QUERY_REWARD_DISTANCE = -1.0
_C.RL.WITH_QUERY_CONSTRAINT = True
_C.RL.NUM_TOTAL_QUERY = 5
_C.RL.SOFT_QUERY_REWARD = False
_C.RL.SOFT_QUERY_REWARD_MAX = -0.1  # schema parity; only in commented-out reference code (environments.py:117)
# distance-sampled query reward (environments.py:126-133): on query, draw
# s ~ gaussian(MEAN, SD) or beta(ALPHA, BETA); if dtg*s <= 3 add QUERY_REWARD_DISTANCE
_C.RL.DISTANCE_DISTRIBUTION_TYPE = "gaussian"
_C.RL.WITH_DISTANCE_CONSTRAINT = False
_C.RL.MEAN = 0.0
_C.RL.SD = 0.5
_C.RL.ALPHA = 2.0
_C.RL.BETA = 2.0

# -- PPO (semantics: ss_baselines/savi/ppo/ppo.py:30-303) -------------------
_C.RL.PPO = CN()
_C.RL.PPO.clip_param = 0.2
_C.RL.PPO.ppo_epoch = 4
_C.RL.PPO.num_mini_batch = 2
_C.RL.PPO.value_loss_coef = 0.5
_C.RL.PPO.entropy_coef = 0.01
_C.RL.PPO.lr = 7e-4
_C.RL.PPO.eps = 1e-5
_C.RL.PPO.max_grad_norm = 0.5
_C.RL.PPO.num_steps = 5
_C.RL.PPO.hidden_size = 512
_C.RL.PPO.use_gae = True
_C.RL.PPO.use_linear_lr_decay = False
_C.RL.PPO.use_linear_clip_decay = False
_C.RL.PPO.gamma = 0.99
_C.RL.PPO.tau = 0.95
_C.RL.PPO.reward_window_size = 50
_C.RL.PPO.use_normalized_advantage = False
_C.RL.PPO.unct_coef = 0.5
# CLIP text tower size (ViT-B/32 text defaults; shrink for smoke tests)
_C.RL.PPO.CLIP_WIDTH = 512
_C.RL.PPO.CLIP_LAYERS = 12
_C.RL.PPO.policy_type = "rnn"  # rnn | smt | dialog | interactive
_C.RL.PPO.use_external_memory = False
_C.RL.PPO.use_state_memory = False
_C.RL.PPO.use_mlp_state_encoder = False

_C.RL.PPO.SCENE_MEMORY_TRANSFORMER = CN()
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.memory_size = 300
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.hidden_size = 128
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.nhead = 8
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.num_encoder_layers = 1
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.num_decoder_layers = 1
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.dropout = 0.0
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.activation = "relu"
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.use_pretrained = False
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.pretrained_path = ""
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.freeze_encoders = False
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.pretraining = False
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.use_action_encoding = True
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.use_belief_encoding = False
# TPU-native: PPO re-evaluation reconstructs each step's ring-memory view by
# gather (rl/rollout_smt.py:reconstruct_memory_views) and runs the SMT on
# (batched_eval_chunk * B)-row batches instead of T sequential scan steps —
# same math (tests/test_batched_smt_eval.py), MXU-sized matmuls
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval = True
_C.RL.PPO.SCENE_MEMORY_TRANSFORMER.batched_eval_chunk = 15

_C.RL.PPO.use_belief_predictor = False
_C.RL.PPO.BELIEF_PREDICTOR = CN()
_C.RL.PPO.BELIEF_PREDICTOR.online_training = False
_C.RL.PPO.BELIEF_PREDICTOR.lr = 1e-3
_C.RL.PPO.BELIEF_PREDICTOR.audio_only = False
_C.RL.PPO.BELIEF_PREDICTOR.train_encoder = False
_C.RL.PPO.BELIEF_PREDICTOR.normalize_category_distribution = False
_C.RL.PPO.BELIEF_PREDICTOR.use_label_belief = True
_C.RL.PPO.BELIEF_PREDICTOR.use_location_belief = True
_C.RL.PPO.BELIEF_PREDICTOR.current_pred_only = False
_C.RL.PPO.BELIEF_PREDICTOR.weighting_factor = 0.5
_C.RL.PPO.BELIEF_PREDICTOR.pretrained_path = ""

# -- DD-PPO (semantics: ss_baselines/savi/ddppo/algo/ddppo.py; TPU: pjit+pmean)
_C.RL.DDPPO = CN()
_C.RL.DDPPO.sync_frac = 0.6  # kept for config parity; SPMD has no stragglers
_C.RL.DDPPO.distrib_backend = "ICI"  # reference: GLOO|NCCL; here: ICI collectives
_C.RL.DDPPO.rnn_type = "LSTM"
_C.RL.DDPPO.num_recurrent_layers = 1
_C.RL.DDPPO.backbone = "resnet50"
_C.RL.DDPPO.pretrained_weights = ""
_C.RL.DDPPO.pretrained = False
_C.RL.DDPPO.reset_critic = True
_C.RL.DDPPO.master_port = None

# -- speaker / oracle-instruction source ------------------------------------
# The reference invokes a pretrained R2R speaker on every query
# (ppo_trainer.py:549-562, speaker_pipeline.py:110-124). Here the source is
# configurable: template or neural backend, and banked (precomputed token
# tensor, zero host round-trips) or per-query host callback (scale-safe for
# real Matterport scene sizes where an O(N^2) bank is infeasible).
_C.SPEAKER = CN()
_C.SPEAKER.BACKEND = "template"  # template | neural
_C.SPEAKER.CKPT_PATH = ""  # neural speaker checkpoint (train_speaker output)
_C.SPEAKER.USE_PANO_FEATURES = False  # heading-aligned panorama view features
_C.SPEAKER.BANK_MODE = "auto"  # auto | bank | callback | cached
_C.SPEAKER.MAX_BANK_NODES = 64  # auto: callback when a scene exceeds this
# device token-cache capacity for the chunked-prefetch instruction source
# (dialog/instr_prefetch.py — the callback-less real-scale path)
_C.SPEAKER.CACHE_SLOTS = 4096

# -- dialog / AVLEN ---------------------------------------------------------
_C.DIALOG_TRAINING = False
_C.DIALOG_TRAINING_WITHOUT_DIALOG = False
_C.NUM_DIALOG_STEPS = 5
_C.QUERY_COUNT_EMB_SIZE = 32
_C.AGENT_STEP_EMB_SIZE = 128
_C.GOAL_CKPT_PATH = ""  # frozen π_g weights (savi_interactive_1st_stage.yaml:18)
_C.VLN_CKPT_PATH = ""  # pretrained π_l weights (savi_interactive_1st_stage.yaml:14)
_C.QUERY_WITHIN_RADIUS = True
_C.ALLOW_STOP = False
# eval-time query strategy (ppo_trainer.py:1333-1356, 2036)
_C.QS_METHOD = "ours"  # ours | random | uniform | jask
_C.PREDICTION_INTERVAL = 10  # AV-WAN low-level steps per waypoint
_C.HOW_MANY_QUERY = 3
_C.LIMIT_QUERY = True
_C.ENFORCED_GAP = 1

# ---------------------------------------------------------------------------
# Task config (habitat-style SIMULATOR/TASK/DATASET/ENVIRONMENT tree)
# ---------------------------------------------------------------------------
_TC = CN()

_TC.ENVIRONMENT = CN()
_TC.ENVIRONMENT.MAX_EPISODE_STEPS = 500
_TC.ENVIRONMENT.MAX_EPISODE_SECONDS = 10000000
_TC.ENVIRONMENT.ITERATOR_OPTIONS = CN()
_TC.ENVIRONMENT.ITERATOR_OPTIONS.CYCLE = True
_TC.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = True
_TC.ENVIRONMENT.ITERATOR_OPTIONS.GROUP_BY_SCENE = True
_TC.ENVIRONMENT.ITERATOR_OPTIONS.NUM_EPISODE_SAMPLE = -1
_TC.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_EPISODES = -1
_TC.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = 10000
_TC.ENVIRONMENT.ITERATOR_OPTIONS.STEP_REPETITION_RANGE = 0.2

_TC.SIMULATOR = CN()
_TC.SIMULATOR.TYPE = "SoundSpacesSim"
_TC.SIMULATOR.SEED = 100
_TC.SIMULATOR.FORWARD_STEP_SIZE = 0.25
_TC.SIMULATOR.GRID_SIZE = 0.5
_TC.SIMULATOR.CONTINUOUS_VIEW_CHANGE = False
_TC.SIMULATOR.VIEW_CHANGE_FPS = 10
_TC.SIMULATOR.SCENE_DATASET = "replica"
_TC.SIMULATOR.USE_RENDERED_OBSERVATIONS = True
_TC.SIMULATOR.SCENE_OBSERVATION_DIR = "data/scene_observations"
_TC.SIMULATOR.USE_SYNC_VECENV = False
_TC.SIMULATOR.SCENE = ""
_TC.SIMULATOR.TURN_ANGLE = 90

_TC.SIMULATOR.RGB_SENSOR = CN()
_TC.SIMULATOR.RGB_SENSOR.HEIGHT = 128
_TC.SIMULATOR.RGB_SENSOR.WIDTH = 128
_TC.SIMULATOR.RGB_SENSOR.HFOV = 90
_TC.SIMULATOR.DEPTH_SENSOR = CN()
_TC.SIMULATOR.DEPTH_SENSOR.HEIGHT = 128
_TC.SIMULATOR.DEPTH_SENSOR.WIDTH = 128
_TC.SIMULATOR.DEPTH_SENSOR.HFOV = 90
_TC.SIMULATOR.DEPTH_SENSOR.MIN_DEPTH = 0.0
_TC.SIMULATOR.DEPTH_SENSOR.MAX_DEPTH = 10.0
_TC.SIMULATOR.DEPTH_SENSOR.NORMALIZE_DEPTH = True
_TC.SIMULATOR.SEMANTIC_SENSOR = CN()
_TC.SIMULATOR.SEMANTIC_SENSOR.HEIGHT = 128
_TC.SIMULATOR.SEMANTIC_SENSOR.WIDTH = 128

_TC.SIMULATOR.AUDIO = CN()
_TC.SIMULATOR.AUDIO.SCENE = ""
_TC.SIMULATOR.AUDIO.EVERLASTING = True
_TC.SIMULATOR.AUDIO.BINAURAL_RIR_DIR = "data/binaural_rirs"
_TC.SIMULATOR.AUDIO.RIR_SAMPLING_RATE = 44100
_TC.SIMULATOR.AUDIO.SOURCE_SOUND_DIR = "data/sounds/1s_all"
_TC.SIMULATOR.AUDIO.METADATA_DIR = "data/metadata"
_TC.SIMULATOR.AUDIO.POINTS_FILE = "points.txt"
_TC.SIMULATOR.AUDIO.GRAPH_FILE = "graph.pkl"
_TC.SIMULATOR.AUDIO.HAS_DISTRACTOR_SOUND = False
_TC.SIMULATOR.AUDIO.DISTRACTOR_SOUND_DIR = "data/sounds/1s_all_distractor"
# TPU-native: cap on padded RIR length in samples (bucketed padding)
_TC.SIMULATOR.AUDIO.MAX_RIR_LENGTH = 24000
# reference-data RIR storage: dense device bank below this byte size,
# mmap HostRIRStore above (each step reads its RIRs on the host and copies
# them to the device, data/reference.py). Force 0 to route ALL audio through
# the host store (real-Matterport-scale path).
_TC.SIMULATOR.AUDIO.DENSE_RIR_MAX_BYTES = 2147483648
# device associative-cache capacity (entries) for the host-prefetch audio
# path; HBM cost ≈ slots × rir_len × 2ch × 4B (data/host_prefetch.py)
_TC.SIMULATOR.AUDIO.RIR_CACHE_SLOTS = 4096
# Precompute the full spectrogram bank on device (the reference's
# _spectrogram_cache steady state); auto-skipped for multi-second sounds,
# distractors, or when the bank exceeds the byte budget.
_TC.SIMULATOR.AUDIO.CACHE_SPECTROGRAMS = True
# precompute per-(sound, second) convolution-segment rFFTs (tiny bank): the
# non-banked audio path then skips one large rFFT per env per step
_TC.SIMULATOR.AUDIO.CACHE_SOUND_FFTS = True
_TC.SIMULATOR.AUDIO.SPECTROGRAM_CACHE_MAX_BYTES = 4294967296

_TC.TASK = CN()
_TC.TASK.TYPE = "AudioNav"
_TC.TASK.SUCCESS_DISTANCE = 0.2
_TC.TASK.SENSORS = []
_TC.TASK.MEASUREMENTS = []
_TC.TASK.GOAL_SENSOR_UUID = "pointgoal"
_TC.TASK.POSSIBLE_ACTIONS = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]

_TC.TASK.AUDIOGOAL_SENSOR = CN()
_TC.TASK.AUDIOGOAL_SENSOR.TYPE = "AudioGoalSensor"
_TC.TASK.SPECTROGRAM_SENSOR = CN()
_TC.TASK.SPECTROGRAM_SENSOR.TYPE = "SpectrogramSensor"
_TC.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR = CN()
_TC.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR.TYPE = "PointGoalWithGPSCompassSensor"
_TC.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR.GOAL_FORMAT = "POLAR"
_TC.TASK.POINTGOAL_WITH_GPS_COMPASS_SENSOR.DIMENSIONALITY = 2

_TC.TASK.CATEGORY = CN()
_TC.TASK.CATEGORY.TYPE = "Category"
_TC.TASK.CATEGORY_BELIEF = CN()
_TC.TASK.CATEGORY_BELIEF.TYPE = "CategoryBelief"
_TC.TASK.LOCATION_BELIEF = CN()
_TC.TASK.LOCATION_BELIEF.TYPE = "LocationBelief"
_TC.TASK.MPCAT40_INDEX_SENSOR = CN()
_TC.TASK.MPCAT40_INDEX_SENSOR.TYPE = "MPCat40IndexSensor"
_TC.TASK.POSE_SENSOR = CN()
_TC.TASK.POSE_SENSOR.TYPE = "PoseSensor"
_TC.TASK.COLLISION = CN()
_TC.TASK.COLLISION.TYPE = "Collision"
_TC.TASK.ORACLE_ACTION_SENSOR = CN()
_TC.TASK.ORACLE_ACTION_SENSOR.TYPE = "OracleActionSensor"

# AV-WAN mapping sensors (av_wan/config/default.py:161-193)
_TC.TASK.GEOMETRIC_MAP = CN()
_TC.TASK.GEOMETRIC_MAP.TYPE = "GeometricMap"
_TC.TASK.GEOMETRIC_MAP.MAP_SIZE = 200
_TC.TASK.GEOMETRIC_MAP.INTERNAL_MAP_SIZE = 500
_TC.TASK.GEOMETRIC_MAP.MAP_RESOLUTION = 0.1
_TC.TASK.GEOMETRIC_MAP.NUM_CHANNEL = 2
_TC.TASK.ACOUSTIC_MAP = CN()
_TC.TASK.ACOUSTIC_MAP.TYPE = "AcousticMap"
_TC.TASK.ACOUSTIC_MAP.MAP_SIZE = 20
_TC.TASK.ACOUSTIC_MAP.MAP_RESOLUTION = 0.5
_TC.TASK.ACOUSTIC_MAP.NUM_CHANNEL = 1
_TC.TASK.ACOUSTIC_MAP.ENCODING = "average_intensity"
_TC.TASK.ACTION_MAP = CN()
_TC.TASK.ACTION_MAP.TYPE = "ActionMap"
_TC.TASK.ACTION_MAP.MAP_SIZE = 9
_TC.TASK.ACTION_MAP.MAP_RESOLUTION = 0.5
_TC.TASK.ACTION_MAP.NUM_CHANNEL = 1
_TC.TASK.INTENSITY = CN()
_TC.TASK.INTENSITY.TYPE = "Intensity"

_TC.TASK.EGOMAP_SENSOR = CN()
_TC.TASK.EGOMAP_SENSOR.TYPE = "EgoMap"
_TC.TASK.EGOMAP_SENSOR.MAP_SIZE = 31
_TC.TASK.EGOMAP_SENSOR.MAP_RESOLUTION = 0.1
_TC.TASK.EGOMAP_SENSOR.HEIGHT_THRESH = [0.2, 1.5]

# Measures
_TC.TASK.SUCCESS = CN()
_TC.TASK.SUCCESS.TYPE = "Success"
_TC.TASK.SUCCESS.SUCCESS_DISTANCE = 0.2
_TC.TASK.SPL = CN()
_TC.TASK.SPL.TYPE = "SPL"
_TC.TASK.SOFT_SPL = CN()
_TC.TASK.SOFT_SPL.TYPE = "SoftSPL"
_TC.TASK.DISTANCE_TO_GOAL = CN()
_TC.TASK.DISTANCE_TO_GOAL.TYPE = "DistanceToGoal"
_TC.TASK.DISTANCE_TO_GOAL.DISTANCE_TO = "POINT"  # POINT | VIEW_POINTS
_TC.TASK.NORMALIZED_DISTANCE_TO_GOAL = CN()
_TC.TASK.NORMALIZED_DISTANCE_TO_GOAL.TYPE = "NormalizedDistanceToGoal"
_TC.TASK.NUM_ACTION = CN()
_TC.TASK.NUM_ACTION.TYPE = "NA"
_TC.TASK.SUCCESS_WEIGHTED_BY_NUM_ACTION = CN()
_TC.TASK.SUCCESS_WEIGHTED_BY_NUM_ACTION.TYPE = "SNA"
_TC.TASK.SUCCESS_WHEN_SILENT = CN()
_TC.TASK.SUCCESS_WHEN_SILENT.TYPE = "SWS"
_TC.TASK.TOP_DOWN_MAP = CN()
_TC.TASK.TOP_DOWN_MAP.TYPE = "TopDownMap"

_TC.DATASET = CN()
_TC.DATASET.TYPE = "AudioNav"
# Asset source: "synthetic" = procedurally generated worlds
# (avlen_tpu/sim/synthetic.py); "reference" = the reference's on-disk data
# tree — metadata points.txt/graph.pkl, binaural RIR wav trees, frame-cache
# pickles, content/{scene}.json.gz episode shards (avlen_tpu/data/reference.py)
_TC.DATASET.SOURCE = "synthetic"
_TC.DATASET.SPLIT = "train"
_TC.DATASET.VERSION = "v1"
_TC.DATASET.SCENES_DIR = "data/scene_datasets"
_TC.DATASET.CONTENT_SCENES = ["*"]
_TC.DATASET.DATA_PATH = "data/datasets/audionav/{split}/{split}.json.gz"
# native mmap frame banks (scripts/cache_observations.py) loaded through the
# frame server at env build; the counterpart of USE_RENDERED_OBSERVATIONS
# pickles for the synthetic path
_TC.DATASET.FRAME_CACHE_DIR = ""
# heard/unheard protocol (the paper's eval splits; reference eval switch at
# soundspaces/tasks/semantic_audionav_task.py:222-224): sounds listed here
# are HELD OUT of training — train episodes using one are remapped onto the
# train sound set — and SOUND_TYPE=unheard evals remap every episode onto
# them (heard evals stay on the train set). Entries are sound ids
# (synthetic) or sound file names (reference data).
_TC.DATASET.HELD_OUT_SOUNDS = []
# Synthetic world generation (used when TYPE == "synthetic"; this environment
# ships no Matterport/Replica assets, so tests and benchmarks run on
# procedurally generated scenes — see avlen_tpu/sim/synthetic.py)
_TC.DATASET.SYNTHETIC = CN()
_TC.DATASET.SYNTHETIC.NUM_SCENES = 2
_TC.DATASET.SYNTHETIC.SIDE = 8
_TC.DATASET.SYNTHETIC.NUM_EPISODES = 200
_TC.DATASET.SYNTHETIC.RIR_LENGTH = 2000
_TC.DATASET.SYNTHETIC.NUM_SOUNDS = 4
_TC.DATASET.SYNTHETIC.SOUND_SECS = 1
_TC.DATASET.SYNTHETIC.FRAME_RES = 64
# re-serve the procedural RIRs through the mmap HostRIRStore (as ingested
# reference data is) — config-only route to the host-served audio paths
# (io_callback / chunked prefetch) at any synthetic scale (sim/builder.py)
_TC.DATASET.SYNTHETIC.PACK_HOST_RIRS = False
_TC.DATASET.SYNTHETIC.MIN_HOPS = 2
_TC.DATASET.SYNTHETIC.MAX_HOPS = 40
_TC.DATASET.SYNTHETIC.SEED = 0


def get_task_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
) -> ConfigNode:
    config = _TC.clone()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = config_paths.split(CONFIG_FILE_SEPARATOR)
        for config_path in config_paths:
            config.merge_from_file(config_path)
    if opts:
        config.merge_from_list(opts)
    config.freeze()
    return config


def get_config(
    config_paths: Optional[Union[List[str], str]] = None,
    opts: Optional[list] = None,
    model_dir: Optional[str] = None,
    run_type: Optional[str] = None,
    overwrite: bool = False,
) -> ConfigNode:
    """defaults ← yaml chain ← CLI opts, with model-dir path derivation and the
    eval-time overrides of the reference (savi/config/default.py:298-369)."""
    config = _C.clone()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = config_paths.split(CONFIG_FILE_SEPARATOR)
        for path in config_paths:
            config.merge_from_file(path)

    if config.BASE_TASK_CONFIG_PATH:
        config.TASK_CONFIG = get_task_config(config.BASE_TASK_CONFIG_PATH).clone()
    else:
        config.TASK_CONFIG = _TC.clone()

    if model_dir is not None:
        config.MODEL_DIR = model_dir
    config.TENSORBOARD_DIR = os.path.join(config.MODEL_DIR, "tb")
    config.CHECKPOINT_FOLDER = os.path.join(config.MODEL_DIR, "data")
    config.VIDEO_DIR = os.path.join(config.MODEL_DIR, "video_dir")
    config.LOG_FILE = os.path.join(config.MODEL_DIR, "train.log")
    config.EVAL_CKPT_PATH_DIR = os.path.join(config.MODEL_DIR, "data")

    if opts:
        config.CMD_TRAILING_OPTS = list(opts)
        config.merge_from_list(list(opts))

    if run_type == "eval":
        if not config.DIALOG_TRAINING:
            config.NUM_PROCESSES = 10
            if config.EVAL.SPLIT.startswith("val"):
                config.USE_SYNC_VECENV = True
                config.TEST_EPISODE_COUNT = 500
            elif config.EVAL.SPLIT.startswith("test"):
                config.TEST_EPISODE_COUNT = 1000
        else:
            config.NUM_PROCESSES = 8
            if config.EVAL.SPLIT == "val":
                config.TEST_EPISODE_COUNT = 7051
            elif config.EVAL.SPLIT == "train":
                config.TEST_EPISODE_COUNT = 77516

    config.TASK_CONFIG.defrost()
    config.TASK_CONFIG.SIMULATOR.USE_SYNC_VECENV = config.USE_SYNC_VECENV
    config.TASK_CONFIG.freeze()
    config.freeze()
    return config
