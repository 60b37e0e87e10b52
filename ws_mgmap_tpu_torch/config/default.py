"""Experiment + task config tree (yacs-surface, reference key-compatible).

The port's copy of ``ws_mgmap_tpu/config/default.py``. Its YAMLs sit
beside it, and their ``BASE_TASK_CONFIG_PATH`` names the port's own task
YAMLs (relative to the working directory, as in the JAX package).

Mirrors the three-level tree of the reference: habitat base + task
extensions (`habitat_extensions/config/default.py:7-121`) merged under
``TASK_CONFIG``, experiment defaults
(`vlnce_baselines/config/default.py:11-152`), experiment YAML, CLI dotted
overrides. The YAML surface (CMA_AUG*.yaml keys) is preserved.
"""
from __future__ import annotations

import os
from typing import List, Optional, Union

from ws_mgmap_tpu_torch.utils.config import Config as CN


# -----------------------------------------------------------------------------
# TASK CONFIG (habitat base + habitat_extensions defaults)
# -----------------------------------------------------------------------------
def _task_config() -> CN:
    t = CN()
    t.SEED = 100
    t.ENVIRONMENT = CN()
    t.ENVIRONMENT.MAX_EPISODE_STEPS = 500
    t.ENVIRONMENT.ITERATOR_OPTIONS = CN()
    t.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = True
    t.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = 10000

    t.SIMULATOR = CN()
    t.SIMULATOR.TYPE = "FakeSim"  # or "Sim-v0" (habitat backend)
    t.SIMULATOR.FORWARD_STEP_SIZE = 0.25
    t.SIMULATOR.TURN_ANGLE = 15
    t.SIMULATOR.AGENT_0 = CN()
    t.SIMULATOR.AGENT_0.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
    # agent body (habitat-lab defaults; consumed by the navmesh)
    t.SIMULATOR.AGENT_0.RADIUS = 0.1
    t.SIMULATOR.AGENT_0.HEIGHT = 1.5
    t.SIMULATOR.HABITAT_SIM_V0 = CN()
    t.SIMULATOR.HABITAT_SIM_V0.GPU_DEVICE_ID = 0
    t.SIMULATOR.HABITAT_SIM_V0.ALLOW_SLIDING = True
    t.SIMULATOR.RGB_SENSOR = CN()
    t.SIMULATOR.RGB_SENSOR.WIDTH = 224
    t.SIMULATOR.RGB_SENSOR.HEIGHT = 224
    t.SIMULATOR.RGB_SENSOR.HFOV = 90
    t.SIMULATOR.RGB_SENSOR.POSITION = [0.0, 1.25, 0.0]
    t.SIMULATOR.DEPTH_SENSOR = CN()
    t.SIMULATOR.DEPTH_SENSOR.WIDTH = 256
    t.SIMULATOR.DEPTH_SENSOR.HEIGHT = 256
    t.SIMULATOR.DEPTH_SENSOR.HFOV = 90
    t.SIMULATOR.DEPTH_SENSOR.POSITION = [0.0, 1.25, 0.0]
    # habitat-lab DepthSensor normalization: depth -> [0,1] over
    # [MIN_DEPTH, MAX_DEPTH] meters; the mapper's depth_scale=10
    # un-normalization (`rgb_mapping.py:149`) assumes MAX_DEPTH=10
    t.SIMULATOR.DEPTH_SENSOR.MIN_DEPTH = 0.0
    t.SIMULATOR.DEPTH_SENSOR.MAX_DEPTH = 10.0
    t.SIMULATOR.DEPTH_SENSOR.NORMALIZE_DEPTH = True
    t.SIMULATOR.SEMANTIC_SENSOR = CN()
    t.SIMULATOR.SEMANTIC_SENSOR.WIDTH = 256
    t.SIMULATOR.SEMANTIC_SENSOR.HEIGHT = 256
    t.SIMULATOR.SEMANTIC_SENSOR.HFOV = 90
    t.SIMULATOR.SEMANTIC_SENSOR.POSITION = [0.0, 1.25, 0.0]

    t.TASK = CN()
    t.TASK.TYPE = "VLN-v0"
    t.TASK.SUCCESS_DISTANCE = 3.0
    t.TASK.SENSORS = [
        "INSTRUCTION_SENSOR",
        "VLN_ORACLE_ACTION_SENSOR",
        "VLN_ORACLE_PROGRESS_SENSOR",
        "VLN_ORACLE_WAYPOINT_SENSOR",
        "VLN_ORACLE_PATH_SENSOR",
        "HEADING_SENSOR",
        "COMPASS_SENSOR",
        "GPS_SENSOR",
        "GT_SEMANTIC_MAP_SENSOR",
    ]
    t.TASK.INSTRUCTION_SENSOR_UUID = "instruction"
    t.TASK.POSSIBLE_ACTIONS = ["STOP", "MOVE_FORWARD", "TURN_LEFT", "TURN_RIGHT"]
    t.TASK.MEASUREMENTS = [
        "DISTANCE_TO_GOAL", "SUCCESS", "SPL", "NDTW", "PATH_LENGTH",
        "ORACLE_SUCCESS", "STEPS_TAKEN",
    ]

    t.TASK.VLN_ORACLE_ACTION_SENSOR = CN()
    t.TASK.VLN_ORACLE_ACTION_SENSOR.TYPE = "VLNOracleActionSensor"
    t.TASK.VLN_ORACLE_ACTION_SENSOR.GOAL_RADIUS = 0.5
    t.TASK.VLN_ORACLE_ACTION_SENSOR.USE_ORIGINAL_FOLLOWER = True

    t.TASK.VLN_ORACLE_PROGRESS_SENSOR = CN()
    t.TASK.VLN_ORACLE_PROGRESS_SENSOR.TYPE = "VLNOracleProgressSensor"

    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR = CN()
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.TYPE = "VLNOracleWaypointSensor"
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.GOAL_RADIUS = 0.5
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.USE_ORIGINAL_FOLLOWER = True
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.MAP_SIZE = 100
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.MAP_RESOLUTION = 1250
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW = CN()
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.USE = True
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.SPLIT = "train"
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.GT_PATH = (
        "data/datasets/R2R_VLNCE_v1-2_preprocessed/{split}/{split}_gt.json.gz")
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.IS_SPARSE = True
    t.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.NUM_WAYPOINTS = 6

    t.TASK.VLN_ORACLE_PATH_SENSOR = CN()
    t.TASK.VLN_ORACLE_PATH_SENSOR.TYPE = "VLNOraclePathSensor"
    t.TASK.VLN_ORACLE_PATH_SENSOR.MAP_RESOLUTION = 1250
    t.TASK.VLN_ORACLE_PATH_SENSOR.MAP_SIZE = 100
    t.TASK.VLN_ORACLE_PATH_SENSOR.LINE_WIDTH = 1

    t.TASK.SEMANTIC_FILTER_SENSOR = CN()
    t.TASK.SEMANTIC_FILTER_SENSOR.TYPE = "SemanticFilterSensor"
    t.TASK.SEMANTIC_FILTER_SENSOR.HEIGHT = 256
    t.TASK.SEMANTIC_FILTER_SENSOR.WIDTH = 256
    t.TASK.SEMANTIC_FILTER_SENSOR.CATEGORY = 27

    t.TASK.GT_SEMANTIC_MAP_SENSOR = CN()
    t.TASK.GT_SEMANTIC_MAP_SENSOR.TYPE = "GtSemanticMapSensor"
    t.TASK.GT_SEMANTIC_MAP_SENSOR.MAP_SIZE = 100
    t.TASK.GT_SEMANTIC_MAP_SENSOR.SPLIT = "train"
    t.TASK.GT_SEMANTIC_MAP_SENSOR.DATA_DIR = "data/map_data/semantic/{split}"

    t.TASK.HEADING_SENSOR = CN()
    t.TASK.HEADING_SENSOR.TYPE = "HeadingSensor"

    t.TASK.NDTW = CN()
    t.TASK.NDTW.TYPE = "NDTW"
    t.TASK.NDTW.SPLIT = "val_seen"
    t.TASK.NDTW.FDTW = True
    t.TASK.NDTW.GT_PATH = (
        "data/datasets/R2R_VLNCE_v1-2_preprocessed/{split}/{split}_gt.json.gz")
    t.TASK.NDTW.SUCCESS_DISTANCE = 3.0
    t.TASK.SDTW = CN()
    t.TASK.SDTW.TYPE = "SDTW"
    t.TASK.SDTW.SPLIT = "val_seen"
    t.TASK.SDTW.FDTW = True
    t.TASK.SDTW.GT_PATH = (
        "data/datasets/R2R_VLNCE_v1-2_preprocessed/{split}/{split}_gt.json.gz")
    t.TASK.SDTW.SUCCESS_DISTANCE = 3.0
    t.TASK.PATH_LENGTH = CN(); t.TASK.PATH_LENGTH.TYPE = "PathLength"
    t.TASK.ORACLE_NAVIGATION_ERROR = CN()
    t.TASK.ORACLE_NAVIGATION_ERROR.TYPE = "OracleNavigationError"
    t.TASK.ORACLE_SUCCESS = CN()
    t.TASK.ORACLE_SUCCESS.TYPE = "OracleSuccess"
    t.TASK.ORACLE_SUCCESS.SUCCESS_DISTANCE = 3.0
    t.TASK.ORACLE_SPL = CN()
    t.TASK.ORACLE_SPL.TYPE = "OracleSPL"
    t.TASK.ORACLE_SPL.SUCCESS_DISTANCE = 3.0
    t.TASK.STEPS_TAKEN = CN(); t.TASK.STEPS_TAKEN.TYPE = "StepsTaken"
    t.TASK.SUCCESS = CN(); t.TASK.SUCCESS.SUCCESS_DISTANCE = 3.0
    t.TASK.SPL = CN(); t.TASK.SPL.SUCCESS_DISTANCE = 3.0

    t.DATASET = CN()
    t.DATASET.TYPE = "VLN-CE-v1"
    t.DATASET.SPLIT = "train"
    t.DATASET.DATA_PATH = (
        "data/datasets/R2R_VLNCE_v1-2_preprocessed/{split}/{split}.json.gz")
    t.DATASET.SCENES_DIR = "data/scene_datasets/"
    t.DATASET.CONTENT_SCENES = ["*"]
    t.DATASET.split_num = 0
    t.DATASET.split_rank = 0
    # FakeSim dataset knobs (framework extension; used when DATA_PATH is
    # missing so the full stack runs without Matterport3D assets)
    t.DATASET.FAKE_EPISODES = 16
    t.DATASET.FAKE_SCENES = 2
    # FakeSim episode difficulty band (geodesic start->goal, meters).
    # Must stay above TASK.SUCCESS_DISTANCE so nothing starts pre-solved.
    t.DATASET.FAKE_MIN_GEODESIC = 4.0
    t.DATASET.FAKE_MAX_GEODESIC = 8.0
    # Additive episode-seed offset: an independent draw of FakeSim
    # episodes for the same splits (tools/learning_check.py --seed), so
    # learning claims can be reproduced on a fresh episode set instead of
    # just re-run deterministically
    t.DATASET.FAKE_SEED_OFFSET = 0
    return t


def get_task_config(config_path: Optional[str] = None,
                    opts: Optional[list] = None) -> CN:
    config = _task_config()
    if config_path:
        config.merge_from_file(config_path)
    if opts:
        config.merge_from_list(opts)
    return config


# -----------------------------------------------------------------------------
# EXPERIMENT CONFIG (mirrors `vlnce_baselines/config/default.py:11-152`)
# -----------------------------------------------------------------------------
_C = CN()
_C.BASE_TASK_CONFIG_PATH = ""
_C.TASK_CONFIG = CN()
_C.CMD_TRAILING_OPTS = []
_C.TRAINER_NAME = "dagger"
_C.ENV_NAME = "VLNCEDaggerEnv"
_C.SIMULATOR_GPU_ID = 0
_C.SIMULATOR_GPU_IDS = None
_C.TORCH_GPU_ID = 0
_C.NUM_PROCESSES = 4
_C.VIDEO_OPTION = []
_C.VIDEO_DIR = "videos/debug"
_C.TENSORBOARD_DIR = "data/tensorboard_dirs/debug"
_C.SENSORS = ["RGB_SENSOR", "DEPTH_SENSOR"]
_C.CHECKPOINT_FOLDER = "data/checkpoints"
_C.LOG_FILE = "train.log"
_C.EVAL_CKPT_PATH_DIR = "data/checkpoints"
_C.NUM_UPDATES = 300000
_C.CHECKPOINT_INTERVAL = 512000

_C.EVAL = CN()
_C.EVAL.SPLIT = "val_seen"
_C.EVAL.USE_CKPT_CONFIG = True
_C.EVAL.EPISODE_COUNT = 2
# ours: bound the eval folder-polling idle wait in seconds (-1 = poll forever,
# the reference behavior at common_trainer.py:210-226)
_C.EVAL.POLL_IDLE_TIMEOUT = -1.0

_C.INFERENCE = CN()
_C.INFERENCE.SPLIT = "test"
_C.INFERENCE.USE_CKPT_CONFIG = True
_C.INFERENCE.CKPT_PATH = "data/checkpoints/CMA_PM_DA_Aug.pth"
_C.INFERENCE.PREDICTIONS_FILE = "predictions.json"

_C.DAGGER = CN()
_C.DAGGER.LR = 2.5e-4
_C.DAGGER.ITERATIONS = 10
_C.DAGGER.EPOCHS = 4
_C.DAGGER.UPDATE_SIZE = 5000
_C.DAGGER.BATCH_SIZE = 5
_C.DAGGER.P = 0.75
_C.DAGGER.LMDB_MAP_SIZE = 5.0e12
_C.DAGGER.LMDB_COMMIT_FREQUENCY = 50
_C.DAGGER.USE_IW = True
_C.DAGGER.PRELOAD_LMDB_FEATURES = False
_C.DAGGER.LMDB_FEATURES_DIR = "data/trajectories_dirs/debug/trajectories.lmdb"
_C.DAGGER.LOAD_FROM_CKPT = False
_C.DAGGER.CKPT_TO_LOAD = "data/checkpoints/ckpt.0.pth"

_C.MODEL = CN()
_C.MODEL.inflection_weight_coef = 3.2
_C.MODEL.ablate_depth = False
_C.MODEL.ablate_rgb = False
_C.MODEL.ablate_instruction = False
# ours: run collection/eval rollouts with the frozen trunks in bfloat16
# (parity-exempt fast path; training and parity tests stay fp32)
_C.MODEL.ROLLOUT_BF16 = False

_C.MODEL.INSTRUCTION_ENCODER = CN()
_C.MODEL.INSTRUCTION_ENCODER.vocab_size = 2504
_C.MODEL.INSTRUCTION_ENCODER.max_length = 200
_C.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings = True
_C.MODEL.INSTRUCTION_ENCODER.embedding_file = (
    "data/datasets/R2R_VLNCE_v1-2_preprocessed/embeddings.json.gz")
_C.MODEL.INSTRUCTION_ENCODER.dataset_vocab = (
    "data/datasets/R2R_VLNCE_v1-2_preprocessed/train/train.json.gz")
_C.MODEL.INSTRUCTION_ENCODER.fine_tune_embeddings = False
_C.MODEL.INSTRUCTION_ENCODER.embedding_size = 50
_C.MODEL.INSTRUCTION_ENCODER.hidden_size = 128
_C.MODEL.INSTRUCTION_ENCODER.rnn_type = "LSTM"
_C.MODEL.INSTRUCTION_ENCODER.final_state_only = False
_C.MODEL.INSTRUCTION_ENCODER.bidirectional = True
_C.MODEL.INSTRUCTION_ENCODER.backbone = "lstm"

_C.MODEL.RGB_ENCODER = CN()
_C.MODEL.RGB_ENCODER.output_size = 256
_C.MODEL.RGB_ENCODER.backbone = "unet"
_C.MODEL.RGB_ENCODER.pretrain_model = (
    "data/pretrain_model/unet-models/2021_02_14-23_42_50.pt")
# ours: torchvision resnet18 ImageNet state_dict for from-scratch init
_C.MODEL.RGB_ENCODER.imagenet_resnet18 = "data/pretrain_model/resnet18-imagenet.pth"

_C.MODEL.RGB_ENCODER.unet_width = 1.0  # channel multiplier (testbeds only)

_C.MODEL.DEPTH_ENCODER = CN()
_C.MODEL.DEPTH_ENCODER.output_size = 128
# spatial side of the depth trunk (4 for 256^2 depth; (H/2)/32 otherwise)
_C.MODEL.DEPTH_ENCODER.spatial_hw = 4
_C.MODEL.DEPTH_ENCODER.backbone = "resnet50"
_C.MODEL.DEPTH_ENCODER.ddppo_checkpoint = (
    "data/pretrain_model/ddppo-models/gibson-2plus-resnet50.pth")

_C.MODEL.MAP_ENCODER = CN()
_C.MODEL.MAP_ENCODER.ego_map_size = 100
_C.MODEL.MAP_ENCODER.output_size = 256

_C.MODEL.STATE_ENCODER = CN()
_C.MODEL.STATE_ENCODER.hidden_size = 512
_C.MODEL.STATE_ENCODER.rnn_type = "GRU"
_C.MODEL.STATE_ENCODER.input_type = ["rgb", "depth", "map"]

_C.MODEL.PROGRESS_MONITOR = CN()
_C.MODEL.PROGRESS_MONITOR.use = True
_C.MODEL.PROGRESS_MONITOR.alpha = 1.0

_C.MODEL.CONTRASTIVE_MONITOR = CN()
_C.MODEL.CONTRASTIVE_MONITOR.target_tau = 0.07
_C.MODEL.CONTRASTIVE_MONITOR.use = True
_C.MODEL.CONTRASTIVE_MONITOR.alpha = 1.0

_C.MODEL.PREDICTION_MONITOR = CN()
_C.MODEL.PREDICTION_MONITOR.use = True
_C.MODEL.PREDICTION_MONITOR.alpha = 0.1

_C.MODEL.RGBMAPPING = CN()
_C.MODEL.RGBMAPPING.map_depth = 64
_C.MODEL.RGBMAPPING.global_map_size = 240
_C.MODEL.RGBMAPPING.egocentric_map_size = 100
_C.MODEL.RGBMAPPING.resolution = 0.12
# rotate splat coordinates instead of warping the splatted grid (TPU fast
# path, half-cell-equivalent but not bitwise; see ops/projection.py)
_C.MODEL.RGBMAPPING.rotate_in_splat = False
_C.MODEL.RGBMAPPING.gpu_id = 0
_C.MODEL.RGBMAPPING.num_proc = 1

# eval-time local controller weights (`action_maker.py:60`)
_C.DDPPO_CONTROLLER_CKPT = (
    "data/pretrain_model/ddppo-models/"
    "gibson-4plus-mp3d-train-val-test-resnet50.pth")

_C.STOP_CONDITION = CN()
_C.STOP_CONDITION.TYPE = "prog"
_C.STOP_CONDITION.PROG_THRESHOLD = 0.8

_C.OVERWRITE = False
_C.LOG_INTERVAL = 100
_C.random_agent = False
_C.RESUME_CKPT = None
_C.VIDEO_NUM = 99999
_C.ego_map_size = 100
_C.same_level_train = False
_C.ep_max_len = 200
_C.step_num = 3
_C.use_ddppo = False


def get_config(config_paths: Optional[Union[List[str], str]] = None,
               opts: Optional[list] = None) -> CN:
    """YAML merge + CLI dotted overrides (`config/default.py:155-181`)."""
    config = _C.clone()
    if config_paths:
        if isinstance(config_paths, str):
            config_paths = [config_paths]
        for p in config_paths:
            config.merge_from_file(p)
    base = config.BASE_TASK_CONFIG_PATH
    task = get_task_config(base if base and os.path.exists(base) else None)
    task.merge_from_other_cfg(config.TASK_CONFIG)
    config.TASK_CONFIG = task
    if opts:
        config.CMD_TRAILING_OPTS = list(opts)
        config.merge_from_list(list(opts))
    return config


def refine_config(config: CN, local_rank: int = 0) -> CN:
    """`config/default.py:184-206`."""
    config.defrost()
    config.TORCH_GPU_ID = local_rank
    config.MODEL.RGBMAPPING.gpu_id = config.TORCH_GPU_ID
    config.MODEL.RGBMAPPING.num_proc = config.NUM_PROCESSES

    split = config.TASK_CONFIG.DATASET.SPLIT
    config.TASK_CONFIG.TASK.NDTW.SPLIT = split
    config.TASK_CONFIG.TASK.SDTW.SPLIT = split
    config.TASK_CONFIG.TASK.VLN_ORACLE_WAYPOINT_SENSOR.LAW.SPLIT = split

    if config.DAGGER.P == 1.0:
        config.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.MAX_SCENE_REPEAT_STEPS = -1
    if config.same_level_train:
        config.TASK_CONFIG.DATASET.DATA_PATH = (
            "data/datasets/R2R_VLNCE_v1-2_preprocessed/train/"
            "train_same_level.json.gz")
    if "aug" in str(config.BASE_TASK_CONFIG_PATH):
        config.TASK_CONFIG.TASK.GT_SEMANTIC_MAP_SENSOR.SPLIT = "train_aug"
    config.freeze()
    return config


def set_save_dir(config: CN, run_type: str, model_dir: Optional[str],
                 note: str = "base", local_rank: int = 0) -> CN:
    """Run-dir layout (`config/default.py:208-231`)."""
    config.defrost()
    if model_dir:
        run_dir = os.path.join(model_dir, f"run_{run_type}_{note}")
        os.makedirs(run_dir, exist_ok=True)
        config.CHECKPOINT_FOLDER = os.path.join(run_dir, "checkpoint")
        config.LOG_FILE = os.path.join(run_dir, f"{run_type}.log")
        config.TENSORBOARD_DIR = os.path.join(run_dir, "tensorboard")
        if not config.DAGGER.PRELOAD_LMDB_FEATURES:
            config.DAGGER.LMDB_FEATURES_DIR = os.path.join(
                run_dir, "trajectories.lmdb")
        config.VIDEO_DIR = os.path.join(run_dir, "video_dir")
        config.CODE_DIR = os.path.join(run_dir, "sh_n_codes")
        config.CONFIG_DIR = os.path.join(run_dir, "config")
        config.METRIC_DIR = os.path.join(run_dir, "metric")
    config.SIMULATOR_GPU_ID = local_rank
    config.freeze()
    return config
