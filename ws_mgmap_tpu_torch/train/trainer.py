"""Trainer orchestration: DAgger training, checkpoint-folder evaluation and
leaderboard inference.

Port of ``ws_mgmap_tpu/train/trainer.py``, which re-provides
`CommonTrainer`/`DaggerTrainer` (`vlnce_baselines/common_trainer.py:29-535`,
`dagger_trainer.py:241-678`): per DAgger iteration a rollout engine built
from the current weights collects beta-mixed episodes into the
trajectory store (``train/collector.py``), then teacher-forcing epochs
read the store (``train/replay.py``) through the update of
``train/step.py``, rank 0 writes a ``ckpt.<index>.pth`` per epoch and
evaluates on a reduced validation split. One process is one rank with
one device (``parallel/mesh.py``); with more than one rank the update is
the data-parallel one and the ranks meet at a barrier after collection.
"""
from __future__ import annotations

import gzip
import json
import os
import re
import time
import traceback
import warnings
import zlib
from typing import Dict, List, Optional

import numpy as np
import torch
import torch.distributed as dist

from ws_mgmap_tpu_torch.env.dataset import (
    VLNCEDataset,
    fake_gt_locations,
    make_fake_dataset,
)
from ws_mgmap_tpu_torch.models.instruction_encoder import (
    load_pretrained_embeddings)
from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.parallel import mesh
from ws_mgmap_tpu_torch.train import checkpoint as ckpt_lib
from ws_mgmap_tpu_torch.train import step as step_lib
from ws_mgmap_tpu_torch.train.collector import collect_dataset
from ws_mgmap_tpu_torch.train.evaluator import (EvalObserver, evaluate,
                                                rollout)
from ws_mgmap_tpu_torch.train.losses import MonitorConfig
from ws_mgmap_tpu_torch.train.replay import ReplayLoader
from ws_mgmap_tpu_torch.train.rollout import RolloutEngine
from ws_mgmap_tpu_torch.utils.convert import (ddppo_depth_state,
                                              import_imagenet_resnet18,
                                              load_matching,
                                              load_torch_checkpoint)
from ws_mgmap_tpu_torch.utils.device import resolve_device

_CKPT_INDEX = re.compile(r"ckpt\.(\d+)\.pth$")


def load_split(config, split: str):
    """Dataset + GT locations for a split; FakeSim data when the R2R_VLNCE
    files are absent."""
    path = config.TASK_CONFIG.DATASET.DATA_PATH.format(split=split)
    if os.path.exists(path):
        ds = VLNCEDataset.from_file(path)
        gt_path = config.TASK_CONFIG.TASK.NDTW.GT_PATH.format(split=split)
        gt = {}
        if os.path.exists(gt_path):
            with gzip.open(gt_path, "rt") as f:
                gt = json.load(f)
        return ds, gt
    n = config.TASK_CONFIG.DATASET.FAKE_EPISODES
    n_scenes = config.TASK_CONFIG.DATASET.FAKE_SCENES
    scenes = [f"fake/{split}_{i}" for i in range(n_scenes)]
    # zlib.crc32, not hash(): str hash is salted per process, which would
    # give every run — and every distributed RANK — a different episode
    # set for the same split
    ds = make_fake_dataset(
        num_episodes=n, scenes=scenes,
        seed=(zlib.crc32(split.encode())
              + config.TASK_CONFIG.DATASET.FAKE_SEED_OFFSET) % 1000,
        min_geodesic=config.TASK_CONFIG.DATASET.FAKE_MIN_GEODESIC,
        max_geodesic=config.TASK_CONFIG.DATASET.FAKE_MAX_GEODESIC)
    return ds, fake_gt_locations(ds)


def add_video_sensors(config) -> None:
    """What a video eval adds to its (defrosted) config: the semantic
    overlay sensor, and the simulator's semantic frames it reads
    (`common_trainer.py:272-277`)."""
    sensors = list(config.TASK_CONFIG.TASK.SENSORS)
    if "SEMANTIC_FILTER_SENSOR" not in sensors:
        sensors.append("SEMANTIC_FILTER_SENSOR")
    config.TASK_CONFIG.TASK.SENSORS = sensors
    agent_sensors = list(config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS)
    if "SEMANTIC_SENSOR" not in agent_sensors:
        agent_sensors.append("SEMANTIC_SENSOR")
    config.TASK_CONFIG.SIMULATOR.AGENT_0.SENSORS = agent_sensors


class _Trajectories(EvalObserver):
    """Inference's record: each row's per-step infos, moved into
    ``predictions`` (episode id -> infos) as its episode ends."""

    def __init__(self):
        self.predictions: Dict[str, list] = {}

    def reset(self, n: int) -> None:
        self.rows: List[list] = [[] for _ in range(n)]

    def stepped(self, observations, infos, episodes) -> None:
        for row, info in zip(self.rows, infos):
            row.append(info)

    def episode_done(self, i: int, episode, info) -> None:
        self.predictions[episode.episode_id] = self.rows[i]
        self.rows[i] = []

    def keep(self, keep) -> None:
        self.rows = [self.rows[i] for i in keep]


class DaggerTrainer:
    """`DaggerTrainer` (`dagger_trainer.py:241-678`) for rank ``rank`` of
    ``world_size``. ``device``: this rank's device; by default card
    ``TORCH_GPU_ID`` (the local rank, ``refine_config``), and without a
    card the trainer raises unless the caller passes ``device="cpu"``.
    ``env_workers``: the env processes of collection, evaluation and
    inference (False: in process)."""

    def __init__(self, config, rank: int = 0, world_size: int = 1,
                 env_workers: bool = True, device=None):
        self.config = config
        self.rank = rank
        self.world_size = world_size
        self.env_workers = env_workers
        self.device = resolve_device(device)
        if self.device.type == "cuda" and self.device.index is None:
            self.device = torch.device("cuda", config.TORCH_GPU_ID)
        self.model_cfg = MGMapConfig.from_config(config.MODEL)
        self.monitors = MonitorConfig.from_config(config.MODEL)
        self.store_dir = config.DAGGER.LMDB_FEATURES_DIR
        self.rollout_dtype = (torch.bfloat16
                              if getattr(config.MODEL, "ROLLOUT_BF16", False)
                              else None)
        self.writer = None
        self._eval_fail_streak = 0

    # -- setup ---------------------------------------------------------------
    def init_policy(self, seed: int = 0,
                    model_cfg: Optional[MGMapConfig] = None) -> BasePolicy:
        """The policy for ``model_cfg`` (by default the config's) on the
        trainer's device: torch's initializers drawn from ``seed`` (the
        global generator's state is left as it was), then the pretrained
        weights."""
        with torch.random.fork_rng(devices=[]):
            torch.manual_seed(seed)
            policy = BasePolicy(model_cfg or self.model_cfg)
        self._load_pretrained(policy)
        return policy.to(self.device)

    def _load_pretrained(self, policy: BasePolicy) -> None:
        """Frozen-trunk checkpoints (`unet_encoder.py:19-22`,
        `resnet_encoders.py:37-50`), the instruction embeddings and an
        optional policy ckpt, into ``policy`` in place."""
        cfg = self.config
        unet_path = cfg.MODEL.RGB_ENCODER.pretrain_model
        if os.path.exists(unet_path):
            sd = load_torch_checkpoint(unet_path)
            load_matching(policy, {f"net.rgb_encoder.base_model.{k}": v
                                   for k, v in sd.items()})
            self._log(f"loaded UNet weights from {unet_path}")
        else:
            # From-scratch path: the reference seeds UNet/MapDecoder with
            # ImageNet resnet18 (`unet_encoder.py:34`, `map_encoder.py:75`).
            imagenet = getattr(cfg.MODEL.RGB_ENCODER, "imagenet_resnet18", "")
            if imagenet and os.path.exists(imagenet):
                n = import_imagenet_resnet18(policy,
                                             load_torch_checkpoint(imagenet))
                self._log(f"seeded UNet/MapDecoder backbones from ImageNet "
                          f"resnet18 ({imagenet}, {n} tensors)")
            else:
                warnings.warn(
                    "No UNet checkpoint and no ImageNet resnet18 weights "
                    f"found ({unet_path!r} / {imagenet!r}): the RGB segmenter "
                    "and map decoder start from RANDOM init. The reference "
                    "initializes these backbones from ImageNet "
                    "(unet_encoder.py:34); place a torchvision resnet18 "
                    "state_dict at MODEL.RGB_ENCODER.imagenet_resnet18 for "
                    "equivalent from-scratch statistics.", stacklevel=3)
        ddppo_path = cfg.MODEL.DEPTH_ENCODER.ddppo_checkpoint
        if os.path.exists(ddppo_path):
            load_matching(policy, ddppo_depth_state(
                load_torch_checkpoint(ddppo_path)))
            self._log(f"loaded DD-PPO depth weights from {ddppo_path}")
        emb_path = cfg.MODEL.INSTRUCTION_ENCODER.embedding_file
        if (cfg.MODEL.INSTRUCTION_ENCODER.use_pretrained_embeddings
                and os.path.exists(emb_path)):
            emb = load_pretrained_embeddings(emb_path)
            tgt = policy.net.instruction_encoder.embedding_layer.weight
            if tuple(emb.shape) == tuple(tgt.shape):
                with torch.no_grad():
                    tgt.copy_(torch.from_numpy(emb))
                self._log(f"loaded instruction embeddings from {emb_path}")
        if cfg.DAGGER.LOAD_FROM_CKPT and os.path.exists(cfg.DAGGER.CKPT_TO_LOAD):
            ckpt_lib.restore(policy, cfg.DAGGER.CKPT_TO_LOAD)
            self._log(f"loaded policy ckpt {cfg.DAGGER.CKPT_TO_LOAD}")

    def _engine(self, policy: BasePolicy, num_envs: int) -> RolloutEngine:
        """A rollout engine with its own copy of ``policy``'s weights, in
        the rollout dtype. The one rank of a run splits its envs over
        every local card, its own first, as JAX's engine shards them over
        every local chip (``trainer.py:93``); with more ranks each keeps
        to its own card, as JAX drops the mesh (``rollout.py:55-58``)."""
        cards = (torch.cuda.device_count()
                 if self.device.type == "cuda" and self.world_size == 1
                 else 1)
        if cards < 2:
            return RolloutEngine(policy, num_envs,
                                 compute_dtype=self.rollout_dtype,
                                 device=self.device)
        own = self.device.index or 0
        devices = [torch.device("cuda", i)
                   for i in [own] + [i for i in range(cards) if i != own]]
        return RolloutEngine(policy, num_envs,
                             compute_dtype=self.rollout_dtype,
                             devices=devices)

    def _log(self, msg: str):
        if self.rank == 0:
            print(f"[trainer] {msg}", flush=True)

    def _tb(self):
        """TensorBoard's writer on rank 0, or None where TensorBoard is not
        installed (the run goes on without it)."""
        if self.writer is None and self.rank == 0:
            try:
                from torch.utils.tensorboard import SummaryWriter
                os.makedirs(self.config.TENSORBOARD_DIR, exist_ok=True)
                self.writer = SummaryWriter(self.config.TENSORBOARD_DIR)
            except (ImportError, OSError):
                self.writer = False
        return self.writer or None

    # -- resume ---------------------------------------------------------------
    def resume(self, policy: BasePolicy) -> tuple[int, int]:
        """`resume_dagger` (`common_trainer.py:118-139`): the newest
        checkpoint (or ``RESUME_CKPT``) into ``policy``; returns
        (dagger_it, epoch) to start from."""
        folder = self.config.CHECKPOINT_FOLDER
        ckpt_file = self.config.RESUME_CKPT or ckpt_lib.latest_checkpoint(folder)
        if not ckpt_file:
            return 0, 0
        blob = ckpt_lib.restore(policy, ckpt_file)
        d_it, epoch = ckpt_lib.parse_resume_point(
            blob, ckpt_file, self.config.DAGGER.EPOCHS)
        self._log(f"resumed from {ckpt_file} -> dagger_it={d_it} epoch={epoch}")
        return d_it, epoch

    # -- train ---------------------------------------------------------------
    def train(self) -> Dict[str, float]:
        cfg = self.config
        if self.rank == 0:
            os.makedirs(self.store_dir, exist_ok=True)
            os.makedirs(cfg.CHECKPOINT_FOLDER, exist_ok=True)

        policy = self.init_policy()
        start_it, start_epoch = self.resume(policy)
        distributed = self.world_size > 1
        state = step_lib.create_train_state(policy, cfg.DAGGER.LR,
                                            device=self.device)
        if distributed:
            mesh.replicate(state.policy)
        update = step_lib.make_train_step(self.monitors,
                                          distributed=distributed)

        dataset, gt = load_split(cfg, cfg.TASK_CONFIG.DATASET.SPLIT)
        tb = self._tb()
        step_id = 0
        metrics: Dict[str, float] = {}

        for dagger_it in range(start_it, cfg.DAGGER.ITERATIONS):
            if not cfg.DAGGER.PRELOAD_LMDB_FEATURES:
                # the engine carries this iteration's weights
                # (`dagger_trainer.py:543-560`)
                engine = self._engine(state.policy, cfg.NUM_PROCESSES)
                collect_dataset(cfg, engine, dataset, gt, self.store_dir,
                                dagger_it, self.rank, self.world_size,
                                workers=self.env_workers, log_fn=self._log)
                del engine
            if distributed:
                # every rank's store shard must be complete before any rank
                # sizes its loader (the reference's barrier at
                # `dagger_trainer.py:345,551`)
                dist.barrier()

            loader = ReplayLoader(
                self.store_dir, cfg.DAGGER.BATCH_SIZE, rank=self.rank,
                world_size=self.world_size, max_len=cfg.ep_max_len,
                seed=dagger_it, fixed_len=distributed)
            for epoch in range(start_epoch, cfg.DAGGER.EPOCHS):
                t0 = time.time()
                n_batches = 0
                for batch in loader:
                    metrics = update(state, {
                        "obs": batch["obs"],
                        "weights": batch["weights"],
                        "not_done_masks": batch["not_done_masks"],
                    })
                    n_batches += 1
                    step_id += 1
                    if tb and step_id % cfg.LOG_INTERVAL == 0:
                        for k in ("loss", "action_loss", "aux_loss"):
                            tb.add_scalar(
                                f"train_{k}_iter_{dagger_it}",
                                float(metrics[k]), step_id)
                metrics = {k: float(v) for k, v in metrics.items()}
                self._log(
                    f"dagger_it {dagger_it} epoch {epoch}: {n_batches} batches "
                    f"in {time.time()-t0:.1f}s " +
                    " ".join(f"{k}={v:.4f}" for k, v in metrics.items()))
                if self.rank == 0:
                    idx = dagger_it * cfg.DAGGER.EPOCHS + epoch
                    ckpt_lib.save_checkpoint(
                        os.path.join(cfg.CHECKPOINT_FOLDER, f"ckpt.{idx}.pth"),
                        state.policy, config=cfg,
                        extra_state={"dagger_it": dagger_it})
                # long stage-1 runs eval every 3rd epoch
                # (`dagger_trainer.py:644-655`)
                if (cfg.DAGGER.EPOCHS > 10 and epoch % 3 == 0
                        and self.rank == 0):
                    self._eval_while_training(state.policy, tb, step=epoch)
            # end-of-iteration eval (`dagger_trainer.py:660-666`)
            if self.rank == 0 and cfg.DAGGER.ITERATIONS > 1:
                self._eval_while_training(state.policy, tb, step=dagger_it)
            start_epoch = 0
        return metrics

    def _eval_while_training(self, policy: BasePolicy, tb, step: int) -> None:
        """Rollout eval on the reduced validation split during training
        (`dagger_trainer.py:644-666`, `common_trainer.py:269-271`)."""
        cfg = self.config
        eval_cfg = cfg.clone()
        eval_cfg.defrost()
        eval_cfg.TASK_CONFIG.DATASET.SPLIT = "val_unseen_min"
        eval_cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        eval_cfg.NUM_PROCESSES = min(cfg.NUM_PROCESSES, 4)
        eval_cfg.freeze()
        try:
            dataset, gt = load_split(eval_cfg, "val_unseen_min")
            engine = self._engine(policy, eval_cfg.NUM_PROCESSES)
            agg = evaluate(eval_cfg, engine, dataset, gt,
                           episode_count=min(len(dataset.episodes), 8),
                           workers=self.env_workers, log_fn=self._log)
            if tb:
                for k, v in agg.items():
                    if np.isfinite(v):
                        tb.add_scalar(f"eval_while_training_{k}", v, step)
            self._eval_fail_streak = 0
        except Exception as e:
            # One transient failure (e.g. an env worker dying) must not kill
            # a long training run, but a broken eval path should not degrade
            # to a log line for 30 epochs: re-raise on repeat failures.
            self._eval_fail_streak += 1
            self._log(f"eval-while-training failed "
                      f"({self._eval_fail_streak} consecutive): {e}\n"
                      + traceback.format_exc())
            if self._eval_fail_streak >= 2:
                raise

    # -- inference (leaderboard) ----------------------------------------------
    def inference(self, checkpoint_path: Optional[str] = None) -> str:
        """Leaderboard trajectory dump. The reference stubs this out
        (`common_trainer.py:534-535`); the VLNCEInferenceEnv per-step info
        stream of every episode of ``INFERENCE.SPLIT`` goes, once, into
        ``INFERENCE.PREDICTIONS_FILE``."""
        from ws_mgmap_tpu_torch.env.environments import VLNCEInferenceEnv
        from ws_mgmap_tpu_torch.env.vector_env import construct_envs

        cfg = self.config.clone()
        cfg.defrost()
        split = cfg.INFERENCE.SPLIT
        cfg.TASK_CONFIG.DATASET.SPLIT = split
        cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        cfg.NUM_PROCESSES = max(1, self.config.NUM_PROCESSES)
        cfg.freeze()

        policy = self.init_policy()
        path = checkpoint_path or cfg.INFERENCE.CKPT_PATH
        if path and os.path.exists(path):
            ckpt_lib.restore(policy, path)

        dataset, gt = load_split(cfg, split)
        engine = self._engine(policy, cfg.NUM_PROCESSES)
        envs = construct_envs(cfg, dataset, gt, auto_reset_done=False,
                              workers=self.env_workers,
                              env_cls=VLNCEInferenceEnv)
        total = min(len(dataset.episodes), cfg.EVAL.EPISODE_COUNT)
        trajectories = _Trajectories()
        try:
            rollout(cfg, engine, envs, total, trajectories)
        finally:
            envs.close()
        predictions = trajectories.predictions
        out_path = cfg.INFERENCE.PREDICTIONS_FILE
        os.makedirs(os.path.dirname(out_path) or ".", exist_ok=True)
        with open(out_path, "w") as f:
            json.dump(predictions, f)
        self._log(f"wrote {len(predictions)} trajectories to {out_path}")
        return out_path

    # -- eval ---------------------------------------------------------------
    @staticmethod
    def _ckpt_order_key(fname: str):
        """Ascending checkpoint index (`ckpt.10.pth` after `ckpt.2.pth`),
        matching the reference's index-ordered polling
        (`common_trainer.py:210-226`); non-indexed names sort last by name."""
        m = _CKPT_INDEX.search(fname)
        return (0, int(m.group(1)), fname) if m else (1, 0, fname)

    def eval(self, checkpoint_path: Optional[str] = None,
             poll: Optional[bool] = None,
             idle_timeout_s: Optional[float] = None) -> Dict[str, float]:
        """Single-checkpoint eval, or poll-the-folder mode
        (`common_trainer.py:189-226`): a directory path polls for new
        checkpoints **indefinitely** (the production "train on rank 0,
        eval in a second job" workflow), evaluating in ascending ckpt
        index. ``idle_timeout_s`` bounds the idle wait; the default comes
        from EVAL.POLL_IDLE_TIMEOUT (-1 = forever)."""
        cfg = self.config
        path = checkpoint_path or cfg.EVAL_CKPT_PATH_DIR
        if poll is None:
            poll = os.path.isdir(path)
        if not poll or os.path.isfile(path):
            return self._eval_one(path)

        if idle_timeout_s is None:
            t = float(getattr(cfg.EVAL, "POLL_IDLE_TIMEOUT", -1.0))
            idle_timeout_s = None if t < 0 else t

        evaluated = set()
        last: Dict[str, float] = {}
        idle_since = time.time()
        while (idle_timeout_s is None
               or time.time() - idle_since < idle_timeout_s):
            candidates = sorted(
                (f for f in os.listdir(path)
                 if f.endswith(".pth") and f not in evaluated),
                key=self._ckpt_order_key)
            if not candidates:
                time.sleep(2)
                continue
            idle_since = time.time()
            for f in candidates:
                evaluated.add(f)
                last = self._eval_one(os.path.join(path, f))
        return last

    def _eval_one(self, path: Optional[str]) -> Dict[str, float]:
        from ws_mgmap_tpu_torch.utils.config import Config

        cfg = self.config
        if path and os.path.isdir(path):
            path = ckpt_lib.latest_checkpoint(path)

        blob = None
        ckpt_index = 0
        if path and os.path.exists(path):
            blob = ckpt_lib.load_checkpoint(path)
            m = _CKPT_INDEX.search(path)
            ckpt_index = int(m.group(1)) if m else 0

        # EVAL.USE_CKPT_CONFIG: rebuild the experiment config from the
        # checkpoint (`common_trainer.py:245-248`)
        if (blob is not None and cfg.EVAL.USE_CKPT_CONFIG
                and isinstance(blob.get("config"), dict)):
            ck_cfg = Config(blob["config"])
            # a copy: the JAX package assigns the frozen node itself, so
            # its re-merge below stops at the first EVAL key of the opts
            ck_cfg.EVAL = cfg.EVAL.clone()
            ck_cfg.EVAL_CKPT_PATH_DIR = cfg.EVAL_CKPT_PATH_DIR
            ck_cfg.NUM_PROCESSES = cfg.NUM_PROCESSES
            # eval-time runtime settings survive the swap — the reference's
            # _setup_eval_config re-merges the eval command's trailing opts
            # over the checkpoint config (habitat BaseRLTrainer)
            for key in ("VIDEO_OPTION", "VIDEO_DIR", "VIDEO_NUM",
                        "METRIC_DIR", "random_agent"):
                if hasattr(cfg, key):
                    setattr(ck_cfg, key, getattr(cfg, key))
            opts = list(getattr(cfg, "CMD_TRAILING_OPTS", []) or [])
            if opts:
                try:
                    ck_cfg.merge_from_list(opts)
                except ValueError:
                    pass  # a value an older ckpt config cannot take
            cfg = ck_cfg

        split = cfg.EVAL.SPLIT
        eval_cfg = cfg.clone()
        eval_cfg.defrost()
        eval_cfg.TASK_CONFIG.DATASET.SPLIT = split
        eval_cfg.TASK_CONFIG.ENVIRONMENT.ITERATOR_OPTIONS.SHUFFLE = False
        eval_cfg.NUM_PROCESSES = min(cfg.NUM_PROCESSES, 11)
        if eval_cfg.VIDEO_OPTION:
            add_video_sensors(eval_cfg)
        eval_cfg.freeze()

        # the checkpoint's config may describe a different model size; build
        # the policy for it (`common_trainer.py:289` rebuilds per-eval too)
        policy = self.init_policy(
            model_cfg=MGMapConfig.from_config(eval_cfg.MODEL))
        # random_agent: evaluate the untrained policy (`run.py` flag,
        # `common_trainer.py:289` passes not random_agent as load flag)
        if blob is not None and not self.config.random_agent:
            ckpt_lib.load_policy_state(policy, blob["state_dict"])
            self._log(f"evaluating {path}")

        dataset, gt = load_split(eval_cfg, split)
        engine = self._engine(policy, eval_cfg.NUM_PROCESSES)
        metric_dir = getattr(self.config, "METRIC_DIR", None)
        return evaluate(
            eval_cfg, engine, dataset, gt,
            episode_count=cfg.EVAL.EPISODE_COUNT,
            workers=self.env_workers, log_fn=self._log,
            metric_dir=metric_dir, checkpoint_index=ckpt_index, split=split,
            tb_writer=self._tb())
