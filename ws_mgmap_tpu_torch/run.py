"""The port's experiment entry point, with ``run.py``'s command line:

    python -m ws_mgmap_tpu_torch.run --run-type {train,eval,inference} \\
        -c ws_mgmap_tpu_torch/config/CMA_AUG.yaml -e /path/to/model_dir \\
        [--note tag] [OPT.KEY value ...]

It runs on the card (card ``LOCAL_RANK``); without one it raises, unless
``WS_MGMAP_PLATFORM=cpu`` asks for the CPU. Data parallelism is one
process per rank: ``WORLD_SIZE``, ``RANK`` and ``LOCAL_RANK`` (as torchrun
sets them, with ``MASTER_ADDR`` and ``MASTER_PORT``) put the process into
a ``torch.distributed`` group, NCCL on the card and gloo on the CPU.
"""
from __future__ import annotations

import argparse
import os
import random
from typing import List, Optional

import numpy as np
import torch

# the value of WS_MGMAP_PLATFORM -> the device the run asks for
PLATFORMS = {"cpu": "cpu", "cuda": None}


def platform_device() -> torch.device:
    """The device ``WS_MGMAP_PLATFORM`` asks for: the card when it is
    unset (raising without one), the CPU for ``cpu``."""
    from ws_mgmap_tpu_torch.utils.device import resolve_device

    platform = os.environ.get("WS_MGMAP_PLATFORM", "cuda")
    if platform not in PLATFORMS:
        raise ValueError(f"WS_MGMAP_PLATFORM={platform!r}: one of "
                         f"{sorted(PLATFORMS)}")
    return resolve_device(PLATFORMS[platform])


def parse_args(argv: Optional[List[str]] = None) -> argparse.Namespace:
    parser = argparse.ArgumentParser()
    parser.add_argument("--run-type", choices=["train", "eval", "inference"],
                        default="train")
    parser.add_argument("-c", "--exp-config", type=str, required=True,
                        help="path to experiment yaml")
    parser.add_argument("-e", "--model-dir", default=None,
                        help="path to save checkpoints, logs, metrics")
    parser.add_argument("--note", default="base")
    parser.add_argument("-g", "--gpus", default=None, nargs="+", type=int,
                        help="accepted for reference-CLI compatibility "
                             "(unused: LOCAL_RANK picks the card)")
    parser.add_argument("opts", default=None, nargs=argparse.REMAINDER)
    parser.add_argument("--local_rank", default=-1, type=int)
    return parser.parse_args(argv)


def main(argv: Optional[List[str]] = None) -> None:
    args = parse_args(argv)
    # torchrun passes the local rank in the environment, not as a flag
    local_rank = (args.local_rank if args.local_rank >= 0
                  else int(os.environ.get("LOCAL_RANK", "0")))
    run_exp(args.exp_config, args.run_type, args.model_dir, args.note,
            args.opts, local_rank)


def run_exp(exp_config: str, run_type: str, model_dir: Optional[str],
            note: str, opts: Optional[List[str]] = None,
            local_rank: int = 0) -> None:
    from ws_mgmap_tpu_torch.config.default import (get_config, refine_config,
                                                   set_save_dir)
    from ws_mgmap_tpu_torch.parallel import mesh
    from ws_mgmap_tpu_torch.train.trainer import DaggerTrainer
    from ws_mgmap_tpu_torch.utils.bookkeeping import (
        check_exist_file, save_config, save_sh_n_codes)

    device = platform_device()
    config = get_config(exp_config, opts)
    config = set_save_dir(config, run_type, model_dir, note, local_rank)
    config = refine_config(config, local_rank)

    world_size = int(os.environ.get("WORLD_SIZE", "1"))
    rank = int(os.environ.get("RANK", str(local_rank)))
    if world_size > 1:
        os.environ.setdefault("LOCAL_RANK", str(local_rank))
        rank, world_size, device = mesh.init_distributed(
            "cpu" if device.type == "cpu" else None)

    try:
        if rank == 0 and model_dir:
            check_exist_file(config)
            save_sh_n_codes(config, run_type,
                            ignore_dir=["data", "result", "build", "temp"])
            save_config(config, run_type)

        random.seed(config.TASK_CONFIG.SEED)
        np.random.seed(config.TASK_CONFIG.SEED)
        torch.manual_seed(config.TASK_CONFIG.SEED)

        trainer = DaggerTrainer(config, rank=rank, world_size=world_size,
                                device=device)
        if run_type == "train":
            trainer.train()
        elif run_type == "eval":
            trainer.eval()
        elif run_type == "inference":
            trainer.inference()
    finally:
        if world_size > 1:
            torch.distributed.destroy_process_group()


if __name__ == "__main__":
    main()
