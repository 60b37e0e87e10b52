"""The system under test, built from a configuration's file: the port's
policy at the configured sizes holding the benchmark's weights, the
numeric settings the configuration states, and the rollout engine."""
from __future__ import annotations

import torch

from benchmark.weights import make_state_dict

DTYPES = {"fp32": torch.float32, "bf16": torch.bfloat16}


def policy_config(cfg: dict):
    from ws_mgmap_tpu_torch.models.policy import MGMapConfig
    from ws_mgmap_tpu_torch.ops.mapping import MapperParams

    return MGMapConfig(
        vocab_size=cfg["vocab_size"], embedding_size=cfg["embedding_size"],
        instr_hidden=cfg["instr_hidden"],
        rgb_output_size=cfg["rgb_output_size"],
        depth_output_size=cfg["depth_output_size"],
        depth_spatial=cfg["depth_spatial"], unet_width=cfg["unet_width"],
        map_output_size=cfg["map_output_size"],
        ego_map_size=cfg["ego_map_size"], map_depth=cfg["map_depth"],
        hidden_size=cfg["hidden_size"], num_classes=cfg["num_classes"],
        mapper=MapperParams(resolution=cfg["resolution"],
                            ego_size=cfg["ego_map_size"],
                            global_size=cfg["global_map_size"],
                            map_depth=cfg["map_depth"],
                            rotate_in_splat=cfg["rotate_in_splat"]))


def apply_numerics(cfg: dict) -> None:
    """TF32 as the configuration states it (cuDNN and matmuls)."""
    torch.backends.cudnn.allow_tf32 = bool(cfg["tf32"])
    torch.backends.cuda.matmul.allow_tf32 = bool(cfg["tf32"])


def shapes(cfg: dict) -> tuple[dict, tuple]:
    """(name -> shape of every state-dict entry, the transposed-conv
    weights' names) of the policy at the configured sizes."""
    from ws_mgmap_tpu_torch.models.policy import BasePolicy

    with torch.device("meta"):
        policy = BasePolicy(policy_config(cfg))
    transposed = tuple(f"{n}.weight" for n, m in policy.named_modules()
                       if isinstance(m, torch.nn.ConvTranspose2d))
    return ({k: tuple(v.shape) for k, v in policy.state_dict().items()},
            transposed)


def weights(cfg: dict, seed: int, device) -> dict:
    names, transposed = shapes(cfg)
    return make_state_dict(names, seed, device, transposed)


def build_policy(cfg: dict, state_dict: dict, device):
    """The port's policy on ``device`` holding ``state_dict`` (copied)."""
    from ws_mgmap_tpu_torch.models.policy import BasePolicy

    with torch.device("meta"):
        policy = BasePolicy(policy_config(cfg))
    policy = policy.to_empty(device=device)
    policy.load_state_dict(state_dict)
    return policy


def engine(cfg: dict, policy, envs: int, device):
    from ws_mgmap_tpu_torch.train.rollout import RolloutEngine

    dtype = None if cfg["rollout_dtype"] == "fp32" else DTYPES[
        cfg["rollout_dtype"]]
    return RolloutEngine(policy, envs, instruction_len=cfg["instruction_len"],
                         compute_dtype=dtype, device=device)
