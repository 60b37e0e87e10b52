"""Shared pieces of the port's tests: a small policy configuration in
both packages, JAX weights from ``init`` with non-trivial norm statistics,
their carry-over into the port, seeded raw observations, and seeded
replay episodes for the training step; seeded JAX variables of any
policy configuration without a compile, and the small end-to-end
configuration in both packages.

Small widths: UNet width 0.125 over 64^2 RGB, 128^2 depth (a 2x2 depth
trunk), a 20^2 ego map of 8 channels, hidden 64, vocab 50.
"""
import jax
import jax.numpy as jnp
import numpy as np

from ws_mgmap_tpu.models.policy import BasePolicy as JPolicy
from ws_mgmap_tpu.models.policy import MGMapConfig as JConfig
from ws_mgmap_tpu.ops import mapping as jmap
from ws_mgmap_tpu_torch.models.policy import BasePolicy, MGMapConfig
from ws_mgmap_tpu_torch.ops import mapping
from ws_mgmap_tpu_torch.tools import synthetic
from ws_mgmap_tpu_torch.utils.convert import from_jax_variables

SMALL = dict(vocab_size=50, instr_hidden=16, rgb_output_size=32,
             depth_output_size=16, map_output_size=32, ego_map_size=20,
             map_depth=8, hidden_size=64, unet_width=0.125, depth_spatial=2)
MAP = dict(ego_size=20, global_size=48, map_depth=8)
RGB_HW, DEPTH_HW, INSTR_LEN = 64, 128, 24


def jax_config(rotate: bool = False) -> JConfig:
    return JConfig(**SMALL, mapper=jmap.MapperParams(
        **MAP, rotate_in_splat=rotate,
        splat_backend="pallas" if rotate else "auto"))


def port_config(rotate: bool = False) -> MGMapConfig:
    return MGMapConfig(**SMALL, mapper=mapping.MapperParams(
        **MAP, rotate_in_splat=rotate))


def perturb_norms(variables, rng):
    """Non-trivial BN statistics and BN/GN affines, so BN folding and the
    norm layers' parameters are exercised (a copy; numpy leaves)."""
    def walk(tree, stats):
        out = {}
        for k, v in tree.items():
            if isinstance(v, dict):
                out[k] = walk(v, stats)
            elif stats and k == "mean":
                out[k] = (rng.randn(*v.shape) * 0.1).astype(np.float32)
            elif stats and k == "var":
                out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif not stats and k == "scale":
                out[k] = (rng.rand(*v.shape) + 0.5).astype(np.float32)
            elif not stats and k == "logstd._bias":
                out[k] = (rng.randn(*v.shape) * 0.3).astype(np.float32)
            else:
                out[k] = np.asarray(v)
        return out
    out = {"params": walk(variables["params"], False)}
    if "batch_stats" in variables:
        out["batch_stats"] = walk(variables["batch_stats"], True)
    return out


def init_policy_variables(seed: int = 0):
    """JAX ``BasePolicy`` variables (every module, via ``act``) as numpy,
    with perturbed norms."""
    policy = JPolicy(jax_config())
    obs = {"instruction": jnp.ones((1, INSTR_LEN), jnp.int32),
           "rgb": jnp.zeros((1, RGB_HW, RGB_HW, 3)),
           "depth": jnp.zeros((1, DEPTH_HW, DEPTH_HW, 1)),
           "gps": jnp.zeros((1, 2)), "compass": jnp.zeros((1, 1))}
    init = jax.jit(lambda k: policy.init(
        k, obs, jnp.zeros((2, 1, SMALL["hidden_size"])), jnp.ones((1, 1)),
        jmap.init_global_map(1, policy.cfg.mapper), method=JPolicy.act))
    variables = jax.tree.map(np.asarray, init(jax.random.PRNGKey(seed)))
    return perturb_norms(variables, np.random.RandomState(seed + 100))


def port_policy(variables, rotate: bool = False) -> BasePolicy:
    """The port's policy with ``variables`` loaded strictly."""
    policy = BasePolicy(port_config(rotate))
    policy.load_state_dict(from_jax_variables(variables), strict=True)
    return policy


def tokens(rng, b: int, lengths) -> np.ndarray:
    """[b, INSTR_LEN] int32 tokens with the given real lengths."""
    out = np.zeros((b, INSTR_LEN), np.int32)
    for i, n in enumerate(lengths):
        out[i, :n] = rng.randint(1, SMALL["vocab_size"], n)
    return out


def raw_obs(rng, b: int, t: int, instr: np.ndarray) -> list[dict]:
    """Raw observations of step ``t``: random RGB, depth with a near band
    cleared, a compass spin and a walk."""
    out = []
    for i in range(b):
        depth = (rng.rand(DEPTH_HW, DEPTH_HW, 1) * 0.5).astype(np.float32)
        depth[: 10 + 5 * i] = 0.0
        out.append({
            "instruction": instr[i],
            "rgb": rng.randint(0, 255, (RGB_HW, RGB_HW, 3)).astype(
                np.float32),
            "depth": depth,
            "gps": np.array([0.5 * t - 0.3 * i, 0.4 * t * (1 - i)],
                            np.float32),
            "compass": np.array([0.4 * t - 0.9 * i], np.float32),
        })
    return out


def train_episodes(rng, lengths) -> list[dict]:
    """Seeded replay episodes at the small widths (the card drives' own
    generator, ``tools/synthetic.py::train_episodes``): 200-token
    instructions of 20-120 words, a 20^2 ego map of 8 channels."""
    return synthetic.train_episodes(rng, lengths, port_config())


def jax_batch(batch: dict) -> dict:
    """A collated numpy batch as JAX arrays (the trainer's device put)."""
    return jax.tree.map(jnp.asarray, batch)


def random_variables(jcfg: JConfig, seed: int, rgb_hw: int = RGB_HW,
                     depth_hw: int = DEPTH_HW) -> dict:
    """Seeded variables of the JAX ``BasePolicy`` of ``jcfg``, drawn in
    numpy for the shapes of its ``init`` (``eval_shape``: no compile):
    weights U(-1/sqrt(fan_in), 1/sqrt(fan_in)), biases U(-0.1, 0.1), norm
    scales in [0.75, 1.25), BN statistics as ``perturb_norms`` draws them,
    embeddings N(0, 0.3^2)."""
    policy = JPolicy(jcfg)
    obs = {"instruction": jnp.ones((1, INSTR_LEN), jnp.int32),
           "rgb": jnp.zeros((1, rgb_hw, rgb_hw, 3)),
           "depth": jnp.zeros((1, depth_hw, depth_hw, 1)),
           "gps": jnp.zeros((1, 2)), "compass": jnp.zeros((1, 1))}
    shapes = jax.eval_shape(lambda k: policy.init(
        k, obs, jnp.zeros((2, 1, jcfg.hidden_size)), jnp.ones((1, 1)),
        jmap.init_global_map(1, jcfg.mapper), method=JPolicy.act),
        jax.random.PRNGKey(0))
    rng = np.random.RandomState(seed)

    def draw(coll, leaf, shape):
        if coll == "batch_stats":
            return (rng.randn(*shape) * 0.1 if leaf == "mean"
                    else rng.rand(*shape) + 0.5)
        if leaf == "scale":
            return rng.rand(*shape) * 0.5 + 0.75
        if leaf == "bias" or "bias" in leaf.split(".")[-1]:
            return rng.uniform(-0.1, 0.1, shape)
        if leaf == "embedding":
            return rng.randn(*shape) * 0.3
        # flax kernels are [..., in, out]; raw torch weights [out, in, ...]
        fan_in = (int(np.prod(shape[:-1])) if leaf in ("kernel", "kernel_t")
                  else int(np.prod(shape[1:])))
        b = 1.0 / np.sqrt(fan_in)
        return rng.uniform(-b, b, shape)

    def walk(coll, tree):
        return {k: walk(coll, v) if isinstance(v, dict)
                else draw(coll, k, v.shape).astype(np.float32)
                for k, v in tree.items()}
    return {coll: walk(coll, tree) for coll, tree in shapes.items()}


def tiny_configs(tmp_dir: str, opts=()) -> tuple:
    """(the port's config, the JAX package's) from the port's
    ``synthetic.TINY_OPTS`` and then ``opts``, each with its store,
    checkpoints and TensorBoard in its own directory under ``tmp_dir``."""
    import os

    from ws_mgmap_tpu.config.default import get_config as jget_config

    port = synthetic.tiny_config(os.path.join(tmp_dir, "port"), opts)
    jcfg = jget_config(opts=synthetic.TINY_OPTS + list(opts))
    jcfg.defrost()
    jcfg.DAGGER.LMDB_FEATURES_DIR = os.path.join(tmp_dir, "jax", "traj")
    jcfg.CHECKPOINT_FOLDER = os.path.join(tmp_dir, "jax", "ckpt")
    jcfg.TENSORBOARD_DIR = os.path.join(tmp_dir, "jax", "tb")
    jcfg.freeze()
    return port, jcfg
