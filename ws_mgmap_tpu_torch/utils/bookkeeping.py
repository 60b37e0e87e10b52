"""Experiment bookkeeping: run-dir snapshots of code, command, config.

Port of ``ws_mgmap_tpu/utils/bookkeeping.py`` (`check_exist_file` /
`save_sh_n_codes` / `save_config`, `vlnce_baselines/common/utils.py:48-99`).
The run script records the environment variables the port reads; the
config is written as JSON, since the port has no YAML writer.
"""
from __future__ import annotations

import json
import os
import shutil
import socket
import sys
import zipfile
from glob import glob
from shlex import quote

# what the port reads from the environment: the card, the CPU switch, the
# process group, and the CUDA toolkit that builds the kernels
RUN_ENV = ("CUDA_VISIBLE_DEVICES", "WS_MGMAP_PLATFORM", "WORLD_SIZE", "RANK",
           "LOCAL_RANK", "MASTER_ADDR", "MASTER_PORT", "CUDA_HOME")


def check_exist_file(config, interactive: bool = False) -> None:
    dirs = [config.VIDEO_DIR, config.TENSORBOARD_DIR, config.CHECKPOINT_FOLDER]
    existing = [d for d in dirs if os.path.exists(d)]
    if not existing:
        return
    if config.OVERWRITE:
        for d in existing:
            shutil.rmtree(d)
        return
    if interactive:
        order = None
        while order not in ("y", "n"):
            order = input("Output directory already exists! Overwrite? (y/n)")
        if order == "y":
            for d in existing:
                shutil.rmtree(d)


def save_sh_n_codes(config, run_type: str, ignore_dir=("",)) -> None:
    """``CODE_DIR/run_<type>_<host>.sh`` (the environment the port reads
    and the command line) and ``CODE_DIR/code.zip`` (the working
    directory, but ``ignore_dir`` and this run's own directory: where that
    lies inside the working directory, the JAX package zips ``code.zip``
    into itself while it grows)."""
    code_dir = getattr(config, "CODE_DIR", None)
    if not code_dir:
        return
    os.makedirs(code_dir, exist_ok=True)

    name = os.path.join(code_dir, f"run_{run_type}_{socket.gethostname()}.sh")
    with open(name, "w") as f:
        for env in RUN_ENV:
            value = os.environ.get(env)
            if value is not None:
                f.write(f"export {env}={quote(value)}\n")
        f.write(sys.executable + " " + " ".join(quote(a) for a in sys.argv) + "\n")

    run_dir = os.path.dirname(os.path.abspath(code_dir))
    name = os.path.join(code_dir, "code.zip")
    with zipfile.ZipFile(name, mode="w", compression=zipfile.ZIP_DEFLATED) as zf:
        first = [p for p in glob("*") if p not in ignore_dir]
        files = []
        for pattern in (p + "/**" for p in first):
            files.extend(glob(pattern, recursive=True))
        files += [p for p in first if os.path.isfile(p)]
        for fn in files:
            fn = fn[:-1] if fn.endswith("/") else fn
            if os.path.isfile(fn) and not os.path.abspath(fn).startswith(
                    run_dir + os.sep):
                zf.write(fn)


def save_config(config, run_type: str) -> None:
    """``CONFIG_DIR/config_of_<type>.txt``: the config tree as JSON."""
    config_dir = getattr(config, "CONFIG_DIR", None)
    if not config_dir:
        return
    os.makedirs(config_dir, exist_ok=True)
    with open(os.path.join(config_dir, f"config_of_{run_type}.txt"), "w") as f:
        json.dump(config.to_dict(), f, indent=2)
