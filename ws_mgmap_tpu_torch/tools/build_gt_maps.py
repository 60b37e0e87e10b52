"""Offline GT semantic-map cache builder.

Port of ``tools/build_gt_maps.py``: writes ``ep_<id>.npy`` files (480x480,
0.12 m cells, centred on the episode's start) into ``--out``, the cache the
port's ``GtSemanticMapSensor`` reads (reference `README.md:41-44`,
`sensors.py:362-410`). The maps come from preprocessed scene point clouds
(``<scene>_pcloud.npz``, `common/utils.py:124-144`) with ``--pcloud-dir``,
else from FakeSim scenes. ``--fake``, or an episodes file that does not
exist, builds the 8-episode FakeSim split.

    python -m ws_mgmap_tpu_torch.tools.build_gt_maps --split train \\
        --out data/map_data/semantic/train \\
        [--episodes data/datasets/.../train.json.gz] [--pcloud-dir DIR] [--fake]
"""
from __future__ import annotations

import argparse
import os

import numpy as np

from ws_mgmap_tpu_torch.env.dataset import VLNCEDataset, make_fake_dataset
from ws_mgmap_tpu_torch.env.semantics import (build_episode_gt_map,
                                              load_scene_pcloud,
                                              rasterize_gt_map, slice_scene)
from ws_mgmap_tpu_torch.env.sim import FakeSim
from ws_mgmap_tpu_torch.utils.geometry import AgentState, get_sim_location


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--split", default="train")
    p.add_argument("--out", required=True)
    p.add_argument("--episodes", default=None,
                   help="{split}.json.gz (defaults to the standard layout)")
    p.add_argument("--pcloud-dir", default=None,
                   help="dir of <scene>_pcloud.npz files")
    p.add_argument("--fake", action="store_true",
                   help="build from FakeSim scenes (tests/CI)")
    args = p.parse_args(argv)

    if args.fake or not args.episodes or not os.path.exists(args.episodes):
        ds = make_fake_dataset(num_episodes=8)
    else:
        ds = VLNCEDataset.from_file(args.episodes)

    n = 0
    for ep in ds.episodes:
        if args.pcloud_dir:
            scene_name = os.path.splitext(os.path.basename(ep.scene_id))[0]
            (x, y, z), _, labels27 = load_scene_pcloud(
                args.pcloud_dir, scene_name)
            state = AgentState(np.asarray(ep.start_position),
                               ep.start_rotation_quat)
            pose, height = get_sim_location(state)
            xf, yf, lf = slice_scene(x, y, z, labels27, height)
            grid = rasterize_gt_map(xf, yf, lf, pose)
            os.makedirs(args.out, exist_ok=True)
            np.save(os.path.join(args.out, f"ep_{ep.episode_id}.npy"), grid)
        else:
            build_episode_gt_map(FakeSim(ep.scene_id), ep, args.out)
        n += 1
    print(f"wrote {n} GT maps to {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
