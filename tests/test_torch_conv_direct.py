"""The direct fused conv's launch plan (``conv.direct_tile`` /
``direct_grid`` / ``direct_smem_bytes``) and the gate's fp32 rule, on the
CPU: no card, no JAX. The kernel itself is held against its twin by the
``gpu`` tests of ``tests/test_torch_kernels.py`` and by ``chip_smoke.py``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import CONV_SITES
from ws_mgmap_tpu_torch.ops.kernels import conv as kconv

BATCHES = (1, 2, 6, 24)
SMEM_LIMIT = 232448  # shared memory a Hopper block may have (227 KB)
# (H, W, C1, C2, Co): every fused call site, then the ragged shapes the
# card tests run (a tile that divides neither H nor W, Ci below a chunk,
# an x/x2 split inside a chunk, Co = 1 mod 4, Co past one N tile)
SHAPES = sorted({(h, h, c1, c2, co) for _, h, c1, c2, co, *_ in CONV_SITES})
RAGGED = [(16, 24, 8, 0, 16), (32, 20, 5, 0, 7), (28, 28, 96, 32, 70),
          (14, 14, 64, 0, 130), (13, 22, 32, 0, 64), (9, 11, 5, 0, 16),
          (20, 20, 12, 20, 64), (18, 18, 64, 0, 65)]


def _coverage(b, h, w, co, tile):
    """How often each output (pixel, channel) of one image is owned by a
    block of the grid, and the grid, by ``direct_grid``'s mapping."""
    th, tw, bn = tile[:3]
    grid = kconv.direct_grid(b, h, w, co, tile)
    tiles_w = -(-w // tw)
    cov = np.zeros((h, w, co), np.int32)
    for bx in range(grid[0]):
        y0, x0 = (bx // tiles_w) * th, (bx % tiles_w) * tw
        for by in range(grid[1]):
            # no block lies wholly outside the output
            assert y0 < h and x0 < w and by * bn < co
            cov[y0:y0 + th, x0:x0 + tw, by * bn:(by + 1) * bn] += 1
    return cov, grid


@pytest.mark.parametrize("b", BATCHES)
@pytest.mark.parametrize("shape", SHAPES + RAGGED)
def test_direct_tile_covers_every_output_once(shape, b):
    h, w, c1, c2, co = shape
    tile = kconv.direct_tile(b, h, w, c1 + c2, co)
    assert tile in kconv.DIRECT_TILES and tile[2] <= max(co, 64)
    cov, grid = _coverage(b, h, w, co, tile)
    assert grid[2] == b
    assert (cov == 1).all()
    assert kconv.direct_smem_bytes(tile) <= SMEM_LIMIT
    # the pick is the cheapest tile by the plan's own model
    cost = kconv.direct_cost(b, h, w, c1 + c2, co, tile)
    assert all(cost <= kconv.direct_cost(b, h, w, c1 + c2, co, t)
               for t in kconv.DIRECT_TILES if t[2] <= max(co, 64))


@pytest.mark.parametrize("tile", list(kconv.DIRECT_TILES))
def test_every_direct_tile_fits_and_covers(tile):
    # 8 pixels x 8 channels a thread, warps of 4 rows x 8 channel groups;
    # the split divides a chunk's (channel quad, dy) work units; the block
    # and the blocks an SM holds fit the SM
    th, tw, bn, kc, split, stages = tile
    per_sm, speed = kconv.DIRECT_TILES[tile]
    assert th % 4 == 0 and tw % 8 == 0 and bn % 64 == 0
    assert kc % 4 == 0 and (kc // 4 * 3) % split == 0 and stages >= 2
    threads = split * th * tw * bn // 64
    assert threads % 32 == 0 and per_sm * threads <= 2048
    assert per_sm * (kconv.direct_smem_bytes(tile) + 1024) <= 233472
    assert 0 < speed <= 1
    cov, _ = _coverage(2, 13, 22, 136, tile)
    assert (cov == 1).all()


def test_direct_smem_bytes_of_the_compiled_tiles():
    # stages x ((TH+2)(TW+2) * (KC+4) + 9 * KC * BN) floats, or the split
    # groups' partial tiles if larger, as conv3x3.cu
    assert {t: kconv.direct_smem_bytes(t) for t in kconv.DIRECT_TILES} == {
        (8, 16, 64, 16, 1, 2): 102528, (8, 16, 64, 16, 3, 2): 102528,
        (8, 8, 64, 16, 2, 2): 89728, (8, 8, 64, 8, 2, 3): 69696}


@pytest.mark.parametrize("b,site,split", [(24, "conv_original_size2", 1),
                                          (6, "conv_original_size1", 1),
                                          (6, "layer3 conv", 2),
                                          (6, "map_decoder.conv_up0", 2),
                                          (24, "conv_up3", 3)])
def test_direct_tile_splits_only_where_the_grid_is_short(b, site, split):
    # a full card takes the widest unsplit tile; a grid short of it a
    # split one (the tiles measured fastest there)
    _, h, c1, c2, co, *_ = next(s for s in CONV_SITES if s[0] == site)
    assert kconv.direct_tile(b, h, h, c1 + c2, co)[4] == split


@pytest.mark.parametrize("site", CONV_SITES, ids=lambda s: s[0])
@pytest.mark.parametrize("mode,fused_on", [("on", ("cuda", "cpu")),
                                           ("auto", ("cuda",)),
                                           ("off", ())])
def test_fp32_gate_on_fuses_every_site_through_direct(site, mode, fused_on):
    # fp32 fuses on the card under "on" and "auto", on the CPU under "on"
    # alone (its twin), and nowhere under "off" (the library conv)
    _, h, c1, c2, co, *_ = site
    shape = (2, h, h, c1 + c2)
    kconv.set_fused_conv_mode(mode)
    try:
        for dev in ("cuda", "cpu"):
            got = kconv.fused_conv_active(shape, torch.float32,
                                          torch.device(dev), 3, 1)
            assert got == (dev in fused_on), dev
        # bf16 fuses on the card in every mode but "off"
        assert kconv.fused_conv_active(shape, torch.bfloat16,
                                       torch.device("cuda"), 3,
                                       1) == (mode != "off")
    finally:
        kconv.set_fused_conv_mode("auto")
    assert kconv.conv_variant(torch.float32, c1, c2, co) == "direct"
