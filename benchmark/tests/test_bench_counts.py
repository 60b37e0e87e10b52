"""The operation and byte counts reproduce the bounds the repository
measured its kernels against (a B=6 bf16 step: the wgmma conv 0.213 ms a
map update and 0.215 ms an act, the splat 0.0078 ms), and a whole step's
operations contain its conv sites'."""
from __future__ import annotations

import pytest

from benchmark import harness, system
from benchmark.counts import flops, kernels
from benchmark.counts.peaks import bound_s


def full_cfg() -> dict:
    return harness.load_json("configs", "wsmgmap_bf16")


def test_conv_sites_per_step():
    sites = kernels.conv_sites(full_cfg())
    assert sum(s.per_update_map for s in sites) == 16
    assert sum(s.per_act for s in sites) == 20
    assert sum(1 for s in sites if not s.labelled) == 2


@pytest.mark.parametrize("step,want_ms", [("update_map", 0.213),
                                          ("act", 0.215)])
def test_wgmma_bound(step, want_ms):
    cfg = full_cfg()
    total = 0.0
    key = "per_update_map" if step == "update_map" else "per_act"
    for s in kernels.conv_sites(cfg):
        for _ in range(getattr(s, key)):
            total += bound_s(kernels.conv_bytes(s, 6, "bf16"),
                             kernels.conv_flops(s, 6), "bf16")["bound_s"]
    assert total * 1e3 == pytest.approx(want_ms, abs=5e-4)
    assert kernels.step_conv_bound_s(cfg, step, 6, "bf16") == \
        pytest.approx(total)
    # a few small sites are bound by their bytes, not their operations
    assert kernels.step_conv_flops(cfg, step, 6) / 989e12 <= total


def test_splat_bound():
    # 6 frames of 224^2 pixels, a quarter valid, 64 bf16 channels
    pixels = 224 * 224
    n_valid = int(0.25 * 6 * pixels)
    nbytes = kernels.splat_bytes(n_valid, 6, pixels, 64, 100, "bf16")
    b = bound_s(nbytes, n_valid * 64, "bf16")
    assert b["bound_by"] == "bytes"
    assert b["bound_s"] * 1e3 == pytest.approx(0.0078, abs=1e-4)


def test_step_flops_contain_the_sites():
    cfg = full_cfg()
    shapes = system.shapes(cfg)[0]
    upd = flops.update_map_flops(cfg, shapes, 5)
    act = flops.act_flops(cfg, shapes, 5)
    assert kernels.step_conv_flops(cfg, "update_map", 5) < upd < act
    assert kernels.step_conv_flops(cfg, "act", 5) < act
    # the UNet at 224^2 is some tens of GFLOP a frame
    assert 5e9 < upd / 5 < 1e11
    assert flops.encode_flops(cfg, 5, 80) == 5 * 80 * 2 * (
        2 * 50 * 512 + 2 * 128 * 512)
    assert flops.train_flops(cfg, shapes, 60) > flops.train_flops(cfg, shapes,
                                                                   20)
