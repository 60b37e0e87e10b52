"""Operations and bytes of the rollout's two hand-written kernel sites,
from shapes: the 3x3 stride-1 conv sites that the fused conv takes (conv
+ folded BN + optional residual + ReLU, over the concat of two inputs
without building it) and the ground-plane splat."""
from __future__ import annotations

from typing import NamedTuple

from benchmark.counts.peaks import bound_s

ELEMENT_BYTES = {"bf16": 2, "fp32": 4}


class ConvSite(NamedTuple):
    name: str       # the module path under the policy
    h: int          # input (and output) side
    c1: int         # channels of the first input
    c2: int         # channels of the second input (the skip), 0 if none
    co: int
    residual: bool
    per_update_map: int
    per_act: int
    # whether a module boundary holds this site and nothing else, so that
    # a label around the module times the site alone
    labelled: bool = True


def conv_sites(cfg: dict) -> list[ConvSite]:
    """The UNet's 16 fused sites (on both steps) and the map decoder's 4
    (on the act step). In ``layer2.0`` and ``layer3.0`` only the second
    conv is a site (the first has stride 2), so those two blocks cannot
    be labelled around the site alone."""
    c64, c128, c256, c512 = (max(8, int(c * cfg["unet_width"]))
                             for c in (64, 128, 256, 512))
    r = cfg["rgb_hw"]
    m = 1 + (cfg["ego_map_size"] + 6 - 8) // 2       # map encoder: k8 s2 p3
    m = 1 + (m + 2 - 5) // 2                           # k5 s2 p1
    mo = cfg["map_output_size"]
    u = "net.rgb_encoder.base_model."
    d = "net.map_decoder."
    return [
        ConvSite(u + "conv_original_size1", r, c64, 0, c64, False, 1, 1),
        ConvSite(u + "conv_original_size2", r, c128, c64, c64, False, 1, 1),
        ConvSite(u + "conv_up0", r // 2, c256, c64, c128, False, 1, 1),
        ConvSite(u + "conv_up1", r // 4, c256, c64, c256, False, 1, 1),
        ConvSite(u + "conv_up2", r // 8, c512, c128, c256, False, 1, 1),
        ConvSite(u + "conv_up3", r // 16, c512, c256, c512, False, 1, 1),
        ConvSite(u + "layer1.1.0", r // 4, c64, 0, c64, False, 1, 1),
        ConvSite(u + "layer1.1.0", r // 4, c64, 0, c64, True, 1, 1),
        ConvSite(u + "layer1.1.1", r // 4, c64, 0, c64, False, 1, 1),
        ConvSite(u + "layer1.1.1", r // 4, c64, 0, c64, True, 1, 1),
        ConvSite(u + "layer2.0", r // 8, c128, 0, c128, True, 1, 1, False),
        ConvSite(u + "layer2.1", r // 8, c128, 0, c128, False, 1, 1),
        ConvSite(u + "layer2.1", r // 8, c128, 0, c128, True, 1, 1),
        ConvSite(u + "layer3.0", r // 16, c256, 0, c256, True, 1, 1, False),
        ConvSite(u + "layer3.1", r // 16, c256, 0, c256, False, 1, 1),
        ConvSite(u + "layer3.1", r // 16, c256, 0, c256, True, 1, 1),
        ConvSite(d + "conv_original_size0", m, mo, 0, 64, False, 0, 1),
        ConvSite(d + "conv_original_size1", m, 64, 0, 64, False, 0, 1),
        ConvSite(d + "conv_up0", m // 2, 64, 64, 128, False, 0, 1),
        ConvSite(d + "conv_original_size2", m, 128, 64, 64, False, 0, 1),
    ]


def conv_flops(site: ConvSite, b: int) -> float:
    return 2.0 * b * site.h * site.h * 9 * (site.c1 + site.c2) * site.co


def conv_bytes(site: ConvSite, b: int, dtype: str) -> float:
    """x, x2, the weight and the residual read once, the output written
    once, the folded scale and bias in fp32."""
    esz = ELEMENT_BYTES[dtype]
    s = site
    return (esz * (b * s.h * s.h * (s.c1 + s.c2 + s.co * (2 if s.residual
                                                           else 1))
                   + 9 * (s.c1 + s.c2) * s.co) + 8 * s.co)


def step_conv_flops(cfg: dict, step: str, b: int,
                    labelled_only: bool = False) -> float:
    """The fused sites' operations in one ``update_map`` or ``act`` step."""
    key = "per_update_map" if step == "update_map" else "per_act"
    return sum(conv_flops(s, b) * getattr(s, key) for s in conv_sites(cfg)
               if s.labelled or not labelled_only)


def step_conv_bound_s(cfg: dict, step: str, b: int, dtype: str,
                      labelled_only: bool = False) -> float:
    """The least time the fused sites of one step could take: each call's
    operations over the peak rate or its bytes over the memory rate,
    whichever is larger, summed."""
    key = "per_update_map" if step == "update_map" else "per_act"
    return sum(bound_s(conv_bytes(s, b, dtype), conv_flops(s, b),
                       dtype)["bound_s"] * getattr(s, key)
               for s in conv_sites(cfg) if s.labelled or not labelled_only)


def splat_bytes(n_valid: int, frames: int, pixels: int, channels: int,
                ego_size: int, dtype: str) -> float:
    """Each valid pixel's features read once, every pixel's cell id read
    once, the fp32 ego grid written once."""
    return (n_valid * channels * ELEMENT_BYTES[dtype] + frames * pixels * 4
            + frames * ego_size * ego_size * channels * 4)
