"""The fused conv sites' share of their roofline: the least time of the
3x3 stride-1 sites whose module holds the site alone (14 of the UNet's
16 on every step, and the map decoder's 4 on an act step; each call's
operations over the configuration's peak rate or its bytes over 3.35
TB/s, whichever is larger), divided by the device time of whatever
kernels implement those sites (the wgmma conv, the direct conv, or
cuDNN's conv with BN and ReLU), summed under a label around each
site."""
from benchmark.counts import kernels as K


def read(record):
    s = record.trace.by_label.get("bench:conv_site")
    if not s:
        return None
    cfg = record.cfg
    b = record.workload["traffic"]["envs"]
    dtype = cfg["rollout_dtype"]
    least = record.trace.units["cycles"] * (
        K.step_conv_bound_s(cfg, "act", b, dtype, labelled_only=True)
        + 2 * K.step_conv_bound_s(cfg, "update_map", b, dtype,
                                  labelled_only=True))
    return 100.0 * least / s
