"""The splat kernel's share of its roofline: the least time its bytes
need at 3.35 TB/s (each valid pixel's features and every cell id read
once, the fp32 ego grid written once; the valid pixels counted by the
benchmark's own binning of the same frames) over the device time of the
``splat_max_kernel`` launches in the profiled sub-window."""
from benchmark.counts import kernels as K
from benchmark.counts.peaks import bound_s


def read(record):
    t = sum(e - s for name, s, e in record.trace.kernels
            if "splat_max_kernel" in name) / 1e6
    w = record.counters.get("splat")
    if not t or not w:
        return None
    cfg = record.cfg
    nbytes = K.splat_bytes(w["n_valid"], w["frames"], w["pixels"],
                           cfg["map_depth"], cfg["ego_map_size"],
                           cfg["rollout_dtype"])
    least = bound_s(nbytes, w["n_valid"] * cfg["map_depth"],
                    cfg["rollout_dtype"])["bound_s"]
    return 100.0 * least / t
