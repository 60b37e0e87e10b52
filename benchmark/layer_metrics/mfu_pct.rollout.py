"""The whole rollout's share of the card's peak: the model operations
(every convolution and matrix product, from shapes) of all the engine
steps and text encodings in the measured window, over the window's
seconds times the configuration's peak rate (989 TFLOP/s in bf16, 67 in
fp32)."""
from benchmark.counts.peaks import PEAK_FLOPS


def read(record):
    w = record.window
    peak = PEAK_FLOPS[record.cfg["rollout_dtype"]]
    return 100.0 * w["flops"] / (w["seconds"] * peak) if w["flops"] else None
