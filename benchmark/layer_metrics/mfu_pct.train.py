"""The training's share of the card's peak: the model operations
(forward and backward, 3x the forward's convolutions and matrix
products, from shapes) of the valid frames trained in the measured
window, over the window's seconds times the fp32 peak (67 TFLOP/s)."""
from benchmark.counts.peaks import PEAK_FLOPS


def read(record):
    w = record.window
    peak = PEAK_FLOPS[record.cfg["train_dtype"]]
    return 100.0 * w["flops"] / (w["seconds"] * peak) if w["flops"] else None
