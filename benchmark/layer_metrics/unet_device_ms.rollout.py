"""Device ms per decision cycle of every kernel launched under
``net.rgb_encoder`` (the UNet; the hand-written convs included), from
the profiled sub-window."""


def read(record):
    s = record.trace.by_label.get("bench:unet")
    return 1e3 * s / record.trace.units["cycles"] if s else None
