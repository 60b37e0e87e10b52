"""Device ms per decision cycle of the mapping chain (projection, splat,
registration: every kernel under ``rgb_mapping_step``), from the
profiled sub-window."""


def read(record):
    s = record.trace.by_label.get("bench:mapping")
    return 1e3 * s / record.trace.units["cycles"] if s else None
