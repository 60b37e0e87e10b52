"""The share of the profiled sub-window in which no operation ran on
the device: 1 - (the union of the device operations' intervals / the
sub-window's wall time)."""


def read(record):
    t = record.trace
    return 100.0 * (1.0 - t.busy_s() / t.window_s) if t.kernels else None
