"""Kernels launched per decision cycle (one act and two map updates) in
the profiled sub-window; copies and sets are not counted."""


def read(record):
    n = sum(1 for name, _, _ in record.trace.kernels
            if not name.startswith(("Memcpy", "Memset")))
    return n / record.trace.units["cycles"] if n else None
