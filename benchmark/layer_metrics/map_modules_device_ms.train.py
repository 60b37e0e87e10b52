"""Device ms per update of the map modules (encoder, decoder,
classifier and their linears), forward and backward: a backward kernel
counts toward the module of the forward op with its autograd sequence
number. From the profiled updates."""


def read(record):
    s = record.trace.by_label.get("bench:map_modules")
    return 1e3 * s / record.trace.units["updates"] if s else None
