"""Device ms per update of the batch's host-to-device copies, every
operation under ``train.step.upload_batch``, from the profiled
updates."""


def read(record):
    s = record.trace.by_label.get("bench:upload")
    return 1e3 * s / record.trace.units["updates"] if s else None
