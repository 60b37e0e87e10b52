"""Host ms per update spent waiting for the next batch from
``ReplayLoader`` (its prefetch thread decodes and collates ahead),
averaged over every update of the measured window."""


def read(record):
    spans = record.spans.get("loader_wait")
    return 1e3 * sum(spans) / len(spans) if spans else None
