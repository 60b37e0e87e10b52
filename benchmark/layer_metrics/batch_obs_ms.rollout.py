"""Host ms per engine step of ``RolloutEngine.batch_obs`` (stacking the
B observations and uploading them), averaged over every step of the
measured window: the rollout engine's host side."""


def read(record):
    spans = record.spans.get("batch_obs")
    return 1e3 * sum(spans) / len(spans) if spans else None
