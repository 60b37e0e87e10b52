"""Replay data: the trajectory store (``trajstore``)."""
