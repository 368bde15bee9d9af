"""Retry backoff shared by the coordinator and worker planes.

The counterpart of ``presto_tpu/exec/backoff.py``. It lives in ``exec/``
so the coordinator's retry path (``exec/cluster.py``) does not import
the worker's HTTP module for one helper.
"""
from __future__ import annotations

import random


def jittered(seconds: float) -> float:
    """Retry backoff with +/-50% uniform jitter: a deterministic
    exponential backoff makes N consumers retry in bursts against a
    recovering worker; jitter spreads them (the reference's airlift
    Backoff adds the same randomization)."""
    return seconds * random.uniform(0.5, 1.5)
