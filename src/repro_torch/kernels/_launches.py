"""Kernel launch counts, safe under threads.

Every kernel wrapper carries a ``launches`` attribute.  :func:`count` adds
one to it under one lock, where the wrapper launches its kernel and
nowhere else, so the workers of a fleet, each launching from its own
thread, lose no count; ``reset_launches`` and ``launch_counts`` in
``repro_torch.kernels`` take the same lock.
"""

from __future__ import annotations

import threading

LOCK = threading.Lock()


def count(wrapper) -> None:
    """Add one launch to ``wrapper.launches``."""
    with LOCK:
        wrapper.launches += 1
