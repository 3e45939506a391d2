"""The lock factory of ``parallax_tpu/analysis/sanitizer.py``.

``make_lock`` returns a plain ``threading.Lock`` / ``RLock``: the
lock-order sanitizer that instruments it in the JAX package waits for
ROADMAP queue 1 item 14, so ``name`` only labels the call site for now.
"""

from __future__ import annotations

import threading


def make_lock(name: str, reentrant: bool = False):
    """Lock for shared state, named ``module.role`` as in the JAX package."""
    del name
    return threading.RLock() if reentrant else threading.Lock()
