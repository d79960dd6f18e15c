"""The JAX package's C slot index, as the port's comparison tests need it.

The JAX package's loader (``ratelimiter_tpu/engine/native_index.py``)
builds ``native/libslotindex.so`` in place with ``make`` and marks the
library failed for the life of the process on any error.  Test processes
started together (pytest-xdist workers) each run that build, and one that
loads the file while another's linker is still writing it fails.  The
port's tests wait for the build to settle and let the loader try again
before they give up; nothing in the JAX package changes.

The module also carries ``idle_reference_flushers``, an autouse fixture
that every port test file imports.  The JAX package's micro-batcher keeps
an emptied queue's age after a deadline shed, so its flusher spins from
then on, after ``close()`` too (ROADMAP C7); the reference's own
``tests/test_overload.py`` leaves two such threads in its process.  A
port test file that runs later in the same process (pytest-xdist hands
each worker whole files) would share the interpreter with them and run
its micro steps' torch calls many times slower.  The fixture finds those
batchers and clears the stale age under their lock, as the port's
batcher does at the shed; nothing in the JAX package changes.
"""

from __future__ import annotations

import gc
import time

import pytest

from ratelimiter_tpu.engine import native_index as ref_native

RETRY_SECONDS = 120.0  # the loader's own ``make`` time limit
RETRY_PAUSE = 1.0
_gave_up = False


def require_reference_native() -> None:
    """Fail, saying why, when the JAX package's C slot index cannot be
    loaded in this process: its storage then falls back to a Python index
    that takes other routes, and its bindings return False.  A failed load
    is retried (the failure mark cleared) until ``RETRY_SECONDS`` pass, so
    another process's build of the same file can finish first; after one
    retry that runs out, the process fails at once."""
    global _gave_up
    deadline = time.monotonic() + RETRY_SECONDS
    while not ref_native.native_available():
        if _gave_up or time.monotonic() >= deadline:
            _gave_up = True
            pytest.fail("the JAX package's native slot index "
                        "(native/libslotindex.so) failed to load in this "
                        f"process, retried for {RETRY_SECONDS:.0f} s; the "
                        "comparisons with the reference need it")
        time.sleep(RETRY_PAUSE)
        ref_native._lib_failed = False


@pytest.fixture(autouse=True, scope="module")
def idle_reference_flushers():
    """Stop every reference micro-batcher in this process from spinning on
    an emptied, aged queue (see the module docstring)."""
    from ratelimiter_tpu.engine.batcher import MicroBatcher

    for obj in gc.get_objects():
        if type(obj) is MicroBatcher:
            with obj._cv:
                for pend in obj._pending.values():
                    if (pend.born is not None and not pend.n
                            and not pend.clears):
                        pend.born = None
                obj._cv.notify_all()
    yield
