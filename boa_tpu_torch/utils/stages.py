"""Background host-stage worker for the study orchestrator.

Counterpart of `boa_tpu/utils/stages.py`. ONE background thread runs
pure-host stages (gzip saves, the renders) while the calling thread keeps
launching device work, which mostly waits on the card with the interpreter
lock released. Without a worker (`worker=None` at the call sites) the stages run
inline.

Rule kept by convention (not by the class): never submit work that
launches on the card, so that the device's order stays that of the calling
thread; submitted callables touch only host memory and disk.
"""

from __future__ import annotations

import logging
from concurrent.futures import Future, ThreadPoolExecutor
from time import perf_counter
from typing import Any, Callable

logger = logging.getLogger(__name__)


class HostWorker:
    """Single-thread executor for deferred host stages.

    - ``submit(name, fn, *args)`` returns a Future; stages run FIFO.
    - ``barrier()`` waits for everything submitted so far and re-raises
      the first stage exception, except from a stage submitted with
      ``suppress=True`` (the preview render): its failure is logged as a
      warning and its Future holds None.
    - ``close()`` (also the context manager's exit) is a barrier, then
      stops the thread.
    """

    def __init__(self) -> None:
        self._pool: ThreadPoolExecutor | None = None
        self._pending: list[tuple[str, Future]] = []

    @staticmethod
    def _run(name: str, suppress: bool, fn: Callable[..., Any], args: tuple,
             kwargs: dict) -> Any:
        t0 = perf_counter()
        try:
            return fn(*args, **kwargs)
        except Exception:
            if not suppress:
                raise
            logger.warning("Deferred stage %s failed", name, exc_info=True)
            return None
        finally:
            logger.info("Stage %s: DONE in %0.5fs (overlapped)", name, perf_counter() - t0)

    def submit(self, name: str, fn: Callable[..., Any], *args: Any, suppress: bool = False,
               **kwargs: Any) -> Future:
        if self._pool is None:
            self._pool = ThreadPoolExecutor(
                max_workers=1, thread_name_prefix="boa-host-stage")
        # prune completed-successful stages: a long-lived shared worker
        # must not retain every stage's result
        self._pending = [(n, f) for n, f in self._pending
                         if not f.done() or f.exception() is not None]
        fut = self._pool.submit(self._run, name, suppress, fn, args, kwargs)
        self._pending.append((name, fut))
        return fut

    def barrier(self) -> None:
        """Wait for all submitted stages; raise the first failure (later
        failures are logged so they aren't silently dropped)."""
        pending, self._pending = self._pending, []
        first_exc: BaseException | None = None
        for name, fut in pending:
            exc = fut.exception()
            if exc is None:
                continue
            if first_exc is None:
                first_exc = exc
            else:
                logger.error("Deferred stage %s also failed: %s", name, exc)
        if first_exc is not None:
            raise first_exc

    def close(self) -> None:
        try:
            self.barrier()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None

    def __enter__(self) -> "HostWorker":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
