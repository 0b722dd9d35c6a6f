"""A watchdog for a training loop that stops making progress.

The loop reports each stage it reaches with `update(stage)`. While the
context is open, a watcher thread waits for those reports; if none comes
for `timeout` seconds it logs the last stage, writes every thread's stack
to stderr and kills the process with SIGKILL, so that a scheduler sees a
dead job (and may restart it from its checkpoint) instead of a hung one.
Closing the context stops the watcher. With `use=False` it does nothing.
"""
import faulthandler
import logging
import os
import signal
import sys
import threading
import typing as tp

logger = logging.getLogger(__name__)


class DeadlockDetect:
    def __init__(self, use: bool = False, timeout: float = 600.0):
        self.use = use
        self.timeout = timeout
        self.last_stage = "init"
        self._progress = threading.Event()
        self._closed = threading.Event()
        self._thread: tp.Optional[threading.Thread] = None

    def update(self, stage: str) -> None:
        if self.use:
            self.last_stage = stage
            self._progress.set()

    def __enter__(self):
        if self.use:
            self._closed.clear()
            self._thread = threading.Thread(target=self._watch, daemon=True,
                                            name="deadlock-watchdog")
            self._thread.start()
        return self

    def __exit__(self, exc_type, exc_val, exc_tb):
        if self._thread is not None:
            self._closed.set()
            self._progress.set()
            self._thread.join()
            self._thread = None

    def _watch(self) -> None:
        while True:
            progressed = self._progress.wait(self.timeout)
            if self._closed.is_set():
                return
            if not progressed:
                self._kill()
                return
            self._progress.clear()

    def _kill(self) -> None:
        logger.error("No progress for %s s; the last stage was %r. Killing "
                     "the process.", self.timeout, self.last_stage)
        faulthandler.dump_traceback(file=sys.stderr, all_threads=True)
        sys.stderr.flush()
        os.kill(os.getpid(), signal.SIGKILL)
