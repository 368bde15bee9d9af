"""The closed loop: each client sends its next statement when the last
one has returned, as each query stream of TPC-H's throughput test does.
Times are host-clock seconds from the window's start."""
from __future__ import annotations

import dataclasses
import threading
import time
import traceback
from typing import Callable, Iterator, List, Optional

from .traffic import Instance

#: how long past the window's close a statement may still come back
LATE_S = 60.0


@dataclasses.dataclass
class Statement:
    client: int
    instance: Instance
    sent: float
    done: Optional[float] = None
    rows: Optional[list] = None
    error: Optional[str] = None


def run_all(execute: Callable[[str], list], work: List[List[Instance]]):
    """Run each thread's list of instances, one thread per list, all at
    once (set-up's warm pass). Raises the first error."""
    errors: List[BaseException] = []

    def body(items):
        try:
            for inst in items:
                execute(inst.sql)
        except BaseException as e:      # re-raised in the caller
            errors.append(e)

    threads = [threading.Thread(target=body, args=(items,), daemon=True)
               for items in work if items]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]


class ClosedLoop:
    """``clients`` threads sending for ``seconds`` from ``start()``."""

    def __init__(self, execute: Callable[[str], list],
                 sequences: List[Iterator[Instance]], seconds: float):
        self.execute = execute
        self.seconds = float(seconds)
        self.statements: List[Statement] = []
        self._lock = threading.Lock()
        self._go = threading.Event()
        self.t0 = 0.0
        self._threads = [threading.Thread(target=self._client,
                                          args=(c, seq), daemon=True)
                         for c, seq in enumerate(sequences)]
        for t in self._threads:
            t.start()

    def now(self) -> float:
        return time.perf_counter() - self.t0

    def start(self) -> None:
        self.t0 = time.perf_counter()
        self._go.set()

    def _client(self, client: int, seq: Iterator[Instance]) -> None:
        self._go.wait()
        for inst in seq:
            sent = self.now()
            if sent >= self.seconds:
                return
            st = Statement(client, inst, sent)
            with self._lock:
                self.statements.append(st)
            try:
                st.rows = self.execute(inst.sql)
            except Exception:         # judged as a failed statement
                st.error = traceback.format_exc(limit=3)
            st.done = self.now()

    def wait(self) -> bool:
        """Wait for the clients to stop (the statements in flight at the
        close come back); False when one is still out LATE_S past it."""
        deadline = self.t0 + self.seconds + LATE_S
        for t in self._threads:
            t.join(max(0.0, deadline - time.perf_counter()))
        return not any(t.is_alive() for t in self._threads)
