"""Interval and conditional triggers.

Counterpart of ``aquery2_tpu/runtime/triggers.py`` (the reference's
trigger hosts, server/threading.cpp:158-270, engine/ast.py:1190-1254):

  * ``CREATE TRIGGER t ACTION a INTERVAL n`` runs stored procedure ``a``
    every n milliseconds, from a ticker thread that wakes every 50 ms (the
    reference's IntervalBasedTriggerHost tick);
  * ``CREATE TRIGGER t ON tbl ACTION a WHEN q`` runs procedure ``q`` after
    each INSERT or LOAD into ``tbl`` and, if its first cell is true (or
    there is no ``q``), procedure ``a``. The inserting thread only puts
    the trigger on a queue; one worker thread runs the queue in order, so
    a slow action never stalls ingest and a table's firings keep their
    order. ``drain`` waits until the queue is empty and its last item
    has run.

Both threads start at first use and stop at ``shutdown`` (Session.close).
An action runs on the session's device: each one inside
``torch.cuda.device(session.device)``, so a session on ``cuda:1`` does
not launch on device 0; the kernels' wrappers take the thread's current
stream, which is the device's default stream. An exception in an action
goes to ``session.log_error`` and the thread lives on, as in the JAX
package. A query on a trigger thread is not isolated from an INSERT on
another thread (neither package takes a lock).
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from dataclasses import dataclass

import torch


@dataclass
class Trigger:
    name: str
    action: str
    interval_ms: int | None = None
    table: str | None = None
    when: str | None = None
    next_fire: float = 0.0


class TriggerHost:
    TICK_SECONDS = 0.05         # the reference ticks every 50 ms

    def __init__(self, session) -> None:
        self.session = session
        self.triggers: dict[str, Trigger] = {}
        self._lock = threading.Lock()
        self._ticker: threading.Thread | None = None
        self._stop = threading.Event()
        self._queue: "queue.Queue[Trigger | None]" = queue.Queue()
        self._worker: threading.Thread | None = None
        self._pending = 0           # conditional firings queued or running
        self._done = threading.Condition(self._lock)

    # -- registration ------------------------------------------------------

    def create(self, stmt) -> None:
        t = Trigger(stmt.name.lower(), stmt.action,
                    interval_ms=stmt.interval_ms,
                    table=stmt.table.lower() if stmt.table else None,
                    when=stmt.when)
        with self._lock:
            self.triggers[t.name] = t
        if t.interval_ms is not None:
            t.next_fire = time.monotonic() + t.interval_ms / 1000.0
            self._ensure_ticker()

    def drop(self, name: str) -> None:
        with self._lock:
            self.triggers.pop(name.lower(), None)

    def threads(self) -> list[threading.Thread]:
        """The ticker and worker threads that were started."""
        return [t for t in (self._ticker, self._worker) if t is not None]

    def _run(self, name: str):
        """Run procedure ``name`` on the session's device."""
        dev = self.session.device
        with (torch.cuda.device(dev) if dev.type == "cuda"
              else contextlib.nullcontext()):
            return self.session.run_procedure(name)

    # -- interval triggers -------------------------------------------------

    def _ensure_ticker(self) -> None:
        if self._ticker is None or not self._ticker.is_alive():
            self._stop.clear()
            self._ticker = threading.Thread(target=self._tick_loop,
                                            name="aq-trigger-ticker",
                                            daemon=True)
            self._ticker.start()

    def _tick_loop(self) -> None:
        while not self._stop.wait(self.TICK_SECONDS):
            now = time.monotonic()
            due = []
            with self._lock:
                for t in self.triggers.values():
                    if t.interval_ms is not None and now >= t.next_fire:
                        t.next_fire = now + t.interval_ms / 1000.0
                        due.append(t)
            for t in due:
                try:
                    self._run(t.action)
                except Exception as e:      # the ticker lives on
                    self.session.log_error(f"trigger {t.name}: {e}")

    # -- conditional triggers ----------------------------------------------

    def notify_insert(self, table_name: str) -> None:
        """Queue the conditional triggers watching ``table_name`` for the
        worker thread; returns at once."""
        with self._lock:
            watchers = [t for t in self.triggers.values()
                        if t.table == table_name.lower()]
            self._pending += len(watchers)
        if not watchers:
            return
        self._ensure_worker()
        for t in watchers:
            self._queue.put(t)

    def _ensure_worker(self) -> None:
        if self._worker is None or not self._worker.is_alive():
            self._worker = threading.Thread(target=self._work_loop,
                                            name="aq-trigger-worker",
                                            daemon=True)
            self._worker.start()

    def _work_loop(self) -> None:
        while True:
            t = self._queue.get()
            if t is None:
                return
            try:
                cond = self._run(t.when) if t.when else None
                if cond is None or not cond.nrows or \
                        bool(cond.rows(limit=1)[0][0]):
                    self._run(t.action)
            except Exception as e:
                self.session.log_error(f"trigger {t.name}: {e}")
            finally:
                with self._lock:
                    self._pending -= 1
                    self._done.notify_all()

    def drain(self, timeout: float = 10.0) -> bool:
        """Wait until every queued conditional trigger has run; False if
        ``timeout`` seconds passed first."""
        with self._lock:
            return self._done.wait_for(lambda: self._pending == 0, timeout)

    def shutdown(self, timeout: float = 10.0) -> None:
        """Stop the ticker and the worker (the worker after the firings
        already queued) and wait for both."""
        self._stop.set()
        if self._worker is not None and self._worker.is_alive():
            self._queue.put(None)
        for th in self.threads():
            if th is not threading.current_thread():
                th.join(timeout)
