"""In-process multi-consumer event bus (+ the on-disk live spool).

Modeled on Ray's aggregator ``MultiConsumerEventBuffer``: one publisher
lock, N subscribers each with a **bounded** buffer and per-subscriber
drop accounting — a slow consumer loses *its own* oldest events, never
anybody else's, and publishing never blocks on a consumer.  Publishers
are the wave scheduler's stage lane, the executor's container/timer
threads, the scan pool and the lakekeeper jobs, so ``publish`` is fully
thread-safe and cheap (one lock, one deque append per subscriber).

The bus also mirrors every event to a **spool file** (JSON lines) under
the lake root when given a path: that is what makes ``repro events
--follow`` work from a *different process* than the one executing
``run_async`` — the CLI tails the spool exactly like ``tail -f``, no
socket required.  The spool rotates at ``spool_max_bytes`` (current +
one ``.1`` predecessor) so a long-lived service does not grow it without
bound.
"""
from __future__ import annotations

import json
import os
import threading
import time
from collections import deque
from pathlib import Path
from typing import Any, Callable, Deque, Dict, Iterator, List, Optional, Union

from repro_torch.telemetry.events import Event, event_from_json_dict

__all__ = ["EventBus", "Subscription", "read_spool", "follow_spool"]

#: global sequence scope for events that carry no run_id
_GLOBAL_SCOPE = -1


class Subscription:
    """One consumer's bounded view of the bus.

    ``poll()`` drains what is buffered without blocking; ``follow()``
    yields events as they arrive (with an idle timeout).  ``dropped``
    counts events this subscriber lost to its bound — gaps are also
    detectable from the per-run ``seq`` numbers.
    """

    def __init__(self, bus: "EventBus", maxlen: int):
        self._bus = bus
        self.maxlen = maxlen
        self._buf: Deque[Event] = deque()
        self._dropped = 0
        self._closed = False

    # ---------------------------------------------------------- consuming
    @property
    def dropped(self) -> int:
        with self._bus._lock:
            return self._dropped

    def poll(self, max_items: Optional[int] = None) -> List[Event]:
        """Drain buffered events (up to ``max_items``), non-blocking."""
        with self._bus._lock:
            n = len(self._buf) if max_items is None else min(max_items, len(self._buf))
            return [self._buf.popleft() for _ in range(n)]

    def drain(self) -> List[Event]:
        """Everything buffered right now (alias for unbounded poll)."""
        return self.poll()

    def follow(
        self, *, idle_timeout_s: Optional[float] = None
    ) -> Iterator[Event]:
        """Yield events as they are published.  Stops when the
        subscription is closed, or after ``idle_timeout_s`` seconds with
        nothing new (None = wait forever)."""
        while True:
            with self._bus._cond:
                while not self._buf and not self._closed:
                    if not self._bus._cond.wait(timeout=idle_timeout_s):
                        return  # idle timeout
                if self._closed and not self._buf:
                    return
                batch = [self._buf.popleft() for _ in range(len(self._buf))]
            yield from batch

    def close(self) -> None:
        with self._bus._cond:
            self._closed = True
            self._bus._subs.discard(self)
            self._bus._cond.notify_all()

    def __enter__(self) -> "Subscription":
        return self

    def __exit__(self, *exc: Any) -> None:
        self.close()

    # called by the bus with the lock held
    def _offer(self, event: Event) -> None:
        if len(self._buf) >= self.maxlen:
            self._buf.popleft()  # drop-oldest; the tail stays fresh
            self._dropped += 1
        self._buf.append(event)


class EventBus:
    """Thread-safe publish, bounded multi-consumer delivery, spool mirror."""

    def __init__(
        self,
        *,
        spool_path: Union[str, Path, None] = None,
        spool_max_bytes: int = 8 * 1024 * 1024,
    ):
        self._lock = threading.RLock()
        self._cond = threading.Condition(self._lock)
        self._subs: set = set()
        #: per-scope monotonic sequence counters (scope = run_id or global)
        self._seqs: Dict[int, int] = {}
        self._published = 0
        self.spool_path = Path(spool_path) if spool_path is not None else None
        self._spool_max_bytes = spool_max_bytes
        self._spool_fh: Optional[Any] = None
        self._spool_bytes = 0

    # ----------------------------------------------------------- publish
    def publish(self, event: Event) -> Event:
        """Stamp ``ts``/``seq`` and deliver to every subscriber + spool."""
        if event.ts == 0.0:
            event.ts = time.time()
        line: Optional[str] = None
        with self._cond:
            scope = event.run_id if event.run_id is not None else _GLOBAL_SCOPE
            seq = self._seqs.get(scope, 0) + 1
            self._seqs[scope] = seq
            event.seq = seq
            self._published += 1
            for sub in self._subs:
                sub._offer(event)
            if self.spool_path is not None:
                line = json.dumps(event.to_json_dict(), sort_keys=True)
                self._spool_write(line)
            self._cond.notify_all()
        return event

    def _spool_write(self, line: str) -> None:
        # called with the lock held; spool failures must never sink a run
        try:
            if self._spool_fh is None:
                self.spool_path.parent.mkdir(parents=True, exist_ok=True)
                self._spool_fh = open(self.spool_path, "a", encoding="utf-8")
                self._spool_bytes = self._spool_fh.tell()
            self._spool_fh.write(line + "\n")
            self._spool_fh.flush()  # tail -f semantics for repro events
            self._spool_bytes += len(line) + 1
            if self._spool_bytes > self._spool_max_bytes:
                self._spool_fh.close()
                self._spool_fh = None
                os.replace(self.spool_path, str(self.spool_path) + ".1")
                self._spool_bytes = 0
        except OSError:
            self._spool_fh = None

    # --------------------------------------------------------- subscribe
    def subscribe(self, *, maxlen: int = 4096) -> Subscription:
        sub = Subscription(self, maxlen)
        with self._lock:
            self._subs.add(sub)
        return sub

    # ------------------------------------------------------------- stats
    def stats(self) -> Dict[str, int]:
        with self._lock:
            return {
                "published": self._published,
                "subscribers": len(self._subs),
                "dropped": sum(s._dropped for s in self._subs),
            }

    def close(self) -> None:
        with self._cond:
            for sub in list(self._subs):
                sub._closed = True
            self._subs.clear()
            if self._spool_fh is not None:
                try:
                    self._spool_fh.close()
                except OSError:
                    pass
                self._spool_fh = None
            self._cond.notify_all()


# ---------------------------------------------------------------- spool IO
def _iter_spool_lines(path: Path) -> Iterator[str]:
    # include the rotated predecessor so a tail spanning a rotation is whole
    for p in (Path(str(path) + ".1"), path):
        if p.exists():
            with open(p, "r", encoding="utf-8") as fh:
                yield from fh


def read_spool(
    path: Union[str, Path],
    *,
    run_id: Optional[int] = None,
    limit: Optional[int] = None,
) -> List[Event]:
    """Read the spool's current contents (``repro events`` without
    ``--follow``)."""
    path = Path(path)
    out: List[Event] = []
    for line in _iter_spool_lines(path):
        line = line.strip()
        if not line:
            continue
        try:
            ev = event_from_json_dict(json.loads(line))
        except (json.JSONDecodeError, TypeError):
            continue  # torn write at a rotation boundary
        if run_id is not None and ev.run_id != run_id:
            continue
        out.append(ev)
    if limit is not None:
        out = out[-limit:]
    return out


def follow_spool(
    path: Union[str, Path],
    *,
    run_id: Optional[int] = None,
    poll_s: float = 0.2,
    stop: Optional[Callable[[], bool]] = None,
) -> Iterator[Event]:
    """Tail the spool file across processes (``repro events --follow``).

    Yields existing events, then polls for appended lines until ``stop()``
    returns True (or forever).  Chunked-poll file tailing, the same shape
    as Ray's job-log ``file_tail_iterator``.
    """
    path = Path(path)
    # initial catch-up: rotated predecessor first, then the live file —
    # tracking exactly how many bytes of the live file were consumed so
    # a line appended mid-read is neither skipped nor double-yielded
    pos = 0
    initial: List[Event] = []
    rotated = Path(str(path) + ".1")
    if rotated.exists():
        initial.extend(read_spool(rotated, run_id=run_id))
    if path.exists():
        with open(path, "r", encoding="utf-8") as fh:
            for line in fh:
                line = line.strip()
                if line:
                    try:
                        ev = event_from_json_dict(json.loads(line))
                    except (json.JSONDecodeError, TypeError):
                        continue
                    if run_id is None or ev.run_id == run_id:
                        initial.append(ev)
            pos = fh.tell()
    yield from initial
    while stop is None or not stop():
        if not path.exists():
            time.sleep(poll_s)
            continue
        size = path.stat().st_size
        if size < pos:
            pos = 0  # rotated under us — restart from the fresh file
        if size == pos:
            time.sleep(poll_s)
            continue
        with open(path, "r", encoding="utf-8") as fh:
            fh.seek(pos)
            chunk = fh.read()
            pos = fh.tell()
        for line in chunk.splitlines():
            line = line.strip()
            if not line:
                continue
            try:
                ev = event_from_json_dict(json.loads(line))
            except (json.JSONDecodeError, TypeError):
                continue
            if run_id is not None and ev.run_id != run_id:
                continue
            yield ev
