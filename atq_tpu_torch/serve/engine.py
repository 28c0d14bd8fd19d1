"""Micro-batching serving engine.

A copy of atq_tpu/serve/engine.py, which is pure numpy and threading (the
port imports nothing of the JAX package). It fronts any per-batch apply
function with a request queue, a collector thread that forms batches up to
``max_batch`` (dispatching early after ``max_wait_ms`` when traffic is
light), and shape buckets.

Design points:
- **Static shapes**: every request is padded to its bucket's shape; the
  bucket set is fixed up front.
- **One dispatch per batch**: requests are stacked on the leading axis,
  run once, and the outputs split back per request.
- **Futures**: ``submit`` returns ``concurrent.futures.Future``; callers
  block only on their own result. Exceptions propagate to the requests
  of the failing batch, not the whole server.

The ``fallback_fn`` parameter is kept for parity with the JAX engine, but
no entry point of the port passes one: a failing packed kernel fails its
requests instead of being re-served dense.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass, field
from queue import Empty, Queue
from typing import Callable, Dict, List, Optional, Sequence

import numpy as np


def pad_to_bucket(arr: np.ndarray, length: int, pad_value=0):
    """Pad ``arr``'s axis 0 (its own length axis) up to ``length``."""
    if arr.shape[0] > length:
        raise ValueError(f"request length {arr.shape[0]} exceeds largest "
                         f"bucket {length}")
    if arr.shape[0] == length:
        return arr
    pad = [(0, length - arr.shape[0])] + [(0, 0)] * (arr.ndim - 1)
    return np.pad(arr, pad, constant_values=pad_value)


def pick_bucket(buckets: Sequence[int], n: int) -> int:
    for b in sorted(buckets):
        if n <= b:
            return b
    raise ValueError(f"length {n} exceeds largest bucket {max(buckets)}")


@dataclass
class _Request:
    payload: tuple
    future: Future = field(default_factory=Future)
    bucket: Optional[int] = None
    seq: int = 0  # arrival order, for oldest-first bucket scheduling


class BatchServer:
    """Micro-batching front for a per-batch function.

    Args:
        apply_fn: callable taking stacked numpy arrays with a leading
            batch axis (one positional arg per request field) and
            returning an array (or tuple of arrays) with the same leading
            batch size.
        max_batch: largest batch per dispatch.
        max_wait_ms: how long the collector waits for more requests
            before dispatching a partial batch.
        bucket_by: index of the request field whose axis-0 length chooses
            the shape bucket (e.g. token ids), or None when all requests
            share one shape (images).
        buckets: sorted lengths for the bucketed field.
        pad_value: padding constant for the bucketed field.
        fallback_fn: optional second apply path tried when ``apply_fn``
            raises. A batch whose primary dispatch fails is re-run on the
            fallback instead of failing its callers. Kept for parity with
            the JAX engine; the port's serving CLI passes none.
        max_primary_failures: after this many CONSECUTIVE
            fallback-confirmed primary failures (the primary raised but
            the fallback served the very same batch — so the program,
            not the input, is at fault) the primary is latched OFF and
            every batch routes straight to the fallback — a
            repeatedly-crashing program is not worth re-wedging the chip
            for. A primary success resets the count; a batch that fails
            on BOTH paths is treated as a bad input and charged to
            neither; without a ``fallback_fn`` the primary is never
            latched off (there would be nothing left to serve with).
            ``stats["primary_failures"]`` / ``stats["fallback_batches"]``
            expose what happened.
    """

    def __init__(self, apply_fn: Callable, max_batch: int = 32,
                 max_wait_ms: float = 2.0, bucket_by: Optional[int] = None,
                 buckets: Sequence[int] = (), pad_value=0,
                 fallback_fn: Optional[Callable] = None,
                 max_primary_failures: int = 3):
        if bucket_by is not None and not buckets:
            raise ValueError("bucket_by requires buckets")
        self._apply = apply_fn
        self._fallback = fallback_fn
        self._max_primary_failures = max_primary_failures
        self._primary_failures = 0
        self._primary_disabled = False
        self._max_batch = max_batch
        self._max_wait = max_wait_ms / 1000.0
        self._bucket_by = bucket_by
        self._buckets = tuple(sorted(buckets))
        self._pad_value = pad_value
        self._queue: Queue = Queue()
        # Collector-thread-only: requests popped from the shared queue
        # whose bucket didn't match the batch being formed. Served
        # oldest-bucket-first BEFORE the shared queue, so a minority
        # bucket can never be starved behind newer arrivals.
        self._pending: Dict[Optional[int], deque] = {}
        self._seq = itertools.count()
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._started = False
        self.stats = {"batches": 0, "requests": 0, "occupancy_sum": 0.0,
                      "primary_failures": 0, "fallback_batches": 0}

    # -- public API ------------------------------------------------------

    def start(self) -> "BatchServer":
        if not self._started:
            self._started = True
            self._thread.start()
        return self

    def submit(self, *fields) -> Future:
        """Enqueue one request (each field WITHOUT the batch axis)."""
        if self._stop.is_set():
            raise RuntimeError("BatchServer is stopped")
        if not self._started:
            self.start()  # lazy start so bare submit()/call() just work
        fields = tuple(np.asarray(f) for f in fields)
        req = _Request(payload=fields, seq=next(self._seq))
        if self._bucket_by is not None:
            n = fields[self._bucket_by].shape[0]
            req.bucket = pick_bucket(self._buckets, n)
        self._queue.put(req)
        return req.future

    def __call__(self, *fields):
        """Synchronous convenience: submit and wait."""
        return self.submit(*fields).result()

    def stop(self) -> None:
        self._stop.set()
        if self._started:
            self._thread.join(timeout=5)

    def __enter__(self) -> "BatchServer":
        return self.start()

    def __exit__(self, *exc) -> None:
        self.stop()

    # -- collector -------------------------------------------------------

    def _pop_oldest_pending(self) -> Optional[_Request]:
        """Head of the pending deque whose front request arrived first."""
        oldest_key = None
        for key, pend in self._pending.items():
            if pend and (oldest_key is None
                         or pend[0].seq < self._pending[oldest_key][0].seq):
                oldest_key = key
        if oldest_key is None:
            return None
        return self._pending[oldest_key].popleft()

    def _take_batch(self) -> List[_Request]:
        """Form one batch, deferred-pending buckets first.

        Deferred requests (popped from the shared queue while a different
        bucket's batch was forming) sit in per-bucket deques and are
        consumed BEFORE the shared queue — oldest bucket first — so under
        sustained traffic in one bucket another bucket's requests wait at
        most one dispatch cycle, never behind newer arrivals.
        """
        first = self._pop_oldest_pending()
        if first is None:
            try:
                first = self._queue.get(timeout=0.1)
            except Empty:
                return []
        batch = [first]
        # Same-bucket deferred requests join immediately (no wait).
        pend = self._pending.get(first.bucket)
        while pend and len(batch) < self._max_batch:
            batch.append(pend.popleft())
        deadline = time.monotonic() + self._max_wait
        while len(batch) < self._max_batch:
            remaining = deadline - time.monotonic()
            if remaining <= 0:
                break
            try:
                req = self._queue.get(timeout=remaining)
            except Empty:
                break
            if req.bucket == first.bucket:
                batch.append(req)
            else:
                self._pending.setdefault(req.bucket, deque()).append(req)
        return batch

    def _run(self) -> None:
        while not self._stop.is_set():
            batch = self._take_batch()
            if not batch:
                continue
            self._dispatch(batch)
        # drain on shutdown
        while True:
            batch = self._take_batch()
            if not batch:
                break
            self._dispatch(batch)

    def _dispatch(self, batch: List[_Request]) -> None:
        try:
            n_fields = len(batch[0].payload)
            stacked = []
            for i in range(n_fields):
                fields = [r.payload[i] for r in batch]
                if self._bucket_by == i:
                    fields = [pad_to_bucket(f, batch[0].bucket,
                                            self._pad_value)
                              for f in fields]
                stacked.append(np.stack(fields))
        except Exception as e:  # malformed request batch
            for req in batch:
                if not req.future.done():
                    req.future.set_exception(e)
            return

        paths = []
        if not self._primary_disabled or self._fallback is None:
            # With no fallback the primary is all there is — never skip
            # it, even after repeated failures.
            paths.append(("primary", self._apply))
        if self._fallback is not None:
            paths.append(("fallback", self._fallback))
        last_exc: Optional[Exception] = None
        primary_failed = False
        for name, fn in paths:
            try:
                out = fn(*stacked)
                outs = out if isinstance(out, tuple) else (out,)
                outs = tuple(np.asarray(o) for o in outs)
            except Exception as e:
                last_exc = e
                if name == "primary":
                    primary_failed = True
                    self.stats["primary_failures"] += 1
                continue
            if name == "primary":
                self._primary_failures = 0  # consecutive count resets
            elif primary_failed:
                # The fallback served the exact batch the primary choked
                # on: the program (not the input) is at fault. Latch the
                # primary off after max_primary_failures in a row.
                self._primary_failures += 1
                if self._primary_failures >= self._max_primary_failures:
                    self._primary_disabled = True
            for j, req in enumerate(batch):
                per = tuple(o[j] for o in outs)
                req.future.set_result(per if len(per) > 1 else per[0])
            self.stats["batches"] += 1
            self.stats["requests"] += len(batch)
            self.stats["occupancy_sum"] += len(batch) / self._max_batch
            if name == "fallback":
                self.stats["fallback_batches"] += 1
            return
        if last_exc is None:  # defensive: paths can never be empty
            last_exc = RuntimeError("BatchServer has no serving path")
        for req in batch:  # every path failed: THIS batch's callers only
            if not req.future.done():
                req.future.set_exception(last_exc)
