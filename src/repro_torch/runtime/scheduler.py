"""Slot-based request scheduler for the continuous-batching engine.

Pure host-side bookkeeping: the device never sees requests, only the
fixed slot array. A :class:`Request` waits in an arrival-ordered queue
until its ``arrival_step`` has passed and a decode slot is free; it is
then *admitted* (prefilled into the slot mid-flight, while other slots
keep decoding) and *evicted* the step it finishes, freeing the slot for
the next pending request. Per-request state that must ride through the
decode step (sampling temperature) is exposed as a dense per-slot
array; everything else (generated tokens, budgets) stays host-side.

The scheduler is deliberately oblivious to KV state: eviction does not
touch the device cache, because :func:`repro_torch.models.cache.insert_slot`
overwrites a slot's entire extent on admission — the invariant the
slot-reuse property test (and the CI serving parity gate) enforces.
"""

from __future__ import annotations

import dataclasses
from collections import deque
from typing import Callable, Iterator, Optional

import numpy as np

#: Ring-buffer bound on the per-step stat histories (depth / latency /
#: queue waits). A long-running serve observes one entry per engine
#: iteration; unbounded lists are a slow host-memory leak under
#: sustained traffic, and every consumer (autopilot EWMA, bench p99)
#: only ever looks at a recent window anyway.
HISTORY_LIMIT = 4096


class SchedulerError(Exception):
    """Base class for typed scheduler failures."""


class AdmissionError(SchedulerError, ValueError):
    """A request can never be served as submitted (oversized prompt,
    duplicate id): reject at admission instead of spinning in the queue.
    Subclasses ``ValueError`` so pre-existing callers keep working."""


class DeadlineExceeded(SchedulerError):
    """A request's deadline passed before it finished (reason marker;
    the scheduler records the failure rather than raising mid-batch)."""


@dataclasses.dataclass
class Request:
    """One generation request.

    ``arrival_step`` is measured in engine iterations (decode steps) —
    the unit the mixed-arrival scenarios are scripted in; a wall-clock
    frontend would translate timestamps before submission.

    ``deadline_step``: absolute engine iteration by which the request
    must have finished; past it the scheduler fails the request (pending
    or mid-decode) instead of letting it occupy a slot forever. ``None``
    = no deadline.

    ``shared_prefix_len``: the request declares its first N prompt tokens
    as a shared prefix (a system prompt): the paged engine's prefix
    registry maps the same physical KV pages read-only across requests
    with byte-identical declared prefixes (DESIGN.md §12). 0 = no
    sharing. Purely advisory — engines without prefix sharing ignore it.
    """

    rid: int
    tokens: np.ndarray  # (S,) int32 prompt
    max_new_tokens: int
    temperature: float = 0.0
    arrival_step: int = 0
    deadline_step: Optional[int] = None
    shared_prefix_len: int = 0

    def __post_init__(self):
        self.tokens = np.asarray(self.tokens, np.int32)
        if self.tokens.ndim != 1 or self.tokens.size == 0:
            raise ValueError("prompt must be a non-empty 1-D token array")
        if self.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        if self.shared_prefix_len < 0 or self.shared_prefix_len > self.tokens.size:
            raise ValueError(
                f"shared_prefix_len ({self.shared_prefix_len}) must be in "
                f"[0, prompt length {self.tokens.size}]"
            )
        if self.deadline_step is not None and self.deadline_step <= self.arrival_step:
            raise ValueError(
                f"deadline_step ({self.deadline_step}) must be after "
                f"arrival_step ({self.arrival_step})"
            )


@dataclasses.dataclass
class _InFlight:
    request: Request
    generated: list  # of int


@dataclasses.dataclass(frozen=True)
class SchedulerStats:
    admitted: int = 0
    evicted: int = 0
    peak_occupancy: int = 0
    queue_steps: int = 0  # total steps requests spent waiting past arrival
    failed: int = 0  # deadline-expired / fault-exhausted / unservable
    requeued: int = 0  # fault retries returned to the queue
    quarantined_slots: int = 0
    shed: int = 0  # overload-evicted from the queue tail (autopilot)
    # controller inputs, recorded via observe_step(): one entry per
    # observed engine iteration, aligned by position. Ring-buffered to
    # the most recent HISTORY_LIMIT entries (host-memory bound under
    # sustained traffic).
    depth_history: tuple = ()  # queue depth at each observed step
    latency_history: tuple = ()  # per-step wall latency (s), NaN if unknown
    queue_waits: tuple = ()  # per-admission steps waited past arrival


class SlotScheduler:
    """Admits pending requests into free decode slots, evicts finished ones.

    Containment extensions (DESIGN.md §9): ``max_extent`` rejects
    never-servable prompts at admission with a typed
    :class:`AdmissionError`; :meth:`expire` fails requests past their
    deadline; :meth:`requeue` returns a faulted in-flight request to the
    queue (bounded by the engine's retry budget via :meth:`retries`);
    :meth:`quarantine` retires a repeatedly-faulting slot from the free
    pool. Failed requests land in ``failed`` (rid -> reason) — never in
    ``finished`` — and ``done`` stays reachable because failing removes
    them from the queue.
    """

    def __init__(
        self,
        n_slots: int,
        max_extent: Optional[int] = None,
        history_limit: int = HISTORY_LIMIT,
    ):
        if n_slots < 1:
            raise ValueError("need at least one slot")
        self.n_slots = n_slots
        self.max_extent = max_extent
        self.history_limit = history_limit
        self._pending: deque[Request] = deque()
        self._active: dict[int, _InFlight] = {}
        self._reserved: set[int] = set()  # staged prefills in flight
        self._free: list[int] = list(range(n_slots - 1, -1, -1))  # pop() -> slot 0 first
        self.finished: dict[int, np.ndarray] = {}
        self.failed: dict[int, str] = {}
        self._retries: dict[int, int] = {}
        self._quarantined: set[int] = set()
        self._admitted = 0
        self._evicted = 0
        self._peak = 0
        self._queue_steps = 0
        self._failed = 0
        self._requeued = 0
        self._shed = 0
        # deque(maxlen=...) ring buffers: O(1) append, oldest entries
        # dropped — see HISTORY_LIMIT
        self._depth_history: deque[int] = deque(maxlen=history_limit)
        self._latency_history: deque[float] = deque(maxlen=history_limit)
        self._queue_waits: deque[int] = deque(maxlen=history_limit)

    # -- queue side ---------------------------------------------------------

    def submit(self, request: Request) -> None:
        if any(r.rid == request.rid for r in self._pending) or any(
            f.request.rid == request.rid for f in self._active.values()
        ) or request.rid in self.finished or request.rid in self.failed:
            raise AdmissionError(f"duplicate request id {request.rid}")
        if self.max_extent is not None:
            extent = int(request.tokens.size) + request.max_new_tokens
            if extent > self.max_extent:
                raise AdmissionError(
                    f"request {request.rid}: prompt ({request.tokens.size}) + "
                    f"max_new_tokens ({request.max_new_tokens}) = {extent} "
                    f"exceeds the cache extent ({self.max_extent}); it could "
                    "never be served — rejected at admission"
                )
        self._pending.append(request)

    def admissible(
        self,
        step: int,
        capacity: Optional[Callable[[Request], bool]] = None,
    ) -> Iterator[tuple[int, Request]]:
        """Yield (slot, request) pairs to prefill at engine iteration
        ``step``: arrival-ordered, as many as there are free slots. The
        caller must follow each yield with :meth:`start`.

        ``capacity(request) -> bool``: an extra admission gate beyond
        free slots — the paged engine checks free-*page* capacity here
        instead of the dense ``max_extent``. A failing head request
        stops admission (FIFO, no bypass: letting smaller requests jump
        a capacity-starved head would starve large requests forever).
        Requests are popped lazily, so a caller that stops iterating
        leaves the remainder queued."""
        while self._free and self._pending and self._pending[0].arrival_step <= step:
            if capacity is not None and not capacity(self._pending[0]):
                return
            req = self._pending.popleft()
            waited = step - req.arrival_step
            self._queue_steps += waited
            self._queue_waits.append(waited)
            yield self._free[-1], req

    def reserve(self, slot: int) -> None:
        """Remove ``slot`` from the free pool ahead of :meth:`start`: a
        staged (chunked) prefill occupies the slot across several engine
        iterations before its first token exists, and the slot must not
        be handed to another request meanwhile (DESIGN.md §12)."""
        if slot not in self._free:
            raise SchedulerError(f"slot {slot} is not free; cannot reserve")
        self._free.remove(slot)
        self._reserved.add(slot)

    def unreserve(self, slot: int) -> None:
        """Abort a staged prefill: return its reserved slot to the free
        pool (the request itself is the caller's to fail or resubmit)."""
        if slot not in self._reserved:
            raise SchedulerError(f"slot {slot} is not reserved")
        self._reserved.discard(slot)
        self._release(slot)

    def start(self, slot: int, request: Request, first_token: int) -> bool:
        """Occupy ``slot`` with ``request`` whose prefill sampled
        ``first_token``. Returns True if the request is already complete
        (max_new_tokens == 1), in which case the slot is freed again.
        Accepts either the next free slot (immediate admission) or a
        slot previously taken via :meth:`reserve` (staged prefill)."""
        if slot in self._reserved:
            self._reserved.discard(slot)
        else:
            popped = self._free.pop()
            if popped != slot:
                raise RuntimeError(
                    f"slot order violated: expected {popped}, got {slot}"
                )
        self._active[slot] = _InFlight(request, [int(first_token)])
        self._admitted += 1
        self._peak = max(self._peak, len(self._active))
        if request.max_new_tokens == 1:
            self._evict(slot)
            return True
        return False

    # -- decode side --------------------------------------------------------

    @property
    def active_slots(self) -> list[int]:
        return sorted(self._active)

    def temperatures(self) -> np.ndarray:
        """Dense per-slot temperature array for the decode step
        (free slots get 0 — their lanes are never read)."""
        temps = np.zeros((self.n_slots,), np.float32)
        for slot, inf in self._active.items():
            temps[slot] = inf.request.temperature
        return temps

    def record(self, slot: int, token: int) -> bool:
        """Append a decoded token for ``slot``; evict when the request's
        budget is exhausted. Returns True on eviction."""
        inf = self._active[slot]
        inf.generated.append(int(token))
        if len(inf.generated) >= inf.request.max_new_tokens:
            self._evict(slot)
            return True
        return False

    def _evict(self, slot: int) -> None:
        inf = self._active.pop(slot)
        self.finished[inf.request.rid] = np.asarray(inf.generated, np.int32)
        self._release(slot)
        self._evicted += 1

    def _release(self, slot: int) -> None:
        if slot not in self._quarantined:
            self._free.append(slot)
            self._free.sort(reverse=True)

    # -- containment (DESIGN.md §9) -----------------------------------------

    def fail(self, rid: int, reason: str) -> None:
        """Record a request as failed (it must already be out of the
        queue/slots)."""
        self.failed[rid] = reason
        self._failed += 1

    def expire(self, step: int) -> list[int]:
        """Fail every request whose deadline has passed at ``step`` —
        pending ones silently missed their window, active ones are evicted
        mid-decode (their slot frees for the next tenant). Returns the
        failed rids."""
        expired: list[int] = []
        kept: deque[Request] = deque()
        for req in self._pending:
            if req.deadline_step is not None and step >= req.deadline_step:
                self.fail(req.rid, f"deadline: expired in queue at step {step}")
                expired.append(req.rid)
            else:
                kept.append(req)
        self._pending = kept
        for slot in list(self._active):
            req = self._active[slot].request
            if req.deadline_step is not None and step >= req.deadline_step:
                self._active.pop(slot)
                self._release(slot)
                self.fail(req.rid, f"deadline: evicted mid-decode at step {step}")
                expired.append(req.rid)
        return expired

    def requeue(self, slot: int, arrival_step: int) -> int:
        """Return ``slot``'s in-flight request to the queue (its slot hit
        a fault): generated tokens are discarded, the request re-prefills
        from its prompt at ``arrival_step`` (the retry backoff). Inserted
        in arrival order so it cannot stall the queue head. Returns the
        rid; pair with :meth:`retries` to bound attempts."""
        inf = self._active.pop(slot)
        self._release(slot)
        return self.resubmit(inf.request, arrival_step)

    def resubmit(self, request: Request, arrival_step: int) -> int:
        """Return a popped-but-not-started request to the queue (a staged
        prefill whose pages faulted mid-flight): counts as a requeue/retry
        exactly like :meth:`requeue`, but the caller holds the request —
        it is in no slot. The caller must :meth:`unreserve` its slot."""
        request.arrival_step = arrival_step
        self._retries[request.rid] = self._retries.get(request.rid, 0) + 1
        self._requeued += 1
        self._insert_pending(request)
        return request.rid

    def _insert_pending(self, req: Request) -> None:
        """Insert in arrival order so a requeue cannot stall the head."""
        pending = list(self._pending)
        at = next(
            (i for i, r in enumerate(pending) if r.arrival_step > req.arrival_step),
            len(pending),
        )
        pending.insert(at, req)
        self._pending = deque(pending)

    def retries(self, rid: int) -> int:
        return self._retries.get(rid, 0)

    def drop_pending(self, rid: int, reason: str) -> None:
        """Fail a pending request (e.g. its retry budget ran out)."""
        self._pending = deque(r for r in self._pending if r.rid != rid)
        self.fail(rid, reason)

    # -- controller signals (DESIGN.md §10) ---------------------------------

    def queue_depth(self, step: int) -> int:
        """Number of pending requests that have *arrived* by ``step`` —
        the autopilot's instantaneous backlog signal. Pre-submitted
        requests with a future ``arrival_step`` do not count: they are
        scripted traffic, not demand the engine is failing to serve."""
        return sum(1 for r in self._pending if r.arrival_step <= step)

    def waiting(self, step: int) -> list[Request]:
        """Arrived-but-unadmitted requests in queue order at ``step``
        (the shedding ladder's candidate pool)."""
        return [r for r in self._pending if r.arrival_step <= step]

    def observe_step(self, step: int, latency_s: float = float("nan")) -> None:
        """Record one engine iteration's controller inputs: queue depth
        at ``step`` and the step's wall latency (NaN when the caller did
        not time it). Histories are exported via :meth:`stats`."""
        self._depth_history.append(self.queue_depth(step))
        self._latency_history.append(float(latency_s))

    def shed(self, rid: int, reason: str) -> None:
        """Overload-evict a pending request (autopilot shedding ladder):
        it fails with ``reason`` and counts in ``stats().shed`` so load
        shedding is distinguishable from deadline/fault failures."""
        if not any(r.rid == rid for r in self._pending):
            raise KeyError(f"rid {rid} is not pending; only queued requests shed")
        self._pending = deque(r for r in self._pending if r.rid != rid)
        self.fail(rid, reason)
        self._shed += 1

    def quarantine(self, slot: int) -> None:
        """Retire a repeatedly-faulting slot: it leaves the free pool and
        is never admitted into again (an occupying request must be
        requeued/failed by the caller first)."""
        self._quarantined.add(slot)
        self._free = [s for s in self._free if s != slot]

    @property
    def quarantined_slots(self) -> frozenset:
        return frozenset(self._quarantined)

    @property
    def servable(self) -> bool:
        """False when pending requests can never run: every slot is
        quarantined (the all-slots-poisoned liveness hazard)."""
        return not self._pending or bool(
            self._free or self._active or self._reserved
        )

    # -- lifecycle ----------------------------------------------------------

    @property
    def pending_rids(self) -> list[int]:
        return [r.rid for r in self._pending]

    @property
    def done(self) -> bool:
        return not self._pending and not self._active

    def next_arrival(self) -> Optional[int]:
        return self._pending[0].arrival_step if self._pending else None

    def stats(self) -> SchedulerStats:
        return SchedulerStats(
            admitted=self._admitted,
            evicted=self._evicted,
            peak_occupancy=self._peak,
            queue_steps=self._queue_steps,
            failed=self._failed,
            requeued=self._requeued,
            quarantined_slots=len(self._quarantined),
            shed=self._shed,
            depth_history=tuple(self._depth_history),
            latency_history=tuple(self._latency_history),
            queue_waits=tuple(self._queue_waits),
        )
