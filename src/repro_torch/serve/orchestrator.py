"""Async serving orchestrator over the three-stage engine API (port of
``repro.serve.orchestrator``).

The engine (:mod:`repro_torch.serve.engine`) is a synchronous slot machine:
``add_requests`` prefills+inserts, ``step`` generates one round for every
active slot.  This module wraps it JetStream-style with the HOST-side
concerns a real serving deployment has, overlapped with device compute on
background threads:

* a **submission queue** with backpressure — a bounded semaphore caps the
  number of requests in flight (queued + decoding); ``submit`` blocks up
  to an admission timeout and returns ``False`` instead of growing the
  queue without bound;
* a **scheduler thread** that drains submissions, groups compatible
  prompts into one bucketed-length prefill batch (``engine.add_requests``
  right-pads to a shared power-of-two bucket), runs the free-slot decode
  loop, requeues pool-dry evictions at the front of the line, and retires
  finished slots;
* a **detokenizer thread** that turns emitted token batches into text and
  fires per-token streaming callbacks, so Python-side string work never
  blocks the next ``generate`` dispatch.

Robustness (the chaos-hardened lifecycle; ``tests/test_torch_chaos.py``):

* **every submitted request reaches a terminal state.**  ``_finish`` is
  idempotent (``_terminal`` flag under a lock), so deadline expiry,
  cancellation, loop crashes and normal completion can race without a
  double release or a stranded waiter;
* **deadlines + cancellation** — ``StreamingRequest.deadline_s`` (or the
  config-wide ``deadline_s``) expires a request relative to its submit
  stamp with terminal ``error="deadline"``; ``StreamingRequest.cancel()``
  is honored mid-decode with ``error="cancelled"``.  Both paths abort the
  engine side first (slot + pages reclaimed) on the scheduler thread;
* **crash containment** — a scheduler- or detokenizer-loop death fails
  every queued and in-flight request with an error, reclaims engine
  slots/pages, flips ``healthy`` to False (``submit`` then raises), and
  records the first worker exception, which ``__exit__`` re-raises and
  ``health()`` reports;
* a **watchdog thread** (``watchdog_s``) fails in-flight requests when
  the scheduler makes no progress for that long with work in flight —
  a stuck ``generate`` round degrades to fast errors instead of hangs;
* ``close`` raises on leaked (still-alive) worker threads instead of
  silently returning, and finishes any stragglers once both loops are
  down.

Fault injection (:mod:`repro_torch.serve.faults`) hooks the scheduler tick,
tokenize and detokenize paths here (``sched_crash`` / ``tokenize_crash``
/ ``detok_crash``); the injector is shared with the engine
(``engine.faults``).  All hooks are ``is not None`` checks — disabled
costs nothing.

Tokenisation is pluggable (``tokenize``/``detokenize`` callables); the
default is a byte-level codec clipped to the model vocab, which is enough
for the synthetic-data models this repo trains.  Timing is recorded
host-side per emission (`submit`/first-token/finish ``perf_counter``
stamps — monotonic and comparable across threads), so the serving
benchmark can derive TTFT and inter-token latency percentiles without
touching the engine.

Telemetry rides the engine's :class:`repro_torch.obs.MetricsRegistry`
under the ``orch.`` prefix (``orch.submitted`` / ``finished`` /
``rejected`` / ``admission_timeouts`` / ``cancelled`` /
``deadline_expired`` / ``watchdog_fired`` / ``loop_crashes`` counters,
``orch.queue_depth`` gauge) and the engine's tracer: scheduler-loop segments get host spans
(``orch.pull``, ``orch.admit``, ``orch.step``, ``orch.retire``,
``orch.reap``, ``orch.idle``) and the detokenizer thread gets
``cat="detok"`` spans, which the stage-breakdown report counts as
concurrent rather than wall-clock.

Threading contract: the engine is only ever touched from the scheduler
thread (on the card: every stage, and so every kernel launch, is issued
from it; the watchdog and detokenizer issue no CUDA work);
``submit``/``wait``/``cancel``/``health`` are safe from any thread.  Build
the engine before the orchestrator: its constructor loads the kernel
libraries, so no first ``nvcc`` build runs under the watchdog.
Callbacks run on the detokenizer thread and must not call back into the
orchestrator (except ``submit``).
"""
from __future__ import annotations

import dataclasses
import json
import queue
import threading
import time
from collections import deque
from typing import Any, Callable, Dict, List, Optional, Sequence, Union

import numpy as np

from ..obs import StatsView
from .engine import Request, ServingEngine

__all__ = ["OrchestratorConfig", "StreamingRequest", "Orchestrator"]


@dataclasses.dataclass
class OrchestratorConfig:
    """Host-side serving knobs (the device-side ones live in ServeConfig).

    max_queue: backpressure cap on requests in flight (queued + active).
    admission_timeout_s: default ``submit`` blocking time once the queue
        is full; ``submit`` returns False on expiry instead of enqueueing.
    batch_window_s: how long the scheduler lingers after the first
        pending prompt to coalesce more arrivals into one bucketed
        prefill batch (0 = admit immediately).
    poll_interval_s: scheduler sleep when there is nothing to do.
    detokenize: decode emitted tokens to text on the detokenizer thread
        (False streams token ids only; text fields stay empty).
    deadline_s: default per-request deadline, measured from the submit
        stamp; on expiry the request terminates with ``error="deadline"``
        and its slot + pages are reclaimed.  A request's own
        ``deadline_s`` overrides this; None disables.
    watchdog_s: arm a watchdog thread that fails all in-flight requests
        (``error`` mentioning the watchdog, orchestrator marked
        unhealthy) when the scheduler completes no iteration for this
        long while work is in flight.  None disables.
    ttft_slo_s / itl_slo_s: latency SLO thresholds.  When set, every
        finished request's TTFT (and every inter-token gap) is checked
        against them and ``orch.slo.ttft_violations`` /
        ``orch.slo.itl_violations`` counters tick next to the matching
        ``*_total`` denominators.
    request_log: path of a JSONL file appended one line per terminal
        request (finished or rejected): uid, token count, error, TTFT
        and the full lifecycle decomposition (queue wait / prefill /
        insert / decode seconds from the engine's per-request stamps).
    """
    max_queue: int = 64
    admission_timeout_s: float = float("inf")
    batch_window_s: float = 0.0
    poll_interval_s: float = 0.001
    detokenize: bool = True
    deadline_s: Optional[float] = None
    watchdog_s: Optional[float] = None
    ttft_slo_s: Optional[float] = None
    itl_slo_s: Optional[float] = None
    request_log: Optional[str] = None


@dataclasses.dataclass(eq=False)
class StreamingRequest:
    """One streaming generation request.

    ``prompt`` may be text (tokenized host-side) or a token-id sequence.
    ``on_token(sreq, token_ids, text_piece)`` fires on the detokenizer
    thread once per emission batch — batches hold >1 token under
    speculative decoding because accepted drafts commit together.
    ``deadline_s`` (submit-relative) and :meth:`cancel` terminate the
    stream early with ``error="deadline"`` / ``"cancelled"``.
    """
    prompt: Union[str, Sequence[int]]
    max_new: int = 32
    temperature: Optional[float] = None   # None inherits ServeConfig's
    on_token: Optional[Callable[["StreamingRequest", List[int], str], None]] = None
    deadline_s: Optional[float] = None    # None inherits the config's

    # outputs / telemetry (filled in by the orchestrator)
    out_tokens: List[int] = dataclasses.field(default_factory=list)
    out_text: str = ""
    error: Optional[str] = None
    submit_t: float = 0.0
    token_t: List[float] = dataclasses.field(default_factory=list)
    finish_t: float = 0.0
    _req: Optional[Request] = dataclasses.field(default=None, repr=False)
    _done: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    _cancel: threading.Event = dataclasses.field(
        default_factory=threading.Event, repr=False)
    # terminal-once flag; only _finish flips it (under the orchestrator's
    # terminal lock), making every terminal path idempotent
    _terminal: bool = dataclasses.field(default=False, repr=False)

    def wait(self, timeout: Optional[float] = None) -> bool:
        """Block until the stream finishes; True if it did."""
        return self._done.wait(timeout)

    def cancel(self) -> None:
        """Request cooperative cancellation: the scheduler aborts the
        stream at its next tick (terminal ``error="cancelled"``, slot
        and pages reclaimed).  Safe from any thread, no-op once the
        stream is already terminal."""
        self._cancel.set()

    @property
    def cancelled(self) -> bool:
        return self._cancel.is_set()

    @property
    def done(self) -> bool:
        return self._done.is_set()

    @property
    def ttft_s(self) -> Optional[float]:
        """Submit-to-first-token latency, once at least one token landed."""
        return self.token_t[0] - self.submit_t if self.token_t else None

    def itl_s(self) -> List[float]:
        """Inter-token gaps (speculative batches share one stamp → 0s)."""
        return [b - a for a, b in zip(self.token_t, self.token_t[1:])]

    def lifecycle(self) -> Dict[str, float]:
        """The engine's per-request ``perf_counter`` stamps, in lifecycle
        order (submit → admit → prefill_done → insert_done → first_token
        → finish).  Rejected requests carry only submit + finish; keys a
        request never reached are absent.  Requests that never got an
        engine-side Request (e.g. failed before tokenization) still
        carry the orchestrator's own submit/finish stamps — every
        terminal path has both."""
        timing = dict(self._req.timing) if self._req is not None else {}
        if self.submit_t:
            timing.setdefault("submit", self.submit_t)
        if self.finish_t:
            timing.setdefault("finish", self.finish_t)
        order = ("submit", "admit", "prefill_done", "insert_done",
                 "first_token", "finish")
        return {k: timing[k] for k in order if k in timing}

    def lifecycle_deltas(self) -> Dict[str, float]:
        """TTFT decomposition in seconds relative to submit: queue wait
        (submit→admit), prefill (admit→prefill_done), insert
        (prefill_done→insert_done plus first-token sampling up to
        first_token), decode (first_token→finish), total."""
        t = self.lifecycle()
        out: Dict[str, float] = {}
        if "admit" in t:
            out["queue_wait_s"] = t["admit"] - t["submit"]
        if "prefill_done" in t and "admit" in t:
            out["prefill_s"] = t["prefill_done"] - t["admit"]
        if "insert_done" in t and "prefill_done" in t:
            out["insert_s"] = t["insert_done"] - t["prefill_done"]
        if "first_token" in t:
            out["ttft_s"] = t["first_token"] - t["submit"]
        if "finish" in t:
            out["total_s"] = t["finish"] - t["submit"]
            if "first_token" in t:
                out["decode_s"] = t["finish"] - t["first_token"]
        return out


def _default_tokenize(vocab: int) -> Callable[[str], List[int]]:
    def tok(text: str) -> List[int]:
        return [min(b, vocab - 1) for b in text.encode("utf-8")]
    return tok


def _default_detokenize(vocab: int) -> Callable[[List[int]], str]:
    del vocab
    def detok(toks: List[int]) -> str:
        return bytes(t % 256 for t in toks).decode("utf-8", errors="replace")
    return detok


class Orchestrator:
    """Threaded request orchestrator over a ServingEngine.

    Usage::

        with Orchestrator(engine) as orch:
            sreq = StreamingRequest("hello", max_new=16,
                                    on_token=lambda r, ids, s: print(s))
            assert orch.submit(sreq)
            sreq.wait()

    ``__exit__`` re-raises the first worker-thread exception (as the
    cause of a RuntimeError) if a loop crashed during the block."""

    def __init__(self, engine: ServingEngine,
                 ocfg: OrchestratorConfig = OrchestratorConfig(), *,
                 tokenize: Optional[Callable[[str], List[int]]] = None,
                 detokenize: Optional[Callable[[List[int]], str]] = None):
        if ocfg.max_queue < 1:
            raise ValueError(f"max_queue must be >= 1, got {ocfg.max_queue}")
        self.engine = engine
        self.ocfg = ocfg
        vocab = engine.cfg.vocab
        self.tokenize = tokenize or _default_tokenize(vocab)
        self.detokenize = detokenize or _default_detokenize(vocab)
        # fault-injection hooks for the orchestrator's own sites
        # (sched/tokenize/detok) share the engine's injector
        self.faults = getattr(engine, "faults", None)

        self._slots = threading.BoundedSemaphore(ocfg.max_queue)
        self._submitted: "queue.Queue[StreamingRequest]" = queue.Queue()
        self._stream_q: "queue.Queue[tuple]" = queue.Queue()
        self._by_req: Dict[int, StreamingRequest] = {}  # id(Request) -> sreq
        self._pending: deque = deque()     # scheduler thread only
        self._closed = False
        self._uid = 0
        self._stop = threading.Event()
        # ---- robustness state ----
        self._healthy = True
        self._fail_reason: Optional[str] = None
        self._worker_exc: Optional[BaseException] = None
        self._term_lock = threading.Lock()   # _terminal + _worker_exc
        self._detok_gate = threading.Lock()  # _detok_dead + "done" enqueue
        self._detok_dead = False
        self._beat = time.perf_counter()     # scheduler progress heartbeat
        self.tracer = engine.tracer
        self.metrics = engine.metrics
        self.stats = StatsView(self.metrics, prefix="orch.")
        self.stats.bind_counters("submitted", "finished", "rejected",
                                 "admission_timeouts", "cancelled",
                                 "deadline_expired", "watchdog_fired",
                                 "loop_crashes")
        self._queue_depth = self.metrics.gauge("orch.queue_depth")
        # lifecycle latency distributions + SLO accounting (scheduler
        # thread only; Histogram.observe is locked anyway)
        self._h_ttft = self.metrics.histogram("orch.ttft_s")
        self._h_itl = self.metrics.histogram("orch.itl_s")
        self._h_qwait = self.metrics.histogram("orch.queue_wait_s")
        self._slo = {k: self.metrics.counter(f"orch.slo.{k}")
                     for k in ("ttft_total", "ttft_violations",
                               "itl_total", "itl_violations")}
        self._reqlog = (open(ocfg.request_log, "a")
                        if ocfg.request_log else None)
        self._reqlog_lock = threading.Lock()

        engine.on_emit = self._on_emit       # runs on the scheduler thread
        self._sched = threading.Thread(target=self._scheduler_loop,
                                       name="orch-scheduler", daemon=True)
        self._detok = threading.Thread(target=self._detok_loop,
                                       name="orch-detok", daemon=True)
        self._wd: Optional[threading.Thread] = None
        self._wd_stop = threading.Event()
        self._sched.start()
        self._detok.start()
        if ocfg.watchdog_s is not None:
            self._wd = threading.Thread(target=self._watchdog_loop,
                                        name="orch-watchdog", daemon=True)
            self._wd.start()

    # ---- submission side (any thread) ----
    def submit(self, sreq: StreamingRequest,
               timeout: Optional[float] = None) -> bool:
        """Enqueue a request; False if backpressure held past ``timeout``
        (default: the config admission timeout).  Raises once the
        orchestrator is closed or unhealthy (a worker loop died)."""
        if self._closed:
            raise RuntimeError("orchestrator is closed")
        if not self._healthy:
            raise RuntimeError(
                f"orchestrator is unhealthy: {self._fail_reason}")
        if timeout is None:
            timeout = self.ocfg.admission_timeout_s
        blocking = timeout > 0
        if not self._slots.acquire(
                blocking,
                None if timeout == float("inf") or not blocking else timeout):
            self.stats["admission_timeouts"] += 1
            return False
        sreq.submit_t = time.perf_counter()
        self.stats["submitted"] += 1
        self._submitted.put(sreq)
        self._queue_depth.set(self._submitted.qsize())
        return True

    # ---- health (any thread) ----
    @property
    def healthy(self) -> bool:
        """False once a worker loop died or the watchdog fired."""
        return self._healthy

    @property
    def worker_exc(self) -> Optional[BaseException]:
        """First exception that killed a worker loop (None = none yet)."""
        return self._worker_exc

    def health(self) -> Dict[str, Any]:
        """Point-in-time health snapshot (thread-safe, JSON-friendly):
        liveness flags, the first failure, thread liveness, in-flight
        depth, engine slot/page occupancy and the robustness counters
        (``orch.*`` / ``faults.*`` / ``guard.*`` / stage retries).
        Surfaced by ``launch/serve.py --health``."""
        c = self.metrics.snapshot()["counters"]
        keep = ("orch.", "faults.", "guard.")
        threads = {t.name: t.is_alive()
                   for t in (self._sched, self._detok, self._wd)
                   if t is not None}
        alloc = getattr(self.engine, "allocator", None)
        return {
            "healthy": self._healthy,
            "closed": self._closed,
            "error": self._fail_reason,
            "worker_exc": (repr(self._worker_exc)
                           if self._worker_exc is not None else None),
            "threads": threads,
            "in_flight": len(self._by_req) + self._submitted.qsize(),
            "engine": {
                "free_slots": self.engine.free_slots(),
                "live_pages": (alloc.live_pages
                               if alloc is not None else None)},
            "counters": {k: v for k, v in sorted(c.items())
                         if k.startswith(keep)
                         or k == "stage.retries"
                         or k == "stage.retry_exhausted"},
        }

    # ---- scheduler thread ----
    def _on_emit(self, req: Request, toks: List[int]) -> None:
        sreq = self._by_req.get(id(req))
        if sreq is None:
            return
        now = time.perf_counter()
        sreq.token_t.extend([now] * len(toks))
        self._stream_q.put(("toks", sreq, list(toks)))

    def _finish(self, sreq: StreamingRequest, error: Optional[str] = None):
        """Terminal transition for one stream.  Idempotent — the first
        caller wins (normal retire, deadline/cancel reap, crash
        containment and close-time backstop may race); every path ends
        with ``_done`` set and the backpressure slot released."""
        with self._term_lock:
            if sreq._terminal:
                return
            sreq._terminal = True
        sreq.error = error
        sreq.finish_t = time.perf_counter()
        if sreq._req is not None:
            # rejects the orchestrator filters itself never reach the
            # engine's stamping paths; backfill the terminal stamps so
            # every terminal request has submit+finish
            sreq._req.timing.setdefault("submit", sreq.submit_t)
            sreq._req.timing.setdefault("finish", sreq.finish_t)
        self._observe_slo(sreq)
        self.stats["rejected" if error else "finished"] += 1
        with self._detok_gate:
            if self._detok_dead:
                # the detokenizer is gone: resolve the waiter directly
                # instead of enqueueing for a dead consumer
                sreq._done.set()
            else:
                self._stream_q.put(("done", sreq))
        self._slots.release()

    def _observe_slo(self, sreq: StreamingRequest) -> None:
        """Latency histograms + SLO violation counters for one terminal
        request."""
        d = sreq.lifecycle_deltas()
        if "queue_wait_s" in d:
            self._h_qwait.observe(d["queue_wait_s"])
        ttft = sreq.ttft_s
        if ttft is not None:
            self._h_ttft.observe(ttft)
            if self.ocfg.ttft_slo_s is not None:
                self._slo["ttft_total"].inc()
                if ttft > self.ocfg.ttft_slo_s:
                    self._slo["ttft_violations"].inc()
        for gap in sreq.itl_s():
            self._h_itl.observe(gap)
            if self.ocfg.itl_slo_s is not None:
                self._slo["itl_total"].inc()
                if gap > self.ocfg.itl_slo_s:
                    self._slo["itl_violations"].inc()

    def _record_worker_exc(self, exc: BaseException) -> None:
        with self._term_lock:
            if self._worker_exc is None:
                self._worker_exc = exc

    def _contain(self, reason: str, *, engine_safe: bool) -> None:
        """Crash containment: mark the orchestrator unhealthy and finish
        EVERY queued or in-flight request with ``reason`` — no stream is
        ever stranded behind a dead loop.  ``engine_safe`` means we are
        on the scheduler thread (the only thread allowed to touch the
        engine), so slots/pages are reclaimed too; other threads leave
        engine cleanup to the scheduler, which runs containment again on
        its next iteration when it observes ``healthy == False``."""
        self._healthy = False
        if self._fail_reason is None:
            self._fail_reason = reason
        if engine_safe:
            eng = self.engine
            try:
                for r in list(eng._evicted):
                    eng.abort(r, error=reason)
                for r in list(eng.slot_req):
                    if r is not None:
                        eng.abort(r, error=reason)
            except Exception:
                # a corrupted engine must not block failing the streams
                pass
        while True:
            try:
                sreq = self._submitted.get_nowait()
            except queue.Empty:
                break
            self._finish(sreq, error=reason)
        for sreq in list(self._by_req.values()):
            self._finish(sreq, error=sreq.error or reason)
        if engine_safe:
            self._by_req.clear()
            self._pending.clear()
        self._queue_depth.set(0)

    def _scheduler_loop(self) -> None:
        try:
            self._scheduler_body()
        except BaseException as e:  # containment must see everything
            self._record_worker_exc(e)
            self.stats["loop_crashes"] += 1
            self._contain(f"scheduler loop crashed: {e!r}",
                          engine_safe=True)
        finally:
            # graceful exit and crash exit both stop the detokenizer
            self._stream_q.put(("stop",))

    def _scheduler_body(self) -> None:
        eng, ocfg, tracer = self.engine, self.ocfg, self.tracer
        pending = self._pending
        while True:
            self._beat = time.perf_counter()
            if not self._healthy:
                # another thread (watchdog / detokenizer) initiated
                # containment; do the engine-side half here and exit
                self._contain(self._fail_reason or "orchestrator unhealthy",
                              engine_safe=True)
                return
            if self.faults is not None:
                self.faults.on_sched()
            # pull new submissions; filter out the never-admissible
            fresh = False
            with tracer.span("orch.pull"):
                while True:
                    try:
                        sreq = self._submitted.get_nowait()
                    except queue.Empty:
                        break
                    try:
                        sreq._req = self._to_engine_request(sreq)
                    except BaseException as e:
                        # the popped request is in neither queue nor
                        # _by_req — finish it before containment runs,
                        # or it would be the one stream left stranded
                        self._finish(sreq, error=f"tokenize failed: {e!r}")
                        raise
                    reject = eng._reject_reason(sreq._req)
                    if reject is not None:
                        self._finish(sreq, error=reject)
                        continue
                    self._by_req[id(sreq._req)] = sreq
                    pending.append(sreq)
                    fresh = True
                # pool-dry evictions resume at the head of the line
                if eng._evicted:
                    evicted, eng._evicted = eng._evicted, []
                    for r in reversed(evicted):
                        pending.appendleft(self._by_req[id(r)])
                self._queue_depth.set(len(pending))
            # cancellations + expired deadlines before spending a tick
            self._reap()
            if fresh and ocfg.batch_window_s > 0 and eng.free_slots():
                with tracer.span("orch.idle", kind="batch_window"):
                    time.sleep(ocfg.batch_window_s)   # coalesce one batch
                continue
            # bucketed admission: one shared-bucket prefill per batch
            if pending and eng.free_slots():
                with tracer.span("orch.admit", n=len(pending)):
                    batch = [pending.popleft() for _ in
                             range(min(len(pending), eng.free_slots()))]
                    ok = eng.add_requests([s._req for s in batch])
                    failed = [s for s, admitted in zip(batch, ok)
                              if not admitted]
                    for s in reversed(failed):   # infeasible right now:
                        pending.appendleft(s)    # retry in FIFO order
                self._queue_depth.set(len(pending))
            active = any(r is not None for r in eng.slot_req)
            if active:
                with tracer.span("orch.step"):
                    eng.step()
            # retire finished requests (admission can finish prompt-only
            # requests too, so scan the full map)
            with tracer.span("orch.retire"):
                done_ids = [rid for rid, s in self._by_req.items()
                            if s._req.done and s not in pending]
                for rid in done_ids:
                    s = self._by_req.pop(rid)
                    self._finish(s, error=s._req.error)
            if self._stop.is_set() and not pending and not active \
                    and self._submitted.empty() and not eng._evicted:
                return
            if not active and not pending:
                with tracer.span("orch.idle", kind="poll"):
                    time.sleep(ocfg.poll_interval_s)

    def _reap(self) -> None:
        """Terminate cancelled and deadline-expired requests (scheduler
        thread): abort the engine side first — slot and pages reclaimed —
        then finish with the terminal error."""
        now = time.perf_counter()
        doomed = []
        for sreq in list(self._by_req.values()):
            if sreq._terminal:
                continue
            if sreq._cancel.is_set():
                doomed.append((sreq, "cancelled"))
                continue
            dl = (sreq.deadline_s if sreq.deadline_s is not None
                  else self.ocfg.deadline_s)
            if dl is not None and now - sreq.submit_t > dl:
                doomed.append((sreq, "deadline"))
        if not doomed:
            return
        with self.tracer.span("orch.reap", n=len(doomed)):
            for sreq, err in doomed:
                if sreq in self._pending:
                    self._pending.remove(sreq)
                self._by_req.pop(id(sreq._req), None)
                self.engine.abort(sreq._req, error=err)
                self._finish(sreq, error=err)
                self.stats["cancelled" if err == "cancelled"
                           else "deadline_expired"] += 1

    def _to_engine_request(self, sreq: StreamingRequest) -> Request:
        if self.faults is not None:
            self.faults.on_tokenize()
        toks = (self.tokenize(sreq.prompt)
                if isinstance(sreq.prompt, str) else
                [int(t) for t in sreq.prompt])
        self._uid += 1
        req = Request(uid=self._uid, prompt=np.asarray(toks, np.int32),
                      max_new=sreq.max_new, temperature=sreq.temperature)
        # the engine's lifecycle stamps start from the true submission
        # time, not the scheduler pull time, so queue wait is end-to-end
        req.timing["submit"] = sreq.submit_t
        return req

    # ---- watchdog thread ----
    def _watchdog_loop(self) -> None:
        wd = self.ocfg.watchdog_s
        tick = max(min(wd / 4.0, 0.25), 0.005)
        while not self._wd_stop.wait(tick):
            busy = bool(self._by_req) or not self._submitted.empty()
            stale = time.perf_counter() - self._beat
            if busy and stale > wd and self._healthy:
                self.stats["watchdog_fired"] += 1
                msg = (f"watchdog: scheduler made no progress for "
                       f"{stale:.2f}s (> {wd}s) with work in flight")
                self._record_worker_exc(RuntimeError(msg))
                # fail the waiters NOW; the scheduler (if it ever
                # recovers) sees unhealthy and reclaims the engine side
                self._contain(msg, engine_safe=False)
                return

    # ---- detokenizer thread ----
    def _detok_loop(self) -> None:
        try:
            self._detok_body()
        except BaseException as e:
            self._record_worker_exc(e)
            self.stats["loop_crashes"] += 1
            with self._detok_gate:
                # flag first, then drain: under the gate no "done" can be
                # enqueued concurrently, and every later _finish resolves
                # its waiter directly
                self._detok_dead = True
                while True:
                    try:
                        item = self._stream_q.get_nowait()
                    except queue.Empty:
                        break
                    if item[0] == "done":
                        item[1]._done.set()
            self._contain(f"detokenizer loop crashed: {e!r}",
                          engine_safe=False)

    def _detok_body(self) -> None:
        while True:
            item = self._stream_q.get()
            if item[0] == "stop":
                return
            if item[0] == "done":
                # log BEFORE _done.set(): close() joins this thread, so a
                # waiter that saw done=True is guaranteed a flushed line
                if self._reqlog is not None:
                    self._write_reqlog(item[1])
                item[1]._done.set()
                continue
            _, sreq, toks = item
            if self.faults is not None:
                self.faults.on_detok()
            # cat="detok" → the breakdown report counts this thread's work
            # as concurrent with the scheduler, not extra wall time
            with self.tracer.span("orch.detok", cat="detok", n=len(toks)):
                sreq.out_tokens.extend(toks)
                piece = ""
                if self.ocfg.detokenize:
                    piece = self.detokenize(toks)
                    sreq.out_text += piece
                if sreq.on_token is not None:
                    sreq.on_token(sreq, toks, piece)

    def _write_reqlog(self, sreq: StreamingRequest) -> None:
        """One JSONL line per terminal request (detokenizer thread)."""
        uid = sreq._req.uid if sreq._req is not None else None
        rec = {"uid": uid,
               "error": sreq.error,
               "n_prompt": (len(sreq._req.prompt)
                            if sreq._req is not None else None),
               "n_tokens": len(sreq._req.out_tokens)
               if sreq._req is not None else 0,
               "ttft_s": sreq.ttft_s,
               "lifecycle": sreq.lifecycle(),
               "deltas": sreq.lifecycle_deltas()}
        line = json.dumps(rec) + "\n"
        with self._reqlog_lock:
            self._reqlog.write(line)
            self._reqlog.flush()

    # ---- lifecycle ----
    def close(self, timeout: Optional[float] = 60.0) -> None:
        """Drain in-flight work, then stop all worker threads.

        Raises RuntimeError if a worker thread is still alive after
        ``timeout`` — a leaked thread means a stuck scheduler or
        detokenizer, and silently returning used to mask exactly that.
        Once both loops are down, any straggler requests (submitted
        around the stop, or stranded by a crash) are finished with an
        error so no waiter hangs."""
        if self._closed:
            return
        self._closed = True
        self._stop.set()
        self._sched.join(timeout)
        self._detok.join(timeout)
        self._wd_stop.set()
        if self._wd is not None:
            self._wd.join(timeout)
        leaked = [t.name for t in (self._sched, self._detok)
                  if t.is_alive()]
        if not leaked:
            with self._detok_gate:
                self._detok_dead = True   # finish() resolves waiters now
            err = self._fail_reason or "orchestrator closed"
            while True:
                try:
                    sreq = self._submitted.get_nowait()
                except queue.Empty:
                    break
                self._finish(sreq, error=err)
            for sreq in list(self._by_req.values()):
                self._finish(sreq, error=sreq.error or err)
            self._by_req.clear()
        if self._reqlog is not None:
            with self._reqlog_lock:
                self._reqlog.close()
        if leaked:
            raise RuntimeError(
                f"orchestrator close(timeout={timeout}) leaked threads: "
                f"{leaked} — scheduler or detokenizer failed to stop")

    def __enter__(self) -> "Orchestrator":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
        if exc_type is None and self._worker_exc is not None:
            raise RuntimeError(
                f"orchestrator worker crashed: {self._fail_reason}"
            ) from self._worker_exc
