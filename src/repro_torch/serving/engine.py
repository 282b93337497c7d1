"""The SpMV traffic engine: submit → coalesce → one SpMM launch → slice.

Requests are ``y = A @ x`` against matrices resident in a
:class:`MatrixRegistry`.

The engine is event-driven and single-threaded by design — `submit` never
computes, it enqueues and returns a :class:`Ticket`; work happens in
`poll` (flushes batches whose size or deadline policy fired) and `flush`
(drains unconditionally, e.g. at shutdown or when a ticket's result is
demanded).  A caller that wants wall-clock-driven service calls `poll`
from its own loop; tests and benchmarks inject a virtual ``clock`` and get
fully deterministic flush decisions.

Two dispatch modes share that loop:

* **synchronous** (default, ``overlap=False``) — ``_run_batch`` blocks on
  the device result before completing the batch, exactly the historical
  behavior: ``poll()`` returns with every fired batch fully served.
* **overlapped** (``overlap=True``) — ``_run_batch`` only *dispatches*:
  CUDA launches are asynchronous, so the SpMM is queued on the card, a
  ``torch.cuda.Event`` is recorded behind it, the batch parks on an
  in-flight list, and the host goes straight back to coalescing the next
  bucket while the device computes this one.  ``poll`` harvests batches
  whose events report done (``event.query()``) without blocking;
  :meth:`Ticket.result` (via :meth:`flush`) is the only place that blocks
  on the device.  On the CPU the work is done at dispatch and every
  batch is ready at once.

Multi-tenant policy rides the same loop: each matrix key maps to a
:class:`~repro_torch.serving.qos.QoSClass` (deadline, weighted-fair share,
admission-control depth).  Submit sheds with a typed
:class:`~repro_torch.serving.qos.BackpressureError` when a tenant's queue is
saturated, and poll flushes due tenants in weighted-fair order — the
scheduler reads the SLO burn-rate classifications and head-of-line queue
waits, so a paging tenant is boosted and a starving queue breaks ties.

Instrumentation is part of the contract: per matrix the engine counts
requests, batches, k-bucket occupancy and padding, p50/p99 request
latency, per-batch compute seconds, and the admission cost still
unamortized — :meth:`ServingEngine.stats` snapshots all of it.  The
backing store is the registry's shared
:class:`~repro_torch.obs.metrics.MetricRegistry` (one ledger for admission and
traffic; ``stats()`` is a view over it — including the new ``qos.*``
shed/virtual-work state), and with ``repro_torch.obs`` enabled the hot loop
additionally emits flush spans, flush-reason counters, queue-depth gauges
and deadline-miss counts.

Three always-on layers ride the same loop regardless of the obs flag:

* every flush lands in the process **flight recorder** ring, and a
  deadline miss / latency anomaly / queue saturation / load shed triggers
  a Perfetto-loadable post-mortem dump (:mod:`repro_torch.obs.flight`);
* per-flush **attribution counters** (``attr.launches`` /
  ``attr.bytes_modeled`` / ``attr.compute_s``, labeled by matrix,
  strategy and k_tiling) record achieved-vs-modeled bandwidth;
* every completed request feeds the **SLO engine**, and
  :meth:`ServingEngine.health` classifies per-matrix burn rates — the
  same classifications the weighted-fair scheduler consumes
  (:mod:`repro_torch.obs.slo`).
"""
from __future__ import annotations

import time
from collections import deque
from typing import Dict, Iterable, Optional

import numpy as np
import torch

from repro_torch import obs
from repro_torch.kernels.ops import K_BUCKETS, bucket_k, modeled_launch_bytes
from repro_torch.obs.flight import FlightRecorder, get_flight
from repro_torch.obs.requesttrace import RequestContext, RequestLog, get_request_log, new_context
from repro_torch.obs.slo import SLO, SLOEngine, worst_status

from .batcher import MicroBatcher, SpMVRequest
from .qos import BackpressureError, QoSClass, WeightedFairScheduler
from .registry import MatrixRegistry

__all__ = ["Ticket", "ServingEngine"]


class Ticket:
    """Handle to one submitted request; ``result()`` forces completion."""

    __slots__ = ("_engine", "_req")

    def __init__(self, engine: "ServingEngine", req: SpMVRequest):
        """Bind the ticket to its engine and tracked request."""
        self._engine = engine
        self._req = req

    @property
    def req_id(self) -> int:
        """The engine-scoped monotonically increasing request id."""
        return self._req.req_id

    @property
    def trace_id(self) -> Optional[str]:
        """The request's trace id — the join key into exemplars, flight
        dumps and flow events."""
        ctx = self._req.ctx
        return ctx.trace_id if ctx is not None else None

    @property
    def context(self) -> Optional[RequestContext]:
        """The live request context (stamps fill in as the request moves)."""
        return self._req.ctx

    def done(self) -> bool:
        """Whether the request has completed (non-blocking)."""
        return self._req.done

    def result(self) -> np.ndarray:
        """The request's ``y``; drains its matrix's queue if still pending.

        This is the ONE engine call that blocks on device arrays: pending
        submissions for the matrix are dispatched and every in-flight
        batch of the matrix is harvested to completion.
        """
        if not self._req.done:
            self._engine.flush(self._req.key)
        assert self._req.result is not None
        return self._req.result

    def latency_s(self) -> float:
        """Submit-to-complete wall time (raises until completed)."""
        if self._req.t_done is None:
            raise RuntimeError("request not completed yet")
        return self._req.t_done - self._req.t_submit


# latency percentiles are computed over a sliding window of this many most
# recent requests — a long-lived engine must not grow per-request state
_LATENCY_WINDOW = 4096

# burn-rate gauges are refreshed every this many flushed batches (health()
# and evaluate() always compute fresh — this only paces the passive gauges)
_SLO_EVAL_EVERY = 32


class _InFlight:
    """One dispatched-but-unharvested batch (overlap mode)."""

    __slots__ = ("key", "batch", "Y", "event", "k", "reason", "t_dispatch", "t0_wall")

    def __init__(self, key, batch, Y, event, k, reason, t_dispatch, t0_wall):
        """Record the dispatched batch and its launch stamps."""
        self.key = key
        self.batch = batch
        self.Y = Y  # device tensor (or host array in sync mode), NOT copied back
        self.event = event  # CUDA event recorded behind the launch, or None
        self.k = k
        self.reason = reason
        self.t_dispatch = t_dispatch  # engine clock domain
        self.t0_wall = t0_wall  # wall clock, for compute attribution

    def ready(self) -> bool:
        """Whether the batch can be harvested without blocking."""
        return self.event is None or self.event.query()


def _to_host(Y) -> np.ndarray:
    """The batch result as a host array (blocks until the device is done)."""
    return Y.cpu().numpy() if isinstance(Y, torch.Tensor) else np.asarray(Y)


class ServingEngine:
    """Micro-batching SpMV server over a :class:`MatrixRegistry`.

    ``max_batch`` is clamped to the top k-bucket so a drained batch always
    fits one bucketed SpMM launch; ``clock`` supplies "now" for deadlines
    and latency accounting (inject a virtual clock for determinism —
    compute seconds are always wall time regardless).

    ``qos`` maps matrix keys to :class:`~repro_torch.serving.qos.QoSClass`
    deadline classes; unmapped keys get ``default_qos`` (which defaults to
    a per-engine "standard" class whose deadline is ``max_wait_s`` — the
    historical deadline-hit semantics).  The class drives three things:
    the per-request deadline the SLOs account against, the weighted-fair
    flush share under contention, and the admission-control ``max_queue``
    past which :meth:`submit` sheds with a typed
    :class:`~repro_torch.serving.qos.BackpressureError`.

    ``overlap=True`` enables asynchronous dispatch: fired batches are
    queued on the device and harvested when ready instead of blocking the
    poll loop (see the module docstring for the contract).

    ``slos`` declares the objectives :meth:`health` evaluates (default: a
    99% deadline-hit-ratio SLO); ``queue_limit`` is the per-matrix pending
    depth past which the flight recorder snapshots a ``queue_saturation``
    dump (default ``4 * max_batch``); ``flight`` overrides the process
    flight recorder (tests inject their own to isolate dump artifacts).
    """

    def __init__(
        self,
        registry: MatrixRegistry,
        *,
        max_batch: int = K_BUCKETS[-1],
        max_wait_s: float = 0.002,
        buckets: tuple = K_BUCKETS,
        clock=time.perf_counter,
        qos: Optional[Dict[str, QoSClass]] = None,
        default_qos: Optional[QoSClass] = None,
        overlap: bool = False,
        slos: Optional[Iterable[SLO]] = None,
        queue_limit: Optional[int] = None,
        flight: Optional[FlightRecorder] = None,
        request_log: Optional[RequestLog] = None,
    ):
        """Wire the engine over ``registry`` (see class docstring)."""
        if max_batch > buckets[-1]:
            raise ValueError(
                f"max_batch={max_batch} exceeds the top k-bucket {buckets[-1]}"
            )
        self.registry = registry
        self.batcher = MicroBatcher(max_batch=max_batch, max_wait_s=max_wait_s)
        self.buckets = tuple(buckets)
        self.clock = clock
        self.overlap = overlap
        # one ledger with the registry: admission and traffic counters live
        # side by side, and both stats() views read the same store
        self.metrics = registry.metrics
        self.flight = flight if flight is not None else get_flight()
        # completed RequestContexts land here; the process-global log by
        # default so dump()/--requests see every engine's traffic
        self.request_log = request_log if request_log is not None else get_request_log()
        self.queue_limit = (
            queue_limit if queue_limit is not None else 4 * self.batcher.max_batch
        )
        self.qos_map: Dict[str, QoSClass] = dict(qos or {})
        # a zero batching window (flush-immediately engines) still needs a
        # valid positive deadline; 1us preserves the historical semantics
        # under a virtual clock (zero wait is a hit either way)
        self.default_qos = (
            default_qos
            if default_qos is not None
            else QoSClass("standard", deadline_s=max(max_wait_s, 1e-6))
        )
        self.scheduler = WeightedFairScheduler(lambda key: self.qos_of(key).weight)
        # per-key SLO classification from the most recent evaluation —
        # the scheduler's boost input (refreshed every _SLO_EVAL_EVERY
        # batches and on every health() call)
        self._status: Dict[str, str] = {}
        # slo.* gauges ride the shared ledger so dump()/report() see them
        self.slo = SLOEngine(slos, metrics=self.metrics, clock=clock)
        self._inflight: deque = deque()
        self._next_id = 0
        self._batches = 0

    # --- QoS ---------------------------------------------------------------

    def qos_of(self, key: str) -> QoSClass:
        """The deadline class serving ``key`` (``default_qos`` if unmapped)."""
        return self.qos_map.get(key, self.default_qos)

    def set_qos(self, key: str, qos: QoSClass) -> None:
        """Map ``key`` to ``qos`` (takes effect on the next submit/poll)."""
        self.qos_map[key] = qos
        self.batcher.set_wait(key, qos.max_wait_s)

    # --- the serving loop --------------------------------------------------

    def submit(self, key: str, x) -> Ticket:
        """Enqueue ``y = A_key @ x``; returns immediately with a ticket.

        Raises :class:`~repro_torch.serving.qos.BackpressureError` when the
        key's QoS class declares ``max_queue`` and the queue is already
        that deep — the request is shed *before* it holds a queue slot,
        never silently dropped after.
        """
        plan = self.registry.get(key)
        x = np.asarray(x, np.float32)
        if x.shape != (plan.shape[1],):
            raise ValueError(
                f"x has shape {x.shape}, matrix {key!r} expects ({plan.shape[1]},)"
            )
        q = self.qos_of(key)
        depth = self.batcher.pending(key)
        if q.max_queue is not None and depth >= q.max_queue:
            # typed shedding: counted on the always-live ledger, flight-
            # dumped (rate-limited, so the first shed of an overload burst
            # leaves a post-mortem), then surfaced to the caller
            self.metrics.counter("qos.shed", matrix=key, qos=q.name).inc()
            self.flight.trigger(
                "load_shed", matrix=key, qos=q.name, depth=depth, limit=q.max_queue
            )
            raise BackpressureError(key, q.name, depth, q.max_queue)
        if q.max_wait_s is not None:
            self.batcher.set_wait(key, q.max_wait_s)
        t_submit = self.clock()
        # the context is the single per-request allocation this path makes;
        # every later lifecycle stamp is a plain attribute write on it
        req = SpMVRequest(
            key=key,
            x=x,
            req_id=self._next_id,
            t_submit=t_submit,
            ctx=new_context(key, t_submit),
        )
        self._next_id += 1
        self.batcher.add(req)
        req.ctx.t_enqueue = self.clock()
        depth = self.batcher.pending(key)
        if obs.enabled():
            obs.gauge("serving.queue_depth", matrix=key).set(depth)
            # flow start: the submit end of the Perfetto submit→flush arrow
            obs.flow("request", req.ctx.trace_id, "s", matrix=key)
        # always-on saturation watch: an int compare until the queue blows
        # past the limit, then a flight-recorder post-mortem dump
        self.flight.observe_queue_depth(key, depth, self.queue_limit)
        return Ticket(self, req)

    def poll(self, now: Optional[float] = None) -> int:
        """Serve every batch whose policy fired; returns requests completed.

        Due keys flush in weighted-fair order (paging tenants boosted,
        least-served-per-weight first, head-of-line wait breaking ties).
        In overlap mode this call never blocks: batches are dispatched,
        and whatever the device has finished — from this call or earlier
        ones — is harvested and counted.
        """
        now = self.clock() if now is None else now
        served = self._harvest() if self._inflight else 0
        due = self.batcher.due(now)
        for key in self.scheduler.order(
            due,
            head_wait=lambda k: self.batcher.head_age(k, now),
            status=self._status,
        ):
            # a key can owe several full batches after a burst
            while self.batcher.pending(key) >= self.batcher.max_batch:
                served += self._run_batch(key, reason="size")
            if key in self.batcher.due(now):  # deadline still unmet
                served += self._run_batch(key, reason="deadline")
        if self._inflight:
            served += self._harvest()
        return served

    def flush(self, key: Optional[str] = None) -> int:
        """Drain everything pending (for ``key``, or all matrices).

        Blocks until the drained batches (and any earlier in-flight ones
        for the same scope) have completed — this is the blocking edge
        :meth:`Ticket.result` relies on.
        """
        keys = [key] if key is not None else self.batcher.keys_with_pending()
        served = 0
        for k in keys:
            while self.batcher.pending(k):
                served += self._run_batch(k, reason="drain")
        served += self._harvest(block=True, key=key)
        return served

    def _run_batch(self, key: str, *, reason: str = "drain") -> int:
        """Dispatch one batch for ``key``; returns requests completed now.

        Synchronous mode blocks on the device result and completes the
        batch inline (return value = batch size); overlap mode queues the
        launch, parks the batch in flight and returns 0 — completion
        happens at harvest.
        """
        batch = self.batcher.take(key)
        if not batch:
            return 0
        plan = self.registry.get(key)
        t_flush = self.clock()
        for req in batch:
            if req.ctx is not None:
                req.ctx.t_flush_start = t_flush
                req.ctx.flush_reason = reason
        X = MicroBatcher.stack(batch)  # [n, k]
        k = X.shape[1]
        sync_compute_s = None
        with obs.span("serve.flush", matrix=key, reason=reason, k=k):
            t_dispatch = self.clock()
            t0 = time.perf_counter()
            # CUDA launches are asynchronous: this enqueues the SpMM and
            # returns; only copying the result back blocks on the device
            Y = plan.matmat(X, bucketed=True, buckets=self.buckets)
            event = None
            if not self.overlap:
                Y = _to_host(Y)  # block inside the span
                sync_compute_s = time.perf_counter() - t0
            elif Y.is_cuda:
                event = torch.cuda.Event()
                event.record(torch.cuda.current_stream(Y.device))
            if obs.enabled():
                # flow finish inside the span so bp="e" binds the arrow to
                # this flush slice — one arrow per coalesced request
                for req in batch:
                    if req.ctx is not None:
                        obs.flow("request", req.ctx.trace_id, "f", matrix=key)
        # weighted-fair accounting happens at dispatch: the device time is
        # committed now, whether or not the host has harvested it yet
        self.metrics.gauge("qos.vwork", matrix=key).set(
            self.scheduler.charge(key, k)
        )
        infl = _InFlight(key, batch, Y, event, k, reason, t_dispatch, t0)
        if not self.overlap:
            return self._complete(infl, compute_s=sync_compute_s)
        self._inflight.append(infl)
        self.metrics.gauge("serving.inflight").set(len(self._inflight))
        return 0

    def _harvest(
        self, *, block: bool = False, key: Optional[str] = None
    ) -> int:
        """Complete in-flight batches: all ready ones, or (``block=True``)
        every one in scope (``key=None`` means all keys).

        Returns requests completed.  The non-blocking path asks each
        batch's CUDA event whether the device has passed it
        (``event.query()``) — the only poll-loop interaction with
        in-flight results.
        """
        if not self._inflight:
            return 0
        served = 0
        keep: deque = deque()
        for infl in self._inflight:
            in_scope = key is None or infl.key == key
            if in_scope and (block or infl.ready()):
                served += self._complete(infl)
            else:
                keep.append(infl)
        self._inflight = keep
        self.metrics.gauge("serving.inflight").set(len(self._inflight))
        return served

    def _complete(self, infl: _InFlight, *, compute_s: Optional[float] = None) -> int:
        """Materialize one batch's results and run the completion accounting.

        ``compute_s`` is the measured blocking time in synchronous mode;
        in overlap mode it is derived here as dispatch-to-harvest wall
        time (an upper bound on device time — the host may harvest late).
        """
        Y = _to_host(infl.Y)  # blocks iff not ready yet
        if compute_s is None:
            compute_s = time.perf_counter() - infl.t0_wall
        key, batch, reason, k = infl.key, infl.batch, infl.reason, infl.k
        plan = self.registry.get(key)
        done = self.clock()
        trace_ids = [r.ctx.trace_id for r in batch if r.ctx is not None]
        # the flush lands in the always-on flight ring *before* any trigger
        # below fires, so a post-mortem dump contains the offending span
        self.flight.record(
            "serve.flush",
            t0=infl.t0_wall,
            dur_s=compute_s,
            matrix=key,
            reason=reason,
            k=k,
            trace_ids=trace_ids,
        )
        launched_k = bucket_k(k, self.buckets)
        m = self.metrics
        m.counter("serving.requests", matrix=key).inc(len(batch))
        m.counter("serving.batches", matrix=key).inc()
        m.counter("serving.columns", matrix=key).inc(k)
        m.counter("serving.padded_columns", matrix=key).inc(launched_k - k)
        m.counter("serving.compute_s", matrix=key).inc(compute_s)
        # bandwidth attribution: modeled bytes of the launch actually issued
        # (at the padded bucket width) joined with the measured seconds —
        # always live, labeled so attribution_rows() can group the join
        attr_labels = dict(
            # k_tiling is a label of the telemetry schema shared with the JAX package
            matrix=key, strategy=plan.strategy, k_tiling="grid"
        )
        m.counter("attr.launches", **attr_labels).inc()
        m.counter("attr.bytes_modeled", **attr_labels).inc(
            modeled_launch_bytes(plan.device, launched_k, plan.strategy)
        )
        m.counter("attr.compute_s", **attr_labels).inc(compute_s)
        lat = m.histogram("serving.latency_s", window=_LATENCY_WINDOW, matrix=key)
        share = 1.0 / len(batch)
        deadline_s = self.qos_of(key).deadline_s
        misses = 0
        late = []  # trace ids of the requests that burned the deadline
        for j, req in enumerate(batch):
            req.result = Y[:, j]
            req.t_done = done
            wait = done - req.t_submit
            hit = wait <= deadline_s
            if not hit:
                misses += 1
            ctx = req.ctx
            if ctx is not None:
                ctx.t_dispatch = infl.t_dispatch
                ctx.t_complete = done
                ctx.compute_s = compute_s
                ctx.batch_share = share
                ctx.batch_k = k
                ctx.deadline_hit = hit
                # the trace id rides the latency histogram as the bucket
                # exemplar: a p99 outlier bucket names its request
                lat.observe(wait, exemplar=ctx.trace_id)
                self.request_log.complete(ctx)
                if not hit:
                    late.append(ctx.trace_id)
            else:
                lat.observe(wait)
            self.slo.record(key, latency_s=wait, deadline_hit=hit, now=done)
            self.flight.observe_latency(key, wait)
        if misses:
            self.flight.trigger(
                "deadline_miss",
                matrix=key,
                misses=misses,
                flush_reason=reason,
                k=k,
                trace_ids=late,
            )
        self._batches += 1
        if self._batches % _SLO_EVAL_EVERY == 0:
            self._refresh_status(self.slo.evaluate(now=done))
        if obs.enabled():
            obs.counter("serving.flush", matrix=key, reason=reason).inc()
            obs.histogram("serving.batch_k", matrix=key).observe(k)
            obs.gauge("serving.queue_depth", matrix=key).set(
                self.batcher.pending(key)
            )
            if misses:
                obs.counter("serving.deadline_miss", matrix=key).inc(misses)
        return len(batch)

    def _refresh_status(self, evaluation: dict) -> None:
        """Fold an SLO evaluation into the scheduler's per-key status map."""
        self._status = {
            key: worst_status(s["status"] for s in slos.values())
            for key, slos in evaluation.items()
        }

    # --- views -------------------------------------------------------------

    def stats(self) -> dict:
        """Per-matrix traffic snapshot, joined with registry admission data.

        ``occupancy`` is real columns per batch relative to ``max_batch``
        (how full the coalescing window runs); ``pad_fraction`` is the share
        of launched bucket slots that carried padding; latency percentiles
        cover the most recent ``_LATENCY_WINDOW`` requests; ``amortized_
        preprocess_s`` is the one-time admission cost divided by requests
        served so far — the number that justifies the HBP preprocessing
        under serving traffic.  ``qos``/``shed`` report the key's deadline
        class and its admission-control rejections.

        Pure view: every number is read back from the shared
        ``MetricRegistry`` — the engine holds no counter state of its own,
        so this report and :meth:`MatrixRegistry.stats` cannot disagree.
        """
        reg = self.registry.stats()
        m = self.metrics
        out = {}
        for key in {*reg, *m.label_values("serving.requests", "matrix")}:
            requests = int(m.value("serving.requests", matrix=key))
            batches = int(m.value("serving.batches", matrix=key))
            columns = int(m.value("serving.columns", matrix=key))
            padded = int(m.value("serving.padded_columns", matrix=key))
            lat = m.get("serving.latency_s", matrix=key)
            launched = columns + padded
            q = self.qos_of(key)
            out[key] = {
                **reg.get(key, {}),
                "requests": requests,
                "batches": batches,
                "mean_batch_k": columns / max(batches, 1),
                "occupancy": columns / max(batches * self.batcher.max_batch, 1),
                "pad_fraction": padded / max(launched, 1),
                "compute_s": m.value("serving.compute_s", matrix=key),
                "latency_p50_s": lat.percentile(0.50) if lat is not None else None,
                "latency_p99_s": lat.percentile(0.99) if lat is not None else None,
                "amortized_preprocess_s": (
                    reg[key]["preprocess_s"] / requests
                    if key in reg and requests
                    else None
                ),
                "pending": self.batcher.pending(key),
                "qos": q.name,
                "deadline_s": q.deadline_s,
                "shed": int(m.value("qos.shed", matrix=key, qos=q.name)),
            }
        return out

    def inflight(self) -> int:
        """Dispatched-but-unharvested batches (always 0 in sync mode)."""
        return len(self._inflight)

    def health(self, now: Optional[float] = None) -> dict:
        """SLO-based health view — the signal the QoS scheduler consumes.

        Per matrix: the multi-window burn-rate evaluation of every declared
        :class:`~repro_torch.obs.slo.SLO` plus the current queue depth and
        deadline class; overall ``status`` is the worst per-matrix
        classification (``ok`` < ``warn`` < ``page``).  Always fresh —
        this evaluates now, it does not read the passively-refreshed
        gauges — and the refreshed classifications feed the next poll's
        weighted-fair boost.
        """
        now = self.clock() if now is None else now
        evaluation = self.slo.evaluate(now=now)
        self._refresh_status(evaluation)
        matrices = {}
        for key in sorted(evaluation):
            slos = evaluation[key]
            matrices[key] = {
                "status": worst_status(s["status"] for s in slos.values()),
                "slos": slos,
                "queue_depth": self.batcher.pending(key),
                "qos": self.qos_of(key).name,
            }
        return {
            "status": worst_status(m["status"] for m in matrices.values()),
            "matrices": matrices,
        }
