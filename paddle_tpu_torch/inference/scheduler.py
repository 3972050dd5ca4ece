"""Overload-robust scheduling for the continuous-batching serving path.
Counterpart of paddle_tpu/inference/scheduler.py.

The policy below is the reference's, whole: the session's
``prefill_chunk=``, ``preempt()`` and ``kv_pool_bytes=`` and
``Request(priority=, deadline_s=)`` drive it as they drive the JAX
package's.

The r4-r6 serving tier admits or queues forever: no bound on prefill
work per step, no deadlines, no cancellation, no way to reclaim pool
blocks from a running request. One burst of long prompts spikes TPOT
for every live stream, and pool exhaustion turns into unbounded
queueing. This module is the policy layer that makes overload a
graceful, observable regime (the vLLM scheduler design, sitting on the
PR 4 block registry that already supplies ref counts, CoW and LRU
cache-on-free):

- **chunked prefill** — a per-step cap on prefill tokens
  (``prefill_chunk``): long prompts admit as a sequence of bounded
  chunks interleaved with the live slots' decode tokens in the SAME
  mixed admit dispatch, so decode TPOT stays flat while a long prompt
  streams in. The chunks reuse the existing power-of-two admit-width
  ladder — no new executables, just narrower ones more often. Only the
  FINAL chunk's sampled token enters the stream (earlier chunks' logits
  are positioned mid-prompt), which keeps greedy streams byte-identical
  chunking on or off.

- **preempt-and-requeue** — under pool pressure a victim (lowest
  priority, then most recently admitted) is evicted: its blocks go back
  to the pool (shared prefix blocks just deref; cache-on-free retains
  its registered prompt hashes), and the request returns to the waiting
  queue carrying the tokens it already emitted. Re-admission prefills
  the request's full committed history (prompt + emitted tokens) as an
  ordinary — typically chunked — admission, hitting the prefix cache
  for whatever survived, so a preempted greedy stream is byte-identical
  to an unpreempted one.

- **deadlines / priorities / cancellation** —
  ``Request(priority=, deadline_s=)`` and ``session.cancel(req_id)``.
  Expired and cancelled requests release their blocks immediately and
  terminate with a typed status + event; a bounded waiting queue
  (``max_waiting`` / env ``PADDLE_SERVING_MAX_WAITING``) turns queue
  overflow into a typed :class:`AdmissionRejected` at submit instead of
  unbounded growth.

The split of labor: this class owns the *policy* (queue order, victim
choice, per-step chunk plan, terminal-state bookkeeping); the session
owns the *mechanism* (device dispatches, block tables, pool calls).
Scheduler state is registered with the flight recorder so post-mortem
dumps show exactly what the scheduler was doing at the kill instant.
"""
from __future__ import annotations

import os
import time
from typing import Optional

from ..analysis.sanitizers import race_handoff, race_track

__all__ = ["Scheduler", "InvalidRequest", "AdmissionRejected",
           "TERMINAL_STATUSES"]

#: statuses a request can never leave.
TERMINAL_STATUSES = ("done", "cancelled", "expired", "rejected")


class InvalidRequest(ValueError):
    """A request that can never be served: empty prompt,
    ``max_new_tokens <= 0``, prompt longer than the session's
    ``max_prompt_len``, or a KV footprint exceeding the whole pool.
    Subclasses ValueError so pre-r13 callers' handlers keep working."""


class AdmissionRejected(RuntimeError):
    """A valid request refused for CAPACITY: the bounded waiting queue
    is full. Retryable by the caller — unlike :class:`InvalidRequest`,
    nothing is wrong with the request itself."""


@race_track
class Scheduler:
    """Queue + admission policy driving one ContinuousBatchingSession.

    Single-threaded with the session's step loop, except ``cancel()``
    which may be called from any thread: cancellations land in a
    pending set drained at the next step boundary (immediately when no
    step is in flight)."""

    def __init__(self, session, prefill_chunk: Optional[int] = None,
                 max_waiting: Optional[int] = None,
                 preemption: bool = True):
        self.session = session
        if max_waiting is None:
            env = os.environ.get("PADDLE_SERVING_MAX_WAITING", "")
            max_waiting = int(env) if env.strip() else None
        self.max_waiting = max_waiting
        cap = session.max_prompt_len
        # the per-step prefill-token budget; None = unlimited per
        # request, but chunking machinery stays active regardless: a
        # preempted request's re-prefill (prompt + emitted tokens) can
        # exceed max_prompt_len, where the admit-width ladder tops out
        self.prefill_chunk = (min(int(prefill_chunk), cap)
                              if prefill_chunk else None)
        if prefill_chunk is not None and int(prefill_chunk) < 1:
            raise ValueError("prefill_chunk must be >= 1")
        self.preemption = bool(preemption)
        self.waiting = []           # Requests; sorted at each plan
        self._submit_seq = 0        # FIFO tiebreak within a priority
        self._admit_seq = 0         # victim choice: most recent first
        self._cancel_pending = set()
        self._in_step = False
        # host counters (mirrored into the metrics registry when
        # observability is on; the stats view reads these)
        self.preemptions = 0
        self.expirations = 0
        self.cancellations = 0
        self.rejections = 0
        self._register_with_flight_recorder()

    # -- submit / cancel ---------------------------------------------------
    def submit(self, req):
        """Validate + enqueue. Raises :class:`InvalidRequest` for
        requests that can never be served and :class:`AdmissionRejected`
        when the bounded waiting queue is full."""
        sess = self.session
        plen = len(req.prompt)
        if plen == 0:
            raise InvalidRequest(
                "empty prompt: prompt length must be >= 1")
        if plen > sess.max_prompt_len:
            raise InvalidRequest(
                f"prompt length {plen} outside this session's "
                f"[1, {sess.max_prompt_len}]")
        if req.max_new_tokens < 1:
            raise InvalidRequest("max_new_tokens must be >= 1")
        if plen + req.max_new_tokens > sess.max_cached:
            # past per-slot KV capacity the paged scatter drops writes
            # and decode would silently sample from a truncated window
            raise InvalidRequest(
                f"prompt + max_new_tokens = "
                f"{plen + req.max_new_tokens} exceeds the model's "
                f"max_seq_len {sess.max_cached}")
        bs = sess._kv_block_size
        need = -(-(plen + req.max_new_tokens) // bs)
        if need > sess._num_blocks:
            # would starve forever: even an empty pool cannot hold it
            raise InvalidRequest(
                f"request needs {need} KV blocks but the pool holds "
                f"{sess._num_blocks}; raise num_blocks or shorten the "
                f"request")
        if req.adapter is not None:
            # no LoRA manager in the port (ROADMAP queue A item 6)
            raise InvalidRequest(
                f"request names adapter {req.adapter!r} but this "
                f"session serves the base model only (no LoRA "
                f"manager attached)")
        if self.max_waiting is not None \
                and len(self.waiting) >= self.max_waiting:
            self.rejections += 1
            req.status = "rejected"
            self._emit_terminal_event(req, "rejected",
                                      waiting=len(self.waiting))
            raise AdmissionRejected(
                f"waiting queue full ({len(self.waiting)} >= "
                f"max_waiting={self.max_waiting}); retry later or "
                f"raise max_waiting")
        now = time.monotonic()
        req.submit_t = now
        req.queued_t = now
        req.submit_seq = self._submit_seq
        self._submit_seq += 1
        req.status = "waiting"
        self.waiting.append(req)
        from .serving import _obs_enabled, _serving_metrics, _tracer
        if _obs_enabled():
            # parent: the router's fleet traceparent (if the HTTP
            # front-end carried one in) — this replica's fragment then
            # stitches into the fleet-wide timeline
            req.trace = _tracer().start_trace(
                "request", req_id=req.req_id, t0=req.submit_t,
                parent=getattr(req, "trace_ctx", None),
                prompt_len=plen, max_new_tokens=req.max_new_tokens)
            sm = _serving_metrics()
            sm["requests_submitted"].inc()
            sm["queue_depth"].set(len(self.waiting))

    def cancel(self, req_id) -> bool:
        """Cancel a waiting or running request. Returns True when the
        request was found live (its blocks free at the next step
        boundary — immediately if none is in flight); False when it is
        unknown or already terminal. Safe to call from another thread
        while the serving loop runs."""
        if self._in_step:
            self._cancel_pending.add(req_id)
            return self._find_live(req_id) is not None
        found = self._do_cancel(req_id)
        return found

    def _find_live(self, req_id):
        for r in self.waiting:
            if r.req_id == req_id:
                return r
        for s in self.session._slots:
            if s.req is not None and s.req.req_id == req_id:
                return s.req
        return None

    def _do_cancel(self, req_id) -> bool:
        sess = self.session
        for k, r in enumerate(self.waiting):
            if r.req_id == req_id:
                self.waiting.pop(k)
                self.cancellations += 1
                sess._terminate(r, "cancelled")
                return True
        for i, s in enumerate(sess._slots):
            if s.req is not None and s.req.req_id == req_id:
                self.cancellations += 1
                sess._terminate(s.req, "cancelled", slot=i)
                return True
        return False

    # -- per-step policy ---------------------------------------------------
    def begin_step(self, now: float):
        """Step-boundary bookkeeping: drain pending cancellations, then
        expire deadlines (waiting AND running — a running expired
        request frees its blocks right here)."""
        sess = self.session
        while self._cancel_pending:
            self._do_cancel(self._cancel_pending.pop())
        expired = [r for r in self.waiting
                   if r.deadline_s is not None
                   and now - r.submit_t > r.deadline_s]
        for r in expired:
            self.waiting.remove(r)
            self.expirations += 1
            sess._terminate(r, "expired")
        for i, s in enumerate(sess._slots):
            r = s.req
            if (r is not None and r.deadline_s is not None
                    and now - r.submit_t > r.deadline_s):
                self.expirations += 1
                sess._terminate(r, "expired", slot=i)

    def chunk_cap(self) -> int:
        """Per-step prefill-token budget for ONE slot; never wider than
        the admit ladder's top (max_prompt_len)."""
        cap = self.session.max_prompt_len
        return min(self.prefill_chunk, cap) if self.prefill_chunk \
            else cap

    def plan_step(self, now: float):
        """Choose this step's prefill work: continuation chunks for
        mid-prefill slots first, then new admissions (priority desc,
        then submit order) into free slots — preempting lower-priority
        victims when slots or blocks run out. Returns the list of slot
        indices with prefill work; admitted requests are already bound
        to their slots.

        The hierarchical-KV gate (r24) runs per candidate BEFORE its
        block plan: a request whose missing prefix is mid-fetch from a
        fleet peer is SKIPPED (not broken on — later arrivals still
        admit) so its prefill never burns the work the fetch is about
        to deliver. Pool-full and adapter-residency gates keep their
        head-of-line ``break`` semantics."""
        sess = self.session
        work = [i for i, s in enumerate(sess._slots)
                if s.req is not None and s.pending is not None]
        if not self.waiting:
            return work
        sess._check_weight_swap()
        self.waiting.sort(key=lambda r: (-r.priority, r.submit_seq))
        bound_now = set()
        gate = getattr(sess, "_kv_tier_gate", None)
        k = 0
        while k < len(self.waiting):
            req = self.waiting[k]
            if gate is not None and gate(req):
                # in-flight fleet fetch: defer THIS request only
                k += 1
                continue
            slot_i = next((i for i, s in enumerate(sess._slots)
                           if s.req is None), None)
            if slot_i is None:
                # no free slot: a strictly lower-priority victim makes
                # room; equal priority never preempts (no thrash)
                if not self._preempt_for(req, bound_now, work):
                    break
                slot_i = next(i for i, s in enumerate(sess._slots)
                              if s.req is None)
            plan = sess._plan_admission(req)
            while plan[0] is None and self.preemption \
                    and self._preempt_for(req, bound_now, work):
                plan = sess._plan_admission(req)  # victim's blocks freed
            if plan[0] is None:
                break   # pool full: the head of the queue waits
            self.waiting.pop(k)
            sess._bind_slot(slot_i, req, plan, now,
                            admit_seq=self._admit_seq)
            self._admit_seq += 1
            bound_now.add(slot_i)
            work.append(slot_i)
        return work

    def _pick_victim(self, exclude, max_priority=None):
        """Victim slot index: lowest priority first, most recently
        admitted breaking ties (vLLM's recompute-preemption order —
        the newest request has the least sunk prefill work). None when
        no slot qualifies."""
        sess = self.session
        cands = [(s.req.priority, -s.admit_seq, i)
                 for i, s in enumerate(sess._slots)
                 if s.req is not None and i not in exclude]
        if not cands:
            return None
        pr, _, i = min(cands)
        if max_priority is not None and pr >= max_priority:
            return None
        return i

    def _preempt_for(self, req, bound_now, work) -> bool:
        if not self.preemption:
            return False
        i = self._pick_victim(bound_now, max_priority=req.priority)
        if i is None:
            return False
        self.session._preempt_slot(i)
        if i in work:        # victim was mid-prefill this step
            work.remove(i)
        return True

    def force_preempt(self, req_id=None):
        """Forced preemption (chaos/testing API): evict the request in
        ``req_id``'s slot — or the default victim — back to the waiting
        queue. Returns the preempted req_id, or None when nothing is
        running. Must be called between steps."""
        if self._in_step:
            raise RuntimeError("force_preempt inside step()")
        sess = self.session
        if req_id is None:
            i = self._pick_victim(exclude=())
        else:
            i = next((k for k, s in enumerate(sess._slots)
                      if s.req is not None and s.req.req_id == req_id),
                     None)
        if i is None:
            return None
        rid = sess._slots[i].req.req_id
        sess._preempt_slot(i)
        return rid

    def requeue(self, req, now: float):
        """Preempted request back to the queue with its ORIGINAL submit
        order (it goes ahead of anything submitted after it at the same
        priority)."""
        req.status = "preempted"
        req.preemptions += 1
        req.queued_t = now
        self.preemptions += 1
        self.waiting.append(req)

    def plan_ahead_safe(self, kind: str = "decode") -> bool:
        """May the overlapped engine stage (or keep) a plan of ``kind``
        for the NEXT step without running begin_step/plan_step? True
        only when this step's plan would provably be a no-op: nothing
        waiting to admit and no cancellation pending. (Deadline expiry
        is the engine's side of the bargain — it refuses to stage while
        any live request carries a deadline.)

        The scheduler's answer is the same for both kinds; the ``kind``
        is recorded so telemetry can attribute refused staging, and
        because the engine-side validation DIFFERS: a ``"spec"`` plan
        additionally predicts each window's acceptance outcome, so
        rollback boundaries short of the staged guess are mispredict
        triggers over and above the slot-version fencing shared with
        ``"decode"``."""
        return not self.waiting and not self._cancel_pending

    # -- introspection -----------------------------------------------------
    def snapshot(self) -> dict:
        """Scheduler state for flight-recorder dumps: what was waiting,
        what was running where, and the policy knobs — the post-mortem
        'what was the scheduler doing at the kill instant' view."""
        now = time.monotonic()
        sess = self.session
        waiting = [{"req_id": str(r.req_id), "priority": r.priority,
                    "status": r.status, "prompt_len": len(r.prompt),
                    "n_tokens": len(r.tokens),
                    "preemptions": r.preemptions,
                    "age_s": (round(now - r.submit_t, 3)
                              if r.submit_t is not None else None)}
                   for r in self.waiting]
        running = [{"slot": i, "req_id": str(s.req.req_id),
                    "priority": s.req.priority,
                    "seq_len": int(s.seq_len),
                    "n_tokens": len(s.req.tokens),
                    "prefilling": s.pending is not None,
                    "pending_prefill": (len(s.pending)
                                        if s.pending is not None else 0)}
                   for i, s in enumerate(sess._slots)
                   if s.req is not None]
        return {
            "waiting": waiting,
            "running": running,
            "preempted": [w["req_id"] for w in waiting
                          if w["status"] == "preempted"],
            "counters": {"preemptions": self.preemptions,
                         "expirations": self.expirations,
                         "cancellations": self.cancellations,
                         "rejections": self.rejections},
            "knobs": {"prefill_chunk": self.prefill_chunk,
                      "max_waiting": self.max_waiting,
                      "preemption": self.preemption,
                      "slots": sess.slots,
                      # num_blocks is the QUANTIZED geometry when
                      # kv_dtype is set (kv_pool_bytes sizing doubles
                      # it at equal bytes): admission accounting,
                      # /schedulerz, /sloz compliance and the
                      # autoscaler all read the doubled capacity, never
                      # a stale bf16 block count
                      "num_blocks": sess._num_blocks,
                      "kv_dtype": getattr(sess, "_kv_dtype", None),
                      "quantize_weights": getattr(
                          sess, "_quant_weights", None),
                      "kv_pool_bytes": getattr(
                          sess, "_kv_pool_bytes", None),
                      # r24: hierarchical-KV arming, so loadgen
                      # --bench serving-kv-tier can refuse to measure
                      # a fleet whose tier never armed (same contract
                      # as the speculative knob below)
                      "kv_tier": (
                          None if getattr(sess, "_kv_tier", None)
                          is None else {
                              "host_capacity_bytes":
                                  sess._kv_tier.host_tier
                                  .capacity_bytes,
                              "peers": len(sess._kv_tier.directory
                                           .state()["peers"])}),
                      # r23: the speculative arming, so loadgen --spec
                      # can refuse to "measure" a spec fleet that is
                      # actually serving plain decode
                      "speculative": (
                          None if getattr(sess, "_spec", None) is None
                          else {
                              "proposer": sess._spec.proposer,
                              "num_draft_tokens":
                                  sess._spec.num_draft_tokens,
                              "accept": getattr(sess, "_spec_accept",
                                                None),
                              "stage_ahead": getattr(sess, "_spec_stage",
                                                     None)})},
        }

    def _register_with_flight_recorder(self):
        """Expose snapshot() to flight-recorder dumps via a weakref so
        the recorder never pins a dead session."""
        import weakref

        from ..observability.flight_recorder import register_state_provider

        ref = weakref.ref(self)

        def _provide():
            sched = ref()
            return None if sched is None else sched.snapshot()

        register_state_provider(f"serving_scheduler_{id(self):x}",
                                _provide)

    def _emit_terminal_event(self, req, status, **extra):
        from .serving import _obs_enabled, _serving_metrics
        if not _obs_enabled():
            return
        from ..observability import get_event_log

        sm = _serving_metrics()
        replica = getattr(self.session, "replica_name", None)
        if status in sm:
            sm[status].inc(**({"replica": replica} if replica else {}))
        get_event_log().emit(
            f"serving.request_{status}", req_id=str(req.req_id),
            replica=replica,
            prompt_len=len(req.prompt), n_tokens=len(req.tokens),
            priority=req.priority, preemptions=req.preemptions, **extra)


# built with the session on the caller thread; under ApiServer every
# mutation then happens on the engine thread (the _pending/_cancels
# deques are the only cross-thread surface).  A second mutator thread
# after that handoff still races.
race_handoff("Scheduler.*",
             "session-init on the caller thread, then engine-thread "
             "single-writer (ApiServer routes work via deques)")
