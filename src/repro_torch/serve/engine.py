"""Serving engine: continuous batching over a fixed-slot KV cache.

The JAX package's ``serve/engine.py`` on the port's ``LM``.  The engine
owns ``max_slots`` cache rows; requests are admitted into free slots,
prefilled (same-length prompts as one batched prefill), then all active
slots decode together with one batched ``decode_step`` per tick.  Finished
slots (EOS or max_tokens) are retired and immediately refilled from the
queue.

Retrieval-augmented requests name a ``context_vertex`` in the lake; the
engine gathers context for **all** requests admitted in a tick via one
batched neighbor retrieval (``context_fn``, e.g.
:class:`repro_torch.serve.retrieval.GraphRetriever`) before prefill.

Pipelined serving
-----------------

Retrieval and decode are independent work, so with ``pipeline=True`` (the
``REPRO_PIPELINE`` default) each tick runs::

    admit(t)                  consume tick t's prefetched contexts,
      |                       prefill admitted slots
    dispatch decode(t)        CUDA launches are asynchronous: returns once
      |                       the step's kernels are queued
    prefetch retrieval(t+1)   speculate next tick's admissions from the
      |                       queue + deterministic retirements and run
      |                       their batched retrieval while decode executes
    sample(t)                 first host read of the logits = the tick's
                              one sync

The overlap holds while the host work of the prefetch runs ahead of the
queued decode; the first operation of the prefetch that waits for the
stream (a blocking copy to or from the card) ends it.  Speculation is
*checked, not trusted*: the retrieval plane's state (meter, LRU, counters)
is snapshotted before every prefetch, and if the next tick's actual
admission batch differs -- a slot retired early on EOS, a request jumped
the queue, or the adjacency column's version moved -- the snapshot is
restored and the tick falls back to the synchronous retrieval path.  Ids,
tokens, and IOMeter are therefore **bit-identical** to the sequential
engine on every tick, speculation hit or miss.

Multi-tenant admission, overload and faults
-------------------------------------------

With ``tenants=[TenantConfig(...), ...]`` the FIFO becomes a
:class:`~repro_torch.serve.tenancy.TenantScheduler` (token buckets,
bounded queues, deficit-weighted round-robin, typed submit outcomes);
per-request deadlines are enforced at tick boundaries.  An optional
:class:`~repro_torch.serve.overload.OverloadController` degrades in
counted, reversible steps; an attached
:class:`~repro_torch.ft.faults.FaultPlan` injects crashes at the
``serve.retrieval``, ``serve.prefill``, ``serve.spec_commit`` and
``serve.ingest`` boundaries, which the engine survives via snapshot
rewind and seeded-backoff retries (delays recorded, never slept);
:meth:`ingest` forwards an edge batch to the retriever's mutable plane.

On a distributed mesh the engine runs under it (``with mesh:``) as it
is: the model's parameters are DTensors (``shard_model``), its caches are
placed by the rules when they are made, each rank writes its own rows of
an admitted group (``steps.write_slots``), and the tick reads the logits
whole, once, to sample.  Every rank drives the same engine on the same
requests.

Differences from the reference: no jit (``decode_step`` and ``prefill``
are plain calls of the model, which holds its weights, so the engine takes
no ``params``); the prefill template cache is zeroed before each use,
since the port writes a KV cache in place; temperature > 0 slots draw from
one ``torch.Generator`` on the model's device seeded with ``seed``, a
stream that is not ``jax.random``'s (greedy slots are bit-identical).
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from collections import deque
from typing import Callable, Dict, List, Optional

import numpy as np
import torch

from repro_torch.ft.backoff import Backoff, retry_call
from repro_torch.ft.faults import FaultPlan, InjectedFault
from repro_torch.ft.faults import check as fault_check
from repro_torch.models.model import LM
from .overload import OverloadConfig, OverloadController
from .sampling import sample
from .steps import _local, write_slots
from .tenancy import (RequestStatus, SubmitOutcome, SubmitStatus,
                      TenantConfig, TenantScheduler)


def _pipeline_default() -> bool:
    """``REPRO_PIPELINE`` default (read at engine construction so tests
    can flip it per engine): pipelined serving is on unless disabled."""
    return os.environ.get("REPRO_PIPELINE", "1") \
        .strip().lower() not in ("0", "false", "no", "off")


def _whole(x: torch.Tensor) -> torch.Tensor:
    """A DTensor's global value (gathered on every rank); anything else
    as it is."""
    return x.full_tensor() if hasattr(x, "full_tensor") else x


@dataclasses.dataclass
class Request:
    request_id: int
    prompt: np.ndarray                 # int32 tokens
    max_new_tokens: int = 32
    temperature: float = 0.0
    context_vertex: Optional[int] = None   # RAG seed vertex in the lake
    tenant: str = "default"            # request class (multi-tenant mode)
    deadline_ticks: Optional[int] = None   # ticks from submit to finish
    # filled by the engine
    output: List[int] = dataclasses.field(default_factory=list)
    done: bool = False
    context_tokens: int = 0            # context appended by the engine
    status: Optional[RequestStatus] = None  # terminal status at retirement
    submitted_tick: Optional[float] = None
    deadline_at: Optional[float] = None    # absolute tick budget
    finished_tick: Optional[float] = None


class UndrainedError(RuntimeError):
    """``run_until_drained`` exhausted ``max_ticks`` with work still in
    flight.  Carries the stuck request ids instead of silently returning
    a partial result that looks like a drain."""

    def __init__(self, queued_ids: List[int], active_ids: List[int],
                 max_ticks: int):
        self.queued_ids = list(queued_ids)
        self.active_ids = list(active_ids)
        self.max_ticks = max_ticks
        super().__init__(
            f"undrained after {max_ticks} ticks: "
            f"{len(self.queued_ids)} queued {self.queued_ids}, "
            f"{len(self.active_ids)} active {self.active_ids}")


class ServeEngine:
    def __init__(self, model: LM, max_slots: int = 4,
                 max_len: int = 512, eos_id: int = 2, seed: int = 0,
                 context_fn: Optional[
                     Callable[[np.ndarray], List[np.ndarray]]] = None,
                 pipeline: Optional[bool] = None, batched: bool = True,
                 tenants: Optional[List[TenantConfig]] = None,
                 overload: Optional[OverloadConfig] = None,
                 faults: Optional[FaultPlan] = None):
        self.model = model
        # ``batched=False`` keeps the per-request tick (one prefill
        # dispatch+sync per admitted request, one sample read per active
        # slot) as the baseline the restructured tick is measured against
        self.batched = bool(batched)
        self.max_slots = max_slots
        self.max_len = max_len
        self.eos_id = eos_id
        self.context_fn = context_fn
        self.queue: deque[Request] = deque()
        self.slots: List[Optional[Request]] = [None] * max_slots
        self.finished: List[Request] = []
        # per-slot positions (vector index): slots advance independently
        self.cache = model.init_cache(max_slots, max_len,
                                      dtype=torch.float32, vector_index=True)
        self.slot_pos = np.zeros(max_slots, np.int32)   # host mirror
        self.generator = torch.Generator(device=model.device)
        self.generator.manual_seed(seed)
        self._tmp_caches: Dict[int, Dict] = {}  # k -> prefill template
        self.steps = 0
        # -- pipelined serving state ------------------------------------------
        self.pipeline = _pipeline_default() if pipeline is None \
            else bool(pipeline)
        # speculative prefetch needs to undo a wrong guess exactly: only
        # a context_fn exposing snapshot/restore can be prefetched against
        self._can_prefetch = (context_fn is not None
                              and hasattr(context_fn, "snapshot")
                              and hasattr(context_fn, "restore"))
        self._prefetch: Optional[Dict[str, object]] = None
        self.prefetch_issued = 0    # speculative retrievals launched
        self.prefetch_hits = 0      # consumed by the predicted admission
        self.mis_speculations = 0   # restored + synchronous fallback
        self.pipeline_overlap_ms = 0.0  # prefetch time spent under decode
        self.last_tick: Dict[str, float] = {}   # last tick's latency split
        self.tick_totals: Dict[str, float] = {}  # cumulative latency split
        self._last_retrieval_ms = 0.0
        # -- multi-tenant admission control -----------------------------------
        self.tick_no = 0        # the admission/deadline clock (1 per step)
        self.scheduler = (TenantScheduler(tenants, now=0.0)
                          if tenants is not None else None)
        self.rejected: List[Request] = []   # shed at submit (typed outcome)
        self.deadline_exceeded = 0          # typed deadline failures
        self.expired_in_queue = 0           # ...of which never held a slot
        self.spec_disabled = False          # overload rung 2 gates prefetch
        self.overload = (OverloadController(self, overload)
                         if overload is not None else None)
        # -- serving-plane fault injection ------------------------------------
        self.faults = faults
        self._fault_backoff = Backoff(seed=0)   # deterministic retry delays
        self.fault_hits: Dict[str, int] = {}    # boundary -> injected count
        self.faults_recovered = 0
        self.fault_backoff_s = 0.0              # simulated, never slept

    # -- admission -------------------------------------------------------------
    def submit(self, req: Request) -> SubmitOutcome:
        """Offer ``req`` to the engine.  Multi-tenant mode gates it
        through the tenant's token bucket and bounded queue and returns
        the typed outcome (``REJECTED`` outcomes carry a retry-after
        hint and the request is recorded in ``self.rejected`` with
        ``status=REJECTED``); single-queue mode always admits."""
        if self.scheduler is not None:
            out = self.scheduler.submit(req, self.tick_no)
            if not out.admitted:
                req.status = RequestStatus.REJECTED
                self.rejected.append(req)
            return out
        req.submitted_tick = self.tick_no
        if req.deadline_ticks is not None:
            req.deadline_at = self.tick_no + req.deadline_ticks
        self.queue.append(req)
        return SubmitOutcome(SubmitStatus.ADMITTED, req.tenant)

    # -- serving-plane fault injection helpers ---------------------------------
    def _note_fault(self, attempt: int, delay: float, exc) -> None:
        """``retry_call`` observer: count the injected fault, accumulate
        the (simulated, never slept) backoff delay."""
        b = getattr(exc, "boundary", "?")
        self.fault_hits[b] = self.fault_hits.get(b, 0) + 1
        self.faults_recovered += 1
        self.fault_backoff_s += delay

    def _fault_retry(self, fn):
        """Run ``fn`` under the seeded retry loop, treating injected
        faults (and only those) as retryable.  Delays are recorded, not
        slept -- a chaos tick must not block."""
        return retry_call(fn, retries=8, backoff=self._fault_backoff,
                          sleep=lambda d: None,
                          retry_on=(InjectedFault,),
                          on_retry=self._note_fault)

    def _retrieve_contexts(self, vs: np.ndarray) -> List[np.ndarray]:
        """The tick's batched context retrieval, crash-checked at the
        ``serve.retrieval`` boundary (pre-dispatch and at commit).  A
        commit-side fault rewinds the retrieval plane's snapshot before
        the retry, so meter/LRU accounting replays exactly once."""
        if self.faults is None:
            return self.context_fn(vs)

        def attempt():
            snap = (self.context_fn.snapshot()
                    if self._can_prefetch else None)
            fault_check(self.faults, "serve.retrieval")
            try:
                out = self.context_fn(vs)
                fault_check(self.faults, "serve.retrieval")
            except InjectedFault:
                if snap is not None:
                    self.context_fn.restore(snap)
                raise
            return out

        return self._fault_retry(attempt)

    def ingest(self, src, dst):
        """Forward an edge batch to the retrieval plane's mutable graph.

        Requires an ingest-capable ``context_fn`` (e.g.
        :class:`~repro_torch.serve.retrieval.GraphRetriever`); ingested
        edges are visible to context retrieval from the next tick on.
        With a fault plan attached the ``serve.ingest`` boundary is
        checked before the batch is forwarded (the delta plane's own
        ``ingest.append`` boundary keeps the batch all-or-nothing), and
        the engine retries through the seeded backoff.
        """
        if self.context_fn is None or not hasattr(self.context_fn,
                                                  "ingest"):
            raise ValueError("no ingest-capable context_fn attached")
        # getattr: tests exercise this forwarder on a bare engine shell
        if getattr(self, "faults", None) is None:
            return self.context_fn.ingest(src, dst)

        def attempt():
            fault_check(self.faults, "serve.ingest")
            return self.context_fn.ingest(src, dst)

        return self._fault_retry(attempt)

    def _clamp_admission(self, req: Request) -> None:
        """``max_len`` is the slot's hard cache-row budget: prompt rows
        plus decode writes must fit.  Clamp both at admission, before the
        context budget is computed from them."""
        prompt = np.asarray(req.prompt, np.int32)
        cap = self.max_len - 2          # leave >= 1 decode row
        if len(prompt) > cap:
            req.prompt = prompt[:cap]
        room = self.max_len - 1 - len(req.prompt)
        if req.max_new_tokens > room:
            req.max_new_tokens = int(room)

    def _graph_epoch(self):
        fn = getattr(self.context_fn, "mutation_epoch", None)
        return fn() if fn is not None else None

    def _discard_prefetch(self) -> None:
        """A prefetched retrieval that cannot be consumed: rewind the
        retrieval plane to its pre-prefetch state (meter, LRU, counters)
        so the synchronous path replays from exactly where the
        sequential engine would stand."""
        pf = self._prefetch
        self._prefetch = None
        if pf is not None:
            self.mis_speculations += 1
            self.context_fn.restore(pf["snapshot"])

    def _take_prefetch(self, vs: np.ndarray) -> Optional[List[np.ndarray]]:
        """Prefetched contexts for exactly this admission batch, or None
        (after restoring) when the speculation missed."""
        pf = self._prefetch
        if pf is None:
            return None
        self._prefetch = None
        if np.array_equal(pf["vs"], vs) \
                and self._graph_epoch() == pf["epoch"]:
            self.prefetch_hits += 1
            return pf["contexts"]
        self.mis_speculations += 1
        self.context_fn.restore(pf["snapshot"])
        return None

    def _attach_context(self, admitted: List[Request]) -> None:
        """One batched lake retrieval for every admitted request's seed
        (served from the previous tick's prefetch when the speculation
        predicted this exact batch)."""
        need = [r for r in admitted if r.context_vertex is not None]
        if not need or self.context_fn is None:
            self._discard_prefetch()
            return
        vs = np.asarray([r.context_vertex for r in need], np.int64)
        contexts = self._take_prefetch(vs)
        if contexts is None:
            contexts = self._retrieve_contexts(vs)
        for req, ctx in zip(need, contexts):
            ctx = np.asarray(ctx, np.int32)
            # leave room for generation within the slot's cache rows
            budget = self.max_len - 1 - req.max_new_tokens - len(req.prompt)
            ctx = ctx[:max(budget, 0)]
            if ctx.size:
                req.prompt = np.concatenate(
                    [np.asarray(req.prompt, np.int32), ctx])
                req.context_tokens = int(ctx.size)

    def _pending_count(self) -> int:
        """Requests waiting for a slot (whichever queue plane is live)."""
        if self.scheduler is not None:
            return self.scheduler.pending()
        return len(self.queue)

    def _peek_admissions(self, width: int) -> List[Request]:
        """The next ``width`` requests admission would take, without
        taking them -- the speculative prefetch's prediction.  In
        multi-tenant mode this previews the DWRR pop order exactly."""
        if self.scheduler is not None:
            return self.scheduler.peek(width)
        return list(itertools.islice(self.queue, 0, width))

    def _admit(self) -> None:
        free = [i for i in range(self.max_slots) if self.slots[i] is None]
        admitted: List[tuple] = []
        if self.scheduler is not None:
            for req in self.scheduler.pop(len(free), self.tick_no):
                admitted.append((free.pop(0), req))
        else:
            while free and self.queue:
                admitted.append((free.pop(0), self.queue.popleft()))
        for _, req in admitted:
            self._clamp_admission(req)
        t0 = time.perf_counter()
        self._attach_context([r for _, r in admitted])
        self._last_retrieval_ms = (time.perf_counter() - t0) * 1e3
        # grouped prefill: all admitted prompts of one length run as ONE
        # batched forward + one multi-slot cache write
        if self.batched:
            groups: Dict[int, List[tuple]] = {}
            for slot, req in admitted:
                groups.setdefault(len(req.prompt), []).append((slot, req))
            grouped = list(groups.values())
        else:
            grouped = [[(slot, req)] for slot, req in admitted]
        for grp in grouped:
            self._prefill_group(grp)
        for slot, req in admitted:
            self.slots[slot] = req

    def _template(self, k: int) -> Dict:
        """The empty batch-``k`` prefill cache, built once per ``k``.  The
        model writes a cache in place, so a reused template holds the last
        group's rows: every leaf (k and v, an SSM layer's conv tail, which
        a prefill reads, and its state) is zeroed before every prefill,
        which gives each group the reference's fresh zero cache."""
        tmpl = self._tmp_caches.get(k)
        if tmpl is None:
            tmpl = self.model.init_cache(k, self.max_len,
                                         dtype=torch.float32)
            self._tmp_caches[k] = tmpl
        for layer in tmpl["layers"]:
            for part in layer.values():
                for name, leaf in part.items():
                    if name != "index":
                        _local(leaf).zero_()
        return tmpl

    def _prefill_group(self, grp: List[tuple]) -> None:
        """Batched prefill of same-length prompts: one forward over the
        stacked ``(k, L)`` prompt matrix, one multi-slot cache write, one
        host sync for the k argmax tokens."""
        k = len(grp)
        prompts = np.stack([np.asarray(req.prompt, np.int32)
                            for _, req in grp])

        def run():
            return self.model.prefill({"tokens": prompts}, self._template(k))

        if self.faults is None:
            logits, tmp_cache = run()
        else:
            # ``serve.prefill`` boundary: the template is zeroed and the
            # engine cache written only below, so a crash on either side
            # of the forward retries to identical logits/cache rows
            def attempt():
                fault_check(self.faults, "serve.prefill")
                out = run()
                fault_check(self.faults, "serve.prefill")
                return out

            logits, tmp_cache = self._fault_retry(attempt)
        write_slots(self.cache, tmp_cache, [s for s, _ in grp])
        toks = torch.argmax(_whole(logits)[:, -1], dim=-1).cpu().numpy()
        for (slot, req), tok in zip(grp, toks):
            self.slot_pos[slot] = len(req.prompt)
            req.output.append(int(tok))
            # the prefill token counts toward the budget:
            # max_new_tokens=1 (e.g. a clamped near-capacity admission)
            # retires right here
            if int(tok) == self.eos_id or \
                    len(req.output) >= req.max_new_tokens:
                req.done = True

    # -- speculative prefetch (the pipeline's second stage) --------------------
    def _predict_retiring(self, active: List[int]) -> int:
        """Slots certain to retire this tick, *before* sampling: the
        length/position bounds are deterministic; only EOS is not (a
        wrong guess is caught and rolled back at the next admission)."""
        n = 0
        for i in active:
            req = self.slots[i]
            if len(req.output) + 1 >= req.max_new_tokens or \
                    int(self.slot_pos[i]) + 1 >= self.max_len - 1 or \
                    (req.deadline_at is not None
                     and self.tick_no + 1 > req.deadline_at):
                n += 1
        return n

    def _speculate_prefetch(self, active: List[int]) -> None:
        """Issue tick t+1's batched retrieval while tick t's decode is in
        flight.  The predicted admission batch is the queue's head, as
        wide as the slots certain to free; the retrieval runs through the
        real plane (pages land in the decoded-page LRU, the meter is
        charged miss-only -- exactly what the synchronous path would do
        one tick later), guarded by a snapshot for the fallback."""
        if self._prefetch is not None or not self._can_prefetch \
                or self.spec_disabled or not self._pending_count():
            return
        # certain frees: empty slots, slots already done (EOS at
        # prefill, retired at tick end), and deterministic retirements
        width = sum(1 for s in self.slots if s is None or s.done) \
            + self._predict_retiring(active)
        if width <= 0:
            return
        admits = self._peek_admissions(width)
        vs = np.asarray([r.context_vertex for r in admits
                         if r.context_vertex is not None], np.int64)
        if vs.size == 0:
            return
        snapshot = self.context_fn.snapshot()
        epoch = self._graph_epoch()
        try:
            # ``serve.spec_commit`` boundary: a crash at the speculative
            # commit restores the snapshot and skips this prefetch --
            # speculation is optional work, the synchronous path next
            # tick serves the identical result
            fault_check(self.faults, "serve.spec_commit")
            contexts = self.context_fn(vs)
            fault_check(self.faults, "serve.spec_commit")
        except InjectedFault as e:
            self.context_fn.restore(snapshot)
            self.fault_hits[e.boundary] = \
                self.fault_hits.get(e.boundary, 0) + 1
            self.faults_recovered += 1
            return
        self.prefetch_issued += 1
        self._prefetch = {"vs": vs, "contexts": contexts,
                          "snapshot": snapshot, "epoch": epoch}

    # -- deadlines -------------------------------------------------------------
    def _expire_deadlines(self) -> None:
        """Deadlines are enforced at tick boundaries (start of tick
        ``now``: the request had every tick up to and including its
        budget to finish).  Queued requests past their deadline finish
        with the typed ``DEADLINE_EXCEEDED`` status without ever holding
        a slot; in-slot requests are marked done and their slot frees
        *immediately* -- this same tick's admission reuses it."""
        now = self.tick_no

        def _expire(req: Request) -> None:
            req.status = RequestStatus.DEADLINE_EXCEEDED
            req.done = True
            req.finished_tick = now
            self.deadline_exceeded += 1
            self.expired_in_queue += 1
            if self.scheduler is not None:
                self.scheduler.note_finished(req,
                                             RequestStatus.DEADLINE_EXCEEDED)
            self.finished.append(req)

        if self.scheduler is not None:
            for req in self.scheduler.expire(now):
                _expire(req)
        elif self.queue and any(r.deadline_at is not None
                                for r in self.queue):
            kept: deque[Request] = deque()
            for req in self.queue:
                if req.deadline_at is not None and now > req.deadline_at:
                    _expire(req)
                else:
                    kept.append(req)
            self.queue = kept
        expired_slot = False
        for req in self.slots:
            if req is not None and not req.done \
                    and req.deadline_at is not None \
                    and now > req.deadline_at:
                req.status = RequestStatus.DEADLINE_EXCEEDED
                req.done = True
                self.deadline_exceeded += 1
                expired_slot = True
        if expired_slot:
            self._retire()

    # -- decode tick -------------------------------------------------------------
    def _active(self) -> List[int]:
        return [i for i, r in enumerate(self.slots)
                if r is not None and not r.done]

    def _device_tokens(self, tokens: np.ndarray) -> torch.Tensor:
        """The tick's input tokens on the model's device without a host
        sync: on a card, staged through pinned memory and copied
        asynchronously (a blocking copy would wait for the stream)."""
        t = torch.from_numpy(tokens)
        if self.model.device.type != "cuda":
            return t
        return t.pin_memory().to(self.model.device, non_blocking=True)

    def step(self) -> int:
        """One engine tick: admit + one batched decode. Returns #active.

        Pipelined mode dispatches the decode, runs the speculative
        prefetch in the decode's shadow, and only then samples (the
        logits read is the tick's one host sync)."""
        t0 = time.perf_counter()
        self.tick_no += 1
        self._expire_deadlines()
        self._admit()
        t_admit = time.perf_counter()
        active = self._active()
        if not active:
            self._retire()
            return 0
        tokens = np.zeros((self.max_slots, 1), np.int32)
        for i in active:
            tokens[i, 0] = self.slots[i].output[-1]
        logits, self.cache = self.model.decode_step(
            self._device_tokens(tokens), self.cache)
        t_dispatch = time.perf_counter()
        self.steps += 1
        if self.pipeline:
            self._speculate_prefetch(active)
        t_prefetch = time.perf_counter()
        # greedy slots sample as ONE batched argmax + host read (row-wise
        # argmax is independent per row, so batching is bit-identical);
        # temperature>0 slots draw one by one from the engine's generator
        tok_of: Dict[int, int] = {}
        logits = _whole(logits)
        greedy = [i for i in active if self.slots[i].temperature <= 0.0] \
            if self.batched else []
        if greedy:
            toks = sample(logits[:, 0]).cpu().numpy()
            tok_of.update((i, int(toks[i])) for i in greedy)
        for i in active:
            req = self.slots[i]
            tok = tok_of.get(i)
            if tok is None:
                tok = int(sample(logits[i:i + 1, 0],
                                 temperature=req.temperature,
                                 generator=self.generator)[0])
            req.output.append(tok)
            self.slot_pos[i] += 1
            if tok == self.eos_id or \
                    len(req.output) >= req.max_new_tokens or \
                    int(self.slot_pos[i]) >= self.max_len - 1:
                req.done = True
        t_sample = time.perf_counter()
        self._retire()
        overlap = (t_prefetch - t_dispatch) * 1e3
        self.pipeline_overlap_ms += overlap
        self.last_tick = {
            "admit_ms": (t_admit - t0) * 1e3,
            "retrieval_ms": self._last_retrieval_ms,
            "dispatch_ms": (t_dispatch - t_admit) * 1e3,
            "prefetch_ms": overlap,
            "decode_sample_ms": (t_sample - t_prefetch) * 1e3,
            "tick_ms": (t_sample - t0) * 1e3,
        }
        for k, v in self.last_tick.items():
            self.tick_totals[k] = self.tick_totals.get(k, 0.0) + v
        if self.overload is not None:
            self.overload.observe(self.last_tick["tick_ms"])
        return len(self._active())

    def _retire(self) -> None:
        for i, req in enumerate(self.slots):
            if req is not None and req.done:
                if req.status is None:
                    req.status = RequestStatus.OK
                if req.finished_tick is None:
                    req.finished_tick = self.tick_no
                if self.scheduler is not None:
                    self.scheduler.note_finished(req, req.status)
                self.finished.append(req)
                self.slots[i] = None
                self.slot_pos[i] = 0

    def stats(self) -> Dict[str, object]:
        """Engine counters, including the retrieval plane's per-tick
        batching and decoded-page cache hit/miss counters when the
        context_fn exposes them (e.g. :class:`GraphRetriever`), plus the
        pipeline's speculation counters and per-tick latency breakdown."""
        s: Dict[str, object] = {
            "steps": self.steps,
            "finished": len(self.finished),
            "queued": self._pending_count(),
            "active": len(self._active()),
        }
        if self.scheduler is not None:
            s["tenants"] = self.scheduler.stats()
            s["rejected"] = len(self.rejected)
        if self.deadline_exceeded:
            s["deadline_exceeded"] = self.deadline_exceeded
            s["expired_in_queue"] = self.expired_in_queue
        if self.overload is not None:
            s["overload"] = self.overload.stats()
        if self.faults is not None:
            s["faults"] = {
                "injected": dict(self.fault_hits),
                "recovered": self.faults_recovered,
                "backoff_s": round(self.fault_backoff_s, 3),
                "plan": self.faults.stats(),
            }
        s["pipeline"] = {
            "enabled": self.pipeline,
            "prefetch_issued": self.prefetch_issued,
            "prefetch_hits": self.prefetch_hits,
            "mis_speculations": self.mis_speculations,
            "pipeline_overlap_ms": round(self.pipeline_overlap_ms, 3),
            "last_tick": {k: round(v, 3)
                          for k, v in self.last_tick.items()},
            "totals": {k: round(v, 3)
                       for k, v in self.tick_totals.items()},
        }
        if self.context_fn is not None and hasattr(self.context_fn, "stats"):
            s["retrieval"] = self.context_fn.stats()
        return s

    def run_until_drained(self, max_ticks: int = 10_000) -> List[Request]:
        """Tick until queue and slots are empty; returns the requests
        retired during this call (in retirement order).

        Exhausting ``max_ticks`` with work still in flight raises
        :class:`UndrainedError` naming the stuck request ids -- a
        partial result must never masquerade as a drain."""
        start = len(self.finished)
        for _ in range(max_ticks):
            self.step()
            if not self._pending_count() \
                    and all(s is None for s in self.slots):
                return self.finished[start:]
        if self._pending_count() or any(s is not None for s in self.slots):
            queued = (self.scheduler.pending_ids()
                      if self.scheduler is not None
                      else [r.request_id for r in self.queue])
            active = [r.request_id for r in self.slots if r is not None]
            raise UndrainedError(queued, active, max_ticks)
        return self.finished[start:]
