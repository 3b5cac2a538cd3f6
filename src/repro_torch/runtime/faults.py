"""Fault injection and structured serving events (port of
``repro/runtime/faults.py``): the chaos layer under the continuous
scheduler.

* :class:`EventLog` records everything the scheduler does to a request
  (``submit/admit/evict/preempt/retry/fault/degrade/quarantine`` and the
  terminal ``finish/fail/reject/cancel``); :meth:`EventLog.terminal_
  accounting` is the auditing contract: every submitted request reaches
  exactly one terminal state, under one monotonic clock.
  :meth:`EventLog.subscribe` is how the telemetry layer counts events
  without the scheduler knowing it exists.
* :class:`FaultInjector` is a deterministic, seedable source of
  scheduler-edge faults: pool squeezes, forced preemption storms, dropped
  quantize chunks, NaN poisoning of a pool page or a logits row,
  oversized or garbage prompts, mid-stream cancellation, and a simulated
  kernel-path failure. Faults fire from per-step Bernoulli rates
  (:class:`FaultProfile`) or from an explicit ``schedule`` of
  ``(step, kind, arg)`` triples.

Determinism contract (the reference's, copied exactly):
:meth:`FaultInjector.begin_step` draws one uniform per rate-kind per step,
in a fixed order, from ``np.random.default_rng(seed)``, so the arming
pattern is a pure function of ``(seed, step index)``; candidate picks draw
only when a fault fires, so identical serving trajectories replay
identically, here and in the reference.

The injector never touches device state: the serve loop asks it whether
and what, applies the fault through the ordinary runtime ops
(``kv_cache.reserve_pages``, ``layouts.poison_tree_pages``, ...) and logs a
``fault`` event. Requests whose output a fault may legitimately alter
(dropped quantize chunks) are recorded in :attr:`FaultInjector.touched`.
The port's serve loop refuses ``kernel_fault``: the reference's
flash->einsum degrade is not ported (a kernel that fails raises).
"""

from __future__ import annotations

import dataclasses
import time
from collections import Counter
from typing import (Any, Callable, Dict, Iterable, Iterator, List, Optional,
                    Tuple)

import numpy as np


class InjectedKernelError(RuntimeError):
    """A simulated kernel-path validation failure (chaos only). The
    reference's serve loop degrades to the einsum oracle on it; the port's
    refuses a ``kernel_fault`` before serving (no degrade is ported)."""


# ----------------------------------------------------------------------------
# structured event log
# ----------------------------------------------------------------------------
EVENT_KINDS = frozenset({
    'submit',       # request entered the scheduler (before any validation)
    'admit',        # request took a decode slot (prefill follows)
    'evict',        # slot's pages released (reason: finished/preempt/...)
    'preempt',      # pool-pressure preemption (recompute-style requeue)
    'retry',        # requeued at the queue front (attempt counter)
    'quarantine',   # non-finite logits: lane scrubbed + requeued
    'fault',        # an injected fault was applied (detail names it)
    'degrade',      # kernel path failed; serving fell back to einsum
    'finish',       # terminal: request completed (EOS / budget)
    'fail',         # terminal: deadline / retry budget / queue aging
    'reject',       # terminal: admission backpressure or malformed prompt
    'cancel',       # terminal: cancelled mid-stream
})

#: kinds that end a request's life; terminal accounting demands exactly one
TERMINAL_KINDS = frozenset({'finish', 'fail', 'reject', 'cancel'})


@dataclasses.dataclass
class Event:
    """One scheduler event. ``detail`` carries kind-specific fields
    (reason, pos, attempt, fault name, ...). ``t`` is the monotonic
    wall-clock second the log stamped at emit — ``runtime.telemetry``
    derives queue-wait/TTFT/ITL spans from these, and
    :meth:`EventLog.terminal_accounting` audits their ordering."""
    step: int
    kind: str
    rid: Optional[int] = None
    slot: Optional[int] = None
    detail: Dict[str, Any] = dataclasses.field(default_factory=dict)
    t: float = 0.0

    def to_dict(self) -> dict:
        d = dict(step=self.step, kind=self.kind, t=self.t)
        if self.rid is not None:
            d['rid'] = self.rid
        if self.slot is not None:
            d['slot'] = self.slot
        d.update(self.detail)
        return d


class EventLog:
    """Append-only log of :class:`Event` records, threaded through the
    scheduler and returned in the serve report.

    Every record is stamped with ``clock()`` at emit (default
    ``time.perf_counter`` — monotonic, sub-µs). ``subscribe`` registers a
    listener called synchronously with each emitted event — how the
    telemetry layer counts events and drops trace instants without the
    scheduler knowing it exists. Tests inject a fake ``clock`` to script
    span timings deterministically."""

    def __init__(self, clock: Callable[[], float] = time.perf_counter):
        self.events: List[Event] = []
        self.clock = clock
        self._listeners: List[Callable[[Event], None]] = []

    def subscribe(self, listener: Callable[[Event], None]) -> None:
        self._listeners.append(listener)

    def emit(self, kind: str, *, step: int = -1, rid: Optional[int] = None,
             slot: Optional[int] = None, **detail) -> Event:
        if kind not in EVENT_KINDS:
            raise ValueError(f'unknown event kind {kind!r}; known: '
                             f'{sorted(EVENT_KINDS)}')
        ev = Event(step=int(step), kind=kind,
                   rid=None if rid is None else int(rid),
                   slot=None if slot is None else int(slot), detail=detail,
                   t=float(self.clock()))
        self.events.append(ev)
        for fn in self._listeners:
            fn(ev)
        return ev

    def last(self, kind: Optional[str] = None,
             rid: Optional[int] = None) -> Optional[Event]:
        """Most recent event matching the given kind and/or rid."""
        for ev in reversed(self.events):
            if (kind is None or ev.kind == kind) and \
                    (rid is None or ev.rid == rid):
                return ev
        return None

    def annotate_last(self, kind: str, rid: int, **detail) -> Event:
        """Merge measured detail into the most recent ``(kind, rid)``
        event — how the serve loop attaches each admission's prefill
        duration after the jit'd prefill returns (the admit event is
        emitted before the prefill runs)."""
        ev = self.last(kind, rid)
        if ev is None:
            raise ValueError(f'no {kind!r} event for rid {rid} to annotate')
        ev.detail.update(detail)
        return ev

    def __len__(self) -> int:
        return len(self.events)

    def __iter__(self) -> Iterator[Event]:
        return iter(self.events)

    def by_kind(self, kind: str) -> List[Event]:
        return [e for e in self.events if e.kind == kind]

    def counts(self) -> Dict[str, int]:
        return dict(Counter(e.kind for e in self.events))

    def records(self) -> List[dict]:
        return [e.to_dict() for e in self.events]

    def terminal_accounting(self) -> Dict[int, str]:
        """``rid -> terminal kind`` for every submitted request. Raises
        ValueError if any submitted rid has zero or more than one terminal
        event — the serve loop runs this on every completed continuous
        serve, so a leaked request is a crash, not a silent drop.

        The audit also covers the timestamps: ``t`` must be
        globally non-decreasing in log order (the log is append-only under
        one monotonic clock — out-of-order stamps mean a forged or merged
        log, and they would corrupt every span derived downstream), and a
        terminal event must be the LAST event for its rid — post-mortem
        scheduler activity on a finished request is a lifecycle bug even
        when it never produces a second terminal."""
        submitted = [e.rid for e in self.events
                     if e.kind == 'submit' and e.rid is not None]
        term: Dict[int, str] = {}
        prev_t = -float('inf')
        for e in self.events:
            if e.t < prev_t:
                raise ValueError(
                    f'event timestamps regress at step {e.step} '
                    f'({e.kind}: t={e.t} after t={prev_t}) — the log must '
                    f'be append-only under one monotonic clock')
            prev_t = e.t
            if e.rid is not None and e.rid in term:
                raise ValueError(
                    f'rid {e.rid} has two terminal events '
                    f'({term[e.rid]} then {e.kind}) — a request must '
                    f'end exactly once'
                    if e.kind in TERMINAL_KINDS else
                    f'rid {e.rid} has {e.kind!r} activity after its '
                    f'terminal {term[e.rid]!r} — terminated requests must '
                    f'leave the scheduler')
            if e.kind in TERMINAL_KINDS and e.rid is not None:
                term[e.rid] = e.kind
        missing = [r for r in submitted if r not in term]
        if missing:
            raise ValueError(
                f'submitted rids {missing} have no terminal event '
                f'(finish/fail/reject/cancel) — the scheduler leaked them')
        return term


# ----------------------------------------------------------------------------
# fault injection
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class FaultProfile:
    """Per-step Bernoulli rates (and their magnitudes) for each fault
    kind. All rates default to 0.0 — an injector with the default profile
    and no schedule is inert."""
    pool_squeeze: float = 0.0     # hold free pages hostage for a few steps
    squeeze_pages: int = 2        # pages held per squeeze
    squeeze_steps: int = 3        # steps a squeeze lasts
    preempt_storm: float = 0.0    # force-preempt active lanes
    storm_size: int = 1           # lanes preempted per storm
    poison_page: float = 0.0      # NaN an owned fp pool page
    poison_logits: float = 0.0    # NaN an active lane's logits row
    drop_quant: float = 0.0       # drop one step's quantize chunk
    cancel: float = 0.0           # cancel a live request mid-stream
    mangle_prompt: float = 0.0    # oversize / garbage-token a submission
    kernel_fault_step: Optional[int] = None   # simulate kernel failure once


def chaos_profile() -> FaultProfile:
    """The ``--chaos`` CLI default: every fault kind live at moderate
    rates — enough churn to exercise all recovery paths in a short run
    without starving the stream."""
    return FaultProfile(pool_squeeze=0.05, squeeze_pages=2, squeeze_steps=3,
                        preempt_storm=0.04, storm_size=1,
                        poison_page=0.03, poison_logits=0.03,
                        drop_quant=0.03, cancel=0.02)


class FaultInjector:
    """Deterministic scheduler-edge fault source (see module docstring).

    ``schedule`` entries are ``(step, kind, arg)`` triples; ``kind`` is one
    of :attr:`KINDS`. ``arg`` semantics per kind: ``pool_squeeze`` — pages
    to hold (int, default profile's); ``preempt_storm`` — lanes to preempt
    (int); ``cancel`` — rid to cancel (int, default: injector picks);
    ``mangle_prompt`` — ``(rid, mode)`` with mode ``'oversize'`` or
    ``'garbage'`` (step ignored: mangling happens at submission); others —
    ``None``."""

    KINDS = ('pool_squeeze', 'preempt_storm', 'poison_page',
             'poison_logits', 'drop_quant', 'cancel', 'kernel_fault',
             'mangle_prompt')

    def __init__(self, seed: int = 0,
                 profile: Optional[FaultProfile] = None,
                 schedule: Iterable[Tuple[int, str, Any]] = ()):
        self.seed = seed
        self.rng = np.random.default_rng(seed)
        self.profile = profile if profile is not None else FaultProfile()
        self.schedule = [tuple(e) for e in schedule]
        for _, kind, _ in self.schedule:
            if kind not in self.KINDS:
                raise ValueError(f'unknown fault kind {kind!r}; known: '
                                 f'{list(self.KINDS)}')
        self.counts: Counter = Counter()   # faults armed/applied by kind
        #: rids whose OUTPUT an applied fault may legitimately change
        #: (dropped quantize chunks); parity gates exclude these
        self.touched: set = set()
        self._step = -1
        self._armed: Dict[str, Any] = {}
        self._squeeze_until = -1
        self._squeeze_pages = self.profile.squeeze_pages

    # -- per-step arming -----------------------------------------------------
    def begin_step(self, step: int) -> None:
        """Arm this step's faults. Exactly one uniform draw per rate-kind,
        in fixed order — the arming pattern is a pure function of
        ``(seed, step)`` sequence, independent of scheduler state."""
        self._step = step
        p = self.profile

        def draw(rate):
            return bool(rate > 0.0 and self.rng.random() < rate)

        armed: Dict[str, Any] = {
            'pool_squeeze': draw(p.pool_squeeze),
            'preempt_storm': draw(p.preempt_storm),
            'poison_page': draw(p.poison_page),
            'poison_logits': draw(p.poison_logits),
            'drop_quant': draw(p.drop_quant),
            'cancel': draw(p.cancel),
            'kernel_fault': p.kernel_fault_step == step,
        }
        for st, kind, arg in self.schedule:
            if st == step and kind != 'mangle_prompt':
                armed[kind] = True if arg is None else arg
        if armed['pool_squeeze']:
            arg = armed['pool_squeeze']
            self._squeeze_pages = arg if isinstance(arg, int) and \
                not isinstance(arg, bool) else p.squeeze_pages
            self._squeeze_until = max(self._squeeze_until,
                                      step + p.squeeze_steps)
            self.counts['pool_squeeze'] += 1
        self._armed = armed

    def _take(self, kind: str) -> Any:
        armed = self._armed.get(kind, False)
        if armed:
            self.counts[kind] += 1
        return armed

    # -- queries the serve loop makes, at most once per step each ------------
    def squeeze_pages(self) -> int:
        """Free pages the injector wants held hostage right now (a squeeze
        persists for ``squeeze_steps`` after arming)."""
        return self._squeeze_pages if self._step < self._squeeze_until else 0

    def storm_count(self) -> int:
        armed = self._take('preempt_storm')
        if not armed:
            return 0
        return armed if isinstance(armed, int) and \
            not isinstance(armed, bool) else self.profile.storm_size

    def poison_page_now(self) -> bool:
        return bool(self._take('poison_page'))

    def poison_logits_now(self) -> bool:
        return bool(self._take('poison_logits'))

    def drop_quant_now(self) -> bool:
        return bool(self._take('drop_quant'))

    def cancel_now(self) -> Any:
        """Falsy, True (injector picks the victim), or an explicit rid."""
        return self._take('cancel')

    def kernel_fault_now(self) -> bool:
        return bool(self._take('kernel_fault'))

    # -- picks ---------------------------------------------------------------
    def pick(self, seq):
        """Deterministically pick one element of a (non-empty) sequence."""
        seq = list(seq)
        return seq[int(self.rng.integers(len(seq)))]

    # -- submission-time prompt mangling -------------------------------------
    def mangle(self, req, *, prompt_pad: int, vocab: int):
        """Maybe corrupt a request at submission: ``'oversize'`` grows the
        prompt past the pad width, ``'garbage'`` writes an out-of-vocab id.
        Returns the (possibly replaced) request; the scheduler's admission
        validation is expected to reject the mangled ones."""
        mode = None
        for _, kind, arg in self.schedule:
            if kind != 'mangle_prompt':
                continue
            rid, m = arg if isinstance(arg, tuple) else (arg, 'oversize')
            if rid == req.rid:
                mode = m
        if mode is None and self.profile.mangle_prompt > 0.0 \
                and self.rng.random() < self.profile.mangle_prompt:
            mode = self.pick(['oversize', 'garbage'])
        if mode is None:
            return req
        self.counts['mangle_prompt'] += 1
        prompt = np.asarray(req.prompt, np.int32)
        if mode == 'oversize':
            extra = prompt_pad + 1 - len(prompt)
            prompt = np.concatenate(
                [prompt, np.ones((max(extra, 1),), np.int32)])
        elif mode == 'garbage':
            prompt = prompt.copy()
            prompt[int(self.rng.integers(len(prompt)))] = vocab + 7
        else:
            raise ValueError(f'unknown mangle mode {mode!r}')
        return dataclasses.replace(req, prompt=prompt)
