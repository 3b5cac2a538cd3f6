"""Serving telemetry (port of ``repro/runtime/telemetry.py``): metrics,
request-lifecycle spans, per-step energy metering and Chrome-trace step
tracing for the continuous scheduler.

* :class:`MetricsRegistry`: stdlib-only counters, gauges and fixed-bucket
  histograms with p50/p90/p99 from cumulative-bucket interpolation,
  snapshot as JSON (:meth:`MetricsRegistry.snapshot`) or rendered as
  Prometheus text exposition (:meth:`MetricsRegistry.render_prometheus`).
* :func:`derive_request_spans`: per-request queue wait, prefill, TTFT,
  inter-token latency and service time, and the retry / quarantine /
  preempt counts, derived from the timestamped ``runtime.faults.EventLog``
  alone; :func:`observe_spans` enters them into the histograms.
* :class:`EnergyMeter`: every decode step prices the actual batch through
  ``core.hwmodel.decode_kv_traffic`` (GQA) or ``decode_latent_traffic``
  (MLA), with the tier tracker's measured int8 residency as
  ``cold_blocks``. **Its bytes and pJ are the YOCO hardware model's (the
  paper's macro constants and planning numbers for the memory tiers), not
  a measurement of the card**: ``serve_energy_pj_total`` and
  ``serve_kv_bytes_total`` say what the modelled design would pay for the
  stream the port served. Mamba2 layers add their recurrent state's
  read and write a token (``decode_state_traffic``), a hybrid's attention
  sites their KV. Under head-parallel serving TP (``tp`` > 1)
  ``totals()['tp']`` splits the global columns per shard: GQA pools shard
  by head, so each byte and op lands on one shard (global / ways, and
  ways times that is the global column bit for bit for a power-of-two
  ``ways``); an MLA latent pool is replicated, so only the ops divide and
  the replicated traffic is priced as ``redundant_bytes``.
* :class:`StepTracer`: the ``--trace FILE`` Chrome-trace JSON (one track
  a decode slot and a scheduler track; complete ``ph='X'`` spans and
  instants only). Load it in ``ui.perfetto.dev`` or ``chrome://tracing``.
* :class:`ServeTelemetry`: the bundle ``launch.serve.serve_continuous``
  threads through its loop; it subscribes to the ``EventLog``, so
  ``serve_events_total{kind}`` and ``serve_requests_total{terminal}``
  equal the audit log exactly.

Cost: the hooks do O(active lanes) host arithmetic a step and read
nothing back from the device; the max-|logit| gauge keeps the sentinel's
device scalar and transfers it once, in :meth:`ServeTelemetry.finish`.
"""

from __future__ import annotations

import bisect
import dataclasses
import json
import math
import time
from typing import Any, Dict, Iterable, List, Optional, Sequence, Tuple

from repro_torch.core import hwmodel
from repro_torch.runtime.faults import TERMINAL_KINDS

# latency buckets: 10 µs .. 100 s, three per decade — wide enough that CPU
# interpret-mode smoke runs and real-accelerator runs land mid-range
LATENCY_BUCKETS_S: Tuple[float, ...] = tuple(
    m * (10.0 ** e) for e in range(-5, 3) for m in (1.0, 2.5, 5.0))
#: small-integer buckets (retries per request, pages per op)
COUNT_BUCKETS: Tuple[float, ...] = (0, 1, 2, 3, 4, 6, 8, 12, 16, 24, 32, 48)


# ----------------------------------------------------------------------------
# metric primitives
# ----------------------------------------------------------------------------
class _LabeledScalar:
    """Shared label plumbing for Counter/Gauge: children are keyed by the
    tuple of label values (label names fixed at creation)."""

    kind = 'scalar'

    def __init__(self, name: str, help: str = '',
                 labels: Sequence[str] = ()):
        self.name = name
        self.help = help
        self.label_names: Tuple[str, ...] = tuple(labels)
        self.values: Dict[Tuple[str, ...], float] = {}

    def _key(self, labels: Dict[str, Any]) -> Tuple[str, ...]:
        if set(labels) != set(self.label_names):
            raise ValueError(
                f'{self.name}: got labels {sorted(labels)}, declared '
                f'{sorted(self.label_names)}')
        return tuple(str(labels[k]) for k in self.label_names)

    def value(self, **labels) -> float:
        return self.values.get(self._key(labels), 0.0)

    def total(self) -> float:
        return sum(self.values.values())

    def snapshot(self) -> dict:
        d = dict(type=self.kind, help=self.help)
        if self.label_names:
            d['labels'] = list(self.label_names)
            d['values'] = {','.join(k): v for k, v in
                           sorted(self.values.items())}
        else:
            d['value'] = self.values.get((), 0.0)
        return d

    def render(self) -> List[str]:
        lines = [f'# HELP {self.name} {self.help}',
                 f'# TYPE {self.name} {self.kind}']
        if not self.values:
            lines.append(f'{self.name} 0')
            return lines
        for key, v in sorted(self.values.items()):
            lbl = ','.join(f'{n}="{x}"'
                           for n, x in zip(self.label_names, key))
            lines.append(f'{self.name}{{{lbl}}} {_fmt(v)}' if lbl
                         else f'{self.name} {_fmt(v)}')
        return lines


def _fmt(v: float) -> str:
    return str(int(v)) if float(v).is_integer() else repr(float(v))


class Counter(_LabeledScalar):
    """Monotonically increasing value (per label set)."""

    kind = 'counter'

    def inc(self, amount: float = 1.0, **labels) -> None:
        if amount < 0:
            raise ValueError(f'{self.name}: counters only go up '
                             f'(inc({amount}))')
        k = self._key(labels)
        self.values[k] = self.values.get(k, 0.0) + amount

    def inc_at(self, key: Tuple[str, ...], amount: float = 1.0) -> None:
        """Validated-at-declaration fast path for per-step hot loops:
        ``key`` is the label-value tuple in ``label_names`` order, checked
        by the caller once at catalog time, not per call (the serve loop's
        per-step hooks use it, and :meth:`Gauge.set_at`)."""
        self.values[key] = self.values.get(key, 0.0) + amount


class Gauge(_LabeledScalar):
    """Last-written value (per label set)."""

    kind = 'gauge'

    def set(self, value: float, **labels) -> None:
        self.values[self._key(labels)] = float(value)

    def set_at(self, key: Tuple[str, ...], value: float) -> None:
        """Fast path twin of :meth:`Counter.inc_at` (same contract)."""
        self.values[key] = float(value)


class Histogram:
    """Fixed-bucket histogram with Prometheus ``le`` (<=) semantics plus
    an overflow bucket. Percentiles come from the cumulative bucket counts
    with linear interpolation inside the landing bucket, clamped to the
    observed [min, max] — the classic fixed-bucket estimator, accurate to
    one bucket width (the test suite holds it to that against numpy)."""

    kind = 'histogram'

    def __init__(self, name: str, buckets: Sequence[float] = LATENCY_BUCKETS_S,
                 help: str = ''):
        if not buckets:
            raise ValueError(f'{name}: need at least one bucket bound')
        self.name = name
        self.help = help
        self.bounds: Tuple[float, ...] = tuple(sorted(float(b)
                                                      for b in buckets))
        self.counts: List[int] = [0] * (len(self.bounds) + 1)
        self.count = 0
        self.sum = 0.0
        self.vmin = math.inf
        self.vmax = -math.inf

    def observe(self, value: float) -> None:
        v = float(value)
        self.counts[bisect.bisect_left(self.bounds, v)] += 1
        self.count += 1
        self.sum += v
        self.vmin = min(self.vmin, v)
        self.vmax = max(self.vmax, v)

    def percentile(self, q: float) -> Optional[float]:
        """q in [0, 1] -> estimated quantile, None when empty."""
        if self.count == 0:
            return None
        rank = q * self.count
        cum = 0
        for i, c in enumerate(self.counts):
            if c and cum + c >= rank:
                lo = self.bounds[i - 1] if i > 0 else min(0.0, self.vmin)
                hi = self.bounds[i] if i < len(self.bounds) else self.vmax
                est = lo + max(rank - cum, 0.0) / c * (hi - lo)
                return min(max(est, self.vmin), self.vmax)
            cum += c
        return self.vmax

    def snapshot(self) -> dict:
        d = dict(type=self.kind, help=self.help, count=self.count,
                 sum=self.sum)
        if self.count:
            d.update(mean=self.sum / self.count, min=self.vmin,
                     max=self.vmax, p50=self.percentile(0.50),
                     p90=self.percentile(0.90), p99=self.percentile(0.99))
        # only the occupied buckets — snapshots stay readable
        d['buckets'] = [
            [self.bounds[i] if i < len(self.bounds) else 'inf', c]
            for i, c in enumerate(self.counts) if c]
        return d

    def render(self) -> List[str]:
        lines = [f'# HELP {self.name} {self.help}',
                 f'# TYPE {self.name} histogram']
        cum = 0
        for i, b in enumerate(self.bounds):
            cum += self.counts[i]
            lines.append(f'{self.name}_bucket{{le="{b}"}} {cum}')
        lines.append(f'{self.name}_bucket{{le="+Inf"}} {self.count}')
        lines.append(f'{self.name}_sum {_fmt(self.sum)}')
        lines.append(f'{self.name}_count {self.count}')
        return lines


class MetricsRegistry:
    """Insertion-ordered registry of named metrics. ``counter`` /
    ``gauge`` / ``histogram`` are get-or-create (re-registration with a
    different type raises) so every layer can reach its metrics by name."""

    def __init__(self):
        self._metrics: Dict[str, Any] = {}

    def _get_or_create(self, cls, name, **kw):
        m = self._metrics.get(name)
        if m is None:
            m = self._metrics[name] = cls(name, **kw)
        elif not isinstance(m, cls):
            raise ValueError(f'{name} already registered as {m.kind}')
        return m

    def counter(self, name: str, help: str = '',
                labels: Sequence[str] = ()) -> Counter:
        return self._get_or_create(Counter, name, help=help, labels=labels)

    def gauge(self, name: str, help: str = '',
              labels: Sequence[str] = ()) -> Gauge:
        return self._get_or_create(Gauge, name, help=help, labels=labels)

    def histogram(self, name: str,
                  buckets: Sequence[float] = LATENCY_BUCKETS_S,
                  help: str = '') -> Histogram:
        return self._get_or_create(Histogram, name, buckets=buckets,
                                   help=help)

    def get(self, name: str):
        return self._metrics.get(name)

    def snapshot(self) -> Dict[str, dict]:
        return {name: m.snapshot() for name, m in self._metrics.items()}

    def render_prometheus(self) -> str:
        lines: List[str] = []
        for m in self._metrics.values():
            lines.extend(m.render())
        return '\n'.join(lines) + '\n'


# ----------------------------------------------------------------------------
# request-lifecycle spans from the event log
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class RequestSpan:
    """One request's lifecycle, derived purely from its EventLog records.

    Definitions (all seconds, from the log's monotonic ``t`` stamps):

    * ``queue_wait_s`` — submit -> first admit (None: never admitted).
    * ``prefill_s``    — the *final* admission's prefill duration (the
      serve loop annotates each admit event with it after the prefill
      returns).
    * ``ttft_s``       — submit -> first generated token = first admit's
      ``t`` + that admission's prefill (retries discard earlier tokens,
      but the user saw the first one when it was produced).
    * ``itl_s``        — mean inter-token gap over the final service
      period: (terminal ``t`` - last admit's first-token time) /
      (tokens - 1). Finished requests with >= 2 tokens only.
    * ``service_s``    — submit -> terminal event.
    """
    rid: int
    terminal: str
    submit_t: float
    service_s: float
    tokens: int = 0
    admits: int = 0
    retries: int = 0
    quarantines: int = 0
    preempts: int = 0
    queue_wait_s: Optional[float] = None
    prefill_s: Optional[float] = None
    ttft_s: Optional[float] = None
    itl_s: Optional[float] = None


def derive_request_spans(events: Iterable) -> List[RequestSpan]:
    """Bridge an :class:`runtime.faults.EventLog` (or its ``records()``
    dicts) into per-request :class:`RequestSpan` rows. Requests without a
    terminal event are skipped (the accounting audit catches those)."""
    per: Dict[int, List[dict]] = {}
    for e in events:
        r = e.to_dict() if hasattr(e, 'to_dict') else dict(e)
        if r.get('rid') is not None:
            per.setdefault(int(r['rid']), []).append(r)
    spans: List[RequestSpan] = []
    for rid, evs in sorted(per.items()):
        subs = [e for e in evs if e['kind'] == 'submit']
        terms = [e for e in evs if e['kind'] in TERMINAL_KINDS]
        if not subs or not terms:
            continue
        t0, term = subs[0]['t'], terms[-1]
        admits = [e for e in evs if e['kind'] == 'admit']
        sp = RequestSpan(
            rid=rid, terminal=term['kind'], submit_t=t0,
            service_s=max(term['t'] - t0, 0.0),
            admits=len(admits),
            retries=sum(e['kind'] == 'retry' for e in evs),
            quarantines=sum(e['kind'] == 'quarantine' for e in evs),
            preempts=sum(e['kind'] == 'preempt' for e in evs))
        if admits:
            first, last = admits[0], admits[-1]
            sp.queue_wait_s = max(first['t'] - t0, 0.0)
            sp.prefill_s = last.get('prefill_s')
            sp.ttft_s = max(first['t'] + (first.get('prefill_s') or 0.0)
                            - t0, 0.0)
        if term['kind'] == 'finish':
            sp.tokens = int(term.get('tokens', 0))
            if sp.tokens > 1 and admits:
                dec = term['t'] - (admits[-1]['t']
                                   + (admits[-1].get('prefill_s') or 0.0))
                sp.itl_s = max(dec, 0.0) / (sp.tokens - 1)
        spans.append(sp)
    return spans


def observe_spans(reg: MetricsRegistry,
                  spans: Iterable[RequestSpan]) -> None:
    """Emit span latencies into the registry's histograms/counters — the
    'at terminal events' half of the metric catalog. (``serve_prefill_
    seconds`` is observed live per admission by :class:`ServeTelemetry`,
    covering retried admissions too, so it is not re-observed here.)"""
    qw = reg.histogram('serve_queue_wait_seconds',
                       help='submit -> first admission')
    ttft = reg.histogram('serve_ttft_seconds',
                         help='submit -> first generated token')
    itl = reg.histogram('serve_itl_seconds',
                        help='mean inter-token gap, final service period')
    svc = reg.histogram('serve_service_seconds',
                        help='submit -> terminal event')
    rt = reg.histogram('serve_retries_per_request', buckets=COUNT_BUCKETS,
                       help='requeues (preempt+quarantine) per request')
    term_c = reg.counter('serve_requests_total', labels=('terminal',),
                         help='requests by terminal kind')
    tok_c = reg.counter('serve_tokens_out_total',
                        help='tokens delivered by finished requests')
    for s in spans:
        term_c.inc(terminal=s.terminal)
        svc.observe(s.service_s)
        rt.observe(s.retries)
        if s.queue_wait_s is not None:
            qw.observe(s.queue_wait_s)
        if s.ttft_s is not None:
            ttft.observe(s.ttft_s)
        if s.itl_s is not None:
            itl.observe(s.itl_s)
        if s.terminal == 'finish':
            tok_c.inc(s.tokens)


# ----------------------------------------------------------------------------
# live energy / traffic metering (the hwmodel bridge)
# ----------------------------------------------------------------------------
class EnergyMeter:
    """Prices each decode step's *actual* batch through ``core.hwmodel``.

    Per active lane per step, the attention cost is one
    ``decode_kv_traffic`` (GQA) or ``decode_latent_traffic`` (MLA) call at
    the lane's live length, with ``cold_blocks=`` the scheduler tier
    tracker's real int8 residency (fresh admissions and dropped quantize
    chunks make it differ from the rule-derived steady state), times the
    attention-layer count. Accumulated totals give the run's achieved
    bytes/token and effective TOPS/W (ops / pJ) of the modelled design:

    * ``kv_quant`` runs report the tiered columns (hot fp bytes from the
      SRAM tier, cold int8 bytes from bulk, IMC arithmetic);
    * untiered runs report the baseline columns (everything fp from bulk,
      digital arithmetic): ``achieved == baseline`` by construction.

    The meter is bookkeeping, not a model: it prices exactly as direct
    hwmodel calls do (the tests hold it to equality). Layers split as the
    reference's: a pure SSM has no attention layer, a hybrid one a
    ``hybrid_group``; their Mamba2 layers price the fp read and write of
    the recurrent state (``decode_state_traffic``) every token, tiered or
    not (the state keeps no int8 tier).
    """

    _KEYS = ('tokens', 'hot_bytes', 'cold_bytes', 'achieved_bytes',
             'baseline_bytes', 'achieved_pj', 'baseline_pj', 'ops',
             'shared_saved_bytes', 'shared_saved_pj')

    def __init__(self, cfg, *, page_size: int, kv_quant: bool = False,
                 hot_window: int = 1, fp_bytes: int = 2, tp: int = 1,
                 tier: hwmodel.KVTierConfig = hwmodel.DEFAULT_KV_TIER):
        self.kv_quant = bool(kv_quant)
        self.tier = tier
        self.tp = max(int(tp), 1)
        self.page_size = page_size
        self.hot_window = max(int(hot_window), 1)
        self.fp_bytes = fp_bytes
        # layer split: hybrid groups share one attention site a group; a
        # pure SSM has no attention cache at all
        if cfg.family == 'ssm':
            self.n_attn = 0
        elif cfg.hybrid_group:
            self.n_attn = cfg.n_layers // cfg.hybrid_group
        else:
            self.n_attn = cfg.n_layers
        self.n_mamba = (cfg.n_layers - self.n_attn
                        if cfg.family in ('ssm', 'hybrid') else 0)
        self.is_mla = cfg.mla is not None
        if self.is_mla:
            m = cfg.mla
            self._kv_kw = dict(n_heads=cfg.n_heads,
                               latent_dim=m.kv_lora_rank + m.rope_head_dim,
                               kv_lora_rank=m.kv_lora_rank)
            # per-block fetch cost, mirroring decode_latent_traffic: the
            # latent row is fetched once; one absmax scale per cold page
            self._elems_per_block = page_size * (m.kv_lora_rank
                                                 + m.rope_head_dim)
            self._cold_scale_b = tier.scale_bytes
        else:
            self._kv_kw = dict(n_heads=cfg.n_heads,
                               n_kv_heads=cfg.n_kv_heads,
                               head_dim=cfg.resolved_head_dim)
            # per-block fetch cost, mirroring decode_kv_traffic: K and V
            # rows; per-head K/V absmax scales per cold page
            self._elems_per_block = (page_size * cfg.n_kv_heads
                                     * cfg.resolved_head_dim * 2)
            self._cold_scale_b = cfg.n_kv_heads * 2 * tier.scale_bytes
        self._state: Optional[dict] = None
        if self.n_mamba:
            from repro_torch.models.ssm import dims as ssm_dims
            s, dm = cfg.ssm, ssm_dims(cfg)
            self._state = hwmodel.decode_state_traffic(
                conv_elems=(s.conv_width - 1) * dm['conv_dim'],
                ssm_elems=dm['n_heads'] * s.head_dim * s.d_state,
                n_heads=dm['n_heads'], n_layers=self.n_mamba, tier=tier)
        self._price_cache: Dict[Tuple[int, int], dict] = {}
        self.totals_raw: Dict[str, float] = {k: 0.0 for k in self._KEYS}

    def _price_lane(self, s_live: int, cold_blocks: int) -> dict:
        # memoized: lanes in lock-step waves revisit the same (length,
        # residency) points constantly, and pricing is pure
        r = self._price_cache.get((s_live, cold_blocks))
        if r is None:
            kw = dict(self._kv_kw, page_size=self.page_size,
                      hot_window=self.hot_window, fp_bytes=self.fp_bytes,
                      tier=self.tier, cold_blocks=cold_blocks)
            r = (hwmodel.decode_latent_traffic(s_live, **kw)
                 if self.is_mla else hwmodel.decode_kv_traffic(s_live, **kw))
            self._price_cache[(s_live, cold_blocks)] = r
        return r

    def observe_step(self, lanes: Iterable[Tuple[int, int]], *,
                     dup_hot_blocks: int = 0,
                     dup_cold_blocks: int = 0) -> dict:
        """Account one decode step. ``lanes`` is ``(s_live, cold_blocks)``
        per active slot — ``s_live`` the position count the step attends
        over (write pos + 1), ``cold_blocks`` the tier tracker's quantized
        residency (0 when untiered). Returns this step's increments.

        ``dup_hot_blocks`` / ``dup_cold_blocks`` are this step's
        *duplicate* physical-page reads under prefix sharing: instances
        beyond the first lane reading the same page (per tier). A shared
        page is fetched once and attended by every owner, so duplicate
        fetches are refunded from the achieved bytes/pJ — arithmetic
        (``ops``) is NOT discounted (every lane still runs its own
        attention over those positions), and the baseline columns price
        the unshared pool a private-pages run would have read."""
        inc = {k: 0.0 for k in self._KEYS}
        for s_live, cold in lanes:
            inc['tokens'] += 1
            if self.n_attn:
                r = self._price_lane(int(s_live),
                                     int(cold) if self.kv_quant else 0)
                n = self.n_attn
                inc['baseline_bytes'] += r['baseline_bytes_per_token'] * n
                inc['baseline_pj'] += r['baseline_pj_per_token'] * n
                inc['ops'] += r['ops_per_token'] * n
                if self.kv_quant:
                    inc['hot_bytes'] += r['hot_bytes_per_token'] * n
                    inc['cold_bytes'] += r['cold_bytes_per_token'] * n
                    inc['achieved_bytes'] += r['tiered_bytes_per_token'] * n
                    inc['achieved_pj'] += r['tiered_pj_per_token'] * n
                else:
                    inc['hot_bytes'] += r['baseline_bytes_per_token'] * n
                    inc['achieved_bytes'] += r['baseline_bytes_per_token'] * n
                    inc['achieved_pj'] += r['baseline_pj_per_token'] * n
            if self._state is not None:
                # recurrent state stays fp: achieved and baseline both
                # price its fp read and write
                st = self._state
                for key in ('hot_bytes', 'achieved_bytes', 'baseline_bytes'):
                    inc[key] += st['baseline_bytes_per_token']
                inc['achieved_pj'] += st['baseline_pj_per_token']
                inc['baseline_pj'] += st['baseline_pj_per_token']
                inc['ops'] += st['ops_per_token']
        if self.n_attn and (dup_hot_blocks or dup_cold_blocks):
            n = self.n_attn
            hot_b = dup_hot_blocks * self._elems_per_block * self.fp_bytes * n
            if self.kv_quant:
                cold_b = dup_cold_blocks * (self._elems_per_block
                                            + self._cold_scale_b) * n
                saved_pj = (hot_b * self.tier.sram_pj_per_byte
                            + cold_b * self.tier.hbm_pj_per_byte)
                inc['cold_bytes'] -= cold_b
            else:
                # untiered: every duplicate is an fp block from bulk
                cold_b = 0.0
                saved_pj = hot_b * self.tier.hbm_pj_per_byte
            inc['hot_bytes'] -= hot_b
            inc['achieved_bytes'] -= hot_b + cold_b
            inc['achieved_pj'] -= saved_pj
            inc['shared_saved_bytes'] += hot_b + cold_b
            inc['shared_saved_pj'] += saved_pj
        for k, v in inc.items():
            self.totals_raw[k] += v
        return inc

    def totals(self) -> dict:
        t = dict(self.totals_raw)
        tok = max(t['tokens'], 1.0)
        out = dict(
            tokens=int(t['tokens']),
            kv_quant=self.kv_quant,
            n_attn_layers=self.n_attn,
            n_mamba_layers=self.n_mamba,
            hot_bytes=t['hot_bytes'],
            cold_bytes=t['cold_bytes'],
            achieved_bytes=t['achieved_bytes'],
            baseline_bytes=t['baseline_bytes'],
            achieved_pj=t['achieved_pj'],
            baseline_pj=t['baseline_pj'],
            ops=t['ops'],
            shared_saved_bytes=t['shared_saved_bytes'],
            shared_saved_pj=t['shared_saved_pj'],
            achieved_bytes_per_token=t['achieved_bytes'] / tok,
            baseline_bytes_per_token=t['baseline_bytes'] / tok,
            bytes_reduction=t['baseline_bytes'] / max(t['achieved_bytes'],
                                                      1.0),
            achieved_pj_per_token=t['achieved_pj'] / tok,
            baseline_pj_per_token=t['baseline_pj'] / tok,
            energy_reduction=t['baseline_pj'] / max(t['achieved_pj'], 1e-12),
            # 1 TOPS/W == 1 op/pJ: what this run's mem+compute pJ bought
            effective_tops_w=t['ops'] / max(t['achieved_pj'], 1e-12),
            baseline_tops_w=t['ops'] / max(t['baseline_pj'], 1e-12),
            paper=dict(ima_tops_w=hwmodel.energy_efficiency_tops_w(),
                       digital_tops_w=self.tier.digital_tops_w,
                       core_tops=hwmodel.throughput_tops()),
        )
        if self.tp > 1:
            # the meter prices the host-global tier tracker, which never
            # shards, so the columns above are the one-device figures; this
            # splits them per shard. GQA: every byte and op lands on one
            # shard (dividing then multiplying by a power of two is
            # exact). MLA: each rank reads the whole replicated latent
            # pool, so only the per-head ops divide
            ways = self.tp
            sharded = not self.is_mla
            byte_pj_keys = ('hot_bytes', 'cold_bytes', 'achieved_bytes',
                            'baseline_bytes', 'achieved_pj', 'baseline_pj')
            per_shard = {k: (t[k] / ways if sharded else t[k])
                         for k in byte_pj_keys}
            per_shard['ops'] = t['ops'] / ways
            per_shard['tokens'] = int(t['tokens'])
            agg = {k: per_shard[k] * ways if sharded else per_shard[k]
                   for k in byte_pj_keys}
            agg['ops'] = per_shard['ops'] * ways
            out['tp'] = dict(
                ways=ways,
                latent_replicated=self.is_mla,
                per_shard=per_shard,
                aggregate=agg,
                redundant_bytes=(t['achieved_bytes'] * (ways - 1)
                                 if self.is_mla else 0.0),
            )
        return out


# ----------------------------------------------------------------------------
# Chrome-trace / Perfetto step tracer
# ----------------------------------------------------------------------------
class StepTracer:
    """Buffered Chrome-trace JSON writer (the ``--trace FILE`` surface).

    Track layout: ``tid 0`` is the scheduler (quantize/scrub/degrade
    phases, fault instants without a slot); ``tid slot+1`` is one decode
    lane (prefill and decode spans, per-slot fault instants). All events
    are complete (``ph='X'``) spans or instants (``ph='i'``) — no B/E
    pairing to unbalance. Timestamps are µs relative to construction."""

    def __init__(self, path: str, slots: int,
                 clock=time.perf_counter):
        self.path = path
        self.clock = clock
        self.t0 = clock()
        self.events: List[dict] = [
            dict(ph='M', name='process_name', pid=0, tid=0,
                 args=dict(name='repro_torch.serve')),
            dict(ph='M', name='thread_name', pid=0, tid=0,
                 args=dict(name='scheduler')),
        ]
        for s in range(slots):
            self.events.append(dict(ph='M', name='thread_name', pid=0,
                                    tid=s + 1, args=dict(name=f'slot {s}')))

    def _us(self, t: float) -> float:
        return round((t - self.t0) * 1e6, 3)

    def span(self, name: str, t_start: float, t_end: float, *,
             slot: Optional[int] = None, **args) -> None:
        self.events.append(dict(
            ph='X', name=name, pid=0,
            tid=0 if slot is None else slot + 1,
            ts=self._us(t_start),
            dur=round(max(t_end - t_start, 0.0) * 1e6, 3),
            args=args))

    def instant(self, name: str, t: float, *,
                slot: Optional[int] = None, **args) -> None:
        self.events.append(dict(
            ph='i', s='g', name=name, pid=0,
            tid=0 if slot is None else slot + 1,
            ts=self._us(t), args=args))

    def close(self) -> None:
        with open(self.path, 'w') as f:
            json.dump(dict(traceEvents=self.events,
                           displayTimeUnit='ms'), f)


# ----------------------------------------------------------------------------
# the serving bundle
# ----------------------------------------------------------------------------
#: event kinds that also become trace instants (faults and recoveries)
_TRACE_INSTANTS = frozenset({'fault', 'degrade', 'quarantine', 'preempt',
                             'retry', 'cancel'})


class ServeTelemetry:
    """Everything ``serve_continuous`` needs, behind one object: the
    registry, the energy meter, the optional tracer, and the EventLog
    subscription. Constructed with ``metrics=False`` it only traces (the
    ``--no-metrics --trace X`` combination); the serve loop skips all
    calls when neither is requested."""

    def __init__(self, cfg, *, slots: int, page_size: int,
                 kv_quant: bool = False, hot_window: int = 1, tp: int = 1,
                 metrics: bool = True, trace_path: Optional[str] = None,
                 registry: Optional[MetricsRegistry] = None,
                 clock=time.perf_counter):
        self.metrics = bool(metrics)
        self.clock = clock
        self.reg = registry if registry is not None else MetricsRegistry()
        self.meter = (EnergyMeter(cfg, page_size=page_size,
                                  kv_quant=kv_quant, hot_window=hot_window,
                                  tp=tp)
                      if self.metrics else None)
        self.tracer = (StepTracer(trace_path, slots, clock=clock)
                       if trace_path else None)
        self._t_step0: Optional[float] = None
        self._logit_max = None   # device scalar, host-transferred at finish
        if self.metrics:
            self._declare_catalog()

    def _declare_catalog(self) -> None:
        """Pre-register the whole metric catalog so snapshots carry the
        stable schema even for runs that never hit a path (README pins
        the names) — and keep direct handles so the per-step hooks skip
        the registry lookup and label validation (``inc_at``/``set_at``:
        the label tuples below ARE the validation, done once here)."""
        r = self.reg
        self._c_events = r.counter(
            'serve_events_total', labels=('kind',),
            help='EventLog records by kind (incremented at emit)')
        self._c_faults = r.counter(
            'serve_faults_total', labels=('fault',),
            help='applied injected faults by kind')
        r.counter('serve_requests_total', labels=('terminal',),
                  help='requests by terminal kind')
        r.counter('serve_tokens_out_total',
                  help='tokens delivered by finished requests')
        self._c_pquant = r.counter(
            'serve_pages_quantized_total',
            help='pages aged into the int8 tier')
        self._c_kvb = r.counter(
            'serve_kv_bytes_total', labels=('tier',),
            help='decode cache bytes by residency tier '
                 '(hot=fp, cold=int8+scales; untiered runs are all hot)')
        self._c_pj = r.counter(
            'serve_energy_pj_total', labels=('path',),
            help='modeled decode energy, achieved vs baseline')
        self._c_ops = r.counter(
            'serve_attn_ops_total',
            help='modeled attention/state MACs+adds')
        self._c_phase = r.counter(
            'serve_phase_seconds_total', labels=('phase',),
            help='cumulative wall time by maintenance phase')
        self._g_step = r.gauge('serve_step', help='current scheduler step')
        self._g_slots = r.gauge(
            'serve_slots', labels=('state',),
            help='decode lanes by state (active/free)')
        self._g_queue = r.gauge('serve_queue_depth',
                                help='pending requests')
        self._g_pages = r.gauge(
            'serve_pages', labels=('state',),
            help='pool pages by state (free/reserved/owned)')
        self._g_cold = r.gauge('serve_cold_pages',
                               help='pages resident in the int8 tier')
        self._c_prefix = r.counter(
            'serve_prefix_events_total', labels=('event',),
            help='prefix-cache outcomes '
                 '(hit/miss/evict/cow, deltas of the allocator counters)')
        self._prefix_last = dict(hit=0, miss=0, evict=0, cow=0)
        self._g_lmax = r.gauge(
            'serve_logits_max_abs',
            help='max |logit| this step (drift sentinel)')
        self._h_step = r.histogram('serve_step_seconds',
                                   help='scheduler step wall time')
        self._h_prefill = r.histogram(
            'serve_prefill_seconds',
            help='prefill per admission (retries included)')
        observe_spans(self.reg, ())     # declare the span histograms too

    # -- EventLog bridge -----------------------------------------------------
    def attach(self, events) -> None:
        """Subscribe to a ``runtime.faults.EventLog``: every emitted event
        counts into ``serve_events_total{kind}`` (and
        ``serve_faults_total{fault}``) the moment it happens, and fault/
        recovery kinds drop instants onto the trace."""
        events.subscribe(self._on_event)

    def _on_event(self, ev) -> None:
        if self.metrics:
            self._c_events.inc_at((ev.kind,))
            if ev.kind == 'fault':
                self._c_faults.inc_at(
                    (ev.detail.get('fault', 'unknown'),))
        if self.tracer is not None and ev.kind in _TRACE_INSTANTS:
            name = ev.kind if ev.kind != 'fault' \
                else f"fault:{ev.detail.get('fault', '?')}"
            self.tracer.instant(name, ev.t, slot=ev.slot,
                                **({'rid': ev.rid} if ev.rid is not None
                                   else {}))

    # -- per-step hooks the serve loop calls ---------------------------------
    def begin_step(self, step: int, t: float) -> None:
        self._t_step0 = t
        if self.metrics:
            self._g_step.set_at((), step)

    def prefill(self, *, rid: int, slot: int, t_start: float,
                t_end: float) -> None:
        if self.metrics:
            self._h_prefill.observe(t_end - t_start)
        if self.tracer is not None:
            self.tracer.span('prefill', t_start, t_end, slot=slot, rid=rid)

    def phase(self, name: str, t_start: float, t_end: float,
              **args) -> None:
        """Scheduler-track maintenance phase (quantize/scrub/degrade)."""
        if self.metrics:
            self._c_phase.inc_at((name,), t_end - t_start)
            if name == 'quantize' and args.get('pages'):
                self._c_pquant.inc_at((), args['pages'])
        if self.tracer is not None:
            self.tracer.span(name, t_start, t_end, **args)

    def sample(self, sched, kv) -> None:
        """Once per step, pre-decode: scheduler/allocator gauges and the
        energy meter over the actual batch composition."""
        if not self.metrics:
            return
        g = self._g_slots
        g.set_at(('active',), len(sched.active))
        g.set_at(('free',), len(sched.free_slots))
        self._g_queue.set_at((), len(sched.pending))
        occ = kv.occupancy()
        p = self._g_pages
        p.set_at(('free',), occ['free'])
        p.set_at(('reserved',), occ['reserved'])
        p.set_at(('owned',), occ['owned'])
        p.set_at(('cached',), occ.get('cached', 0))
        p.set_at(('shared',), occ.get('shared', 0))
        tier = getattr(sched, 'tier', None)
        res = tier.residency() if tier is not None else {}
        self._g_cold.set_at((), sum(res.values()))
        lanes = [(st.pos + 1, res.get(slot, 0))
                 for slot, st in sched.active.items()]
        dup_hot = dup_cold = 0
        if getattr(kv, 'prefix_cache', False):
            c = self._c_prefix
            last = self._prefix_last
            for ev, now in (('hit', kv.prefix_hits),
                            ('miss', kv.prefix_misses),
                            ('evict', kv.prefix_evictions),
                            ('cow', kv.cow_copies)):
                if now > last[ev]:
                    c.inc_at((ev,), now - last[ev])
                    last[ev] = now
            # duplicate physical-page reads this step: each shared page
            # is fetched once, every further owner's read is coalesced —
            # the meter refunds those fetches (cold iff the instance sits
            # inside its lane's quantized residency)
            seen = set()
            ps = kv.page_size
            for slot, st in sched.active.items():
                nb = min(-(-(st.pos + 1) // ps), int(kv.counts[slot]))
                cold_n = res.get(slot, 0)
                row = kv.tables[slot]
                for i in range(nb):
                    page = int(row[i])
                    if page in seen:
                        if i < cold_n:
                            dup_cold += 1
                        else:
                            dup_hot += 1
                    else:
                        seen.add(page)
        inc = self.meter.observe_step(lanes, dup_hot_blocks=dup_hot,
                                      dup_cold_blocks=dup_cold)
        kvb = self._c_kvb
        kvb.inc_at(('hot',), inc['hot_bytes'])
        kvb.inc_at(('cold',), inc['cold_bytes'])
        if inc['shared_saved_bytes']:
            kvb.inc_at(('shared_saved',), inc['shared_saved_bytes'])
        pj = self._c_pj
        pj.inc_at(('achieved',), inc['achieved_pj'])
        pj.inc_at(('baseline',), inc['baseline_pj'])
        self._c_ops.inc_at((), inc['ops'])

    def decode(self, t_start: float, t_end: float,
               active_slots: Iterable[int]) -> None:
        if self.tracer is not None:
            for slot in active_slots:
                self.tracer.span('decode', t_start, t_end, slot=slot)

    def logits_gauge(self, max_abs) -> None:
        """Takes the sentinel's max-|logit| as-is: a device scalar stays
        on the device, and the one host transfer happens in
        :meth:`finish`, not per step (a per-step ``float()`` would wait for
        the step and cost more than the rest of the instrumentation)."""
        if self.metrics:
            self._logit_max = max_abs

    def step_done(self, t_end: float) -> None:
        if self.metrics and self._t_step0 is not None:
            self._h_step.observe(t_end - self._t_step0)

    # -- finalization --------------------------------------------------------
    def finish(self, events) -> Optional[dict]:
        """Derive the lifecycle spans from the (timestamped) log, emit
        them into the histograms, and return the full snapshot dict
        (``None`` with ``metrics=False``)."""
        if not self.metrics:
            return None
        if self._logit_max is not None:
            self._g_lmax.set_at((), float(self._logit_max))
        spans = derive_request_spans(events)
        observe_spans(self.reg, spans)
        return dict(metrics=self.reg.snapshot(),
                    energy=self.meter.totals(),
                    spans=len(spans))

    def close_trace(self) -> Optional[str]:
        if self.tracer is None:
            return None
        self.tracer.close()
        return self.tracer.path


def summarize(snapshot: Optional[dict]) -> Optional[dict]:
    """Compact one-row view of a :meth:`ServeTelemetry.finish` snapshot —
    what the benchmarks embed next to their timing rows."""
    if not snapshot:
        return None
    m = snapshot.get('metrics') or {}
    e = snapshot.get('energy') or {}

    def pct(name, p):
        v = (m.get(name) or {}).get(p)
        return None if v is None else round(v, 6)

    return dict(
        ttft_p50_s=pct('serve_ttft_seconds', 'p50'),
        ttft_p99_s=pct('serve_ttft_seconds', 'p99'),
        itl_p50_s=pct('serve_itl_seconds', 'p50'),
        itl_p99_s=pct('serve_itl_seconds', 'p99'),
        queue_wait_p90_s=pct('serve_queue_wait_seconds', 'p90'),
        step_p50_s=pct('serve_step_seconds', 'p50'),
        tokens=e.get('tokens'),
        achieved_bytes_per_token=round(e['achieved_bytes_per_token'], 1)
        if e else None,
        shared_saved_bytes=round(e.get('shared_saved_bytes', 0.0), 1)
        if e else None,
        baseline_bytes_per_token=round(e['baseline_bytes_per_token'], 1)
        if e else None,
        effective_tops_w=round(e['effective_tops_w'], 4) if e else None,
        baseline_tops_w=round(e['baseline_tops_w'], 4) if e else None,
        paper_ima_tops_w=round(e['paper']['ima_tops_w'], 1) if e else None,
    )
