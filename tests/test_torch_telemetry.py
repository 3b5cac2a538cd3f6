"""The port's telemetry and hardware model against the reference's
(``repro.runtime.telemetry``, ``repro.core.hwmodel``), with no model
involved except in the last test.

* ``core.hwmodel``: decode KV and latent traffic equal on a grid of
  (s_live, cold_blocks, page_size, hot_window), and the headline figures.
* ``EnergyMeter``: totals equal direct hwmodel calls (exactly) and the
  reference meter's on the same lane trace, with prefix-sharing refunds.
* ``MetricsRegistry``: the same observations give the same snapshot
  (percentiles included) and the same Prometheus text.
* ``derive_request_spans``: the same event records give the same spans.
* ``ServeTelemetry``: the logits gauge keeps its device scalar until
  ``finish``; the trace holds complete spans and instants only; and
  ``serve_continuous(metrics=False)`` builds no telemetry at all."""

import dataclasses
import json

import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import hwmodel as rhw
from repro.runtime import faults as rfaults
from repro.runtime import telemetry as rtel
from repro_torch import configs as tconfigs
from repro_torch.core import hwmodel as thw
from repro_torch.launch import serve as tserve
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import telemetry as ttel

GRID = [(s, cold, ps, hw) for s in (1, 7, 8, 9, 100, 4096)
        for cold in (None, 0, 3, 10 ** 6) for ps in (1, 8, 128)
        for hw in (1, 2, 5)]


def test_hwmodel_traffic_matches_reference_exactly():
    for s, cold, ps, hw in GRID:
        for fp in (2, 4):
            kw = dict(page_size=ps, hot_window=hw, fp_bytes=fp,
                      cold_blocks=cold)
            gqa = dict(n_heads=32, n_kv_heads=8, head_dim=64)
            assert thw.decode_kv_traffic(s, **gqa, **kw) == \
                rhw.decode_kv_traffic(s, **gqa, **kw)
            mla = dict(n_heads=128, latent_dim=576, kv_lora_rank=512)
            assert thw.decode_latent_traffic(s, **mla, **kw) == \
                rhw.decode_latent_traffic(s, **mla, **kw)
    assert thw.energy_efficiency_tops_w() == rhw.energy_efficiency_tops_w()
    assert thw.throughput_tops() == rhw.throughput_tops()
    assert dataclasses.asdict(thw.DEFAULT_KV_TIER) == \
        dataclasses.asdict(rhw.DEFAULT_KV_TIER)


def _lane_trace(seed=0, steps=40):
    rng = np.random.RandomState(seed)
    return [([(int(rng.randint(1, 300)), int(rng.randint(0, 40)))
              for _ in range(rng.randint(0, 5))],
             int(rng.randint(0, 3)), int(rng.randint(0, 3)))
            for _ in range(steps)]


@pytest.mark.parametrize('arch', ['stablelm-1.6b', 'deepseek-v3-671b',
                                  'qwen2-moe-a2.7b'])
@pytest.mark.parametrize('kv_quant', [False, True])
def test_energy_meter_equals_hwmodel_and_reference(arch, kv_quant):
    tcfg = tconfigs.get(arch, smoke=True)
    rcfg = rconfigs.get(arch, smoke=True)
    kw = dict(page_size=8, kv_quant=kv_quant, hot_window=2)
    got, want = ttel.EnergyMeter(tcfg, **kw), rtel.EnergyMeter(rcfg, **kw)
    direct = dict(tokens=0.0, achieved_bytes=0.0, achieved_pj=0.0,
                  baseline_pj=0.0, ops=0.0)
    for lanes, dup_hot, dup_cold in _lane_trace():
        a = got.observe_step(lanes, dup_hot_blocks=dup_hot,
                             dup_cold_blocks=dup_cold)
        b = want.observe_step(lanes, dup_hot_blocks=dup_hot,
                              dup_cold_blocks=dup_cold)
        assert a == b
        if dup_hot or dup_cold:
            continue
        for s_live, cold in lanes:
            m = tcfg.mla
            price = (thw.decode_latent_traffic(
                s_live, n_heads=tcfg.n_heads,
                latent_dim=m.kv_lora_rank + m.rope_head_dim,
                kv_lora_rank=m.kv_lora_rank, page_size=8, hot_window=2,
                cold_blocks=cold if kv_quant else 0) if m else
                thw.decode_kv_traffic(
                s_live, n_heads=tcfg.n_heads, n_kv_heads=tcfg.n_kv_heads,
                head_dim=tcfg.resolved_head_dim, page_size=8, hot_window=2,
                cold_blocks=cold if kv_quant else 0))
            n = tcfg.n_layers
            tier = 'tiered' if kv_quant else 'baseline'
            direct['tokens'] += 1
            direct['achieved_bytes'] += price[f'{tier}_bytes_per_token'] * n
            direct['achieved_pj'] += price[f'{tier}_pj_per_token'] * n
            direct['baseline_pj'] += price['baseline_pj_per_token'] * n
            direct['ops'] += price['ops_per_token'] * n
    assert got.totals() == want.totals()
    # the meter is bookkeeping: a trace without refunds equals direct calls
    fresh = ttel.EnergyMeter(tcfg, **kw)
    for lanes, dup_hot, dup_cold in _lane_trace():
        if not (dup_hot or dup_cold):
            fresh.observe_step(lanes)
    for key, v in direct.items():
        assert fresh.totals_raw[key] == v, key


def test_energy_meter_refuses_recurrent_families():
    """The meter no longer refuses SSM and hybrid configs: it splits their
    layers as the reference's does (no attention layer in a pure SSM, one
    a ``hybrid_group`` in a hybrid) and prices the recurrent state, equal
    to the reference's meter on the same lane trace."""
    for arch, split in (('mamba2-780m', (0, 48)), ('zamba2-1.2b', (6, 32))):
        for kv_quant in (False, True):
            kw = dict(page_size=8, kv_quant=kv_quant, hot_window=2)
            got = ttel.EnergyMeter(tconfigs.get(arch), **kw)
            want = rtel.EnergyMeter(rconfigs.get(arch), **kw)
            assert (got.n_attn, got.n_mamba) == split
            for lanes, _, _ in _lane_trace(seed=1, steps=10):
                assert got.observe_step(lanes) == want.observe_step(lanes)
            assert got.totals() == want.totals()


def _fill(mod, values):
    reg = mod.MetricsRegistry()
    c = reg.counter('serve_events_total', labels=('kind',), help='events')
    g = reg.gauge('serve_pages', labels=('state',), help='pages')
    h = reg.histogram('serve_step_seconds', help='step')
    k = reg.histogram('serve_retries', buckets=mod.COUNT_BUCKETS, help='r')
    reg.counter('serve_tokens_out_total', help='tokens')
    for i, v in enumerate(values):
        c.inc(kind=('admit', 'finish', 'fault')[i % 3])
        g.set(v * 10, state=('free', 'owned')[i % 2])
        h.observe(v)
        k.observe(i % 13)
    return reg


@pytest.mark.parametrize('seed', [0, 1])
def test_registry_percentiles_and_prometheus_match_reference(seed):
    values = np.random.RandomState(seed).lognormal(-6, 2, 500).tolist()
    got, want = _fill(ttel, values), _fill(rtel, values)
    assert got.snapshot() == want.snapshot()
    assert got.render_prometheus() == want.render_prometheus()
    h = got.get('serve_step_seconds')
    for q in (0.5, 0.9, 0.99):
        est = h.percentile(q)
        i = int(np.searchsorted(h.bounds, np.quantile(values, q)))
        lo = h.bounds[i - 1] if i > 0 else 0.0
        hi = h.bounds[i] if i < len(h.bounds) else max(values)
        assert lo <= est <= hi          # one bucket width, as documented
    assert ttel.MetricsRegistry().histogram('x').percentile(0.5) is None


def _log(mod):
    t = iter(np.arange(0.0, 100.0, 0.25).tolist())
    log = mod.EventLog(clock=t.__next__)
    for rid in range(4):
        log.emit('submit', step=0, rid=rid, plen=5, gen=4)
    log.emit('admit', step=0, rid=0, slot=0)
    log.annotate_last('admit', 0, prefill_s=0.1)
    log.emit('admit', step=0, rid=1, slot=1)
    log.annotate_last('admit', 1, prefill_s=0.2)
    log.emit('reject', step=0, rid=3, reason='garbage_prompt')
    log.emit('fault', step=1, fault='poison_page', slot=1, rid=1)
    log.emit('evict', step=1, rid=1, slot=1, reason='quarantine')
    log.emit('quarantine', step=1, rid=1, slot=1)
    log.emit('retry', step=1, rid=1, attempt=1)
    log.emit('admit', step=2, rid=1, slot=1)
    log.annotate_last('admit', 1, prefill_s=0.05)
    log.emit('finish', step=3, rid=0, slot=0, tokens=4)
    log.emit('cancel', step=4, rid=2, where='pending')
    log.emit('finish', step=6, rid=1, slot=1, tokens=3)
    return log


def test_spans_from_the_same_records_match_reference():
    got = ttel.derive_request_spans(_log(tfaults))
    want = rtel.derive_request_spans(_log(rfaults))
    assert [dataclasses.asdict(s) for s in got] == \
        [dataclasses.asdict(s) for s in want]
    assert [s.terminal for s in got] == ['finish', 'finish', 'cancel',
                                         'reject']
    assert got[1].quarantines == 1 and got[1].retries == 1
    # from the records (dicts) as from the log
    assert ttel.derive_request_spans(_log(tfaults).records()) == got
    reg_t, reg_r = ttel.MetricsRegistry(), rtel.MetricsRegistry()
    ttel.observe_spans(reg_t, got)
    rtel.observe_spans(reg_r, want)
    assert reg_t.render_prometheus() == reg_r.render_prometheus()


def test_logits_gauge_keeps_the_device_scalar_until_finish(tmp_path):
    cfg = tconfigs.get('stablelm-1.6b', smoke=True)
    tel = ttel.ServeTelemetry(cfg, slots=2, page_size=8,
                              trace_path=str(tmp_path / 't.json'))
    log = tfaults.EventLog()
    tel.attach(log)
    scalar = torch.tensor(3.5)
    tel.logits_gauge(scalar)
    assert tel._logit_max is scalar            # held, not converted
    log.emit('submit', step=0, rid=0)
    log.emit('fault', step=0, fault='pool_squeeze', held=2)
    log.emit('reject', step=0, rid=0, reason='empty_prompt')
    snap = tel.finish(log)
    assert snap['metrics']['serve_logits_max_abs']['value'] == 3.5
    assert snap['metrics']['serve_events_total']['values'] == \
        {'fault': 1.0, 'reject': 1.0, 'submit': 1.0}
    trace = json.loads(open(tel.close_trace()).read())
    assert {e['ph'] for e in trace['traceEvents']} <= {'M', 'X', 'i'}
    assert any(e['name'] == 'fault:pool_squeeze'
               for e in trace['traceEvents'])


def test_metrics_off_strips_every_hook(monkeypatch):
    def refuse(*a, **k):
        raise AssertionError('telemetry built with metrics=False')
    monkeypatch.setattr(ttel, 'ServeTelemetry', refuse)
    out = tserve.serve_continuous('stablelm-1.6b', slots=2, n_requests=3,
                                  prompt_len=8, gen_len=3, page_size=4,
                                  metrics=False, device='cpu', quiet=True)
    assert out['completed'] == 3
    assert not {'telemetry', 'telemetry_summary', 'metrics_out',
                'trace'} & set(out)


def test_serve_fills_the_caller_registry():
    """A registry passed in is the one the serve loop fills: its own
    metrics stay, the loop's join them, and the report's snapshot is it."""
    reg = ttel.MetricsRegistry()
    reg.counter('app_requests_total', 'a metric of the caller').inc(2)
    out = tserve.serve_continuous('stablelm-1.6b', slots=2, n_requests=3,
                                  prompt_len=8, gen_len=3, page_size=4,
                                  registry=reg, device='cpu', quiet=True)
    assert out['completed'] == 3
    snap = reg.snapshot()
    assert snap['app_requests_total']['value'] == 2.0
    assert snap['serve_events_total']['values']['submit'] == 3.0
    assert out['telemetry']['metrics'] == snap


def test_max_steps_caps_the_serve_loop():
    """``max_steps`` bounds the loop: too few steps raise as stalled, as
    many as the run took serve it whole."""
    kw = dict(slots=2, n_requests=3, prompt_len=8, gen_len=6, page_size=4,
              metrics=False, device='cpu', quiet=True)
    full = tserve.serve_continuous('stablelm-1.6b', **kw)
    short = full['steps'] - 1
    with pytest.raises(RuntimeError, match=f'stalled after {short} steps'):
        tserve.serve_continuous('stablelm-1.6b', max_steps=short, **kw)
    capped = tserve.serve_continuous('stablelm-1.6b',
                                     max_steps=full['steps'], **kw)
    assert capped['outputs'] == full['outputs']
