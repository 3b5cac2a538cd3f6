"""Chaos serving, the port against the reference: ``serve_continuous`` on
stablelm smoke, f32 end to end, the same weights and request stream, each
side with its own ``FaultInjector`` of the same seed and schedule, and
``attn_impl='flash'`` on both (the reference's Pallas kernels in interpret
mode, the port's plain kernel versions).

One pair of runs a scheduled fault kind (pool squeeze, preemption storm,
poisoned page, poisoned logits row, dropped quantize chunk, cancellation,
mangled prompts) and one under the full chaos profile with the int8 tier
and the prefix cache. Each pair must give the same event records
(timestamps dropped), terminal map, fault counts, ``pages_quant_dropped``
and ``touched`` set, equal tokens for every request not in ``touched``,
and equal hardware-model energy totals; the port's metrics must count
exactly the event log. A ``kernel_fault`` the reference degrades on is
refused by the port (the degrade is not ported).

The reference NaNs a poisoned logits row in ``np.asarray(logits)``, a
read-only view when the logits are already f32 (its own chaos tests run
bf16, where the cast copies); the f32 runs here hand its serve module a
numpy whose ``asarray`` copies (:class:`_CopyingNumpy`). No reference file
changes."""

import functools
from collections import Counter

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import faults as rfaults
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.runtime import faults as tfaults

ARCH = 'stablelm-1.6b'
KW = dict(slots=3, prompt_len=16, gen_len=8, page_size=4)

#: kind -> (seed, profile kwargs, schedule, serve kwargs)
CASES = {
    'pool_squeeze': (0, {}, [(2, 'pool_squeeze', 6), (7, 'pool_squeeze',
                                                      None)],
                     dict(num_pages=1 + 12)),
    'preempt_storm': (0, {}, [(2, 'preempt_storm', 1),
                              (5, 'preempt_storm', 2)], {}),
    'poison_page': (1, {}, [(3, 'poison_page', None), (5, 'poison_page', None),
                            (7, 'poison_page', None)], {}),
    'poison_logits': (0, {}, [(3, 'poison_logits', None),
                              (6, 'poison_logits', None)], {}),
    'drop_quant': (0, {}, [(3, 'drop_quant', None), (5, 'drop_quant', None),
                           (8, 'drop_quant', None)],
                   dict(kv_quant=True, hot_window=1)),
    'cancel': (2, {}, [(2, 'cancel', None), (4, 'cancel', 6)], {}),
    'mangle_prompt': (0, {}, [(0, 'mangle_prompt', (1, 'oversize')),
                              (0, 'mangle_prompt', (4, 'garbage'))], {}),
    'chaos_profile': (0, 'chaos', [], dict(kv_quant=True, hot_window=1,
                                           prefix_cache=True)),
}


def _stream(mod):
    rng = np.random.RandomState(11)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, 256, 6 + (i * 5) % 11).astype(np.int32),
                target_gen=3 + (i * 3) % 6) for i in range(7)]


@functools.lru_cache(maxsize=None)
def _params_np():
    cfg = rconfigs.get(ARCH, smoke=True)
    return jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                       cfg))


def _injector(mod, kind):
    seed, profile, schedule, _ = CASES[kind]
    profile = mod.chaos_profile() if profile == 'chaos' else \
        mod.FaultProfile(**profile)
    return mod.FaultInjector(seed, profile, schedule=schedule)


class _CopyingNumpy:
    """numpy, but ``asarray`` returns a writable copy."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return np.array(a, *args, **kw)


def _reference(kind, injector=None, attn_impl='flash'):
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(rserve, 'np', _CopyingNumpy())
        mp.setattr(rserve, 'YocoConfig',
                   functools.partial(YocoConfig, compute_dtype=jnp.float32))
        mp.setattr(rserve, 'ModelRuntime',
                   functools.partial(ModelRuntime,
                                     compute_dtype=jnp.float32))
        mp.setattr(rserve.model_mod, 'init_paged_cache_tree',
                   functools.partial(rmodel.init_paged_cache_tree,
                                     dtype=jnp.float32))
        inj = injector or _injector(rfaults, kind)
        out = rserve.serve_continuous(
            ARCH, attn_impl=attn_impl, quiet=True, faults=inj,
            request_stream=_stream(rserve), **KW, **CASES[kind][3])
    return out, inj


def _port(kind, injector=None):
    cfg = rconfigs.get(ARCH, smoke=True)
    inj = injector or _injector(tfaults, kind)
    out = tserve.serve_continuous(
        ARCH, quiet=True, faults=inj, request_stream=_stream(tserve),
        device='cpu', compute_dtype=torch.float32,
        step_hook=lambda sched, kv, cache: kv.check_invariants(),
        params=tmodel.params_from_numpy(_params_np(), cfg, 'cpu'),
        **KW, **CASES[kind][3])
    return out, inj


@pytest.fixture(scope='module', params=sorted(CASES))
def pair(request):
    kind = request.param
    return kind, _port(kind), _reference(kind)


def _records(out):
    return [{k: v for k, v in e.items() if k not in ('t', 'prefill_s')}
            for e in out['event_log']]


def test_chaos_serve_matches_reference(pair):
    kind, (got, tinj), (ref, rinj) = pair
    assert _records(got) == _records(ref)
    assert got['terminal'] == ref['terminal']
    assert got['faults'] == ref['faults'] == dict(tinj.counts)
    assert got['pages_quant_dropped'] == ref['pages_quant_dropped']
    assert tinj.touched == rinj.touched
    clean = set(ref['outputs']) - rinj.touched
    assert {r: got['outputs'][r] for r in clean} == \
        {r: ref['outputs'][r] for r in clean}
    assert got['telemetry']['energy'] == ref['telemetry']['energy']
    # the scheduled kind landed (the profile run lands several kinds)
    if kind == 'chaos_profile':
        assert len(got['faults']) >= 4
    else:
        assert got['faults'].get(kind, 0) >= 1
    if kind == 'drop_quant':
        assert got['pages_quant_dropped'] > 0 and tinj.touched
    if kind in ('poison_page', 'poison_logits'):
        assert got['quarantined'] >= 1


def test_metrics_count_the_event_log_exactly(pair):
    _, (got, _), _ = pair
    m = got['telemetry']['metrics']
    events = {k: float(v) for k, v in got['events'].items()}
    assert m['serve_events_total']['values'] == events
    terminal = Counter(got['terminal'].values())
    assert m['serve_requests_total']['values'] == \
        {k: float(v) for k, v in terminal.items()}
    faults = Counter(e['fault'] for e in got['event_log']
                     if e['kind'] == 'fault')
    assert m['serve_faults_total'].get('values', {}) == \
        {k: float(v) for k, v in faults.items()}
    assert got['telemetry_summary']['tokens'] == got['decode_tokens']


def test_kernel_fault_refused_where_the_reference_degrades():
    sched = [(3, 'kernel_fault', None)]
    ref, _ = _reference('poison_logits', rfaults.FaultInjector(
        0, schedule=sched))
    assert ref['attn_impl_effective'] == 'einsum'
    assert ref['events']['degrade'] == 1
    for inj in (tfaults.FaultInjector(0, schedule=sched),
                tfaults.FaultInjector(0, tfaults.FaultProfile(
                    kernel_fault_step=2))):
        with pytest.raises(ValueError, match='kept decision'):
            _port('poison_logits', inj)
