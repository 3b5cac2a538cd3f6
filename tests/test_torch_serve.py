"""The slice end to end: the port's ``serve_continuous(device='cpu')``
against the reference's ``serve_continuous(attn_impl='einsum',
metrics=False)`` on stablelm smoke with the same weights and the same
numpy-made request stream, once at the default pool and once with a pool
that forces preemption.

In f32 (the reference's dtype defaults monkeypatched in its serve module's
namespace; no reference file changes): equal per-rid tokens, equal terminal
maps and equal event counts, in ``bf16`` and ``w8a8 --prequantize`` modes.
In bf16 the two frameworks round products in different places, so tokens
may differ; with no ``eos_id`` scheduling does not depend on token values,
so the event log and ``out_lens`` must still be equal."""

import functools
import json

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
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

ARCH = 'stablelm-1.6b'
KW = dict(slots=3, prompt_len=16, gen_len=8, page_size=4)
POOLS = {'default': None, 'preempting': 1 + 8}


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


def _reference(monkeypatch, mode, prequant, num_pages, f32):
    if f32:
        monkeypatch.setattr(rserve, 'YocoConfig',
                            functools.partial(YocoConfig,
                                              compute_dtype=jnp.float32))
        monkeypatch.setattr(rserve, 'ModelRuntime',
                            functools.partial(ModelRuntime,
                                              compute_dtype=jnp.float32))
        monkeypatch.setattr(rserve.model_mod, 'init_paged_cache_tree',
                            functools.partial(rmodel.init_paged_cache_tree,
                                              dtype=jnp.float32))
    out = rserve.serve_continuous(ARCH, mode=mode, prequantize=prequant,
                                  num_pages=num_pages, attn_impl='einsum',
                                  metrics=False, quiet=True,
                                  request_stream=_stream(rserve), **KW)
    monkeypatch.undo()
    return out


def _port(mode, prequant, num_pages, f32, attn_impl='flash'):
    cfg = rconfigs.get(ARCH, smoke=True)
    return tserve.serve_continuous(
        ARCH, mode=mode, prequantize=prequant, num_pages=num_pages,
        attn_impl=attn_impl, quiet=True, request_stream=_stream(tserve),
        device='cpu', step_hook=lambda sched, kv, cache: kv.check_invariants(),
        compute_dtype=torch.float32 if f32 else torch.bfloat16,
        params=tmodel.params_from_numpy(_params_np(), cfg, 'cpu'), **KW)


def _schedule(out):
    return [(e['kind'], e['step'], e.get('rid'), e.get('slot'))
            for e in out['event_log']]


@pytest.mark.parametrize('pool', sorted(POOLS))
@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('w8a8', True)])
def test_serve_f32_tokens_match_reference(monkeypatch, mode, prequant, pool):
    ref = _reference(monkeypatch, mode, prequant, POOLS[pool], f32=True)
    got = _port(mode, prequant, POOLS[pool], f32=True)
    assert got['completed'] == ref['completed'] == 7
    assert got['outputs'] == ref['outputs']
    assert got['terminal'] == ref['terminal']
    assert got['events'] == ref['events']
    if pool == 'preempting':
        assert got['preempted'] > 0


@pytest.mark.parametrize('pool', sorted(POOLS))
def test_serve_bf16_schedule_matches_reference(monkeypatch, pool):
    ref = _reference(monkeypatch, 'bf16', False, POOLS[pool], f32=False)
    got = _port('bf16', False, POOLS[pool], f32=False)
    assert _schedule(got) == _schedule(ref)
    assert got['out_lens'] == ref['out_lens']
    assert got['terminal'] == ref['terminal']


def test_serve_einsum_route_equals_flash_route_f32():
    """The port's two decode routes give the same tokens in f32."""
    a = _port('bf16', False, None, f32=True, attn_impl='einsum')
    b = _port('bf16', False, None, f32=True, attn_impl='flash')
    assert a['outputs'] == b['outputs']


def test_serve_report_keys_match_reference(monkeypatch):
    ref = _reference(monkeypatch, 'bf16', False, None, f32=False)
    got = _port('bf16', False, None, f32=False)
    missing = set(ref) - set(got) - {'telemetry', 'telemetry_summary',
                                     'metrics_out', 'trace'}
    assert not missing, missing


def test_synthetic_stream_serves_without_params():
    """No params and no stream: seeded random weights and the port's own
    synthetic prompts, the CLI's path."""
    out = tserve.serve_continuous(ARCH, n_requests=3, device='cpu',
                                  quiet=True, **KW)
    assert out['completed'] == 3


def test_cli_runs_and_rejects_later_flags(capsys, tmp_path):
    out = tserve.main(['--continuous', '--device', 'cpu', '--requests', '2',
                       '--prompt-len', '8', '--gen-len', '4', '--mode',
                       'w8a8', '--prequantize'])
    assert out['completed'] == 2
    assert '"completed": 2' in capsys.readouterr().out
    base = ['--continuous', '--device', 'cpu', '--requests', '2',
            '--prompt-len', '8', '--gen-len', '4']
    for flags in (['--kv-quant', '--hot-window', '1'],
                  ['--prefix-cache', '--shared-prefix', '4'],
                  ['--chunk-prefill', '4'],
                  ['--trace', str(tmp_path / 't.json'), '--metrics-out',
                   str(tmp_path / 'm.prom')]):
        out = tserve.main(base + flags)
        assert out['completed'] == 2
        assert 'telemetry' in out                 # metrics on by default
    assert out['trace'] == str(tmp_path / 't.json')
    assert json.loads((tmp_path / 't.json').read_text())['traceEvents']
    assert 'serve_events_total{kind="submit"} 2' in \
        (tmp_path / 'm.prom').read_text()
    # chaos may cancel a request or fail one past its retry budget; every
    # request still ends, and the injector's faults landed (seed 0 poisons
    # a logits row within this short run)
    out = tserve.main(base + ['--chaos', '--chaos-seed', '0', '--metrics'])
    assert out['completed'] + out['cancelled'] + out['failed'] == 2
    assert out['faults'] and sum(out['faults'].values()) > 0
    assert 'telemetry' in out
    out = tserve.main(base + ['--no-metrics'])
    assert out['completed'] == 2 and 'telemetry' not in out
    # --tp is served now (tests/test_torch_tp_*.py); a head count that does
    # not divide it, and --tp off the continuous path, are refused before
    # any rank is spawned
    with pytest.raises(ValueError, match='n_heads'):
        tserve.main(['--tp', '3', '--continuous', '--device', 'cpu'])
    with pytest.raises(ValueError, match='--continuous'):
        tserve.main(['--tp', '2', '--device', 'cpu'])
    out = tserve.main(base + ['--mode', 'qat', '--no-metrics'])
    assert out['completed'] == 2


@pytest.mark.parametrize('arch', ['stablelm-12b', 'starcoder2-15b',
                                  'gemma3-27b', 'qwen2-moe-a2.7b'])
def test_cli_serves_the_dense_family(arch, monkeypatch):
    """The reference's other dense configs and qwen2-moe (``--arch
    qwen2-moe-a2.7b --smoke --continuous --device cpu``) through the CLI
    at smoke width (continuous, in w8a8 --prequantize too, and static),
    and --no-smoke hands the published width to the serve."""
    base = ['--arch', arch, '--smoke', '--device', 'cpu', '--prompt-len',
            '20', '--gen-len', '3']
    for extra in ([], ['--mode', 'w8a8', '--prequantize']):
        out = tserve.main(base + ['--continuous', '--requests', '2',
                                  '--no-metrics'] + extra)
        assert out['completed'] == 2
    out = tserve.main(base + ['--batch', '2', '--attn-impl', 'flash'])
    assert out['generated_shape'] == [2, 3]
    seen = {}
    monkeypatch.setattr(tserve, 'serve_continuous',
                        lambda arch, **kw: seen.update(kw, arch=arch) or kw)
    tserve.main(['--continuous', '--no-smoke', '--arch', arch])
    assert seen['smoke'] is False and seen['arch'] == arch


def test_cli_no_smoke_selects_full_width(monkeypatch):
    seen = {}
    monkeypatch.setattr(tserve, 'serve_continuous',
                        lambda arch, **kw: seen.update(kw) or kw)
    tserve.main(['--continuous', '--no-smoke'])
    assert seen['smoke'] is False
    tserve.main(['--continuous'])
    assert seen['smoke'] is True
