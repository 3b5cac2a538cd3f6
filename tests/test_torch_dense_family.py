"""The reference's other dense configs through the port, on the CPU:
stablelm-12b (G = 4, partial rotary), starcoder2-15b (G = 4 at smoke, 12
at full width; biases, a GELU MLP) and gemma3-27b (2 local sliding-window
layers to 1 global at smoke, per-layer rope theta, qk-norm, sandwich
norms, GEGLU), each SMOKE config held to the reference on the same numpy
weights.

* Forward logits (a prefill of 20 tokens, past gemma3's smoke window of
  16, then decode steps over the paged cache, flash route through the
  plain kernels) in f32: bf16 mode within 1e-5, w8a8 --prequantize
  within 2e-6 (its int8 products are exact; the f32 norms and softmax
  reduce in another order).
* ``serve_continuous`` in f32 at the default pool and at one that forces
  preemption: equal per-rid tokens, terminal maps and event counts; in
  bf16, equal schedules. The reference runs ``attn_impl='einsum',
  metrics=False`` with its dtype defaults monkeypatched to f32 here, as
  ``tests/test_torch_serve.py`` does.
* gemma3's window binds: the same serve with the window removed gives
  other tokens.
* ``_gemma_layer_meta`` per layer as the reference's; the per-weight
  serving init bit-equal to init-then-convert; the dynamic w8a8 refusal
  of a config whose f32 masters exceed the card's free memory, before any
  draw."""

import dataclasses
import functools
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import kv_cache as rkvc
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.launch import serve as tserve
from repro_torch.models import layers as tlayers
from repro_torch.models import model as tmodel
from repro_torch.runtime import layouts as tlayouts

ARCHS = ['stablelm-12b', 'starcoder2-15b', 'gemma3-27b']
# prompts of 17-24 tokens: past gemma3's smoke window of 16
KW = dict(slots=3, prompt_len=24, gen_len=6, page_size=4)
# 12 pages admit two of these prompts at once but cannot grow both
POOLS = {'default': None, 'preempting': 1 + 12}
B, PLEN, STEPS, PS = 2, 20, 3, 4


def _stream(mod):
    rng = np.random.RandomState(11)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, 256, 17 + (i * 5) % 8).astype(np.int32),
                target_gen=3 + (i * 3) % 4) for i in range(5)]


@functools.lru_cache(maxsize=None)
def _params_np(arch, prequant=False):
    p = rmodel.init_params(jax.random.key(0), rconfigs.get(arch, smoke=True))
    return jax.tree.map(np.asarray, ryl.quantize_tree(p) if prequant else p)


def _port_params(arch, prequant=False, cfg=None):
    cfg = cfg or tconfigs.get(arch, smoke=True)
    return tmodel.params_from_numpy(_params_np(arch, prequant), cfg, 'cpu')


# ----------------------------------------------------------------------------
# forward logits
# ----------------------------------------------------------------------------
def _prompts():
    return np.random.RandomState(0).randint(0, 256, (B, PLEN)) \
        .astype(np.int32)


def _tables(w):
    perm = np.random.RandomState(1).permutation(np.arange(1, 1 + B * w))
    return perm.reshape(B, w).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_forward(arch, mode, prequant):
    """Prefill + STEPS greedy decode steps through the jitted reference in
    f32 (einsum route): (STEPS + 1, B, V) logits."""
    cfg = rconfigs.get(arch, smoke=True)
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)
    rt = ModelRuntime(compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _params_np(arch, prequant))
    w = -(-(PLEN + STEPS) // PS)
    cache = rmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=jnp.float32)
    cache = rkvc.with_block_tables(cache, jnp.asarray(_tables(w)))
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(p, t, pos, c,
                                                             cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts()), cache)
    rows = [np.asarray(logits)]
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode(params, tok, jnp.full((B,), PLEN + i,
                                                     jnp.int32), cache)
        rows.append(np.asarray(logits))
    return np.stack(rows)


def _port_forward(arch, mode, prequant):
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(attn_impl='flash', compute_dtype=torch.float32)
    params = _port_params(arch, prequant)
    w = -(-(PLEN + STEPS) // PS)
    cache = tmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=torch.float32, device='cpu')
    cache = tlayouts.with_block_tables(cache, _tables(w))
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts())), cache, cfg, yoco,
        rt)
    rows = [logits.numpy()]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = tmodel.decode_step(
            params, tok, torch.full((B,), PLEN + i, dtype=torch.int32), cache,
            cfg, yoco, rt)
        rows.append(logits.numpy())
    return np.stack(rows)


@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('w8a8', True)])
@pytest.mark.parametrize('arch', ARCHS)
def test_forward_logits_match_reference_f32(arch, mode, prequant):
    want = _reference_forward(arch, mode, prequant)
    got = _port_forward(arch, mode, prequant)
    # w8a8: int8 codes and int32 sums are exact, but the norms, rope and
    # the attention's softmax reduce in f32 in another order than XLA's:
    # up to 5 ulps of logits below 4 (2.4e-7 an ulp) were seen
    tol = 1e-5 if mode == 'bf16' else 2e-6
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ----------------------------------------------------------------------------
# continuous serving
# ----------------------------------------------------------------------------
def _reference_serve(monkeypatch, arch, mode, prequant, num_pages, f32):
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
    out = rserve.serve_continuous(arch, mode=mode, prequantize=prequant,
                                  num_pages=num_pages, attn_impl='einsum',
                                  metrics=False, quiet=True,
                                  request_stream=_stream(rserve), **KW)
    monkeypatch.undo()
    return out


def _port_serve(arch, mode, prequant, num_pages, f32, params=None):
    return tserve.serve_continuous(
        arch, mode=mode, prequantize=prequant, num_pages=num_pages,
        quiet=True, metrics=False, request_stream=_stream(tserve),
        device='cpu', step_hook=lambda sched, kv, cache: kv.check_invariants(),
        compute_dtype=torch.float32 if f32 else torch.bfloat16,
        params=params if params is not None else _port_params(arch), **KW)


def _schedule(out):
    return [(e['kind'], e['step'], e.get('rid'), e.get('slot'))
            for e in out['event_log']]


@pytest.mark.parametrize('pool,mode,prequant',
                         [('default', 'bf16', False),
                          ('preempting', 'w8a8', True)])
@pytest.mark.parametrize('arch', ARCHS)
def test_serve_f32_tokens_match_reference(monkeypatch, arch, pool, mode,
                                          prequant):
    ref = _reference_serve(monkeypatch, arch, mode, prequant, POOLS[pool],
                           f32=True)
    got = _port_serve(arch, mode, prequant, POOLS[pool], f32=True)
    assert got['completed'] == ref['completed'] == 5
    assert got['outputs'] == ref['outputs']
    assert got['terminal'] == ref['terminal']
    assert got['events'] == ref['events']
    assert (got['preempted'] > 0) == (pool == 'preempting')


@pytest.mark.parametrize('arch', ARCHS)
def test_serve_bf16_schedule_matches_reference(monkeypatch, arch):
    ref = _reference_serve(monkeypatch, arch, 'bf16', False,
                           POOLS['preempting'], f32=False)
    got = _port_serve(arch, 'bf16', False, POOLS['preempting'], f32=False)
    assert _schedule(got) == _schedule(ref)
    assert got['out_lens'] == ref['out_lens']
    assert got['terminal'] == ref['terminal']


def test_gemma3_window_binds(monkeypatch):
    """Local layers mask keys the global layers see: with the window
    removed the port's f32 tokens change."""
    arch = 'gemma3-27b'
    windowed = _port_serve(arch, 'bf16', False, None, f32=True)
    cfg = dataclasses.replace(tconfigs.get(arch, smoke=True),
                              sliding_window=None)
    assert tmodel.layer_windows(cfg, 'cpu') is None
    monkeypatch.setattr(tserve.configs, 'get', lambda name, smoke: cfg)
    unwindowed = _port_serve(arch, 'bf16', False, None, f32=True)
    assert windowed['completed'] == unwindowed['completed'] == 5
    assert windowed['outputs'] != unwindowed['outputs']


# ----------------------------------------------------------------------------
# layer metadata, init, refusal
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('smoke', [True, False])
@pytest.mark.parametrize('arch', ARCHS + ['stablelm-1.6b'])
def test_gemma_layer_meta_matches_reference(arch, smoke):
    tcfg = tconfigs.get(arch, smoke=smoke)
    rcfg = rconfigs.get(arch, smoke=smoke)
    window, theta = tmodel._gemma_layer_meta(tcfg)
    rwin, rtheta = (np.asarray(a) for a in rmodel._gemma_layer_meta(rcfg))
    assert list(window) == rwin.tolist()
    np.testing.assert_array_equal(np.float32(theta), rtheta)
    wins = tmodel.layer_windows(tcfg, 'cpu')
    if tcfg.sliding_window is None:
        assert wins is None
    else:
        assert wins.dtype == torch.int32 and wins.tolist() == list(window)
        assert tmodel.layer_windows(tcfg, 'cpu') is wins     # made once


@pytest.mark.parametrize('arch', ARCHS + ['stablelm-1.6b',
                                  'deepseek-v3-671b', 'qwen2-moe-a2.7b'])
def test_param_count_matches_reference(arch):
    """The count the dynamic w8a8 refusal prices (4 bytes a parameter) is
    the reference's, at both widths."""
    for smoke in (False, True):
        assert tconfigs.get(arch, smoke=smoke).param_count() \
            == rconfigs.get(arch, smoke=smoke).param_count()


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}[{i}]')
    else:
        yield path, tree


@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('w8a8', True),
                                           ('w8a8', False)])
@pytest.mark.parametrize('arch', ['stablelm-1.6b', 'gemma3-27b'])
def test_serving_init_bit_equal_to_init_then_convert(arch, mode, prequant):
    """Each weight drawn straight into its serving form equals the f32
    tree drawn first and converted after, leaf for leaf: values, dtype,
    strides (K-major), and the same draws as an unscaled randn scaled."""
    cfg = tconfigs.get(arch, smoke=True)
    base = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                              device='cpu')
    want = (tyl.quantize_tree(base) if prequant
            else tmodel.cast_linear_weights(base, torch.bfloat16)
            if mode == 'bf16' else tmodel.k_major_linear_weights(base))
    got = tserve._serving_params(cfg, None, torch.device('cpu'), seed=0,
                                 mode=mode, prequantize=prequant,
                                 compute_dtype=torch.bfloat16)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want)))
    for (pg, g), (pw, w) in pairs:
        assert pg == pw
        assert g.dtype == w.dtype and g.stride() == w.stride(), pg
        assert torch.equal(g, w), pg
    if prequant:
        assert isinstance(got['lm_head'], tyl.QuantizedWeight)
    # the in-place scale draws what randn times the scale draws
    gen = torch.Generator().manual_seed(3)
    w = tlayers.dense_init(gen, 48, 16, device='cpu')
    gen = torch.Generator().manual_seed(3)
    assert torch.equal(w, torch.randn((48, 16), generator=gen)
                       * (1.0 / math.sqrt(48)))


def _forbid_draws(monkeypatch):
    """Fail on a generator or a draw anywhere but on the meta device, where
    the refusal counts the serving form's bytes and allocates nothing."""
    init = tmodel.init_params

    def meta_only(gen, cfg, *, device=None, **kw):
        if torch.device(device).type != 'meta':
            raise AssertionError('drew weights')
        return init(gen, cfg, device=device, **kw)

    class NoGenerator:          # a type: torch's lazy imports annotate with it
        def __init__(self, *a, **k):
            raise AssertionError('made a generator')
    monkeypatch.setattr(tmodel, 'init_params', meta_only)
    monkeypatch.setattr(torch, 'Generator', NoGenerator)


def test_dynamic_w8a8_refused_before_any_draw(monkeypatch):
    """gemma3-27b's f32 masters (4 bytes a parameter) exceed an 80 GB
    card's free memory: refused with the bytes of the drawn tree (counted
    on the meta device, within 1e-4 of 4 bytes a parameter of the
    reference's count), before the generator or a weight is made. bf16 and
    --prequantize are not refused."""
    cfg = tconfigs.get('gemma3-27b')
    free = 79 * 10 ** 9
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev=None: (free, 80 * 10 ** 9))
    _forbid_draws(monkeypatch)
    need = tmodel.serving_bytes(cfg, 'w8a8', False, torch.bfloat16)
    assert 0 <= need - 4 * cfg.param_count() < 1e-4 * need
    assert need > 113 * 10 ** 9
    with pytest.raises(ValueError, match=f'{need} bytes.*{free} bytes'):
        tserve._serving_params(cfg, None, torch.device('cuda'), seed=0,
                               mode='w8a8', prequantize=False,
                               compute_dtype=torch.bfloat16)
    for arch in ('stablelm-12b', 'starcoder2-15b'):
        tserve._refuse_oversize(tconfigs.get(arch),
                                torch.device('cuda'), 'w8a8', False)
    for mode, prequant in (('bf16', False), ('w8a8', True)):
        tserve._refuse_oversize(cfg, torch.device('cuda'), mode, prequant)
