"""Continuous serving of deepseek-v3's dense prefix (3 MLA layers, MoE
dropped, smoke width) by the port against the reference, and the refusal
of ``--prequantize`` on MLA configs.

The cut config is registered under one name in both packages' registries
for the module's tests only (other test files list the registries while
they are collected and run).

Tolerances: in f32 end to end, equal greedy tokens, events, peak pages,
pages quantized and prefix counters. In bf16, the model's logits within
5e-2 on fp latent pools, the bound the port's dense model is held to
across the two frameworks (tests/test_torch_model.py, after the
reference's tests/test_flash_decode.py): the two frameworks round bf16
sums in different places, so logits differ by up to 1-2 bf16 ulps (0.037
measured; the reference's own 2e-2, paged against contiguous within one
framework, does not hold across frameworks), and within 2e-1 with the
int8 latent tier at hot window 1 (tests/test_layouts.py). The f32 absorb
weights are held exactly at the layer (tests/test_torch_mla.py)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import kv_cache as rkvc
from repro.runtime import kv_quant as rkvq
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import yoco_linear as tyl
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_quant as tkvq

ARCH = 'deepseek-v3-dense3-test'
KW = dict(slots=2, prompt_len=16, gen_len=8, page_size=4)


@pytest.fixture(scope='module', autouse=True)
def _cut_config():
    """deepseek-v3 cut to its dense prefix, ``replace(..., n_layers=3,
    moe=None)``, registered in both packages and removed afterwards."""
    for base, cfgs in ((rbase, rconfigs), (tbase, tconfigs)):
        full = cfgs.get('deepseek-v3-671b')
        smoke = cfgs.get('deepseek-v3-671b', smoke=True)
        base.register(dataclasses.replace(full, name=ARCH, n_layers=3,
                                          moe=None),
                      dataclasses.replace(smoke, name=ARCH, moe=None))
    yield
    for base in (rbase, tbase):
        base._REGISTRY.pop(ARCH)
        base._SMOKE.pop(ARCH)


@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = rconfigs.get(ARCH, smoke=True)
    return jax.tree.map(np.asarray,
                        rmodel.init_params(jax.random.key(0), cfg))


def _stream(mod, shared=None):
    """Ragged prompts of 7-16 tokens; with ``shared`` N, prompts of N to
    N + 3 tokens that open with the same N tokens (a system prompt; the
    suffix-free request is an exact cover, served by copy-on-write)."""
    rng = np.random.RandomState(12)
    sysp = rng.randint(1, 256, size=shared or 0).astype(np.int32)
    return [mod.Request(rid=i, prompt=np.concatenate(
                [sysp, rng.randint(0, 256, (i * 3) % 4 if shared
                                   else 7 + (i * 4) % 10).astype(np.int32)]),
                target_gen=4 + (i * 3) % 5) for i in range(4)]


def _ref_serve_f32(monkeypatch, shared=None, **kw):
    f32 = jnp.float32
    monkeypatch.setattr(rserve, 'YocoConfig',
                        functools.partial(YocoConfig, compute_dtype=f32))
    monkeypatch.setattr(rserve, 'ModelRuntime',
                        functools.partial(ModelRuntime, compute_dtype=f32))
    monkeypatch.setattr(rserve.model_mod, 'init_paged_cache_tree',
                        functools.partial(rmodel.init_paged_cache_tree,
                                          dtype=f32))
    out = rserve.serve_continuous(ARCH, attn_impl='einsum', metrics=False,
                                  quiet=True,
                                  request_stream=_stream(rserve, shared),
                                  **KW, **kw)
    monkeypatch.undo()
    return out


def _port_serve_f32(shared=None, **kw):
    cfg = rconfigs.get(ARCH, smoke=True)
    return tserve.serve_continuous(
        ARCH, quiet=True, request_stream=_stream(tserve, shared),
        device='cpu', compute_dtype=torch.float32,
        step_hook=lambda sched, kv, cache: kv.check_invariants(),
        params=tmodel.params_from_numpy(_ref_params(), cfg, 'cpu'), **KW,
        **kw)


@pytest.mark.parametrize('opts', [
    dict(),
    dict(kv_quant=True, hot_window=1),
    dict(prefix_cache=True, chunk_prefill=4, shared=8),
    dict(mode='w8a8'),
], ids=['plain', 'kv_quant-hw1', 'prefix-chunk4', 'w8a8-dynamic'])
def test_serve_f32_matches_reference(monkeypatch, opts):
    ref = _ref_serve_f32(monkeypatch, **opts)
    got = _port_serve_f32(**opts)
    assert got['completed'] == ref['completed'] == 4
    assert got['outputs'] == ref['outputs']
    assert got['events'] == ref['events']
    assert got['peak_pages'] == ref['peak_pages']
    assert got['pages_quantized'] == ref['pages_quantized']
    assert (got['pages_quantized'] > 0) == bool(opts.get('kv_quant'))
    assert got['prefix'] == ref['prefix']
    if opts.get('prefix_cache'):
        assert got['prefix']['hits'] >= 2
        assert got['chunk_prefill'] == ref['chunk_prefill'] == 4


def _bf16_run(port_side, kv_dtype):
    """Prefill 2 ragged prompts into a paged latent tree (bf16 pools,
    bf16 compute), quantize the cold pages at hot window 1 when tiered,
    then 3 greedy decode steps of the reference's token stream. Returns the
    (4, B, vocab) f32 logits."""
    cfg = rconfigs.get(ARCH, smoke=True)
    b, plen, ps, w = 2, 10, 4, 4
    tables = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
    toks = np.random.RandomState(7).randint(0, 256, (b, plen))
    lens = np.array([plen, plen - 3], np.int32)
    pages = rkvq.cold_page_list(tables, lens, ps, 1) if kv_dtype else []
    steps = np.array([[3, 5], [17, 2], [250, 9]], np.int32)
    rows = []
    if not port_side:
        params = jax.tree.map(jnp.asarray, _ref_params())
        cache = rmodel.init_paged_cache_tree(cfg, b, num_pages=b * w + 1,
                                             page_size=ps, max_blocks=w,
                                             kv_dtype=kv_dtype,
                                             hot_window=1)
        cache = rkvc.with_block_tables(cache, jnp.asarray(tables))
        logits, cache = rmodel.prefill(params, dict(inputs=jnp.asarray(toks)),
                                       cache, cfg, last_pos=lens - 1)
        if pages:
            cache = jax.jit(rkvq.quantize_tree_pages)(
                cache, jnp.asarray(pages, jnp.int32))
        rows.append(np.asarray(logits, np.float32))
        for i, tok in enumerate(steps):
            logits, cache = rmodel.decode_step(params, jnp.asarray(tok),
                                               jnp.asarray(lens + i), cache,
                                               cfg)
            rows.append(np.asarray(logits, np.float32))
        return np.stack(rows)
    # the serve path's bf16 params: linears stored in bf16, w_ukv kept f32
    params = tmodel.cast_linear_weights(
        tmodel.params_from_numpy(_ref_params(), cfg, 'cpu'), torch.bfloat16)
    assert params['layers'][0]['attn']['w_ukv'].dtype == torch.float32
    assert params['layers'][0]['attn']['w_uq'].dtype == torch.bfloat16
    cache = tmodel.init_paged_cache_tree(cfg, b, num_pages=b * w + 1,
                                         page_size=ps, max_blocks=w,
                                         kv_dtype=kv_dtype, hot_window=1,
                                         device='cpu')
    from repro_torch.runtime import layouts
    cache = layouts.with_block_tables(cache, tables)
    rt = tmodel.ModelRuntime(attn_impl='flash')
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(toks)), cache, cfg,
        rt=rt, last_pos=torch.from_numpy(lens - 1))
    if pages:
        cache = tkvq.quantize_tree_pages(cache, torch.tensor(pages))
    rows.append(logits.float().numpy())
    for i, tok in enumerate(steps):
        logits, cache = tmodel.decode_step(params, torch.from_numpy(tok),
                                           torch.from_numpy(lens + i), cache,
                                           cfg, rt=rt)
        rows.append(logits.float().numpy())
    return np.stack(rows)


@pytest.mark.parametrize('kv_dtype,atol,rtol', [(None, 5e-2, 0.0),
                                                ('int8', 2e-1, 2e-1)],
                         ids=['fp', 'tier-hw1'])
def test_bf16_logits_within_reference_tolerance(kv_dtype, atol, rtol):
    want = _bf16_run(False, kv_dtype)
    got = _bf16_run(True, kv_dtype)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=atol, rtol=rtol)


def test_prequantize_refused_on_mla_where_the_reference_fails():
    """The reference quantizes ``w_ukv`` and its absorbed decode reshapes
    the QuantizedWeight (src/repro/models/attention.py:608); the port
    refuses the option up front, from the API and from the CLI."""
    with pytest.raises(AttributeError, match='reshape'):
        rserve.serve_continuous(ARCH, mode='w8a8', prequantize=True,
                                metrics=False, quiet=True, slots=1,
                                n_requests=1, prompt_len=8, gen_len=2)
    with pytest.raises(ValueError, match='attention.py:608'):
        tserve.serve_continuous(ARCH, mode='w8a8', prequantize=True,
                                device='cpu', quiet=True, n_requests=1)
    with pytest.raises(ValueError, match='--prequantize is not served'):
        tserve.main(['--arch', ARCH, '--continuous', '--mode', 'w8a8',
                     '--prequantize', '--device', 'cpu'])
    # bf16 and dynamic w8a8 are served
    out = tserve.serve_continuous(ARCH, mode='w8a8', device='cpu',
                                  quiet=True, slots=1, n_requests=1,
                                  prompt_len=8, gen_len=2)
    assert out['completed'] == 1
