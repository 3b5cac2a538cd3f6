"""Tensor-parallel continuous serving, the port against the reference, on
the CPU: the port's ``serve_continuous(tp=N, device='cpu')`` (N gloo rank
processes, N = 2 and 4) against the reference's ``serve_continuous(tp=2)``
(a ``shard_map`` over 2 forced host devices, tests/conftest.py; its own
tests hold its tp = 2 and 4 to its tp = 1), both in f32
(``compute_dtype=float32``; the reference's serve, its TP step builders
and its paged pools patched to f32, as the port's other f32 serve tests
patch them) on the reference's weights, at the reference's ``SERVE_KW``
(tests/test_distributed_serve.py) and its synthetic request stream (the
reference's prompts handed to both: the two packages' seeded draws
differ). The port reads its pools through the kernels' plain versions
(``attn_impl='flash'``), the reference through its einsum oracle: its
Pallas kernels run interpreted here, 22 s for the two tp = 2 serves
against 3.7 s, and its own tests hold them to the oracle.

Tolerances: equal per-request tokens, events and quantized pages for
stablelm-1.6b over the int8 tier (the port at tp = 2 and 4) and
deepseek-v3's dense
prefix (3 MLA layers at smoke width, registered in both packages for this
module; MLA with its MoE layers is held to the port's tp = 1 in
tests/test_torch_tp_parity.py); the TP steps' logits (a paged prefill and
greedy decode steps, ``serve_step.tp_step_logits``, run in the same group
as the serves) within 1e-4 of the reference's ``make_tp_prefill_step`` /
``make_tp_decode_step``, the bound the port's f32 model is held to
(tests/test_torch_model.py)."""

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
from repro.data import synthetic as rsynthetic
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import kv_cache as rkvc
from repro.runtime import serve_step as rSS
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.distributed import ranks
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from test_torch_tp_parity import one_thread_a_rank

GQA, MLA = 'stablelm-1.6b', 'deepseek-v3-dense3-tp-test'
SERVE_KW = dict(slots=2, n_requests=3, prompt_len=16, gen_len=8,
                page_size=4, attn_impl='flash', quiet=True, metrics=False)
F32 = jnp.float32
REF = dict(SERVE_KW, attn_impl='einsum')


@functools.lru_cache(maxsize=None)
def _ref_params(arch):
    cfg = rconfigs.get(arch, smoke=True)
    return jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                       cfg))


def _stream(mod, arch):
    """SERVE_KW's stream: the reference's synthetic prompts cut to its
    ragged lengths, as ``mod``'s Requests."""
    n, plen, glen = (SERVE_KW[k] for k in ('n_requests', 'prompt_len',
                                           'gen_len'))
    dc = rsynthetic.for_arch(rconfigs.get(arch, smoke=True),
                             global_batch=n, seq_len=plen)
    prompts = np.asarray(rsynthetic.make_batch(dc, 0)['inputs'])
    return mod._ragged_stream(n, plen, glen, prompts)


def _need(tp):
    if jax.device_count() < tp:
        pytest.skip(f'the reference needs {tp} host devices, has '
                    f'{jax.device_count()}')


def _f32_reference():
    """The reference's serve in f32: its YocoConfig, both ModelRuntime
    names (the serve's and its TP step builders') and its paged pools."""
    mp = pytest.MonkeyPatch()
    mp.setattr(rserve, 'YocoConfig',
               functools.partial(YocoConfig, compute_dtype=F32))
    for mod in (rserve, rSS):
        mp.setattr(mod, 'ModelRuntime',
                   functools.partial(ModelRuntime, compute_dtype=F32))
    mp.setattr(rserve.model_mod, 'init_paged_cache_tree',
               functools.partial(rmodel.init_paged_cache_tree, dtype=F32))
    return mp


def _port_run(arch, **over):
    cfg = rconfigs.get(arch, smoke=True)
    return dict(SERVE_KW, arch=arch, compute_dtype=torch.float32,
                params=tmodel.params_from_numpy(_ref_params(arch), cfg,
                                                'cpu'),
                request_stream=_stream(tserve, arch), **over)


RUNS = {'gqa-kvq': (GQA, dict(kv_quant=True)), 'mla': (MLA, {})}


@pytest.fixture(scope='module', autouse=True)
def _cut_config():
    """deepseek-v3 cut to its dense prefix, ``replace(..., n_layers=3,
    moe=None)``, registered in both packages and removed afterwards."""
    for base, cfgs in ((rbase, rconfigs), (tbase, tconfigs)):
        full = cfgs.get('deepseek-v3-671b')
        smoke = cfgs.get('deepseek-v3-671b', smoke=True)
        base.register(dataclasses.replace(full, name=MLA, n_layers=3,
                                          moe=None),
                      dataclasses.replace(smoke, name=MLA, moe=None))
    yield
    for base in (rbase, tbase):
        base._REGISTRY.pop(MLA)
        base._SMOKE.pop(MLA)


PROMPTS = np.random.RandomState(5).randint(0, 256, (2, 10)).astype(np.int32)
LENS = np.array([10, 7], np.int32)
STEPS = 3


@pytest.fixture(scope='module')
def tp2():
    """The reference's tp = 2 serves, and the port's with its TP step
    logits in one group of two ranks."""
    _need(2)
    mp = _f32_reference()
    try:
        ref = {name: rserve.serve_continuous(
                   arch, tp=2, request_stream=_stream(rserve, arch),
                   **dict(REF, **over))
               for name, (arch, over) in RUNS.items()}
    finally:
        mp.undo()
    placed = ranks.placement(2, 'cpu')
    lead, rest = tserve.serve_jobs(
        [_port_run(arch, **over) for arch, over in RUNS.values()], placed)
    logits = ('repro_torch.runtime.serve_step:tp_step_logits',
              dict(arch=GQA, smoke=True, params=tmodel.params_from_numpy(
                  _ref_params(GQA), rconfigs.get(GQA, smoke=True), 'cpu'),
                   prompts=PROMPTS, lens=LENS, steps=STEPS))
    with one_thread_a_rank(2):
        got = ranks.run(lead + [logits], placed,
                        worker_jobs=rest + [logits])
    return ref, dict(zip(list(RUNS) + ['logits'], got))


@pytest.mark.parametrize('name', list(RUNS))
def test_tp2_tokens_equal_reference_tp2(tp2, name):
    ref, got = tp2[0][name], tp2[1][name]
    assert got['tp'] == ref['tp'] == 2
    assert got['completed'] == ref['completed'] == 3
    assert got['outputs'] == ref['outputs']
    assert got['events'] == ref['events']
    assert got['pages_quantized'] == ref['pages_quantized']
    assert got['attn_impl_effective'] == 'flash'
    if name == 'gqa-kvq':
        assert ref['pages_quantized'] > 0


def test_tp4_gqa_int8_tier_equals_reference(tp2):
    """Four ranks: one query head and one KV head each at smoke width,
    against the reference's tp = 2 serve of the same run (its tp = 2 and
    4 equal its tp = 1, tests/test_distributed_serve.py)."""
    ref = tp2[0]['gqa-kvq']
    with one_thread_a_rank(4):
        got = tserve.serve_continuous(device='cpu', tp=4,
                                      **_port_run(GQA, kv_quant=True))
    assert ref['pages_quantized'] > 0
    assert got['outputs'] == ref['outputs']
    assert got['pages_quantized'] == ref['pages_quantized']
    assert len(got['ranks']) == 4


def _ref_tp_logits(arch, prompts, lens, steps, page_size=4):
    """The reference's TP steps (shard_map over 2 host devices) in f32:
    prefill, then greedy decode steps, on pages of each request's own."""
    cfg = rconfigs.get(arch, smoke=True)
    mesh = jax.sharding.Mesh(np.asarray(jax.devices()[:2]), ('model',))
    b, s = prompts.shape
    w = -(-(s + steps) // page_size)
    params = jax.tree.map(jnp.asarray, _ref_params(arch))
    cache = rmodel.init_paged_cache_tree(cfg, b, num_pages=1 + b * w,
                                         page_size=page_size, max_blocks=w,
                                         dtype=F32)
    cache = rkvc.with_block_tables(cache, jnp.asarray(
        np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w)))
    yoco = YocoConfig(compute_dtype=F32)
    mp = _f32_reference()
    try:
        prefill = jax.jit(rSS.make_tp_prefill_step(
            cfg, yoco, mesh, params, cache, attn_impl='einsum'))
        decode = jax.jit(rSS.make_tp_decode_step(
            cfg, yoco, mesh, params, cache, attn_impl='einsum'))
        logits, cache = prefill(params, dict(inputs=jnp.asarray(prompts)),
                                cache, jnp.asarray(lens - 1))
        rows = [np.asarray(logits, np.float32)]
        tok = jnp.argmax(logits, axis=-1).astype(jnp.int32)
        for i in range(steps):
            tok, logits, cache = decode(params, tok, jnp.asarray(lens + i),
                                        cache)
            rows.append(np.asarray(logits, np.float32))
    finally:
        mp.undo()
    return np.stack(rows)


def test_tp2_step_logits_within_reference_tolerance(tp2):
    """f32 logits of the TP steps at 1e-4; the greedy tokens they feed
    back are then the same."""
    got = tp2[1]['logits']
    want = _ref_tp_logits(GQA, PROMPTS, LENS, STEPS)
    assert got.shape == want.shape and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=1e-4, rtol=0)
