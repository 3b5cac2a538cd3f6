"""Mixture-of-Experts serving through the port, on the CPU: qwen2-moe
(every layer MoE, GQA with biases) and deepseek-v3 (MLA; a dense layer,
then MoE layers: the ``dense_prefix``/``layers`` params and the
``prefix``/``moe`` caches), each SMOKE config held to the reference on
the same numpy weights.

* Forward logits (a prefill of 20 tokens, then paged decode steps, flash
  route through the plain kernels) in f32 within 1e-5, in bf16 mode and in
  qwen2-moe's w8a8 --prequantize (looser than the dense family's 2e-6:
  the expert products reduce in another order than XLA's einsums; the
  int8 codes of the shared FFN are equal).
* ``serve_continuous`` in f32 at the default pool and at one that forces
  preemption: equal per-rid tokens, terminal maps and event counts; in
  bf16, equal schedules. The reference runs ``attn_impl='einsum',
  metrics=False`` with its dtype defaults monkeypatched to f32 here, as
  ``tests/test_torch_dense_family.py`` does. qwen2-moe's static
  ``serve()``: equal tokens.
* The ``prefix``/``moe`` cache tree through ``cache_from_numpy`` /
  ``cache_to_numpy`` and the layout walkers, as the reference's.
* The per-weight serving init bit-equal to init-then-convert (expert
  stacks in the compute dtype, never int8; the shared FFN quantized with
  --prequantize); the dynamic w8a8 refusal prices expert stacks at the
  compute dtype's 2 bytes."""

import dataclasses
import functools

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
from repro.runtime import kv_cache as rkvc
from repro.runtime import kv_quant as rkvq
from repro.runtime import layouts as rlayouts
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_quant as tkvq
from repro_torch.runtime import layouts as tlayouts

QWEN, DSV3 = 'qwen2-moe-a2.7b', 'deepseek-v3-671b'
ARCHS = [QWEN, DSV3]
KW = dict(slots=3, prompt_len=24, gen_len=6, page_size=4)
# 12 pages admit two of these prompts at once but cannot grow both
POOLS = {'default': None, 'preempting': 1 + 12}
# the w8a8 serve of each: qwen2-moe --prequantize; deepseek-v3 dynamic
# (the port refuses --prequantize on MLA, where the reference fails)
W8A8 = {QWEN: True, DSV3: False}
B, PLEN, STEPS, PS = 2, 20, 3, 4


def _stream(mod):
    rng = np.random.RandomState(11)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, 256, 17 + (i * 5) % 8).astype(np.int32),
                target_gen=3 + (i * 3) % 4) for i in range(5)]


@functools.lru_cache(maxsize=None)
def _params_np(arch, prequant=False):
    from repro.core import yoco_linear as ryl
    p = rmodel.init_params(jax.random.key(0), rconfigs.get(arch, smoke=True))
    return jax.tree.map(np.asarray, ryl.quantize_tree(p) if prequant else p)


def _port_params(arch, prequant=False):
    return tmodel.params_from_numpy(_params_np(arch, prequant),
                                    tconfigs.get(arch, smoke=True), 'cpu')


# ----------------------------------------------------------------------------
# forward logits
# ----------------------------------------------------------------------------
def _prompts():
    return np.random.RandomState(0).randint(0, 256, (B, PLEN)) \
        .astype(np.int32)


def _tables(w):
    perm = np.random.RandomState(1).permutation(np.arange(1, 1 + B * w))
    return perm.reshape(B, w).astype(np.int32)


def _reference_forward(arch, mode, prequant):
    cfg = rconfigs.get(arch, smoke=True)
    yoco = YocoConfig(mode=mode, compute_dtype=jnp.float32)
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


@pytest.mark.parametrize('arch,mode,prequant', [
    (QWEN, 'bf16', False), (QWEN, 'w8a8', True), (DSV3, 'bf16', False)])
def test_forward_logits_match_reference_f32(arch, mode, prequant):
    want = _reference_forward(arch, mode, prequant)
    got = _port_forward(arch, mode, prequant)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


# ----------------------------------------------------------------------------
# continuous and static serving
# ----------------------------------------------------------------------------
def _f32_reference(monkeypatch):
    monkeypatch.setattr(rserve, 'YocoConfig',
                        functools.partial(YocoConfig,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(rserve, 'ModelRuntime',
                        functools.partial(ModelRuntime,
                                          compute_dtype=jnp.float32))
    for name in ('init_paged_cache_tree', 'init_cache_tree'):
        monkeypatch.setattr(rserve.model_mod, name, functools.partial(
            getattr(rmodel, name), dtype=jnp.float32))


def _reference_serve(monkeypatch, arch, mode, prequant, num_pages, f32):
    if f32:
        _f32_reference(monkeypatch)
    out = rserve.serve_continuous(arch, mode=mode, prequantize=prequant,
                                  num_pages=num_pages, attn_impl='einsum',
                                  metrics=False, quiet=True,
                                  request_stream=_stream(rserve), **KW)
    monkeypatch.undo()
    return out


def _port_serve(arch, mode, prequant, num_pages, f32):
    return tserve.serve_continuous(
        arch, mode=mode, prequantize=prequant, num_pages=num_pages,
        quiet=True, metrics=False, request_stream=_stream(tserve),
        device='cpu', step_hook=lambda sched, kv, cache: kv.check_invariants(),
        compute_dtype=torch.float32 if f32 else torch.bfloat16,
        params=_port_params(arch), **KW)


def _schedule(out):
    return [(e['kind'], e['step'], e.get('rid'), e.get('slot'))
            for e in out['event_log']]


@pytest.mark.parametrize('pool', ['default', 'preempting'])
@pytest.mark.parametrize('arch', ARCHS)
def test_serve_f32_tokens_match_reference(monkeypatch, arch, pool):
    mode, prequant = (('bf16', False) if pool == 'default'
                      else ('w8a8', W8A8[arch]))
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


def test_static_serve_tokens_match_reference(monkeypatch):
    """qwen2-moe's static serve() in f32: the reference's greedy tokens,
    recorded per decode step, equal the port's (its flash route, K7's
    plain version; the reference's einsum route)."""
    kw = dict(batch=3, prompt_len=10, gen_len=5)
    prompts = np.random.RandomState(5).randint(
        0, 256, (kw['batch'], kw['prompt_len'])).astype(np.int32)
    _f32_reference(monkeypatch)
    monkeypatch.setattr(rserve.synthetic, 'make_batch',
                        lambda dc, step: dict(inputs=jnp.asarray(prompts)))
    steps = []
    make = rserve.SS.make_decode_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recorded(params, token, pos, cache, *key):
            tok, logits, cache = step(params, token, pos, cache, *key)
            jax.debug.callback(
                lambda t_in, t_out: steps.append((np.asarray(t_in),
                                                  np.asarray(t_out))),
                token, tok, ordered=True)
            return tok, logits, cache
        return recorded

    monkeypatch.setattr(rserve.SS, 'make_decode_step', recording_make)
    rserve.serve(QWEN, quiet=True, **kw)
    jax.effects_barrier()
    monkeypatch.undo()
    want = np.stack([steps[0][0]] + [t for _, t in steps], axis=1)
    got = tserve.serve(QWEN, quiet=True, device='cpu',
                       compute_dtype=torch.float32, attn_impl='flash',
                       params=_port_params(QWEN), prompts=prompts, **kw)
    assert got['generated_shape'] == [3, 5]
    np.testing.assert_array_equal(got['tokens'], want)


# ----------------------------------------------------------------------------
# cache trees, serving init, refusal
# ----------------------------------------------------------------------------
def test_prefix_moe_cache_tree_round_trips_and_walks_as_reference():
    """deepseek-v3's caches are ``prefix`` (its dense layer) and ``moe``
    stacks, qwen2-moe's one ``layers`` stack; with the int8 tier, seeded
    pools through block tables, a page quantize and a scrub, leaf for leaf
    as the reference's."""
    for arch, keys in ((DSV3, {'prefix', 'moe'}), (QWEN, {'layers'})):
        rcfg = rconfigs.get(arch, smoke=True)
        tcfg = tconfigs.get(arch, smoke=True)
        sizes = dict(num_pages=9, page_size=4, max_blocks=4,
                     kv_dtype='int8', hot_window=1)
        ref = rmodel.init_paged_cache_tree(rcfg, 2, dtype=jnp.float32,
                                           **sizes)
        mine = tmodel.init_paged_cache_tree(tcfg, 2, dtype=torch.float32,
                                            device='cpu', **sizes)
        assert set(ref) == set(mine) == keys
        rng = np.random.RandomState(7)
        ref = jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)).astype(a.dtype)
            if a.dtype != jnp.int32 else a, ref)
        ref_np = jax.tree.map(np.asarray, ref)
        mine = tmodel.cache_from_numpy(ref_np, 'cpu')
        back = tmodel.cache_to_numpy(mine)
        assert jax.tree.structure(back) == jax.tree.structure(ref_np)
        for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(ref_np)):
            np.testing.assert_array_equal(a, b)
        tables = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
        pages = np.array([1, 3, 0, 0], np.int32)
        want = rlayouts.scrub_tree_pages(
            jax.jit(rkvq.quantize_tree_pages)(
                rkvc.with_block_tables(ref, jnp.asarray(tables)),
                jnp.asarray(pages)), jnp.array([7], jnp.int32))
        got = tlayouts.scrub_tree_pages(
            tkvq.quantize_tree_pages(
                tlayouts.with_block_tables(mine, tables),
                torch.from_numpy(pages)), torch.tensor([7]))
        got, want = tmodel.cache_to_numpy(got), jax.tree.map(np.asarray,
                                                              want)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def _leaves(tree, path=''):
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, f'{path}/{k}')
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, f'{path}[{i}]')
    else:
        yield path, tree


@pytest.mark.parametrize('arch,mode,prequant', [
    (QWEN, 'bf16', False), (QWEN, 'w8a8', True), (QWEN, 'w8a8', False),
    (DSV3, 'bf16', False), (DSV3, 'w8a8', False)])
def test_serving_init_bit_equal_to_init_then_convert(arch, mode, prequant):
    """Each weight drawn straight into its serving form (expert stacks in
    slices of experts) equals the f32 tree drawn in the same slices first
    and converted after, leaf for leaf: values, dtype, strides. Expert
    stacks are bf16 and in the layout moe_dense reads in every mode; the
    shared FFN is int8 with --prequantize."""
    cfg = tconfigs.get(arch, smoke=True)
    base = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                              device='cpu')
    want = tmodel.serving_form(base, mode, prequant, torch.bfloat16)
    got = tserve._serving_params(cfg, None, torch.device('cpu'), seed=0,
                                 mode=mode, prequantize=prequant,
                                 compute_dtype=torch.bfloat16)
    pairs = list(zip(_leaves(got), _leaves(want)))
    assert len(pairs) == len(list(_leaves(want)))
    for (pg, g), (pw, w) in pairs:
        assert pg == pw
        assert g.dtype == w.dtype and g.stride() == w.stride(), pg
        assert torch.equal(g, w), pg
    if cfg.moe.first_k_dense:
        assert len(got['dense_prefix']) == cfg.moe.first_k_dense
    moe = got['layers'][-1]['moe']
    assert moe['router'].dtype == torch.float32
    for name in ('w_gate', 'w_up', 'w_down'):
        assert moe[name].dtype == torch.bfloat16, name
    for name in ('w_gate', 'w_up'):
        assert moe[name].permute(1, 0, 2).is_contiguous(), name
    assert moe['w_down'].is_contiguous()
    assert isinstance(moe['sh_gate'], tyl.QuantizedWeight) == prequant
    # serving_form of a tree already in serving form copies nothing
    again = tmodel.serving_form(got, mode, prequant, torch.bfloat16)
    for (_, a), (_, b) in zip(_leaves(again), _leaves(got)):
        assert a.data_ptr() == b.data_ptr() and a.stride() == b.stride()


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


def test_dynamic_w8a8_prices_expert_stacks_at_two_bytes(monkeypatch):
    """Dynamic w8a8 keeps f32 masters of the linears but its expert stacks
    once in bf16: deepseek-v3 cut to 5 layers needs 61.4 GB, not the
    106.5 GB of 4 bytes a parameter, and is served where that fits;
    qwen2-moe needs 34.0 GB. Below that the refusal fires, with the bytes,
    before any draw. The bytes are the drawn tree's, counted on the meta
    device; they agree to 1e-4 with the reference's parameter count priced
    at 4 bytes a parameter and 2 an expert-stack entry, padded stacks
    included."""
    full = tconfigs.get(DSV3)
    cut = dataclasses.replace(full, n_layers=5)
    need = tmodel.serving_bytes(cut, 'w8a8', False, torch.bfloat16)
    experts = 2 * 256 * 3 * 7168 * 2048
    priced = 4 * (cut.param_count() - experts) + 2 * experts
    assert 0 <= need - priced < 1e-4 * need
    assert 61.3e9 < need < 61.5e9 < 4 * cut.param_count()
    qwen = tconfigs.get(QWEN)
    padded = 24 * 64 * 3 * 2048 * 1408
    priced = 4 * (qwen.param_count() - padded // 64 * 60) + 2 * padded
    got = tmodel.serving_bytes(qwen, 'w8a8', False, torch.bfloat16)
    assert 0 <= got - priced < 1e-4 * got
    free = [70 * 10 ** 9]
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev=None: (free[0], 80 * 10 ** 9))
    tserve._refuse_oversize(cut, torch.device('cuda'), 'w8a8', False)
    tserve._refuse_oversize(qwen, torch.device('cuda'), 'w8a8', False)

    _forbid_draws(monkeypatch)
    free[0] = 60 * 10 ** 9
    with pytest.raises(ValueError, match=f'{need} bytes.*{free[0]} bytes'):
        tserve._serving_params(cut, None, torch.device('cuda'), seed=0,
                               mode='w8a8', prequantize=False,
                               compute_dtype=torch.bfloat16)
    for mode, prequant in (('bf16', False), ('w8a8', True)):
        tserve._refuse_oversize(cut, torch.device('cuda'), mode, prequant)
