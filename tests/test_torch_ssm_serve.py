"""SSM and hybrid serving through the port, on the CPU: mamba2-780m (a pure
SSM with tied embeddings) and zamba2-1.2b (Mamba2 layers and a shared
attention+MLP block at each site), each SMOKE config held to the reference
(``repro/models/ssm.py``, ``model.py``, ``launch/serve.py``) on the same
numpy weights.

* Forward: a 70-token prefill (three SSD chunks of 32, the last padded)
  and decode steps over a paged cache, the flash route through the plain
  kernels, f32: logits within 1e-4, the ``conv`` and ``ssm`` leaves within
  2e-4 (``cache_to_numpy``); in bf16 mode, in mamba2's w8a8 --prequantize
  and in zamba2's dynamic w8a8. A right-padded prefill with ``last_pos``
  leaves the unpadded prompt's logits and state. bf16 compute: the first
  logits within the reference's 2e-2.
* ``serve_continuous`` in f32 (the reference's dtype defaults patched to
  f32, ``attn_impl='einsum'``, ``metrics=False``): equal per-rid tokens,
  terminal maps and event counts at the default pool, at one that forces
  preemption, in dynamic w8a8 and zamba2 over the int8 tier; the static
  ``serve()`` (zamba2 flash lock-step and einsum --ragged, mamba2 einsum
  --ragged): equal tokens per step.
* The routing table: every refusal shown (--kv-quant on a pure SSM,
  --prefix-cache and --chunk-prefill on both, --prequantize on the hybrid
  with the reference shown failing, --attn-impl flash on a pure SSM).
* Layouts, walkers, slot ops, the serving init, ``decode_state_traffic``
  and the ``EnergyMeter`` split against the reference's; one zamba2 chaos
  serve pair."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import hwmodel as rhw
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import faults as rfaults
from repro.runtime import kv_cache as rkvc
from repro.runtime import kv_quant as rkvq
from repro.runtime import layouts as rlayouts
from repro.runtime import telemetry as rtel
from repro_torch import configs as tconfigs
from repro_torch.core import hwmodel as thw
from repro_torch.core import yoco_linear as tyl
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.runtime import faults as tfaults
from repro_torch.runtime import kv_quant as tkvq
from repro_torch.runtime import layouts as tlayouts
from repro_torch.runtime import telemetry as ttel

SSM, HYB = 'mamba2-780m', 'zamba2-1.2b'
ARCHS = [SSM, HYB]
VOCAB = 128                     # both smoke vocabularies hold these ids
KW = dict(slots=3, prompt_len=40, gen_len=6, page_size=4)
# 20 pages admit two 40-position prompts but cannot grow both past them
POOLS = {'default': None, 'preempting': 1 + 20}
B, PLEN, STEPS, PS = 2, 70, 3, 8


def _stream(mod):
    rng = np.random.RandomState(11)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, VOCAB, 33 + (i * 5) % 8).astype(np.int32),
                target_gen=3 + (i * 3) % 4) for i in range(5)]


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    p = rmodel.init_params(jax.random.key(0), rconfigs.get(arch, smoke=True))
    return jax.tree.map(np.asarray, p)


def _port_params(arch):
    return tmodel.params_from_numpy(_params_np(arch),
                                    tconfigs.get(arch, smoke=True), 'cpu')


# ----------------------------------------------------------------------------
# forward: prefill and decode logits, the recurrent state
# ----------------------------------------------------------------------------
def _prompts():
    return np.random.RandomState(0).randint(0, VOCAB, (B, PLEN)) \
        .astype(np.int32)


def _tables(w):
    perm = np.random.RandomState(1).permutation(np.arange(1, 1 + B * w))
    return perm.reshape(B, w).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference_forward(arch, mode, prequant, dtype=jnp.float32):
    from repro.core import yoco_linear as ryl
    cfg = rconfigs.get(arch, smoke=True)
    yoco = YocoConfig(mode=mode, compute_dtype=dtype)
    rt = ModelRuntime(compute_dtype=dtype)
    params = jax.tree.map(jnp.asarray, _params_np(arch))
    if prequant:
        params = ryl.quantize_tree(params)
    w = -(-(PLEN + STEPS) // PS)
    cache = rmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=dtype)
    cache = rkvc.with_block_tables(cache, jnp.asarray(_tables(w)))
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(p, t, pos, c,
                                                             cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts()), cache)
    rows = [np.asarray(logits, np.float32)]
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode(params, tok, jnp.full((B,), PLEN + i,
                                                     jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return np.stack(rows), jax.tree.map(np.asarray, cache['ssm'])


def _port_forward(arch, mode, prequant, dtype=torch.float32):
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=dtype)
    rt = tmodel.ModelRuntime(attn_impl='flash', compute_dtype=dtype)
    params = tmodel.serving_form(_port_params(arch), mode, prequant, dtype)
    w = -(-(PLEN + STEPS) // PS)
    cache = tmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=dtype, device='cpu')
    cache = tlayouts.with_block_tables(cache, _tables(w))
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts())), cache, cfg, yoco,
        rt)
    rows = [logits.float().numpy()]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = tmodel.decode_step(
            params, tok, torch.full((B,), PLEN + i, dtype=torch.int32), cache,
            cfg, yoco, rt)
        rows.append(logits.float().numpy())
    return np.stack(rows), tmodel.cache_to_numpy(cache['ssm'])


# zamba2's dynamic w8a8 forward: its activations hold values within 1e-6
# of a rounding boundary of K3's codes (hundreds a forward at smoke width),
# and the port's f32 products (the shared in_proj above all) differ from
# XLA's in the last bit, so a code flips and the logits move by up to a
# few 1e-2; there the greedy tokens are held equal and the logits to
# W8A8_FLIP_TOL, as the card's smoke phase allows boundary flips
W8A8_FLIP_TOL = 5e-2


@pytest.mark.parametrize('arch,mode,prequant,tol', [
    (SSM, 'bf16', False, 1e-4), (SSM, 'w8a8', True, 1e-4),
    (HYB, 'bf16', False, 1e-4), (HYB, 'w8a8', False, W8A8_FLIP_TOL)])
def test_forward_logits_and_state_match_reference_f32(arch, mode, prequant,
                                                      tol):
    want, want_st = _reference_forward(arch, mode, prequant)
    got, got_st = _port_forward(arch, mode, prequant)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    for k in ('conv', 'ssm'):
        np.testing.assert_allclose(got_st[k], want_st[k], rtol=0,
                                   atol=max(2e-4, tol), err_msg=k)


@pytest.mark.parametrize('arch', ARCHS)
def test_forward_bf16_first_logits_within_reference_tolerance(arch):
    """bf16 compute: the first logits within the reference's 2e-2 of its
    own, or, where the reference's bf16 logits are farther than that from
    its f32 logits, within that distance. zamba2's are (0.049 at smoke
    width): its shared block's residual ``x + (y - h)`` cancels the
    block's input, and XLA keeps excess precision across that fused sum
    where eager bf16 rounds ``y`` first."""
    want, _ = _reference_forward(arch, 'bf16', False, jnp.bfloat16)
    truth, _ = _reference_forward(arch, 'bf16', False)
    got, _ = _port_forward(arch, 'bf16', False, torch.bfloat16)
    tol = max(2e-2, float(np.abs(want[0] - truth[0]).max()))
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=tol)


@pytest.mark.parametrize('arch', ARCHS)
def test_masked_padded_prefill_equals_unpadded(arch):
    """A prompt of 41 tokens padded to 70 with ``last_pos`` 40 gives the
    41-token prefill's logits and recurrent state (and the reference's)."""
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(compute_dtype=torch.float32)
    params = _port_params(arch)
    toks = torch.from_numpy(_prompts()[:1])
    outs = []
    for inputs, lp in ((toks[:, :41], None), (toks, torch.tensor([40]))):
        cache = tmodel.init_cache_tree(cfg, 1, PLEN + 4, dtype=torch.float32,
                                       device='cpu')
        logits, cache = tmodel.prefill(params, dict(inputs=inputs), cache,
                                       cfg, yoco, rt, last_pos=lp)
        outs.append((logits.numpy(), tmodel.cache_to_numpy(cache['ssm'])))
    (l_ref, s_ref), (l_pad, s_pad) = outs
    np.testing.assert_allclose(l_pad, l_ref, rtol=0, atol=1e-4)
    for k in ('conv', 'ssm'):
        np.testing.assert_allclose(s_pad[k], s_ref[k], rtol=0, atol=2e-4,
                                   err_msg=k)
    rcfg = rconfigs.get(arch, smoke=True)
    rcache = rmodel.init_cache_tree(rcfg, 1, PLEN + 4, dtype=jnp.float32)
    want, rcache = jax.jit(lambda p, t, c, lp: rmodel.prefill(
        p, dict(inputs=t), c, rcfg, YocoConfig(compute_dtype=jnp.float32),
        ModelRuntime(compute_dtype=jnp.float32), last_pos=lp))(
        jax.tree.map(jnp.asarray, _params_np(arch)), jnp.asarray(toks),
        rcache, jnp.asarray([40]))
    np.testing.assert_allclose(l_pad, np.asarray(want), rtol=0, atol=1e-4)
    for k in ('conv', 'ssm'):
        np.testing.assert_allclose(s_pad[k], np.asarray(rcache['ssm'][k]),
                                   rtol=0, atol=2e-4, err_msg=k)


# ----------------------------------------------------------------------------
# continuous and static serving
# ----------------------------------------------------------------------------
def _f32_reference(mp):
    mp.setattr(rserve, 'YocoConfig',
               functools.partial(YocoConfig, compute_dtype=jnp.float32))
    mp.setattr(rserve, 'ModelRuntime',
               functools.partial(ModelRuntime, compute_dtype=jnp.float32))
    for name in ('init_paged_cache_tree', 'init_cache_tree'):
        mp.setattr(rserve.model_mod, name, functools.partial(
            getattr(rmodel, name), dtype=jnp.float32))


# (arch, pool, mode, prequantize, options). zamba2's dynamic w8a8 is held
# to the reference's schedule, not its tokens: a K3 code flips at a
# rounding boundary there (see W8A8_FLIP_TOL) and moves a greedy choice
SERVE_CASES = [
    (SSM, 'default', 'bf16', False, {}),
    (SSM, 'preempting', 'w8a8', True, {}),
    (SSM, 'default', 'w8a8', False, {}),
    (HYB, 'default', 'bf16', False, {}),
    (HYB, 'preempting', 'bf16', False, {}),
    (HYB, 'preempting', 'w8a8', False, {}),
    (HYB, 'default', 'bf16', False, dict(kv_quant=True, hot_window=1)),
]


def _schedule(out):
    return [(e['kind'], e['step'], e.get('rid'), e.get('slot'))
            for e in out['event_log']]


@pytest.mark.parametrize('arch,pool,mode,prequant,opts', SERVE_CASES,
                         ids=lambda v: str(v))
def test_serve_f32_tokens_match_reference(arch, pool, mode, prequant, opts):
    with pytest.MonkeyPatch.context() as mp:
        _f32_reference(mp)
        ref = rserve.serve_continuous(
            arch, mode=mode, prequantize=prequant, num_pages=POOLS[pool],
            attn_impl='einsum', metrics=False, quiet=True,
            request_stream=_stream(rserve), **KW, **opts)
    got = tserve.serve_continuous(
        arch, mode=mode, prequantize=prequant, num_pages=POOLS[pool],
        quiet=True, metrics=False, request_stream=_stream(tserve),
        device='cpu', compute_dtype=torch.float32, params=_port_params(arch),
        step_hook=lambda sched, kv, cache: kv.check_invariants(), **KW,
        **opts)
    assert got['completed'] == ref['completed'] == 5
    assert _schedule(got) == _schedule(ref)
    assert got['out_lens'] == ref['out_lens']
    if not (arch == HYB and mode == 'w8a8'):
        assert got['outputs'] == ref['outputs']
    assert got['terminal'] == ref['terminal']
    assert got['events'] == ref['events']
    assert (got['preempted'] > 0) == (pool == 'preempting')
    assert got['pages_quantized'] == ref['pages_quantized']
    assert (got['pages_quantized'] > 0) == bool(opts.get('kv_quant'))


STATIC_CASES = [(HYB, 'flash', False), (HYB, 'einsum', True),
                (SSM, 'einsum', True)]


@pytest.mark.parametrize('arch,impl,ragged', STATIC_CASES)
def test_static_serve_tokens_match_reference(arch, impl, ragged):
    """The static serve() in f32: the reference's greedy tokens (its
    einsum route), recorded per decode step, equal the port's; --ragged
    pads the prompts, which the Mamba2 layers mask past each row's
    last position."""
    kw = dict(batch=3, prompt_len=40, gen_len=5, ragged=ragged)
    prompts = np.random.RandomState(5).randint(
        0, VOCAB, (kw['batch'], kw['prompt_len'])).astype(np.int32)
    steps = []
    with pytest.MonkeyPatch.context() as mp:
        _f32_reference(mp)
        mp.setattr(rserve.synthetic, 'make_batch',
                   lambda dc, step: dict(inputs=jnp.asarray(prompts)))
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

        mp.setattr(rserve.SS, 'make_decode_step', recording_make)
        rserve.serve(arch, quiet=True, **kw)
        jax.effects_barrier()
    want = np.stack([steps[0][0]] + [t for _, t in steps], axis=1)
    got = tserve.serve(arch, quiet=True, device='cpu',
                       compute_dtype=torch.float32, attn_impl=impl,
                       params=_port_params(arch), prompts=prompts, **kw)
    assert got['generated_shape'] == [3, 5]
    np.testing.assert_array_equal(got['tokens'], want)


# ----------------------------------------------------------------------------
# the routing table
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('arch,opts,match', [
    (SSM, dict(kv_quant=True), '--kv-quant tiers paged attention KV'),
    (SSM, dict(prefix_cache=True), '--prefix-cache needs random-access'),
    (HYB, dict(prefix_cache=True), '--prefix-cache needs random-access'),
    (SSM, dict(chunk_prefill=8), '--chunk-prefill needs random-access'),
    (HYB, dict(chunk_prefill=8), '--chunk-prefill needs random-access'),
    (HYB, dict(mode='w8a8', prequantize=True), 'blocks.py:136'),
])
def test_continuous_refusals_match_the_reference_routing(arch, opts, match):
    """Each refusal fires before any weight is drawn, on the CPU, with the
    reason; the reference refuses the same flags (its hybrid
    --prequantize instead fails inside shared_block, shown below)."""
    with pytest.raises(ValueError, match=match):
        tserve.serve_continuous(arch, device='cpu', quiet=True, n_requests=1,
                                **opts)
    if 'prequantize' not in opts:
        with pytest.raises(ValueError):
            rserve.serve_continuous(arch, quiet=True, n_requests=1, **opts)


def test_hybrid_prequantize_refused_where_the_reference_fails():
    """The reference quantizes zamba2's per-site shared in_proj and then
    feeds the QuantizedWeight to an einsum (src/repro/models/blocks.py:
    136): a ValueError from inside the serve, on both paths. The port
    refuses the mode up front on both; mamba2 --prequantize serves."""
    for fn in (rserve.serve_continuous, rserve.serve):
        with pytest.raises(ValueError, match='Einstein sum subscript'):
            fn(HYB, mode='w8a8', prequantize=True, quiet=True,
               **(dict(n_requests=1, prompt_len=8, gen_len=2)
                  if fn is rserve.serve_continuous
                  else dict(batch=1, prompt_len=8, gen_len=2)))
    for fn in (tserve.serve_continuous, tserve.serve):
        with pytest.raises(ValueError, match='not served on hybrid'):
            fn(HYB, mode='w8a8', prequantize=True, quiet=True, device='cpu')
    out = tserve.serve(SSM, mode='w8a8', prequantize=True, quiet=True,
                       device='cpu', batch=2, prompt_len=8, gen_len=2)
    assert out['generated_shape'] == [2, 2]
    with pytest.raises(ValueError, match='pure-SSM decode has no attention'):
        tserve.serve(SSM, attn_impl='flash', device='cpu', quiet=True)


# ----------------------------------------------------------------------------
# cache trees, layouts, slot ops, serving init
# ----------------------------------------------------------------------------
def test_recurrent_trees_classify_and_walk_as_reference():
    """Leaf for leaf as the reference: the trees' structure, the layouts
    each node classifies to, the walkers' pass-through of recurrent nodes
    (a hybrid's site pools quantized and scrubbed through them), and the
    slot ops through the registry."""
    sizes = dict(num_pages=9, page_size=4, max_blocks=4, hot_window=1)
    for arch, kv_dtype in ((SSM, None), (HYB, None), (HYB, 'int8')):
        rcfg = rconfigs.get(arch, smoke=True)
        tcfg = tconfigs.get(arch, smoke=True)
        ref = rmodel.init_paged_cache_tree(rcfg, 2, dtype=jnp.float32,
                                           kv_dtype=kv_dtype, **sizes)
        mine = tmodel.init_paged_cache_tree(tcfg, 2, dtype=torch.float32,
                                            kv_dtype=kv_dtype, device='cpu',
                                            **sizes)
        assert set(ref) == set(mine)
        assert tlayouts.get_layout(mine['ssm']) is tlayouts.RecurrentLayout
        assert rlayouts.get_layout(ref['ssm']) is rlayouts.RecurrentLayout
        assert mine['ssm']['ssm'].dtype == torch.float32
        if arch == HYB:
            assert tlayouts.get_layout(mine) is tlayouts.HybridLayout
            want = (tlayouts.PagedQ8Layout if kv_dtype
                    else tlayouts.PagedLayout)
            assert tlayouts.get_layout(mine['attn']) is want
        rng = np.random.RandomState(7)
        ref = jax.tree.map(lambda a: jnp.asarray(
            rng.randn(*a.shape).astype(np.float32)).astype(a.dtype)
            if a.dtype != jnp.int32 else a, ref)
        ref_np = jax.tree.map(np.asarray, ref)
        mine = tmodel.cache_from_numpy(ref_np, 'cpu')
        back = tmodel.cache_to_numpy(mine)
        assert jax.tree.structure(back) == jax.tree.structure(ref_np)
        tables = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
        pages = np.array([1, 3, 0, 0], np.int32)
        want = rlayouts.scrub_tree_pages(
            jax.jit(rkvq.quantize_tree_pages)(
                rkvc.with_block_tables(ref, jnp.asarray(tables)),
                jnp.asarray(pages)), jnp.array([7], jnp.int32))
        want = rlayouts.poison_tree_pages(want, jnp.array([5], jnp.int32))
        want = rlayouts.zero_tree_tail(want, jnp.asarray(tables[0]), 5, 14)
        want = rlayouts.copy_tree_pages(want, 3, 2)
        got = tlayouts.scrub_tree_pages(
            tkvq.quantize_tree_pages(
                tlayouts.with_block_tables(mine, tables),
                torch.from_numpy(pages)), torch.tensor([7]))
        got = tlayouts.poison_tree_pages(got, torch.tensor([5]))
        got = tlayouts.zero_tree_tail(got, tables[0], 5, 14)
        got = tlayouts.copy_tree_pages(got, 3, 2)
        # the slot ops: reset slot 1, prefill-style snapshot of slot 0
        # changed and restored
        want = rlayouts.reset_state_slots(want, [1])
        snap = rlayouts.slice_state_slot(want, 0)
        snap = dict(snap, ssm=jax.tree.map(lambda a: a * 2, snap['ssm']))
        want = rlayouts.merge_state_slot(want, snap, 0)
        got = tlayouts.reset_state_slots(got, [1])
        part = tlayouts.slice_state_slot(got, 0)
        for leaf in part['ssm'].values():
            leaf.mul_(2)
        got = tlayouts.merge_state_slot(got, part, 0)
        got, want = tmodel.cache_to_numpy(got), jax.tree.map(np.asarray,
                                                              want)
        for (path, w), g in zip(jax.tree_util.tree_leaves_with_path(want),
                                jax.tree.leaves(got)):
            np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_pure_ssm_refuses_an_int8_tier():
    with pytest.raises(ValueError, match='no int8 tier'):
        tmodel.init_paged_cache_tree(tconfigs.get(SSM, smoke=True), 2,
                                     num_pages=5, page_size=4, max_blocks=2,
                                     kv_dtype='int8', device='cpu')


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
    (SSM, 'bf16', False), (SSM, 'w8a8', True), (SSM, 'w8a8', False),
    (HYB, 'bf16', False), (HYB, 'w8a8', False)])
def test_serving_init_bit_equal_to_init_then_convert(arch, mode, prequant):
    """Mamba2's in_proj and out_proj take their serving form as they are
    drawn (int8 K-major with --prequantize, bf16, or K-major f32 in
    dynamic w8a8), equal to the f32 tree converted after; the shared
    block's per-site in_proj stays an f32 einsum weight in every mode."""
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
    mixer = got['layers'][0]['mixer']
    for name in ('in_proj', 'out_proj'):
        w = mixer[name]
        if prequant:
            assert isinstance(w, tyl.QuantizedWeight), name
            assert w.wq.t().is_contiguous(), name
        elif mode == 'bf16':
            assert w.dtype == torch.bfloat16, name
        else:
            assert w.dtype == torch.float32 and w.t().is_contiguous(), name
    if arch == HYB:
        shared = got['shared']['in_proj']
        assert shared.dtype == torch.float32 and shared.is_contiguous()
        assert shared.shape == (cfg.n_layers // cfg.hybrid_group,
                                2 * cfg.d_model, cfg.d_model)


def test_param_count_and_structure_match_reference():
    for arch in ARCHS:
        for smoke in (False, True):
            r, t = rconfigs.get(arch, smoke=smoke), tconfigs.get(arch,
                                                                smoke=smoke)
            assert t.param_count() == r.param_count()
            assert t.per_token_matmuls() == r.per_token_matmuls()
            assert t.attention_free == r.attention_free
            assert t.supports_long_context == r.supports_long_context
        assert tmodel._n_mamba(t) == rmodel._n_mamba(r)
        assert tmodel._n_sites(t) == rmodel._n_sites(r)
    tree = _port_params(HYB)
    ref = _params_np(HYB)
    assert len(tree['layers']) == ref['layers']['norm']['scale'].shape[0]
    np.testing.assert_array_equal(tree['shared']['in_proj'].numpy(),
                                  ref['shared']['in_proj'])


# ----------------------------------------------------------------------------
# telemetry: the recurrent state's traffic and the meter split
# ----------------------------------------------------------------------------
def test_decode_state_traffic_and_meter_split_match_reference():
    for kw in (dict(conv_elems=9984, ssm_elems=393216, n_heads=48,
                    n_layers=48),
               dict(conv_elems=3, ssm_elems=7, n_heads=1, n_layers=1,
                    fp_bytes=2)):
        assert thw.decode_state_traffic(**kw) == \
            rhw.decode_state_traffic(**kw)
    rng = np.random.RandomState(3)
    trace = [[(int(rng.randint(1, 300)), int(rng.randint(0, 40)))
              for _ in range(rng.randint(0, 5))] for _ in range(30)]
    for arch in ARCHS:
        for smoke in (False, True):
            for kv_quant in (False, True):
                kw = dict(page_size=8, kv_quant=kv_quant, hot_window=2)
                got = ttel.EnergyMeter(tconfigs.get(arch, smoke=smoke), **kw)
                want = rtel.EnergyMeter(rconfigs.get(arch, smoke=smoke), **kw)
                assert (got.n_attn, got.n_mamba) == (want.n_attn,
                                                     want.n_mamba)
                for lanes in trace:
                    assert got.observe_step(lanes) == \
                        want.observe_step(lanes)
                assert got.totals() == want.totals()
    full = ttel.EnergyMeter(tconfigs.get(SSM), page_size=8)
    # mamba2-780m: 77.4 MB of f32 state a slot, read and written a token
    assert full._state['state_bytes_resident'] == 77_414_400
    assert (full.n_attn, full.n_mamba) == (0, 48)
    hyb = ttel.EnergyMeter(tconfigs.get(HYB), page_size=8)
    assert (hyb.n_attn, hyb.n_mamba) == (6, 32)


# ----------------------------------------------------------------------------
# chaos: one zamba2 pair
# ----------------------------------------------------------------------------
class _CopyingNumpy:
    """numpy, but ``asarray`` returns a writable copy (the reference NaNs
    a poisoned logits row in place, in f32 a read-only view)."""

    def __getattr__(self, name):
        return getattr(np, name)

    @staticmethod
    def asarray(a, *args, **kw):
        return np.array(a, *args, **kw)


CHAOS = [(2, 'poison_page', None), (3, 'preempt_storm', 1),
         (5, 'poison_logits', None)]


def test_hybrid_chaos_serve_matches_reference():
    """zamba2 under a poisoned page, a preemption storm and a poisoned
    logits row: the same event records, terminal map, fault counts and
    quarantines as the reference, the quarantined lane's recurrent rows
    zeroed before reuse (its requeue recomputes), the untouched requests'
    tokens equal, and the same modelled energy."""
    kw = dict(KW, gen_len=8)
    with pytest.MonkeyPatch.context() as mp:
        _f32_reference(mp)
        mp.setattr(rserve, 'np', _CopyingNumpy())
        rinj = rfaults.FaultInjector(0, rfaults.FaultProfile(),
                                     schedule=CHAOS)
        ref = rserve.serve_continuous(HYB, attn_impl='einsum', quiet=True,
                                      faults=rinj,
                                      request_stream=_stream(rserve), **kw)
    tinj = tfaults.FaultInjector(0, tfaults.FaultProfile(), schedule=CHAOS)
    got = tserve.serve_continuous(
        HYB, quiet=True, faults=tinj, request_stream=_stream(tserve),
        device='cpu', compute_dtype=torch.float32, params=_port_params(HYB),
        step_hook=lambda sched, kv, cache: kv.check_invariants(), **kw)

    def records(out):
        return [{k: v for k, v in e.items() if k not in ('t', 'prefill_s')}
                for e in out['event_log']]
    assert records(got) == records(ref)
    assert got['terminal'] == ref['terminal']
    assert got['faults'] == ref['faults'] == dict(tinj.counts)
    assert got['quarantined'] == ref['quarantined'] >= 1
    assert tinj.touched == rinj.touched
    clean = set(ref['outputs']) - rinj.touched
    assert {r: got['outputs'][r] for r in clean} == \
        {r: ref['outputs'][r] for r in clean}
    assert got['telemetry']['energy'] == ref['telemetry']['energy']
