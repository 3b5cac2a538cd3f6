"""The port's dense model (stablelm smoke) against the reference: prefill
plus 16 decode steps over the paged cache, both decode routes (einsum
oracle, and flash through the plain K1), all three serving modes.

In f32 end to end: logits within 1e-4 (reduction order differs, so not
bitwise), greedy tokens equal, pools equal after ``cache_to_numpy``. In
bf16: logits within 5e-2, the reference's own bound
(tests/test_flash_decode.py)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.models import attention as rattention
from repro.models import model as rmodel
from repro.runtime import kv_cache as rkvc
from repro.runtime import layouts as rlayouts
from repro_torch.core import yoco_linear as tyl
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import layouts as tlayouts

ARCH = 'stablelm-1.6b'
B, PLEN, STEPS, PS = 3, 10, 16, 4


@functools.lru_cache(maxsize=None)
def _ref_params(prequant):
    cfg = rconfigs.get(ARCH, smoke=True)
    p = rmodel.init_params(jax.random.key(0), cfg)
    return ryl.quantize_tree(p) if prequant else p


@functools.lru_cache(maxsize=None)
def _reference_run(mode, prequant, dtype_name):
    """Prefill + STEPS greedy decode steps through the jitted reference
    (einsum route). Returns (logits (STEPS+1, B, V), tokens, pools)."""
    cfg = rconfigs.get(ARCH, smoke=True)
    dt = jnp.float32 if dtype_name == 'float32' else jnp.bfloat16
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=dt)
    rt = rmodel.ModelRuntime(compute_dtype=dt)
    params = _ref_params(prequant)
    w = -(-(PLEN + STEPS) // PS)
    cache = rmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w, dtype=dt)
    cache = rkvc.with_block_tables(cache, jnp.asarray(_tables(w)))
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(p, t, pos, c,
                                                             cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts()), cache)
    rows, toks = [np.asarray(logits, np.float32)], []
    tok = jnp.argmax(logits, -1).astype(jnp.int32)
    for i in range(STEPS):
        toks.append(np.asarray(tok))
        logits, cache = decode(params, tok, jnp.full((B,), PLEN + i,
                                                     jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
    pools = {k: np.asarray(v, np.float32)
             for k, v in cache['layers'].items() if k != 'bt'}
    return np.stack(rows), np.stack(toks), pools


def _prompts():
    return np.random.RandomState(0).randint(0, 256, (B, PLEN)).astype(np.int32)


def _tables(w):
    """Shuffled, non-contiguous pages for every slot."""
    perm = np.random.RandomState(1).permutation(np.arange(1, 1 + B * w))
    return perm.reshape(B, w).astype(np.int32)


def _port_run(mode, prequant, dtype_name, attn_impl):
    cfg = rconfigs.get(ARCH, smoke=True)
    dt = torch.float32 if dtype_name == 'float32' else torch.bfloat16
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=dt)
    rt = tmodel.ModelRuntime(attn_impl=attn_impl, compute_dtype=dt)
    params = tmodel.params_from_numpy(
        jax.tree.map(np.asarray, _ref_params(prequant)), cfg, 'cpu')
    w = -(-(PLEN + STEPS) // PS)
    cache = tmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=dt, device='cpu')
    cache = tlayouts.with_block_tables(cache, _tables(w))
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts())), cache, cfg, yoco,
        rt)
    rows, toks = [logits.float().numpy()], []
    tok = torch.argmax(logits, -1).to(torch.int32)
    for i in range(STEPS):
        toks.append(tok.numpy())
        logits, cache = tmodel.decode_step(
            params, tok, torch.full((B,), PLEN + i, dtype=torch.int32), cache,
            cfg, yoco, rt)
        rows.append(logits.float().numpy())
        tok = torch.argmax(logits, -1).to(torch.int32)
    pools = {k: v for k, v in tmodel.cache_to_numpy(cache)['layers'].items()
             if k != 'bt'}
    return np.stack(rows), np.stack(toks), pools


MODES = [('bf16', False), ('w8a8', True), ('w8a8', False)]


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
@pytest.mark.parametrize('mode,prequant', MODES)
def test_model_f32_matches_reference(mode, prequant, attn_impl):
    want_l, want_t, want_p = _reference_run(mode, prequant, 'float32')
    got_l, got_t, got_p = _port_run(mode, prequant, 'float32', attn_impl)
    np.testing.assert_allclose(got_l, want_l, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got_t, want_t)
    for key in want_p:
        np.testing.assert_allclose(got_p[key], want_p[key], rtol=1e-5,
                                   atol=1e-5, err_msg=key)


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_model_bf16_within_reference_bound(attn_impl):
    want_l = _reference_run('bf16', False, 'bfloat16')[0]
    got_l = _port_run('bf16', False, 'bfloat16', attn_impl)[0]
    # the first three rows see identical inputs; later rows may follow
    # greedy tokens that differ, so hold prefill + first decode step
    np.testing.assert_allclose(got_l[:2], want_l[:2], atol=5e-2)


def test_cache_roundtrip_numpy():
    cfg = rconfigs.get(ARCH, smoke=True)
    cache = rmodel.init_paged_cache_tree(cfg, 2, num_pages=5, page_size=4,
                                         max_blocks=2, dtype=jnp.float32)
    cache = jax.tree.map(
        lambda a: np.random.RandomState(0).randn(*a.shape).astype(a.dtype),
        cache)
    back = tmodel.cache_to_numpy(tmodel.cache_from_numpy(cache, 'cpu'))
    for key in cache['layers']:
        np.testing.assert_array_equal(back['layers'][key],
                                      cache['layers'][key])


def test_init_paged_cache_matches_reference():
    cfg = rconfigs.get(ARCH, smoke=True)
    sizes = dict(num_pages=5, page_size=4, max_blocks=2)
    want = rattention.init_paged_cache(cfg, 3, dtype=jnp.float32, **sizes)
    got = tattention.init_paged_cache(cfg, 3, dtype=torch.float32,
                                      device='cpu', **sizes)
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
        assert str(got[key].dtype).replace('torch.', '') == \
            str(want[key].dtype), key


@pytest.mark.parametrize('pos', [5, (1, 7, 0)], ids=['scalar', 'per_slot'])
def test_contiguous_layout_matches_reference(pos):
    """The contiguous layout's classification, prefill and token writes and
    its densify view, against the reference's on the same numpy inputs."""
    rng = np.random.RandomState(3)
    shape, plen = (3, 12, 2, 4), 4
    pre = {k: rng.randn(3, plen, 2, 4).astype(np.float32) for k in 'kv'}
    tok = {k: rng.randn(3, 1, 2, 4).astype(np.float32) for k in 'kv'}
    posv = np.asarray(pos, np.int32)
    rlay = rlayouts.get_layout(dict(k=0, v=0))
    tlay = tlayouts.get_layout(dict(k=0, v=0))
    assert rlay.name == tlay.name == 'contiguous'
    assert tlayouts.get_layout(dict(k=0, v=0, bt=0)).name == 'paged'
    rc = {k: jnp.zeros(shape, jnp.float32) for k in 'kv'}
    rc = rlay.write_prefill(rc, {k: jnp.asarray(a) for k, a in pre.items()})
    rc = rlay.write_token(rc, {k: jnp.asarray(a) for k, a in tok.items()},
                          jnp.asarray(posv))
    tc = {k: torch.zeros(shape) for k in 'kv'}
    tc = tlay.write_prefill(tc, {k: torch.from_numpy(a)
                                 for k, a in pre.items()})
    tc = tlay.write_token(tc, {k: torch.from_numpy(a) for k, a in tok.items()},
                          torch.from_numpy(posv))
    for want, got in zip(rlay.gather(rc, posv), tlay.gather(tc, posv)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the layout's flash read (K7's plain version here) against the
    # reference's (its Pallas kernel, interpret mode) on the same cache
    q = rng.randn(3, 1, 2, 4).astype(np.float32)
    want = rlay.flash_decode(jnp.asarray(q), rc, jnp.asarray(posv),
                             scale=0.5, interpret=True)
    got = tlay.flash_decode(torch.from_numpy(q), tc, torch.from_numpy(posv),
                            scale=0.5)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=1e-5)


@pytest.mark.parametrize('mla', [False, True], ids=['gqa', 'mla'])
def test_init_cache_and_tree_match_reference(mla):
    """Contiguous caches: the one-layer dict and the layer-stacked tree,
    leaf for leaf in shape, dtype and (zero) content, and the layout each
    classifies as."""
    import dataclasses
    cfg = rconfigs.get(ARCH, smoke=True)
    if mla:
        cfg = dataclasses.replace(rconfigs.get('deepseek-v3-671b',
                                               smoke=True), moe=None)
    for dt_j, dt_t in ((jnp.bfloat16, torch.bfloat16),
                       (jnp.float32, torch.float32)):
        want = rattention.init_cache(cfg, 3, 11, dt_j)
        got = tattention.init_cache(cfg, 3, 11, dt_t, device='cpu')
        rtree = rmodel.init_cache_tree(cfg, 3, 11, dt_j)
        ttree = tmodel.init_cache_tree(cfg, 3, 11, dt_t, device='cpu')
        assert set(got) == set(want) and set(ttree) == set(rtree)
        assert set(ttree['layers']) == set(rtree['layers'])
        for one, ref in ((got, want), (ttree['layers'], rtree['layers'])):
            for key, leaf in ref.items():
                assert tuple(one[key].shape) == leaf.shape, key
                assert one[key].dtype == dt_t and leaf.dtype == dt_j, key
                assert not bool(one[key].any()), key
        assert tlayouts.get_layout(got).name == \
            rlayouts.get_layout(want).name == \
            ('contiguous_mla' if mla else 'contiguous')


def test_scatter_gather_pages_match_reference():
    rng = np.random.RandomState(2)
    pool = np.zeros((9, 4, 2, 3), np.float32)
    bt = rng.permutation(np.arange(1, 9)).reshape(2, 4).astype(np.int32)
    dense = rng.randn(2, 16, 2, 3).astype(np.float32)
    want = np.asarray(rkvc.scatter_pages(jnp.asarray(pool),
                                         jnp.asarray(dense), jnp.asarray(bt)))
    got = tkvc.scatter_pages(torch.from_numpy(pool.copy()),
                             torch.from_numpy(dense), torch.from_numpy(bt))
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tkvc.gather_pages(got, torch.from_numpy(bt)).numpy(),
        np.asarray(rkvc.gather_pages(jnp.asarray(want), jnp.asarray(bt))))
    with pytest.raises(ValueError, match='multiple of the page size'):
        tkvc.scatter_pages(torch.zeros(9, 4, 2, 3), torch.zeros(2, 6, 2, 3),
                           torch.from_numpy(bt))
    with pytest.raises(ValueError, match='block-table capacity'):
        tkvc.scatter_pages(torch.zeros(9, 4, 2, 3), torch.zeros(2, 20, 2, 3),
                           torch.from_numpy(bt))
    with pytest.raises(ValueError, match='block-table capacity'):
        tkvc.paged_prefill_update(torch.zeros(9, 4, 2, 3),
                                  torch.zeros(2, 17, 2, 3),
                                  torch.from_numpy(bt))
