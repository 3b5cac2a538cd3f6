"""The port's prefix cache and chunked prefill against the reference's: the
sharing allocator's admission plans, tables and refcounts, the chunk write,
kernel K5's plain version, the chunked attention layer and model, and
continuous serving with ``prefix_cache`` / ``chunk_prefill``.

Tolerances: allocator state equal; pools equal after the chunk write; K5's
plain version within 1e-5 of the reference kernel in interpret mode on the
rows below ``limit`` (padding rows attend only the fetch-union range: they
are held finite, not to a value); the chunked layer and model in f32 within
1e-4; serving in f32 with equal tokens, prefix counters and peak pages."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig
from repro.kernels import flash_decode as rfd
from repro.launch import serve as rserve
from repro.models import attention as rattention
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import kv_cache as rkvc
from repro.runtime import layouts as rlayouts
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_cache as tkvc
from repro_torch.runtime import layouts as tlayouts

ARCH = 'stablelm-1.6b'


def _state(kv):
    """Everything the allocator decides, for an equality check."""
    return dict(tables=kv.tables.tolist(), counts=kv.counts.tolist(),
                refs=kv.refs.tolist(), shared=kv.shared_blocks.tolist(),
                free=list(kv._free), evictable=list(kv._evictable),
                sealed=sorted(kv.sealed), quantized=sorted(kv.quantized_pages),
                scrub=list(kv.scrub_queue),
                counters=(kv.prefix_hits, kv.prefix_misses,
                          kv.prefix_evictions, kv.cow_copies),
                capacity=(kv.free_capacity, kv.cached_pages,
                          kv.shared_pages, kv.used_pages))


class _Pair:
    """The reference's allocator and the port's, driven op by op; every op
    must return the same value and leave the same state."""

    def __init__(self, *args, **kw):
        self.ref = rkvc.PagedKVCache(*args, prefix_cache=True, **kw)
        self.port = tkvc.PagedKVCache(*args, prefix_cache=True, **kw)

    def __call__(self, op, *args):
        want = getattr(self.ref, op)(*args)
        got = getattr(self.port, op)(*args)
        assert got == want, (op, args, got, want)
        self.port.check_invariants()
        assert _state(self.port) == _state(self.ref), (op, args)
        return got


# ----------------------------------------------------------------------------
# the sharing allocator
# ----------------------------------------------------------------------------
def test_cow_boundary_plans_match_reference():
    kv = _Pair(16, 4, 5, 4)
    prompt = np.arange(1, 13, dtype=np.int32)          # 3 full pages
    assert kv('admit_prompt', 0, prompt)['hit'] is False
    kv('seal_slot', 0, prompt)
    plan = kv('admit_prompt', 1, prompt)               # exact cover: COW
    assert plan['cow'] is not None and plan['prefill_start'] == 11
    plan = kv('admit_prompt', 2, np.concatenate([prompt, [99]]))
    assert plan['shared'] == 3 and plan['cow'] is None
    plan = kv('admit_prompt', 3, prompt[:10])          # unaligned cover
    assert plan['shared'] == 2 and plan['prefill_start'] == 8
    owners = [kv('owners_of', int(p)) for p in kv.port.tables[0, :3]]
    assert owners == [[0, 1, 2, 3], [0, 1, 2, 3], [0, 2]]
    for s in range(4):
        kv('release', s)
    assert kv.port.free_capacity == 15


def test_divergent_prefix_never_shares_like_reference():
    kv = _Pair(16, 4, 4, 2)
    prompt = np.arange(1, 13, dtype=np.int32)
    kv('admit_prompt', 0, prompt)
    kv('seal_slot', 0, prompt)
    other = prompt.copy()
    other[1] += 1
    plan = kv('admit_prompt', 1, other)
    assert not plan['hit'] and plan['shared'] == 0


def test_eviction_under_pressure_matches_reference():
    kv = _Pair(7, 4, 3, 2)
    prompt = np.arange(1, 13, dtype=np.int32)
    kv('admit_prompt', 0, prompt)
    kv('seal_slot', 0, prompt)
    kv('release', 0)
    other = np.arange(50, 62, dtype=np.int32)
    kv('admit_prompt', 0, other)
    kv('seal_slot', 0, other)
    assert kv('admit_prompt', 1, np.arange(80, 92, dtype=np.int32))
    assert kv.port.prefix_evictions >= 3
    kv('release', 0)
    kv('release', 1)
    assert not kv('admit_prompt', 0, prompt)['hit']


@pytest.mark.parametrize('seed', [0, 1])
def test_random_walk_matches_reference(seed):
    """Admissions from an overlapping prompt family, growth, releases,
    quarantines, retirements, squeezes and tier marks; the two allocators
    in lockstep with ``check_invariants()`` after every op."""
    rng = np.random.RandomState(seed)
    ps, slots, max_blocks = 4, 4, 5
    kv = _Pair(14, ps, max_blocks, slots)
    base = rng.randint(1, 40, size=max_blocks * ps).astype(np.int32)
    held = set()
    for _ in range(300):
        op = rng.randint(7)
        s = rng.randint(slots)
        if op == 0 and s not in held:
            p = base[:rng.randint(ps, max_blocks * ps + 1)].copy()
            if rng.rand() < 0.4:
                p[-1] = 100 + rng.randint(40)
            if kv('admit_prompt', s, p) is not None:
                kv('seal_slot', s, p)
                held.add(s)
        elif op == 1 and s in held:
            kv('ensure', s, rng.randint(max_blocks * ps))
        elif op == 2 and s in held:
            kv('release', s)
            held.discard(s)
        elif op == 3 and s in held:
            kv('defer_scrub', s)
            kv('release', s)
            kv('drain_scrub_queue')
            held.discard(s)
        elif op == 4:
            kv('reserve_pages', rng.randint(3))
        elif op == 5:
            kv('unreserve_pages', None)
        elif s in held:
            page = int(kv.port.tables[s, 0])
            kv.ref.quantized_pages.add(page)
            kv.port.quantized_pages.add(page)
            if rng.rand() < 0.3:
                kv('retire_page', page)
    for s in sorted(held):
        kv('release', s)
    kv('unreserve_pages', None)
    assert kv.port.free_capacity == 13 and kv.port.shared_pages == 0


def test_paged_chunk_update_matches_reference():
    rng = np.random.RandomState(3)
    n_pages, ps, w, b, c = 11, 4, 4, 2, 7
    pool = rng.randn(n_pages, ps, 2, 3).astype(np.float32)
    t = rng.randn(b, c, 2, 3).astype(np.float32)
    bt = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
    off = np.array([5, 12], np.int32)
    lim = np.array([9, 16], np.int32)                  # padded tails
    want = np.asarray(rkvc.paged_chunk_update(
        jnp.asarray(pool), jnp.asarray(t), jnp.asarray(off),
        jnp.asarray(lim), jnp.asarray(bt)))
    got = tkvc.paged_chunk_update(torch.from_numpy(pool.copy()),
                                  torch.from_numpy(t), torch.from_numpy(off),
                                  torch.from_numpy(lim),
                                  torch.from_numpy(bt)).numpy()
    # the garbage page takes every padding row; which one lands last is
    # the scatter's business (page 0 is never read unmasked)
    np.testing.assert_array_equal(got[1:], want[1:])
    assert not np.array_equal(got[1:], pool[1:])


# ----------------------------------------------------------------------------
# kernel K5: plain version
# ----------------------------------------------------------------------------
def _k5_case(seed):
    rng = np.random.RandomState(seed)
    b, w, ps, hkv, g, dh = 2, 6, 4, 2, 2, 16
    n_pages = 1 + b * w
    kp = rng.randn(n_pages, ps, hkv, dh).astype(np.float32)
    vp = rng.randn(n_pages, ps, hkv, dh).astype(np.float32)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w).astype(np.int32)
    return rng, kp, vp, bt, hkv * g, dh


@pytest.mark.parametrize('window', [None, 6])
@pytest.mark.parametrize('c,offset,limit', [(4, (8, 0), (14, 3)),
                                            (7, (14, 3), (19, 7))],
                         ids=['C4', 'C7'])
def test_k5_plain_matches_reference_kernel(c, offset, limit, window):
    rng, kp, vp, bt, h, dh = _k5_case(c)
    q = rng.randn(2, c, h, dh).astype(np.float32)
    off, lim = np.array(offset, np.int32), np.array(limit, np.int32)
    want = np.asarray(rfd.flash_chunk_paged(
        jnp.asarray(q), jnp.asarray(kp), jnp.asarray(vp), jnp.asarray(off),
        jnp.asarray(lim), jnp.asarray(bt), scale=0.25, window=window,
        interpret=True))
    got = tfd.flash_chunk_paged(
        torch.from_numpy(q), torch.from_numpy(kp), torch.from_numpy(vp),
        torch.from_numpy(off), torch.from_numpy(lim), torch.from_numpy(bt),
        scale=0.25, window=window).numpy()
    assert got.shape == q.shape and np.isfinite(got).all()
    valid = (off[:, None] + np.arange(c)[None, :]) < lim[:, None]   # (B, C)
    assert (~valid).any()                              # padding rows exist
    np.testing.assert_allclose(got[valid], want[valid], atol=1e-5, rtol=0)
    # chunk == 1 of the same entry point is K1
    one = tfd.flash_decode_gqa_paged_plain(
        torch.from_numpy(q[:, :1].reshape(2, 2, 2, dh)), torch.from_numpy(kp),
        torch.from_numpy(vp), torch.from_numpy(off),
        torch.full((2,), 25 if window is None else window, dtype=torch.int32),
        torch.from_numpy(bt), scale=0.25)
    np.testing.assert_allclose(one.reshape(2, h, dh).numpy(),
                               got[:, 0].astype(np.float32), atol=1e-5)


def test_k5_plain_rejects_a_chunk_without_offset():
    q = torch.zeros((1, 1, 4, 8))
    pools = torch.zeros((3, 4, 1, 8))
    z = torch.zeros((1,), dtype=torch.int32)
    bt = torch.zeros((1, 2), dtype=torch.int32)
    with pytest.raises(ValueError, match='offset'):
        tfd.flash_decode_gqa_paged_plain(q, pools, pools, z, z, bt,
                                         scale=1.0, chunk=2)


# ----------------------------------------------------------------------------
# chunked attention layer and model
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = rconfigs.get(ARCH, smoke=True)
    return jax.tree.map(np.asarray,
                        rmodel.init_params(jax.random.key(0), cfg))


F32_YOCO = YocoConfig(compute_dtype=jnp.float32)
T_YOCO = tyl.YocoConfig(compute_dtype=torch.float32)


@pytest.mark.parametrize('q8', [False, True], ids=['fp', 'q8'])
@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_attention_chunk_matches_reference(attn_impl, q8):
    cfg = rconfigs.get(ARCH, smoke=True)
    pj = jax.tree.map(lambda a: jnp.asarray(a[0]),
                      _ref_params()['layers'])['attn']
    pt = tmodel.params_from_numpy(_ref_params(), cfg, 'cpu')['layers'][0]
    rng = np.random.RandomState(8)
    b, w, ps, c = 2, 5, 4, 6
    ref = rattention.init_paged_cache(cfg, b, num_pages=1 + b * w,
                                      page_size=ps, max_blocks=w,
                                      dtype=jnp.float32,
                                      kv_dtype='int8' if q8 else None)
    bt = rng.permutation(np.arange(1, 1 + b * w)).reshape(b, w)
    ref = dict(ref, bt=jnp.asarray(bt, jnp.int32),
               k=jnp.asarray(rng.randn(*ref['k'].shape), jnp.float32),
               v=jnp.asarray(rng.randn(*ref['v'].shape), jnp.float32))
    port = tmodel.cache_from_numpy(jax.tree.map(np.asarray, ref), 'cpu')
    x = rng.randn(b, c, cfg.d_model).astype(np.float32)
    off, lim = np.array([4, 9], np.int32), np.array([8, 20], np.int32)
    want, wc = rattention.attention_chunk(
        pj, jnp.asarray(x), cfg, F32_YOCO, cache=ref, offset=jnp.asarray(off),
        limit=jnp.asarray(lim), rt=ModelRuntime(attn_impl='einsum'))
    got, gc = tattention.attention_chunk(
        pt['attn'], torch.from_numpy(x), cfg, T_YOCO, cache=port,
        offset=torch.from_numpy(off), limit=torch.from_numpy(lim),
        rt=tmodel.ModelRuntime(attn_impl=attn_impl,
                               compute_dtype=torch.float32))
    valid = (off[:, None] + np.arange(c)[None, :]) < lim[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=1e-4, rtol=1e-4)
    gc = tmodel.cache_to_numpy(gc)
    for key in ('k', 'v'):
        np.testing.assert_allclose(gc[key][1:], np.asarray(wc[key])[1:],
                                   atol=1e-5, err_msg=key)


def test_chunk_mask_matches_reference():
    off = np.array([0, 5, 11], np.int32)
    for window in (None, 4):
        want = np.asarray(rattention.chunk_mask(jnp.asarray(off), 6, 20,
                                                window))
        got = tattention.chunk_mask(torch.from_numpy(off), 6, 20,
                                    window).numpy()
        np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_prefill_chunk_matches_reference(attn_impl):
    """A 13-token prompt prefilled in chunks of 5 over a block table, then
    the last chunk's logits: f32 within 1e-4, pools within 1e-5."""
    cfg = rconfigs.get(ARCH, smoke=True)
    params = jax.tree.map(jnp.asarray, _ref_params())
    tp = tmodel.params_from_numpy(_ref_params(), cfg, 'cpu')
    plen, c, ps, w = 13, 5, 4, 4
    prompt = np.random.RandomState(9).randint(0, 256, plen).astype(np.int32)
    bt = np.array([[6, 2, 5, 3]], np.int32)
    ref = rmodel.init_paged_cache_tree(cfg, 1, num_pages=7, page_size=ps,
                                       max_blocks=w, dtype=jnp.float32)
    ref = rkvc.with_block_tables(ref, jnp.asarray(bt))
    port = tmodel.init_paged_cache_tree(cfg, 1, num_pages=7, page_size=ps,
                                        max_blocks=w, dtype=torch.float32,
                                        device='cpu')
    port = tlayouts.with_block_tables(port, bt)
    step = jax.jit(lambda p, t, o, l, cc: rmodel.prefill_chunk(
        p, dict(inputs=t), o, l, cc, cfg, F32_YOCO,
        ModelRuntime(compute_dtype=jnp.float32)))
    trt = tmodel.ModelRuntime(attn_impl=attn_impl,
                              compute_dtype=torch.float32)
    lim = np.array([plen], np.int32)
    for off in range(0, plen, c):
        ck = np.zeros((1, c), np.int32)
        ck[0, :len(prompt[off:off + c])] = prompt[off:off + c]
        want, ref = step(params, jnp.asarray(ck), jnp.asarray([off]),
                         jnp.asarray(lim), ref)
        got, port = tmodel.prefill_chunk(
            tp, dict(inputs=torch.from_numpy(ck)), torch.tensor([off]),
            torch.from_numpy(lim), port, cfg, T_YOCO, trt)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    gp = tmodel.cache_to_numpy(port)['layers']
    for key in ('k', 'v'):
        np.testing.assert_allclose(gp[key][:, 1:],
                                   np.asarray(ref['layers'][key])[:, 1:],
                                   atol=1e-5, err_msg=key)


# ----------------------------------------------------------------------------
# serving with the prefix cache and chunked prefill
# ----------------------------------------------------------------------------
SUFFIXES = [(2, 6), (0, 5), (3, 7), (1, 6), (4, 8)]
KW = dict(slots=5, prompt_len=16, gen_len=8, page_size=4)


def _shared_stream(mod, shared=12):
    """The reference test's stream: one 12-token system prompt (3 pages),
    per-request suffixes; the suffix-0 request is an exact cover (COW)."""
    rs = np.random.RandomState(0)
    sysp = rs.randint(1, 256, size=shared).astype(np.int32)
    return [mod.Request(rid=i, prompt=np.concatenate(
                [sysp, rs.randint(1, 256, size=extra).astype(np.int32)]),
                target_gen=gen) for i, (extra, gen) in enumerate(SUFFIXES)]


def _ref_serve(monkeypatch, **kw):
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
                                  request_stream=_shared_stream(rserve),
                                  **KW, **kw)
    monkeypatch.undo()
    return out


def _port_serve(stream=None, **kw):
    cfg = rconfigs.get(ARCH, smoke=True)
    audited = [0]

    def hook(sched, kv, cache):
        kv.check_invariants()
        audited[0] += 1

    out = tserve.serve_continuous(
        ARCH, quiet=True, device='cpu', compute_dtype=torch.float32,
        request_stream=stream or _shared_stream(tserve), step_hook=hook,
        params=tmodel.params_from_numpy(_ref_params(), cfg, 'cpu'),
        **dict(KW, **kw))
    assert audited[0] == out['steps']
    return out


def test_serve_prefix_cache_matches_reference(monkeypatch):
    ref = _ref_serve(monkeypatch, prefix_cache=True)
    got = _port_serve(prefix_cache=True)
    priv = _port_serve()
    assert got['completed'] == ref['completed'] == 5
    assert got['outputs'] == ref['outputs'] == priv['outputs']
    assert got['prefix'] == ref['prefix']
    assert got['prefix']['hits'] == 4 and got['prefix']['cow_copies'] == 1
    assert got['peak_pages'] == ref['peak_pages'] < priv['peak_pages']
    assert got['chunk_prefill'] == ref['chunk_prefill'] == 4
    assert got['events'] == ref['events']


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_chunked_prefill_equals_monolithic(attn_impl):
    base = dict(slots=2, attn_impl=attn_impl)
    a = _port_serve(**base)
    b = _port_serve(chunk_prefill=4, **base)
    c = _port_serve(chunk_prefill=7, **base)             # unaligned C
    assert a['outputs'] == b['outputs'] == c['outputs']
    assert a['chunk_prefill'] is None and c['chunk_prefill'] == 7


def test_serve_kv_quant_prefix_cache_quantizes_once_like_reference(
        monkeypatch):
    tier = dict(kv_quant=True, hot_window=1)
    ref = _ref_serve(monkeypatch, prefix_cache=True, **tier)
    got = _port_serve(prefix_cache=True, **tier)
    priv = _port_serve(**tier)
    assert got['outputs'] == ref['outputs'] == priv['outputs']
    assert got['pages_quantized'] == ref['pages_quantized']
    assert 0 < got['pages_quantized'] < priv['pages_quantized']
    assert got['prefix'] == ref['prefix']
