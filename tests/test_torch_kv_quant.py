"""The port's int8 KV tier against the reference's: page quantization,
the tier-mixing densify, the tier bookkeeping, kernel K6's plain version,
the attention layer and model over a quantized cache, and continuous
serving with ``kv_quant``.

Tolerances: page quantization bit-exact with the JITTED reference (its
serve path compiles ``max(absmax, 1e-8) / 127`` into a multiply by
``f32(1/127)``, which the port copies); ``dequant_gather`` exact; K6's
plain version within 2e-5 of the reference kernel in interpret mode (the
reference's own tier-mixing tolerance, tests/test_kv_quant.py) and
bit-equal to K1's plain version when the hot window covers the table; the
attention layer and the model in f32 within 1e-4 with equal greedy tokens
and equal int8 pools; serving in f32 with equal per-request tokens and
equal ``pages_quantized``."""

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
from repro.runtime import kv_quant as rkvq
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import flash_decode as tfd
from repro_torch.launch import serve as tserve
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_quant as tkvq
from repro_torch.runtime import layouts as tlayouts

ARCH = 'stablelm-1.6b'


def _t(tree):
    return tmodel.cache_from_numpy(jax.tree.map(np.asarray, tree), 'cpu')


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


def _q8_layer(rng, b, w, ps, hkv, dh, hot_window, bf16=False):
    """One single-layer tiered cache (numpy): random fp pools (garbage page
    included) behind shuffled block tables, empty int8 tier."""
    n_pages = 1 + b * w
    shape = (n_pages, ps, hkv, dh)
    k = rng.randn(*shape).astype(np.float32)
    v = rng.randn(*shape).astype(np.float32)
    k[3] = 0.0                               # an all-zero page: eps scale
    if bf16:
        k = np.array(jnp.asarray(k, jnp.bfloat16).astype(jnp.float32))
        v = np.array(jnp.asarray(v, jnp.bfloat16).astype(jnp.float32))
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w)
    return dict(k=k, v=v, kq=np.zeros(shape, np.int8),
                vq=np.zeros(shape, np.int8),
                ks=np.zeros((n_pages, hkv), np.float32),
                vs=np.zeros((n_pages, hkv), np.float32),
                bt=bt.astype(np.int32),
                hw=np.full((1,), hot_window, np.int32))


def _as_jax(c, bf16):
    out = {k: jnp.asarray(v) for k, v in c.items()}
    if bf16:
        out['k'] = out['k'].astype(jnp.bfloat16)
        out['v'] = out['v'].astype(jnp.bfloat16)
    return out


def _as_torch(c, bf16):
    out = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    if bf16:
        out['k'] = out['k'].to(torch.bfloat16)
        out['v'] = out['v'].to(torch.bfloat16)
    return out


# ----------------------------------------------------------------------------
# page quantization, densify, bookkeeping
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_quantize_pages_layer_bit_equal_to_jitted_reference(bf16):
    rng = np.random.RandomState(0)
    c = _q8_layer(rng, 3, 4, 4, 2, 8, 1, bf16)
    # garbage-page padding and a repeated page, as the scheduler pads
    pages = np.array([5, 3, 0, 9, 5, 0, 0], np.int32)
    want = jax.jit(rkvq.quantize_pages_layer)(_as_jax(c, bf16),
                                              jnp.asarray(pages))
    got = tkvq.quantize_pages_layer(_as_torch(c, bf16),
                                    torch.from_numpy(pages))
    for key in ('kq', 'vq', 'ks', 'vs'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(got['ks'][3].max()) == float(np.float32(1e-8)
                                              * np.float32(1 / 127))
    # idempotent: quantizing the same pages again changes nothing
    again = {k: v.clone() for k, v in got.items()}
    tkvq.quantize_pages_layer(again, torch.from_numpy(pages))
    for key in ('kq', 'vq', 'ks', 'vs'):
        assert torch.equal(again[key], got[key]), key


def test_quantize_tree_pages_bit_equal_to_jitted_reference():
    cfg = rconfigs.get(ARCH, smoke=True)
    ref = rmodel.init_paged_cache_tree(cfg, 2, num_pages=9, page_size=4,
                                       max_blocks=4, kv_dtype='int8',
                                       hot_window=2, dtype=jnp.float32)
    rng = np.random.RandomState(1)
    lay = dict(ref['layers'])
    for key in ('k', 'v'):
        lay[key] = jnp.asarray(rng.randn(*lay[key].shape).astype(np.float32))
    ref = dict(layers=lay)
    port = _t(ref)
    assert port['layers']['kq'].dtype == torch.int8
    assert tuple(port['layers']['hw'].shape) == (cfg.n_layers, 1)
    pages = np.array([1, 2, 7, 0], np.int32)
    want = jax.jit(rkvq.quantize_tree_pages)(ref, jnp.asarray(pages))
    got = tkvq.quantize_tree_pages(port, torch.from_numpy(pages))
    for key in ('kq', 'vq', 'ks', 'vs'):
        np.testing.assert_array_equal(
            tmodel.cache_to_numpy(got)['layers'][key],
            np.asarray(want['layers'][key]), err_msg=key)
    assert float(got['layers']['ks'][:, 3:7].abs().max()) == 0.0


def test_with_block_tables_refreshes_every_hot_window_copy():
    cfg = rconfigs.get(ARCH, smoke=True)
    ref = rmodel.init_paged_cache_tree(cfg, 2, num_pages=9, page_size=4,
                                       max_blocks=4, kv_dtype='int8',
                                       hot_window=2, dtype=jnp.float32)
    tables = np.array([[1, 2, 0, 0], [5, 6, 7, 0]], np.int32)
    want = rkvc.with_block_tables(ref, jnp.asarray(tables), hot_window=3)
    got = tlayouts.with_block_tables(_t(ref), tables, hot_window=3)
    for key in ('bt', 'hw'):
        np.testing.assert_array_equal(got['layers'][key].numpy(),
                                      np.asarray(want['layers'][key]), key)
    kept = tlayouts.with_block_tables(got, tables)
    assert kept['layers']['hw'] is got['layers']['hw']


def test_init_paged_cache_int8_matches_reference():
    cfg = rconfigs.get(ARCH, smoke=True)
    want = rattention.init_paged_cache(cfg, 3, num_pages=7, page_size=4,
                                       max_blocks=2, kv_dtype='int8',
                                       hot_window=3)
    got = tattention.init_paged_cache(cfg, 3, num_pages=7, page_size=4,
                                      max_blocks=2, kv_dtype='int8',
                                      hot_window=3, device='cpu')
    assert set(got) == set(want)
    for key in want:
        g = tmodel.cache_to_numpy(got[key])
        assert g.shape == want[key].shape, key
        np.testing.assert_array_equal(g, _np(want[key]), err_msg=key)
    assert tlayouts.get_layout(got) is tlayouts.PagedQ8Layout
    with pytest.raises(ValueError, match='hot_window'):
        tattention.init_paged_cache(cfg, 1, num_pages=3, page_size=4,
                                    max_blocks=1, kv_dtype='int8',
                                    hot_window=0, device='cpu')


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_dequant_gather_equals_reference(bf16):
    rng = np.random.RandomState(2)
    c = _q8_layer(rng, 3, 5, 4, 2, 8, 2, bf16)
    pos = np.array([19, 9, 0], np.int32)
    pages = tkvq.cold_page_list(c['bt'], pos, 4, 2)
    assert pages == rkvq.cold_page_list(c['bt'], pos, 4, 2) and pages
    ref = jax.jit(rkvq.quantize_pages_layer)(_as_jax(c, bf16),
                                             jnp.asarray(pages, jnp.int32))
    port = tkvq.quantize_pages_layer(_as_torch(c, bf16),
                                     torch.tensor(pages))
    wk, wv = rkvq.dequant_gather(ref, jnp.asarray(pos))
    gk, gv = tkvq.dequant_gather(port, torch.from_numpy(pos))
    assert gk.dtype == port['k'].dtype
    np.testing.assert_array_equal(gk.float().numpy(), _np(wk))
    np.testing.assert_array_equal(gv.float().numpy(), _np(wv))


def test_tier_tracker_and_cold_pages_match_reference_on_a_walk():
    rng = np.random.RandomState(3)
    ps, w, slots = 4, 6, 3
    ref = rkvq.KVTierTracker(hot_window=2, page_size=ps)
    port = tkvq.KVTierTracker(hot_window=2, page_size=ps)
    tables = rng.permutation(np.arange(1, 1 + slots * w)).reshape(slots, w)
    pos = np.zeros(slots, np.int64)
    for _ in range(300):
        s = rng.randint(slots)
        if rng.rand() < 0.1:
            ref.reset(s)
            port.reset(s)
            pos[s] = rng.randint(w * ps)
        else:
            pos[s] = min(pos[s] + rng.randint(3), w * ps - 1)
        assert port.aged_out(s, int(pos[s]), tables[s]) == \
            ref.aged_out(s, int(pos[s]), tables[s])
        assert port._upto == ref.residency()
        for hw in (1, 2, 5):
            assert tkvq.cold_page_list(tables, pos, ps, hw) == \
                rkvq.cold_page_list(tables, pos, ps, hw)
    with pytest.raises(AssertionError):
        tkvq.KVTierTracker(hot_window=0, page_size=4)


# ----------------------------------------------------------------------------
# kernel K6: plain version
# ----------------------------------------------------------------------------
def _k6_case(seed, hot_window, bf16=False):
    """A tiered pool with every page outside its request's hot window
    quantized (by the jitted reference), one idle slot at pos 0 against
    the garbage page. Returns (jax cache, torch cache, pos, q)."""
    rng = np.random.RandomState(seed)
    b, w, ps, hkv, g, dh = 4, 5, 4, 2, 2, 16
    c = _q8_layer(rng, b, w, ps, hkv, dh, hot_window,
                  bf16)
    c['k'][0] = rng.randn(ps, hkv, dh)             # garbage page content
    c['bt'][3] = 0                                  # the idle slot
    pos = np.array([w * ps - 1, 13, 6, 0], np.int32)
    pages = tkvq.cold_page_list(c['bt'], pos, ps, hot_window)
    ref = jax.jit(rkvq.quantize_pages_layer)(_as_jax(c, bf16),
                                             jnp.asarray(pages + [0],
                                                         jnp.int32))
    port = {k: torch.from_numpy(np.array(v)) for k, v in _np(ref).items()}
    if bf16:
        port['k'] = port['k'].to(torch.bfloat16)
        port['v'] = port['v'].to(torch.bfloat16)
    q = rng.randn(b, 1, hkv * g, dh).astype(np.float32)
    return ref, port, pos, q


def _k6_port(port, pos, q, window=None):
    return tfd.flash_decode_paged_q8(
        torch.from_numpy(q), port['k'], port['v'], port['kq'], port['vq'],
        port['ks'], port['vs'], torch.from_numpy(pos), port['bt'],
        port['hw'], scale=0.25, window=window)


@pytest.mark.parametrize('window', [None, 7])
@pytest.mark.parametrize('hot_window', [1, 2])
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k6_plain_matches_reference_kernel(bf16, hot_window, window):
    """The f32 outputs of the grouped-query entry points, before the one
    cast to the pool dtype (which would round both to bf16)."""
    ref, port, pos, q = _k6_case(4, hot_window, bf16)
    b, _, h, dh = q.shape
    qg = q[:, 0].reshape(b, 2, h // 2, dh)
    win = np.full((b,), 5 * 4 + 1 if window is None else window, np.int32)
    want = rfd.flash_decode_gqa_paged_q8(
        jnp.asarray(qg), ref['k'], ref['v'], ref['kq'], ref['vq'], ref['ks'],
        ref['vs'], jnp.asarray(pos), jnp.asarray(win), ref['bt'], ref['hw'],
        scale=0.25, interpret=True)
    got = tfd.flash_decode_gqa_paged_q8(
        torch.from_numpy(qg), port['k'], port['v'], port['kq'], port['vq'],
        port['ks'], port['vs'], torch.from_numpy(pos),
        torch.from_numpy(win), port['bt'], port['hw'], scale=0.25)
    assert got.dtype == torch.float32 and tuple(got.shape) == qg.shape
    assert bool(torch.isfinite(got).all())          # idle slot stays finite
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-5,
                               rtol=0)
    if not bf16:
        # and the tier-mixing oracle: the einsum route over dequant_gather
        out = _k6_port(port, pos, q, window)
        kd, vd = tkvq.dequant_gather(port, torch.from_numpy(pos))
        oracle = tattention.sdpa_decode(torch.from_numpy(q), kd, vd,
                                        torch.from_numpy(pos), 0.25, window)
        np.testing.assert_allclose(out.numpy(), oracle.numpy(), atol=2e-5,
                                   rtol=0)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k6_plain_bit_equal_to_k1_when_hot_window_covers_table(bf16):
    _, port, pos, q = _k6_case(5, 5, bf16)
    # poison the int8 tier: it must never be read
    port['kq'].fill_(127)
    port['vq'].fill_(-127)
    port['ks'].fill_(float('nan'))
    port['vs'].fill_(1e6)
    for window in (None, 7):
        q8 = _k6_port(port, pos, q, window)
        fp = tfd.flash_decode_paged(torch.from_numpy(q), port['k'],
                                    port['v'], torch.from_numpy(pos),
                                    port['bt'], scale=0.25, window=window)
        assert torch.equal(q8, fp)


# ----------------------------------------------------------------------------
# attention layer and model over a quantized cache
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_params():
    cfg = rconfigs.get(ARCH, smoke=True)
    return jax.tree.map(np.asarray,
                        rmodel.init_params(jax.random.key(0), cfg))


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_attention_decode_on_q8_cache_matches_reference(attn_impl):
    cfg = rconfigs.get(ARCH, smoke=True)
    pj = jax.tree.map(jnp.asarray, _ref_params()['layers'])
    pj = jax.tree.map(lambda a: a[0], pj)['attn']
    pt = tmodel.params_from_numpy(_ref_params(), cfg, 'cpu')['layers'][0]
    pt = pt['attn']
    rng = np.random.RandomState(6)
    b, w, ps = 3, 4, 4
    c = _q8_layer(rng, b, w, ps, cfg.n_kv_heads, cfg.resolved_head_dim, 2)
    pos = np.array([14, 9, 4], np.int32)
    pages = tkvq.cold_page_list(c['bt'], pos, ps, 2)
    ref = jax.jit(rkvq.quantize_pages_layer)(_as_jax(c, False),
                                             jnp.asarray(pages, jnp.int32))
    port = _t(ref)
    x = rng.randn(b, 1, cfg.d_model).astype(np.float32)
    f32 = jnp.float32
    want, wc = rattention.attention_decode(
        pj, jnp.asarray(x), cfg, YocoConfig(compute_dtype=f32),
        cache=ref, pos=jnp.asarray(pos), rt=ModelRuntime(attn_impl='einsum'))
    got, gc = tattention.attention_decode(
        pt, torch.from_numpy(x), cfg,
        tyl.YocoConfig(compute_dtype=torch.float32), cache=port,
        pos=torch.from_numpy(pos),
        rt=tmodel.ModelRuntime(attn_impl=attn_impl,
                               compute_dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4,
                               rtol=1e-4)
    assert set(gc) == set(wc)
    gc = tmodel.cache_to_numpy(gc)
    for key in ('kq', 'vq', 'ks', 'vs', 'hw'):
        np.testing.assert_array_equal(gc[key], np.asarray(wc[key]), key)
    np.testing.assert_allclose(gc['k'], np.asarray(wc['k']), atol=1e-5)


def _decode_q8_run(port_side, attn_impl='flash', hot_window=1):
    """Reference prefill into a tiered tree, cold pages quantized by the
    jitted reference; then 3 greedy decode steps on each side from that
    same state (the port's tree carried over through numpy)."""
    cfg = rconfigs.get(ARCH, smoke=True)
    f32 = jnp.float32
    yoco, rt = YocoConfig(compute_dtype=f32), ModelRuntime(
        compute_dtype=f32)
    params = jax.tree.map(jnp.asarray, _ref_params())
    b, plen, ps, w = 2, 10, 4, 4
    tables = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
    cache = rmodel.init_paged_cache_tree(cfg, b, num_pages=b * w + 1,
                                         page_size=ps, max_blocks=w,
                                         kv_dtype='int8',
                                         hot_window=hot_window, dtype=f32)
    cache = rkvc.with_block_tables(cache, jnp.asarray(tables))
    toks = np.random.RandomState(7).randint(0, 256, (b, plen))
    lens = np.array([plen, plen - 3], np.int32)
    logits, cache = jax.jit(lambda p, t, c: rmodel.prefill(
        p, dict(inputs=t), c, cfg, yoco, rt, last_pos=lens - 1))(
            params, jnp.asarray(toks, jnp.int32), cache)
    pages = tkvq.cold_page_list(tables, lens, ps, hot_window)
    cache = jax.jit(rkvq.quantize_tree_pages)(cache,
                                              jnp.asarray(pages, jnp.int32))
    tok = np.array(jnp.argmax(logits, -1), np.int32)
    rows = []
    if not port_side:
        step = jax.jit(lambda p, t, pos, c: rmodel.decode_step(
            p, t, pos, c, cfg, yoco, rt))
        for i in range(3):
            logits, cache = step(params, jnp.asarray(tok),
                                 jnp.asarray(lens + i), cache)
            rows.append(np.asarray(logits))
            tok = np.array(jnp.argmax(logits, -1), np.int32)
        return np.stack(rows), _np(cache['layers'])
    tp = tmodel.params_from_numpy(_ref_params(), cfg, 'cpu')
    tc = _t(cache)
    tyoco = tyl.YocoConfig(compute_dtype=torch.float32)
    trt = tmodel.ModelRuntime(attn_impl=attn_impl,
                              compute_dtype=torch.float32)
    for i in range(3):
        lg, tc = tmodel.decode_step(tp, torch.from_numpy(tok),
                                    torch.from_numpy(lens + i), tc, cfg,
                                    tyoco, trt)
        rows.append(lg.numpy())
        tok = torch.argmax(lg, -1).to(torch.int32).numpy().copy()
    return np.stack(rows), tmodel.cache_to_numpy(tc)['layers']


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_model_decode_step_on_q8_tree_matches_reference(attn_impl):
    want_l, want_c = _decode_q8_run(False)
    got_l, got_c = _decode_q8_run(True, attn_impl)
    np.testing.assert_allclose(got_l, want_l, atol=1e-4, rtol=1e-4)
    np.testing.assert_array_equal(got_l.argmax(-1), want_l.argmax(-1))
    for key in ('kq', 'vq', 'ks', 'vs'):
        np.testing.assert_array_equal(got_c[key], want_c[key], key)
    for key in ('k', 'v'):
        np.testing.assert_allclose(got_c[key], want_c[key], atol=1e-5)


# ----------------------------------------------------------------------------
# serving with the tier
# ----------------------------------------------------------------------------
KW = dict(slots=2, prompt_len=16, gen_len=8, page_size=4)


def _stream(mod):
    rng = np.random.RandomState(12)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, 256, 7 + (i * 4) % 10).astype(np.int32),
                target_gen=4 + (i * 3) % 5) for i in range(4)]


def _ref_serve_f32(monkeypatch, **kw):
    f32 = jnp.float32
    monkeypatch.setattr(rserve, 'YocoConfig',
                        functools.partial(YocoConfig, compute_dtype=f32))
    monkeypatch.setattr(rserve, 'ModelRuntime',
                        functools.partial(ModelRuntime, compute_dtype=f32))
    monkeypatch.setattr(rserve.model_mod, 'init_paged_cache_tree',
                        functools.partial(rmodel.init_paged_cache_tree,
                                          dtype=f32))
    out = rserve.serve_continuous(ARCH, attn_impl='einsum', metrics=False,
                                  quiet=True, request_stream=_stream(rserve),
                                  **KW, **kw)
    monkeypatch.undo()
    return out


def _port_serve_f32(**kw):
    cfg = rconfigs.get(ARCH, smoke=True)
    return tserve.serve_continuous(
        ARCH, quiet=True, request_stream=_stream(tserve), device='cpu',
        compute_dtype=torch.float32,
        step_hook=lambda sched, kv, cache: kv.check_invariants(),
        params=tmodel.params_from_numpy(_ref_params(), cfg, 'cpu'), **KW,
        **kw)


def test_serve_kv_quant_f32_tokens_match_reference(monkeypatch):
    ref = _ref_serve_f32(monkeypatch, kv_quant=True, hot_window=1)
    got = _port_serve_f32(kv_quant=True, hot_window=1)
    assert got['completed'] == ref['completed'] == 4
    assert got['outputs'] == ref['outputs']
    assert got['pages_quantized'] == ref['pages_quantized'] > 0
    assert got['kv_quant'] is True and got['hot_window'] == 1
    assert got['events'] == ref['events']


def test_serve_kv_quant_covering_hot_window_equals_no_tier():
    fp = _port_serve_f32()
    hot = _port_serve_f32(kv_quant=True, hot_window=64)
    assert hot['pages_quantized'] == 0 and fp['kv_quant'] is False
    assert hot['outputs'] == fp['outputs']
