"""The port's absorbed-MLA path against the reference's, on deepseek-v3's
dense prefix cut to smoke width: the plain versions of kernels K8, K9 and
K10, the int8 latent tier, the latent layouts and the MLA attention
functions. Serving as a whole is in ``test_torch_mla_serve.py``.

Tolerances: K8/K9/K10 plain versions within 2e-5 of the reference kernels
in interpret mode (the reference's documented kernel-vs-oracle tolerance
on f32 latents, tests/test_mla_paged_decode.py), and K10 bit-equal to K8
when the hot window covers the table; latent page quantization bit-exact
with the JITTED reference (its served tier state is compiled: the scale is
``max(absmax, 1e-8) * f32(1/127)``); ``dequant_gather_mla`` and the
layouts' writes and tree walks exact; the MLA attention functions in f32
within 1e-5."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig
from repro.kernels import flash_decode as rfd
from repro.models import attention as rattention
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro.runtime import kv_quant as rkvq
from repro.runtime import layouts as rlayouts
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import flash_decode as tfd
from repro_torch.models import attention as tattention
from repro_torch.models import model as tmodel
from repro_torch.runtime import kv_quant as tkvq
from repro_torch.runtime import layouts as tlayouts

KERNEL_ATOL = 2e-5
LAYER_ATOL = 1e-5
# deepseek-v3's dense prefix at smoke width: 3 MLA layers, MoE dropped
CFG = dataclasses.replace(rconfigs.get('deepseek-v3-671b', smoke=True),
                          moe=None)
M = CFG.mla
R, DK = M.kv_lora_rank, M.kv_lora_rank + M.rope_head_dim
SCALE = 1.0 / float(M.nope_head_dim + M.rope_head_dim) ** 0.5


def _bf16_round(a):
    return np.array(jnp.asarray(a, jnp.bfloat16).astype(jnp.float32))


def _latent_layer(rng, b, w, ps, hot_window=None, bf16=False):
    """One single-layer latent cache (numpy): a random pool (garbage page
    included) behind shuffled block tables; with ``hot_window`` an empty
    int8 tier."""
    n_pages = 1 + b * w
    cl = rng.randn(n_pages, ps, DK).astype(np.float32)
    cl[3] = 0.0                              # an all-zero page: eps scale
    if bf16:
        cl = _bf16_round(cl)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w)
    c = dict(cl=cl, bt=bt.astype(np.int32))
    if hot_window is not None:
        c.update(clq=np.zeros(cl.shape, np.int8),
                 cs=np.zeros((n_pages, 1), np.float32),
                 hw=np.full((1,), hot_window, np.int32))
    return c


def _jax(c, bf16=False):
    out = {k: jnp.asarray(v) for k, v in c.items()}
    if bf16:
        out['cl'] = out['cl'].astype(jnp.bfloat16)
    return out


def _torch(c, bf16=False):
    out = {k: torch.from_numpy(np.array(v)) for k, v in c.items()}
    if bf16:
        out['cl'] = out['cl'].to(torch.bfloat16)
    return out


def _np(tree):
    return jax.tree.map(lambda a: np.asarray(a, np.float32)
                        if a.dtype == jnp.bfloat16 else np.asarray(a), tree)


# ----------------------------------------------------------------------------
# kernels K8 and K10: plain versions
# ----------------------------------------------------------------------------
def _decode_case(seed, bf16, hot_window=None):
    """4 slots over W=5 pages of 4: a full table, two ragged positions and
    an idle slot at pos 0 against the garbage page (which holds data)."""
    rng = np.random.RandomState(seed)
    b, w, ps = 4, 5, 4
    c = _latent_layer(rng, b, w, ps, hot_window, bf16)
    c['bt'][3] = 0
    pos = np.array([w * ps - 1, 13, 6, 0], np.int32)
    q = rng.randn(b, 1, CFG.n_heads, DK).astype(np.float32)
    return c, pos, q


@pytest.mark.parametrize('window', [None, 7])
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k8_plain_matches_reference_kernel(bf16, window):
    c, pos, q = _decode_case(0, bf16)
    b = q.shape[0]
    win = np.full((b,), 5 * 4 + 1 if window is None else window, np.int32)
    j, t = _jax(c, bf16), _torch(c, bf16)
    want = rfd.flash_decode_mla_paged(
        jnp.asarray(q), j['cl'], jnp.asarray(pos), jnp.asarray(win), j['bt'],
        scale=SCALE, r=R, interpret=True)
    got = tfd.flash_decode_mla_paged(
        torch.from_numpy(q), t['cl'], torch.from_numpy(pos),
        torch.from_numpy(win), t['bt'], scale=SCALE, r=R)
    assert got.dtype == torch.float32 and tuple(got.shape) == want.shape
    assert bool(torch.isfinite(got).all())          # idle slot stays finite
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_ATOL, rtol=0)
    # the shape-flexible wrapper, (B, H, dk) query
    flex = tfd.flash_decode_paged_mla(torch.from_numpy(q[:, 0]), t['cl'],
                                      torch.from_numpy(pos), t['bt'], r=R,
                                      scale=SCALE, window=window)
    assert torch.equal(flex, got[:, 0])


def test_k8_plain_matches_absorbed_oracle():
    c, pos, q = _decode_case(1, False)
    t = _torch(c)
    got = tfd.flash_decode_paged_mla(torch.from_numpy(q), t['cl'],
                                     torch.from_numpy(pos), t['bt'], r=R,
                                     scale=SCALE)
    ckv, krope = tlayouts.PagedMLALayout.gather(t, 0, r=R)
    qt = torch.from_numpy(q)
    want = tattention.mla_absorbed_attend(qt[..., :R], qt[..., R:], ckv,
                                          krope, torch.from_numpy(pos),
                                          SCALE)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_ATOL,
                               rtol=0)


def _tiered(seed, hot_window, bf16):
    """The decode case with every page outside its request's hot window
    quantized by the jitted reference; (jax cache, torch cache, pos, q)."""
    c, pos, q = _decode_case(seed, bf16, hot_window)
    pages = tkvq.cold_page_list(c['bt'], pos, 4, hot_window)
    ref = jax.jit(rkvq.quantize_latent_pages_layer)(
        _jax(c, bf16), jnp.asarray(pages + [0], jnp.int32))
    port = {k: torch.from_numpy(np.array(v)) for k, v in _np(ref).items()}
    if bf16:
        port['cl'] = port['cl'].to(torch.bfloat16)
    return ref, port, pos, q


@pytest.mark.parametrize('hot_window', [1, 2])
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k10_plain_matches_reference_kernel(bf16, hot_window):
    ref, port, pos, q = _tiered(2, hot_window, bf16)
    b = q.shape[0]
    win = np.full((b,), 5 * 4 + 1, np.int32)
    assert int(np.asarray(ref['cs']).astype(bool).sum()) >= 6
    want = rfd.flash_decode_mla_paged_q8(
        jnp.asarray(q), ref['cl'], ref['clq'], ref['cs'], jnp.asarray(pos),
        jnp.asarray(win), ref['bt'], ref['hw'], scale=SCALE, r=R,
        interpret=True)
    got = tfd.flash_decode_mla_paged_q8(
        torch.from_numpy(q), port['cl'], port['clq'], port['cs'],
        torch.from_numpy(pos), torch.from_numpy(win), port['bt'],
        port['hw'], scale=SCALE, r=R)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=KERNEL_ATOL, rtol=0)
    if not bf16:
        # and the tier-mixing absorbed oracle over dequant_gather_mla
        ckv, krope = tlayouts.PagedMLAQ8Layout.gather(
            port, torch.from_numpy(pos), r=R)
        qt = torch.from_numpy(q)
        oracle = tattention.mla_absorbed_attend(
            qt[..., :R], qt[..., R:], ckv, krope, torch.from_numpy(pos),
            SCALE)
        np.testing.assert_allclose(got.numpy(), oracle.numpy(),
                                   atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k10_plain_bit_equal_to_k8_when_hot_window_covers_table(bf16):
    _, port, pos, q = _tiered(3, 5, bf16)
    # poison the int8 tier: it must never be read
    port['clq'].fill_(127)
    port['cs'].fill_(float('nan'))
    port['cs'][1::2] = 1e6
    q8 = tfd.flash_decode_paged_mla_q8(
        torch.from_numpy(q), port['cl'], port['clq'], port['cs'],
        torch.from_numpy(pos), port['bt'], port['hw'], r=R, scale=SCALE)
    fp = tfd.flash_decode_paged_mla(torch.from_numpy(q), port['cl'],
                                    torch.from_numpy(pos), port['bt'], r=R,
                                    scale=SCALE)
    assert torch.equal(q8, fp)


# ----------------------------------------------------------------------------
# kernel K9: plain version
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('c,offset,limit', [(4, 8, 12), (4, 10, 12),
                                            (3, 0, 2)],
                         ids=['aligned', 'padded', 'first-padded'])
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_k9_plain_matches_reference_kernel(bf16, c, offset, limit):
    """Chunk rows at or past ``limit`` are padding: the valid rows are held
    to the tolerance and every row must be finite."""
    rng = np.random.RandomState(4)
    b, w, ps = 2, 5, 4
    lat = _latent_layer(rng, b, w, ps, bf16=bf16)
    q = rng.randn(b, c, CFG.n_heads, DK).astype(np.float32)
    off = np.array([offset, max(offset - 4, 0)], np.int32)
    lim = np.array([limit, max(limit - 4, 1)], np.int32)
    j, t = _jax(lat, bf16), _torch(lat, bf16)
    want = np.asarray(rfd.flash_chunk_paged_mla(
        jnp.asarray(q), j['cl'], jnp.asarray(off), jnp.asarray(lim),
        j['bt'], r=R, scale=SCALE, interpret=True))
    got = tfd.flash_chunk_paged_mla(torch.from_numpy(q), t['cl'],
                                    torch.from_numpy(off),
                                    torch.from_numpy(lim), t['bt'], r=R,
                                    scale=SCALE)
    assert tuple(got.shape) == (b, c, CFG.n_heads, R)
    assert bool(torch.isfinite(got).all())
    valid = (off[:, None] + np.arange(c)[None, :]) < lim[:, None]  # (B, C)
    assert valid.any() and (valid.all() == (offset + c <= limit))
    np.testing.assert_allclose(got.numpy()[valid], want[valid],
                               atol=KERNEL_ATOL, rtol=0)


# ----------------------------------------------------------------------------
# the int8 latent tier
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_quantize_latent_pages_bit_equal_to_jitted_reference(bf16):
    rng = np.random.RandomState(6)
    c = _latent_layer(rng, 3, 4, 4, 1, bf16)
    # garbage-page padding and a repeated page, as the scheduler pads
    pages = np.array([5, 3, 0, 9, 5, 0, 0], np.int32)
    want = jax.jit(rkvq.quantize_latent_pages_layer)(_jax(c, bf16),
                                                     jnp.asarray(pages))
    got = tkvq.quantize_latent_pages_layer(_torch(c, bf16),
                                           torch.from_numpy(pages))
    for key in ('clq', 'cs'):
        np.testing.assert_array_equal(got[key].numpy(), np.asarray(want[key]),
                                      err_msg=key)
    assert float(got['cs'][3, 0]) == float(np.float32(1e-8)
                                           * np.float32(1 / 127))
    again = {k: v.clone() for k, v in got.items()}
    tkvq.quantize_latent_pages_layer(again, torch.from_numpy(pages))
    for key in ('clq', 'cs'):
        assert torch.equal(again[key], got[key]), key


def test_quantize_tree_pages_on_latent_stack_bit_equal_to_jitted_reference():
    ref = rmodel.init_paged_cache_tree(CFG, 2, num_pages=9, page_size=4,
                                       max_blocks=4, kv_dtype='int8',
                                       hot_window=2, dtype=jnp.float32)
    lay = dict(ref['layers'])
    lay['cl'] = jnp.asarray(np.random.RandomState(7).randn(
        *lay['cl'].shape).astype(np.float32))
    ref = dict(layers=lay)
    port = tmodel.cache_from_numpy(jax.tree.map(np.asarray, ref), 'cpu')
    assert tlayouts.get_layout(port['layers']) is tlayouts.PagedMLAQ8Layout
    pages = np.array([1, 2, 7, 0], np.int32)
    want = jax.jit(rkvq.quantize_tree_pages)(ref, jnp.asarray(pages))
    got = tkvq.quantize_tree_pages(port, torch.from_numpy(pages))
    for key in ('clq', 'cs'):
        np.testing.assert_array_equal(
            tmodel.cache_to_numpy(got)['layers'][key],
            np.asarray(want['layers'][key]), err_msg=key)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
def test_dequant_gather_mla_equals_reference(bf16):
    ref, port, pos, _ = _tiered(8, 2, bf16)
    want = rkvq.dequant_gather_mla(ref, jnp.asarray(pos))
    got = tkvq.dequant_gather_mla(port, torch.from_numpy(pos))
    assert got.dtype == port['cl'].dtype
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


# ----------------------------------------------------------------------------
# the latent layouts
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_init_paged_cache_mla_matches_reference(kv_dtype):
    want = rattention.init_paged_cache(CFG, 3, num_pages=7, page_size=4,
                                       max_blocks=2, kv_dtype=kv_dtype,
                                       hot_window=3)
    got = tattention.init_paged_cache(CFG, 3, num_pages=7, page_size=4,
                                      max_blocks=2, kv_dtype=kv_dtype,
                                      hot_window=3, device='cpu')
    assert set(got) == set(want)
    for key in want:
        g = tmodel.cache_to_numpy(got[key])
        assert g.shape == want[key].shape, key
        np.testing.assert_array_equal(g, _np(want[key]), err_msg=key)
    lay = tlayouts.get_layout(got)
    assert lay.name == rlayouts.get_layout(want).name
    assert lay is (tlayouts.PagedMLAQ8Layout if kv_dtype
                   else tlayouts.PagedMLALayout)
    tree = tmodel.init_paged_cache_tree(CFG, 3, num_pages=7, page_size=4,
                                        max_blocks=2, kv_dtype=kv_dtype,
                                        device='cpu')
    rtree = rmodel.init_paged_cache_tree(CFG, 3, num_pages=7, page_size=4,
                                         max_blocks=2, kv_dtype=kv_dtype)
    for key, leaf in rtree['layers'].items():
        assert tuple(tree['layers'][key].shape) == leaf.shape, key


@pytest.mark.parametrize('kv_dtype', [None, 'int8'])
def test_latent_layout_writes_match_reference(kv_dtype):
    """Token, prefill and chunk writes of ckv ‖ krope rows, padding rows of
    a chunk landing on the garbage page."""
    rng = np.random.RandomState(9)
    b, w, ps = 2, 4, 4
    c = _latent_layer(rng, b, w, ps, 1 if kv_dtype else None)
    rl, tl = rlayouts.get_layout(_jax(c)), tlayouts.get_layout(_torch(c))
    assert rl.name == tl.name

    def slab(s):
        return dict(ckv=rng.randn(b, s, R).astype(np.float32),
                    krope=rng.randn(b, s, M.rope_head_dim).astype(np.float32))

    def both(fn_r, fn_t, u, *args):
        want = fn_r(_jax(c), {k: jnp.asarray(v) for k, v in u.items()},
                    *[jnp.asarray(a) for a in args])
        got = fn_t(_torch(c), {k: torch.from_numpy(v) for k, v in u.items()},
                   *[torch.from_numpy(a) for a in args])
        for key in want:
            np.testing.assert_array_equal(tmodel.cache_to_numpy(got[key]),
                                          _np(want[key]), err_msg=key)

    both(rl.write_token, tl.write_token, slab(1), np.array([13, 2],
                                                            np.int32))
    both(rl.write_prefill, tl.write_prefill, slab(10))
    both(rl.write_chunk, tl.write_chunk, slab(4), np.array([6, 9], np.int32),
         np.array([8, 16], np.int32))


@pytest.mark.parametrize('pos', [5, (1, 7)], ids=['scalar', 'per_slot'])
def test_contiguous_latent_layout_matches_reference(pos):
    """``ContiguousMLALayout`` (the static path's MLA cache): prefill and
    token writes of ckv and krope rows and the densify view, against the
    reference's on the same numpy inputs."""
    rng = np.random.RandomState(14)
    b, s_max, plen = 2, 9, 4
    shapes = dict(ckv=(b, s_max, R), krope=(b, s_max, M.rope_head_dim))

    def slab(s):
        return {k: rng.randn(b, s, shp[2]).astype(np.float32)
                for k, shp in shapes.items()}

    pre, tok = slab(plen), slab(1)
    posv = np.asarray(pos, np.int32)
    rc = {k: jnp.zeros(shp, jnp.float32) for k, shp in shapes.items()}
    tc = {k: torch.zeros(shp) for k, shp in shapes.items()}
    rl, tl = rlayouts.get_layout(rc), tlayouts.get_layout(tc)
    assert rl.name == tl.name == 'contiguous_mla'
    assert tl is tlayouts.ContiguousMLALayout and not tl.paged
    rc = rl.write_prefill(rc, {k: jnp.asarray(a) for k, a in pre.items()})
    rc = rl.write_token(rc, {k: jnp.asarray(a) for k, a in tok.items()},
                        jnp.asarray(posv))
    tc = tl.write_prefill(tc, {k: torch.from_numpy(a)
                               for k, a in pre.items()})
    tc = tl.write_token(tc, {k: torch.from_numpy(a) for k, a in tok.items()},
                        torch.from_numpy(posv))
    for want, got in zip(rl.gather(rc, posv, r=R), tl.gather(tc, posv, r=R)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_latent_tree_walkers_match_reference():
    """copy, scrub and zero-tail over a layer-stacked int8 latent tree."""
    ref = rmodel.init_paged_cache_tree(CFG, 2, num_pages=9, page_size=4,
                                       max_blocks=4, kv_dtype='int8',
                                       hot_window=1, dtype=jnp.float32)
    rng = np.random.RandomState(10)
    lay = dict(ref['layers'])
    for key in ('cl', 'cs'):
        lay[key] = jnp.asarray(rng.randn(*lay[key].shape).astype(np.float32))
    lay['clq'] = jnp.asarray(rng.randint(-127, 128, lay['clq'].shape),
                             jnp.int8)
    tables = np.array([[3, 1, 7, 5], [2, 8, 4, 6]], np.int32)
    ref = rlayouts.with_block_tables(dict(layers=lay), jnp.asarray(tables))

    def port():
        return tmodel.cache_from_numpy(jax.tree.map(np.asarray, ref), 'cpu')

    cases = [(rlayouts.copy_tree_pages(ref, 3, 6),
              tlayouts.copy_tree_pages(port(), 3, 6)),
             (rlayouts.scrub_tree_pages(ref, jnp.array([1, 5], jnp.int32)),
              tlayouts.scrub_tree_pages(port(), torch.tensor([1, 5]))),
             (rlayouts.zero_tree_tail(ref, jnp.asarray(tables[1]), 5, 12),
              tlayouts.zero_tree_tail(port(), tables[1], 5, 12))]
    for want, got in cases:
        got = tmodel.cache_to_numpy(got)['layers']
        for key, leaf in want['layers'].items():
            np.testing.assert_array_equal(got[key], np.asarray(leaf),
                                          err_msg=key)


# ----------------------------------------------------------------------------
# the MLA attention functions, f32
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _ref_attn_params():
    params = rmodel.init_params(jax.random.key(1), CFG)
    return jax.tree.map(lambda a: np.asarray(a[0]), params['layers'])['attn']


def _attn_params():
    pj = jax.tree.map(jnp.asarray, _ref_attn_params())
    pt = {k: torch.from_numpy(np.array(v)) for k, v in
          _ref_attn_params().items()}
    return pj, pt


F32_J = (YocoConfig(compute_dtype=jnp.float32), jnp.float32)
F32_T = tyl.YocoConfig(compute_dtype=torch.float32)


def test_mla_prefill_matches_reference():
    pj, pt = _attn_params()
    rng = np.random.RandomState(11)
    b, s, w, ps = 2, 7, 3, 4
    c = _latent_layer(rng, b, w, ps)
    x = rng.randn(b, s, CFG.d_model).astype(np.float32)
    want, wc = rattention.mla_attention(pj, jnp.asarray(x), CFG, F32_J[0],
                                        cache=_jax(c))
    got, gc = tattention.mla_attention(pt, torch.from_numpy(x), CFG, F32_T,
                                       cache=_torch(c))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)
    np.testing.assert_allclose(gc['cl'].numpy(), np.asarray(wc['cl']),
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
@pytest.mark.parametrize('hot_window', [None, 1], ids=['fp', 'tier-hw1'])
def test_mla_decode_matches_reference(hot_window, attn_impl):
    """The reference on its einsum route (the interpret-mode kernels are
    held above); the port on both routes, over fp and tiered caches."""
    pj, pt = _attn_params()
    if hot_window is None:
        _, pos, _ = _decode_case(12, False)
        c = _decode_case(12, False)[0]
        ref, port = _jax(c), _torch(c)
    else:
        ref, port, pos, _ = _tiered(12, hot_window, False)
    x = np.random.RandomState(13).randn(4, 1, CFG.d_model).astype(np.float32)
    want, wc = rattention.mla_attention_decode(
        pj, jnp.asarray(x), CFG, F32_J[0], cache=ref, pos=jnp.asarray(pos),
        rt=ModelRuntime(attn_impl='einsum'))
    got, gc = tattention.mla_attention_decode(
        pt, torch.from_numpy(x), CFG, F32_T, cache=port,
        pos=torch.from_numpy(pos),
        rt=tmodel.ModelRuntime(attn_impl=attn_impl,
                               compute_dtype=torch.float32))
    np.testing.assert_allclose(got.numpy(), np.asarray(want),
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)
    np.testing.assert_allclose(gc['cl'].numpy(), np.asarray(wc['cl']),
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_mla_decode_bf16_absorbs_with_f32_weights(attn_impl):
    """bf16 serving stores its linears in bf16 but keeps ``w_ukv`` f32, so
    the absorb einsums see the reference's f32 masters: the decode layer
    is then bit-equal to the reference's in bf16 (with a bf16 ``w_ukv``
    most outputs differ by an ulp)."""
    pj, pt = _attn_params()
    pt = tmodel.cast_linear_weights(pt, torch.bfloat16)
    assert pt['w_ukv'].dtype == torch.float32
    assert pt['w_dq'].dtype == torch.bfloat16
    c, pos, _ = _decode_case(12, True)
    x = np.random.RandomState(3).randn(4, 1, CFG.d_model).astype(np.float32)
    want, _ = rattention.mla_attention_decode(
        pj, jnp.asarray(x, jnp.bfloat16), CFG, YocoConfig(),
        cache=_jax(c, True), pos=jnp.asarray(pos),
        rt=ModelRuntime(attn_impl='einsum'))
    got, _ = tattention.mla_attention_decode(
        pt, torch.from_numpy(x).to(torch.bfloat16), CFG, tyl.YocoConfig(),
        cache=_torch(c, True), pos=torch.from_numpy(pos),
        rt=tmodel.ModelRuntime(attn_impl=attn_impl))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), _np(want))


@pytest.mark.parametrize('attn_impl', ['einsum', 'flash'])
def test_mla_chunk_matches_reference(attn_impl):
    pj, pt = _attn_params()
    rng = np.random.RandomState(14)
    b, w, ps, c = 2, 5, 4, 4
    lat = _latent_layer(rng, b, w, ps)
    x = rng.randn(b, c, CFG.d_model).astype(np.float32)
    off = np.array([8, 4], np.int32)
    lim = np.array([11, 8], np.int32)
    want, wc = rattention.mla_attention_chunk(
        pj, jnp.asarray(x), CFG, F32_J[0], cache=_jax(lat),
        offset=jnp.asarray(off), limit=jnp.asarray(lim),
        rt=ModelRuntime(attn_impl='einsum'))
    got, gc = tattention.mla_attention_chunk(
        pt, torch.from_numpy(x), CFG, F32_T, cache=_torch(lat),
        offset=torch.from_numpy(off), limit=torch.from_numpy(lim),
        rt=tmodel.ModelRuntime(attn_impl=attn_impl,
                               compute_dtype=torch.float32))
    valid = (off[:, None] + np.arange(c)[None, :]) < lim[:, None]
    np.testing.assert_allclose(got.numpy()[valid], np.asarray(want)[valid],
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)
    np.testing.assert_allclose(gc['cl'].numpy(), np.asarray(wc['cl']),
                               atol=LAYER_ATOL, rtol=LAYER_ATOL)


def test_uncut_config_is_refused_by_feature():
    """Refusals go by feature, not by family name: an input kind the
    reference does not have is refused; deepseek-v3 with its MoE layers is
    served, its params the reference's ``dense_prefix`` and ``layers``
    stacks leaf for leaf in shape; the dense-prefix cut keeps
    ``family='moe'`` and is served."""
    full = tconfigs.get('deepseek-v3-671b', smoke=True)
    with pytest.raises(NotImplementedError, match="'pixels' input"):
        tmodel.init_params(torch.Generator(), dataclasses.replace(
            full, input_kind='pixels'), device='cpu')
    got = tmodel.init_params(torch.Generator().manual_seed(0), full,
                             device='cpu')
    want = jax.eval_shape(lambda: rmodel.init_params(
        jax.random.key(0), rconfigs.get('deepseek-v3-671b', smoke=True)))
    assert set(got) == set(want) >= {'dense_prefix', 'layers'}
    for key in ('dense_prefix', 'layers'):
        n = full.moe.first_k_dense if key == 'dense_prefix' else \
            full.n_layers - full.moe.first_k_dense
        assert len(got[key]) == n
        paths = jax.tree_util.tree_leaves_with_path(want[key])
        mine = jax.tree_util.tree_leaves_with_path(got[key][0])
        assert [p for p, _ in mine] == [p for p, _ in paths]
        for (path, leaf), (_, w) in zip(mine, paths):
            assert (n,) + tuple(leaf.shape) == w.shape, (key, path)
    assert 'moe' in got['layers'][0] and 'mlp' in got['dense_prefix'][0]
    assert CFG.family == 'moe'
    params = tmodel.init_params(torch.Generator().manual_seed(0), CFG,
                                device='cpu')
    assert set(params['layers'][0]['attn']) == set(_ref_attn_params())
    for key, leaf in _ref_attn_params().items():
        assert tuple(params['layers'][0]['attn'][key].shape) == leaf.shape
