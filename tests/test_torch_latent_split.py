"""Kernels K8 and K10 on the latent key split, on the CPU. The CUDA kernel
cuts the W * page_size keys a request's block table reaches into absolute
tiles of whole pages (``latent_split_plan``), gives a block of 32 query
rows ``tiles_per_split`` of them, walks the live keys [max(pos - win + 1,
0), min(pos, W * page_size - 1)] in 32-key steps with one online-softmax
update a step (K10: a row of a page before the hot window read as its int8
codes times the page's scale, rounded through the pool dtype), writes a
split with no live key m = -inf, and merges the splits' (m, l, acc)
partials in split order, a split whose m is -inf weighing 0. Its two
products run on tensor cores with every f32 operand split into three bf16
parts as :func:`bf16x3_split` splits it.

A plain mirror of that arithmetic, here, equals
``flash_decode_mla_paged_plain`` and ``flash_decode_mla_paged_q8_plain``
within 1e-6 (only the order of the sums differs) and the JAX reference
kernels in interpret mode within 2e-5 (``test_torch_mla.py``'s tolerance,
the reference's own for its MLA kernel); its K10 equals its K8 bit for bit
when the hot window covers the table, over a poisoned int8 tier. The mirror
with the kernel's three-part products holds 2e-5 against the f32 plain
version at deepseek-v3's width: the CPU's evidence that the split keeps f32
accuracy (it does not model the card's accumulation order)."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro_torch.kernels import flash_decode as tfd

NEG_INF = float('-inf')
KERNEL_ATOL = 2e-5
# deepseek-v3's smoke MLA widths (H=4, r=32, rope 8) and its full ones
SMOKE = dict(h=4, r=32, dr=8)
FULL = dict(h=128, r=512, dr=64)


def bf16x3_split(x):
    """The kernel's three-part bf16 split of an f32 tensor
    (``csrc/flash_decode.cu::split3_pair``): x = x1 + x2 + x3 exactly, each
    part a bf16 value (as f32) holding the next 8 significant bits
    (truncation: the upper 16 bits of the f32 word, then of what is
    left)."""
    def trunc(t):
        return (t.contiguous().view(torch.int32) & -65536).view(torch.float32)
    x = x.to(torch.float32)
    x1 = trunc(x)
    r = x - x1
    x2 = trunc(r)
    return x1, x2, r - x2


def _split_products(q, lat, r, scale, p_fn):
    """Logits and the PV product from the kernel's three-part operands:
    q (H, dk), lat (n, dk) f32 latent rows; p_fn(logits) -> p (H, n).
    Terms whose parts' ranks (from 0) sum to at most 2, smallest first."""
    qp, cp = bf16x3_split(q), bf16x3_split(lat)
    order = ((2, 0), (1, 1), (0, 2), (1, 0), (0, 1), (0, 0))
    logits = torch.zeros((q.shape[0], lat.shape[0]))
    for i, j in order:
        logits = logits + qp[i] @ cp[j].T
    p = p_fn(logits * scale)
    pp = bf16x3_split(p)
    pv = torch.zeros((q.shape[0], r))
    for i, j in order:
        pv = pv + pp[i] @ cp[j][:, :r]
    return p, pv


def _row_loader(bi, pools, bt, ps, cold_end):
    """``load(keys)`` -> f32 (n, dk) latent rows of request ``bi``'s keys
    through its block table; with an int8 tier (``clq`` in ``pools``) a key
    below ``cold_end`` reads ``int8 * scale[page]`` rounded through the pool
    dtype."""
    def load(keys):
        blk = keys // ps
        page = bt[bi, blk].to(torch.int64)
        lat = pools['cl'][page, keys % ps].float()
        if 'clq' not in pools:
            return lat
        deq = (pools['clq'][page, keys % ps].float()
               * pools['cs'][page].float()).to(pools['cl'].dtype).float()
        return torch.where((keys < cold_end)[:, None], deq, lat)
    return load


def latent_split_mirror(q, pools, pos, win, bt, *, scale, r,
                        hot_window=None, split_products=False, offset=None,
                        chunk=1):
    """K8's (``hot_window`` None) or K10's split-and-combine arithmetic in
    plain PyTorch at ``latent_split_plan``'s cut; q (B, 1, H, dk) f32,
    pools cl (P, ps, dk) (and clq int8, cs (P, 1) for K10), pos/win (B,),
    bt (B, W). ``split_products``: the products from three-part operands.
    With ``chunk`` > 1 it is K9's (``test_torch_latent_chunk.py``): the R =
    chunk * H rows of q (B, 1, R, dk), row i at ``offset + i // H`` with
    the window win - (chunk - 1), pos/win the fetch-union scalars; each
    block of the plan's 32 rows narrows [lo, hi] to the keys its rows can
    see, and each row masks its own keys (a row with no valid key in a
    split leaves m = -inf there, weighing 0 in the combine). Returns f32
    (B, 1, R, r) and the number of live blocks (a row group's splits that
    hold one of its keys)."""
    b, _, n_rows, dk = q.shape
    ps, w = pools['cl'].shape[1], bt.shape[1]
    n_keys = w * ps
    plan = tfd.latent_split_plan(b, w, ps, n_rows, dk, r,
                                 pools['cl'].element_size())
    tile, tps, step = plan['tile'], plan['tiles_per_split'], tfd.LATENT_STEP
    n_tiles = -(-n_keys // tile)
    assert tile % ps == 0 and tile % step == 0
    assert plan['n_splits'] * tps >= n_tiles > (plan['n_splits'] - 1) * tps
    # decode rows share one key range, so one group holds them all; a
    # chunk's rows go in the kernel's blocks of plan['rows']
    group = n_rows // chunk
    kr = n_rows if chunk == 1 else plan['rows']
    out, live_splits = torch.empty((b, 1, n_rows, r)), 0
    for bi in range(b):
        p_, w_ = int(pos[bi]), int(win[bi])
        cold_end = (0 if hot_window is None
                    else max(max(p_, 0) // ps - hot_window + 1, 0) * ps)
        load = _row_loader(bi, pools, bt, ps, cold_end)
        for r0 in range(0, n_rows, kr):
            rr = torch.arange(r0, min(r0 + kr, n_rows))
            nr = len(rr)
            lo, hi = max(p_ - w_ + 1, 0), min(p_, n_keys - 1)
            if chunk > 1:
                qp = int(offset[bi]) + rr // group
                row_win = w_ - (chunk - 1)
                lo = max(lo, int(qp[0]) - row_win + 1)
                hi = min(hi, int(qp[-1]))
                row_lo = torch.clamp_min(qp - row_win + 1, lo)[:, None]
                row_hi = torch.clamp_max(qp, hi)[:, None]
            else:
                row_lo = torch.full((nr, 1), lo)
                row_hi = torch.full((nr, 1), hi)
            parts = []
            for split in range(plan['n_splits']):
                t0 = max(split * tps, lo // tile)
                t1 = min(split * tps + tps, n_tiles, hi // tile + 1) \
                    if lo <= hi else t0
                if t0 >= t1:
                    parts.append(None)      # a dead split writes m = -inf
                    continue
                m = torch.full((nr, 1), NEG_INF)
                l = torch.zeros((nr, 1))
                acc = torch.zeros((nr, r))
                for kb in range(max(t0 * tile, lo - lo % step),
                                min(t1 * tile, hi + 1), step):
                    keys = torch.arange(max(kb, lo), min(kb + step, hi + 1))
                    lat = load(keys)
                    valid = (keys[None] >= row_lo) & (keys[None] <= row_hi)
                    state = {}

                    def probs(logits, m=m, state=state, valid=valid):
                        logits = torch.where(valid, logits, NEG_INF)
                        m_new = torch.maximum(m,
                                              logits.amax(-1, keepdim=True))
                        state['m'] = m_new
                        # masked keys weigh 0 (exp(-inf - -inf) is NaN)
                        return torch.where(valid, torch.exp(logits - m_new),
                                           0.0)
                    if split_products:
                        p, pv = _split_products(q[bi, 0, rr], lat, r, scale,
                                                probs)
                    else:
                        p = probs((q[bi, 0, rr] @ lat.T) * scale)
                        pv = p @ lat[:, :r]
                    m_new = state['m']
                    # all-masked guards: exp(-inf - -inf) must contribute 0
                    alpha = torch.where(torch.isfinite(m),
                                        torch.exp(m - m_new), 0.0)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + pv
                    m = m_new
                parts.append((m, l, acc))
            live_splits += sum(pt is not None for pt in parts)
            m_all = torch.full((nr, 1), NEG_INF)
            for pt in parts:
                if pt is not None:
                    m_all = torch.maximum(m_all, pt[0])
            l_all, a_all = torch.zeros((nr, 1)), torch.zeros((nr, r))
            for pt in parts:                # split order
                if pt is None:
                    continue
                # a split whose m is -inf weighs 0
                fin = torch.isfinite(pt[0])
                wt = torch.where(fin, torch.exp(pt[0] - m_all), 0.0)
                l_all = l_all + torch.where(fin, pt[1] * wt, 0.0)
                a_all = a_all + torch.where(fin, pt[2] * wt, 0.0)
            out[bi, 0, rr] = a_all / torch.clamp_min(l_all, 1e-30)
    return out, live_splits


# (case, B, W, page_size, widths, pos, window); window None = no window.
# An idle slot (pos 0) reads the garbage page 0 through an all-zero table
# row; negative pos has no live key.
CASES = [
    ('idle_and_window', 4, 6, 8, SMOKE, [47, 21, 8, 0], [9, None, 5, None]),
    ('long_table_dead_splits', 2, 40, 8, SMOKE, [319, 200], None),
    ('windowed_dead_prefix', 2, 40, 8, SMOKE, [319, 250], [33, 5]),
    ('negative_pos', 2, 4, 8, SMOKE, [-1, 5], None),
    ('page_of_12', 2, 10, 12, SMOKE, [119, 50], [None, 40]),
    ('page_of_4', 3, 12, 4, SMOKE, [47, 3, 30], None),
    ('deepseek_width', 2, 3, 8, FULL, [23, 10], None),
]


def _inputs(case, b, w, ps, widths, pos, window, dtype=torch.float32):
    rng = np.random.RandomState(len(case) + w * ps)
    h, r, dk = widths['h'], widths['r'], widths['r'] + widths['dr']
    n_pages = 1 + b * w
    q = torch.from_numpy(rng.randn(b, 1, h, dk).astype(np.float32))
    shape = (n_pages, ps, dk)
    pools = dict(
        cl=torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype),
        clq=torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)),
        cs=torch.from_numpy(rng.uniform(0.001, 0.05, (n_pages, 1))
                            .astype(np.float32)))
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w).astype(np.int32)
    bt[np.asarray(pos) == 0] = 0
    win = [w * ps + 1 if x is None else x for x in (window or [None] * b)]
    return (q, pools, torch.tensor(pos, dtype=torch.int32),
            torch.tensor(win, dtype=torch.int32), torch.from_numpy(bt), r,
            1.0 / (widths['r'] // 4 + widths['dr']) ** 0.5)


def _fp(pools):
    return dict(cl=pools['cl'])


@pytest.fixture
def sms(request, monkeypatch):
    """The plan at the card's 132 SMs, or at 4 (fewer splits of several
    tiles each)."""
    monkeypatch.setattr(tfd, 'LATENT_SMS', request.param)
    return request.param


@pytest.mark.parametrize('hot_window', [None, 1, 2],
                         ids=['k8', 'k10_hw1', 'k10_hw2'])
@pytest.mark.parametrize('sms', [132, 4], indirect=True,
                         ids=['serving_plan', 'multi_tile_splits'])
@pytest.mark.parametrize('case,b,w,ps,widths,pos,window', CASES,
                         ids=[c[0] for c in CASES])
def test_split_mirror_matches_plain(case, b, w, ps, widths, pos, window,
                                    sms, hot_window):
    q, pools, posv, win, bt, r, scale = _inputs(case, b, w, ps, widths, pos,
                                                window)
    if hot_window is None:
        want = tfd.flash_decode_mla_paged_plain(q, pools['cl'], posv, win,
                                                bt, scale=scale, r=r)
        got, live = latent_split_mirror(q, _fp(pools), posv, win, bt,
                                        scale=scale, r=r)
    else:
        want = tfd.flash_decode_mla_paged_q8_plain(
            q, pools['cl'], pools['clq'], pools['cs'], posv, win, bt,
            torch.tensor([hot_window], dtype=torch.int32), scale=scale, r=r)
        got, live = latent_split_mirror(q, pools, posv, win, bt, scale=scale,
                                        r=r, hot_window=hot_window)
    assert live >= int((posv >= 0).sum())
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('sms', [132, 4], indirect=True,
                         ids=['serving_plan', 'multi_tile_splits'])
def test_dead_and_multi_tile_splits_occur(sms):
    """At the card's SM count the long-table case has splits with no live
    key (they write m = -inf and exit in the kernel), the small SM count
    gives splits of several tiles, and a negative position has no live
    split and gives 0."""
    q, pools, posv, win, bt, r, scale = _inputs(*CASES[1])
    plan = tfd.latent_split_plan(2, 40, 8, 4, 40, 32, 4)
    assert plan['n_splits'] > 1
    assert (plan['tiles_per_split'] > 1) == (sms == 4)
    _, live = latent_split_mirror(q, _fp(pools), posv, win, bt, scale=scale,
                                  r=r)
    assert (plan['n_splits'] * 2 > live) == (sms == 132)
    q, pools, posv, win, bt, r, scale = _inputs(*CASES[3])
    got, live = latent_split_mirror(q, _fp(pools), posv, win, bt,
                                    scale=scale, r=r)
    assert live == 1 and bool((got[0] == 0).all())


def _reference(pools, dtype):
    """The pools as the reference kernel takes them."""
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    return dict(cl=jnp.asarray(pools['cl'].float().numpy(), jdt),
                clq=jnp.asarray(pools['clq'].numpy()),
                cs=jnp.asarray(pools['cs'].numpy()))


@pytest.mark.parametrize('window', [None, 7], ids=['full', 'window7'])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_k8_mirror_matches_reference_kernel(dtype, window):
    case = ('idle_and_window', 4, 6, 8, SMOKE, [47, 21, 8, 0],
            None if window is None else [window] * 4)
    q, pools, posv, win, bt, r, scale = _inputs(*case, dtype=dtype)
    ref = _reference(pools, dtype)
    got, _ = latent_split_mirror(q, _fp(pools), posv, win, bt, scale=scale,
                                 r=r)
    want = rfd.flash_decode_mla_paged(
        jnp.asarray(q.numpy()), ref['cl'], jnp.asarray(posv.numpy()),
        jnp.asarray(win.numpy()), jnp.asarray(bt.numpy()), scale=scale, r=r,
        interpret=True)
    assert bool(torch.isfinite(got).all())          # idle slot stays finite
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize('hot_window', [1, 2])
@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
def test_k10_mirror_matches_reference_kernel(dtype, hot_window):
    q, pools, posv, win, bt, r, scale = _inputs(*CASES[0], dtype=dtype)
    win = torch.full_like(win, 6 * 8 + 1)
    ref = _reference(pools, dtype)
    got, _ = latent_split_mirror(q, pools, posv, win, bt, scale=scale, r=r,
                                 hot_window=hot_window)
    want = rfd.flash_decode_mla_paged_q8(
        jnp.asarray(q.numpy()), ref['cl'], ref['clq'], ref['cs'],
        jnp.asarray(posv.numpy()), jnp.asarray(win.numpy()),
        jnp.asarray(bt.numpy()), jnp.asarray([hot_window], jnp.int32),
        scale=scale, r=r, interpret=True)
    assert int(posv.max()) // 8 - hot_window + 1 > 0, 'no cold page'
    np.testing.assert_allclose(got.numpy(), np.asarray(want, np.float32),
                               atol=KERNEL_ATOL, rtol=0)


@pytest.mark.parametrize('scale_exp', [-40, -3, 0, 7, 60])
def test_bf16x3_split_reconstructs_f32(scale_exp):
    """Each part is a bf16 value and the three sum back to x: within
    2^-24 relative (in fact exactly: truncation keeps 8 bits a part)."""
    rng = np.random.RandomState(scale_exp + 100)
    x = torch.from_numpy((rng.randn(4096) * 2.0 ** scale_exp)
                         .astype(np.float32))
    parts = bf16x3_split(x)
    for part in parts:
        assert torch.equal(part.to(torch.bfloat16).float(), part)
    back = (parts[0] + parts[1]) + parts[2]
    assert bool(((back - x).abs() <= x.abs() * 2.0 ** -24).all())
    assert torch.equal(back, x)
    # the parts fall by 2^8 at least: |x2| <= 2^-7 |x1|, |x3| <= 2^-7 |x2|
    assert bool((parts[1].abs() <= parts[0].abs() * 2.0 ** -7).all())
    assert bool((parts[2].abs() <= parts[1].abs() * 2.0 ** -7).all())


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_split_products_hold_f32_tolerance_at_deepseek_width(dtype):
    """The mirror with the kernel's three-part products (three on a bf16
    latent, which is exact in bf16; six on an f32 one) against the f32
    plain version at H=128, DK=576, r=512: within 2e-5."""
    case = ('split_products', 3, 4, 8, FULL, [31, 17, 0], None)
    q, pools, posv, win, bt, r, scale = _inputs(*case, dtype=dtype)
    if dtype == torch.bfloat16:
        assert torch.equal(bf16x3_split(pools['cl'].float())[1],
                           torch.zeros_like(pools['cl'].float()))
    got, _ = latent_split_mirror(q, _fp(pools), posv, win, bt, scale=scale,
                                 r=r, split_products=True)
    want = tfd.flash_decode_mla_paged_plain(q, pools['cl'], posv, win, bt,
                                            scale=scale, r=r)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=KERNEL_ATOL,
                               rtol=0)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', [CASES[0], CASES[2], CASES[6]],
                         ids=['idle_and_window', 'windowed', 'deepseek'])
def test_k10_mirror_bit_equal_to_k8_when_hot_window_covers_table(case,
                                                                 dtype):
    """A hot window covering the table never reads the int8 tier: the K10
    mirror then equals the K8 mirror bit for bit over int8 codes of 127 /
    -127 and NaN / 1e6 scales."""
    q, pools, posv, win, bt, r, scale = _inputs(*case, dtype=dtype)
    pools['clq'][::2] = 127
    pools['clq'][1::2] = -127
    pools['cs'][::2] = float('nan')
    pools['cs'][1::2] = 1e6
    k8, _ = latent_split_mirror(q, _fp(pools), posv, win, bt, scale=scale,
                                r=r)
    k10, _ = latent_split_mirror(q, pools, posv, win, bt, scale=scale, r=r,
                                 hot_window=bt.shape[1])
    assert bool(torch.isfinite(k8).all())
    assert torch.equal(k10, k8)


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('ps', [1, 4, 8, 12, 16, 128])
def test_plan_tiles_whole_pages_and_covers_the_table(ps, itemsize):
    """Tiles of whole pages in whole 32-key steps, 32 rows a block, splits
    covering the W * page_size keys exactly once, at most
    LATENT_SPLIT_PAGES pages a split, never more splits than fill the
    SMs unless the stage cap forces them."""
    for b, w, h in ((8, 20, 128), (8, 512, 128), (1, 4096, 128),
                    (64, 512, 128), (1, 1, 4), (4, 5, 4)):
        plan = tfd.latent_split_plan(b, w, ps, h, 576 if h == 128 else 40,
                                     512 if h == 128 else 32, itemsize)
        tile, tps = plan['tile'], plan['tiles_per_split']
        assert plan['rows'] == tfd.LATENT_ROWS == 32
        assert tile % tfd.LATENT_STEP == 0 and tile % ps == 0
        n_tiles = -(-w * ps // tile)
        assert (plan['n_splits'] - 1) * tps < n_tiles \
            <= plan['n_splits'] * tps
        assert tps * tile // ps <= max(tfd.LATENT_SPLIT_PAGES, tile // ps)
        pairs = b * -(-h // 32)
        if tps * tile // ps < tfd.LATENT_SPLIT_PAGES // 2:
            assert plan['n_splits'] <= max(1, -(-tfd.LATENT_SMS // pairs))


def test_plan_at_the_serving_row_and_a_long_context():
    """The serving row (B=8, H=128, W=20 pages of 8, bf16) puts a block on
    every SM (5 splits of one 32-key tile: 160 blocks); W=512 ends in one
    wave of 128 blocks (4 splits of 32 tiles), where 5 splits would take
    two."""
    plan = tfd.latent_split_plan(8, 20, 8, 128, 576, 512, 2)
    assert 8 * 4 * plan['n_splits'] >= 132
    assert (plan['tile'], plan['tiles_per_split'], plan['n_splits']) \
        == (32, 1, 5)
    plan = tfd.latent_split_plan(8, 512, 8, 128, 576, 512, 2)
    assert (plan['tiles_per_split'], plan['n_splits']) == (32, 4)
    assert 8 * 4 * plan['n_splits'] <= 132


def test_plan_takes_no_positions():
    params = set(inspect.signature(tfd.latent_split_plan).parameters)
    assert params == {'b', 'w', 'page_size', 'h', 'dk', 'dv', 'itemsize'}


@pytest.mark.parametrize('dk,dv,itemsize', [(44, 32, 4), (40, 40, 4),
                                            (40, 48, 2), (584, 512, 2),
                                            (640, 520, 2), (40, 28, 4),
                                            (576, 512, 1)],
                         ids=['dk_not_8', 'dv_eq_dk', 'dv_gt_dk',
                              'dk_over_576', 'dv_over_512', 'dv_not_8',
                              'int8_pool'])
def test_plan_refuses_shapes_it_cannot_take(dk, dv, itemsize):
    with pytest.raises(ValueError, match='latent split'):
        tfd.latent_split_plan(8, 20, 8, 128, dk, dv, itemsize)
