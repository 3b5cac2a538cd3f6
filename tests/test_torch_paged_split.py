"""Kernels K1 and K6 on the key split, on the CPU. The CUDA kernel cuts the
W * page_size keys a request's block table reaches into absolute tiles of
whole pages (``paged_split_plan``), gives a block ``tiles_per_split`` of
them, visits only the tiles holding the live keys [max(pos - win + 1, 0),
min(pos, W * page_size - 1)], reads each key row through the block table
(K6: a page before the hot window from the int8 tier, times its (page,
head) scales, rounded through the pool dtype), writes a split with no live
key m = -inf, and merges the splits' (m, l, acc) partials in split order,
a split whose m is -inf weighing 0. A plain mirror of that arithmetic,
here, equals ``flash_decode_gqa_paged_plain`` and
``flash_decode_gqa_paged_q8_plain`` within 1e-6 in f32 (only the order of
the sums differs) and the JAX reference kernels in interpret mode within
``test_torch_kernels.py``'s tolerances (1e-5 on f32 pools, 2e-2 on bf16,
the reference's own); its K6 equals its K1 bit for bit when the hot window
covers the table, over a poisoned int8 tier. K5 (a chunk's C * G query rows
at offset + r // G, ``chunk_split_plan``) runs the same split with
CHUNK_ROWS rows a block, each row masking its own keys: its mirror equals
``flash_decode_gqa_paged_plain`` (chunk > 1) within 1e-5 and the
interpreted reference ``flash_chunk_paged`` within the same tolerances on
every row below the chunk's limit, and stays finite on padding rows."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro_torch.kernels import flash_decode as tfd

NEG_INF = float('-inf')


def _row_loader(bi, pools, bt, ps, first_hot):
    """``load(keys)`` -> f32 (n, Hkv, dh) K and V rows of request ``bi``'s
    keys through its block table; with an int8 tier (``kq`` in ``pools``),
    a key in a block before ``first_hot`` reads ``int8 * scale`` rounded
    through the pool dtype, selected per page."""
    def load(keys):
        blk = keys // ps
        page = bt[bi, blk].to(torch.int64)
        r = keys % ps
        k = pools['k'][page, r].float()
        v = pools['v'][page, r].float()
        if 'kq' not in pools:
            return k, v
        cold = (blk < first_hot)[:, None, None]

        def deq(q8, sc, fp):
            return (q8[page, r].float() * sc[page].float()[:, :, None]) \
                .to(fp.dtype).float()
        return (torch.where(cold, deq(pools['kq'], pools['ks'], pools['k']),
                            k),
                torch.where(cold, deq(pools['vq'], pools['vs'], pools['v']),
                            v))
    return load


def _split_partials(q, load, lo, hi, t0, t1, tile, s, scale):
    """(m, l, acc) of one split of one request over its tiles [t0, t1), one
    online-softmax update a tile (a fully masked tile leaves the state
    bit-unchanged); q (Hkv, G, dh) f32; only the live keys are loaded."""
    hkv, g, dh = q.shape
    m = torch.full((hkv, g, 1), NEG_INF)
    l = torch.zeros((hkv, g, 1))
    acc = torch.zeros((hkv, g, dh))
    for t in range(t0, t1):
        keys = torch.arange(max(t * tile, lo), min((t + 1) * tile, s, hi + 1))
        if not len(keys):
            continue
        k, v = load(keys)
        logits = torch.einsum('hgd,shd->hgs', q, k) * scale
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        # all-masked guards: exp(-inf - -inf) must contribute 0, not 1
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.exp(logits - m_new)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum('hgs,shd->hgd', p, v)
        m = m_new
    return m, l, acc


def paged_split_mirror(q, pools, pos, win, bt, *, scale, hot_window=None):
    """K1's (``hot_window`` None) or K6's split-and-combine arithmetic in
    plain PyTorch; q (B, Hkv, G, dh) f32, pools k/v (P, ps, Hkv, dh) (and
    kq/vq int8, ks/vs (P, Hkv) for K6), pos/win (B,), bt (B, W). Returns
    f32 (B, Hkv, G, dh) and the number of splits that held live keys."""
    b, hkv, g, dh = q.shape
    ps, w = pools['k'].shape[1], bt.shape[1]
    s = w * ps
    plan = tfd.paged_split_plan(b, w, ps, hkv, g, dh,
                                pools['k'].element_size())
    tile, tps = plan['tile'], plan['tiles_per_split']
    n_tiles = -(-s // tile)
    assert tile % ps == 0
    assert plan['n_splits'] * tps >= n_tiles > (plan['n_splits'] - 1) * tps
    out, live_splits = torch.empty_like(q), 0
    for bi in range(b):
        p_, w_ = int(pos[bi]), int(win[bi])
        lo, hi = max(p_ - w_ + 1, 0), min(p_, s - 1)
        first_hot = (None if hot_window is None
                     else max(p_, 0) // ps - hot_window + 1)
        load = _row_loader(bi, pools, bt, ps, first_hot)
        parts = []
        for split in range(plan['n_splits']):
            t0 = max(split * tps, lo // tile)
            t1 = min(split * tps + tps, n_tiles, hi // tile + 1) \
                if lo <= hi else t0
            if t0 >= t1:
                parts.append(None)          # a dead split writes m = -inf
                continue
            parts.append(_split_partials(q[bi], load, lo, hi, t0, t1, tile,
                                         s, scale))
        live_splits += sum(pt is not None for pt in parts)
        m_all = torch.full((hkv, g, 1), NEG_INF)
        for pt in parts:
            if pt is not None:
                m_all = torch.maximum(m_all, pt[0])
        l_all = torch.zeros((hkv, g, 1))
        a_all = torch.zeros((hkv, g, dh))
        for pt in parts:                    # split order
            if pt is None:
                continue
            m, l, acc = pt
            wt = torch.where(torch.isfinite(m), torch.exp(m - m_all), 0.0)
            l_all = l_all + torch.where(torch.isfinite(m), l * wt, 0.0)
            a_all = a_all + torch.where(torch.isfinite(m), acc * wt, 0.0)
        out[bi] = a_all / torch.clamp_min(l_all, 1e-30)
    return out, live_splits


# (case, B, W, page_size, Hkv, G, dh, pos, window); window None = no window.
# An idle slot (pos 0) reads the garbage page 0 through an all-zero table row.
CASES = [
    ('idle_and_window', 4, 6, 8, 2, 1, 16, [47, 21, 8, 0], [9, None, 5, None]),
    ('g4_rows_of_two', 3, 20, 8, 2, 4, 32, [159, 63, 100], [None, 33, None]),
    ('dead_splits', 2, 75, 8, 1, 1, 64, [10, 70], None),
    ('windowed_dead_prefix', 2, 75, 8, 2, 1, 8, [599, 400], [33, 5]),
    ('smoke_width', 4, 5, 4, 4, 1, 12, [19, 0, 7, 12], [5, None, None, 1]),
    ('negative_pos', 2, 4, 8, 1, 1, 8, [-1, 5], None),
    ('page_past_tile', 2, 3, 128, 1, 2, 16, [300, 200], [None, 70]),
    ('page_not_power_of_two', 2, 30, 12, 2, 1, 16, [359, 150], [None, 100]),
]


def _inputs(case, b, w, ps, hkv, g, dh, pos, window, dtype=torch.float32):
    rng = np.random.RandomState(len(case) + w * ps)
    n_pages = 1 + b * w
    q = torch.from_numpy(rng.randn(b, hkv, g, dh).astype(np.float32))
    shape = (n_pages, ps, hkv, dh)
    pools = dict(
        k=torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype),
        v=torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype),
        kq=torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)),
        vq=torch.from_numpy(rng.randint(-127, 128, shape).astype(np.int8)),
        ks=torch.from_numpy(rng.uniform(0.001, 0.05, (n_pages, hkv))
                            .astype(np.float32)),
        vs=torch.from_numpy(rng.uniform(0.001, 0.05, (n_pages, hkv))
                            .astype(np.float32)))
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w).astype(np.int32)
    bt[np.asarray(pos) == 0] = 0
    win = [w * ps + 1 if x is None else x
           for x in (window or [None] * b)]
    return (q, pools, torch.tensor(pos, dtype=torch.int32),
            torch.tensor(win, dtype=torch.int32), torch.from_numpy(bt))


def _fp(pools):
    return dict(k=pools['k'], v=pools['v'])


@pytest.mark.parametrize('hot_window', [None, 1, 3], ids=['k1', 'k6_hw1',
                                                          'k6_hw3'])
@pytest.mark.parametrize('target', [tfd.CONTIG_TARGET_BLOCKS, 16],
                         ids=['serving_plan', 'multi_tile_splits'])
@pytest.mark.parametrize('case,b,w,ps,hkv,g,dh,pos,window', CASES,
                         ids=[c[0] for c in CASES])
def test_split_mirror_matches_plain(monkeypatch, case, b, w, ps, hkv, g, dh,
                                    pos, window, target, hot_window):
    monkeypatch.setattr(tfd, 'CONTIG_TARGET_BLOCKS', target)
    q, pools, posv, win, bt = _inputs(case, b, w, ps, hkv, g, dh, pos,
                                      window)
    scale = 1.0 / dh ** 0.5
    if hot_window is None:
        want = tfd.flash_decode_gqa_paged_plain(q, pools['k'], pools['v'],
                                                posv, win, bt, scale=scale)
        got, live = paged_split_mirror(q, _fp(pools), posv, win, bt,
                                       scale=scale)
    else:
        want = tfd.flash_decode_gqa_paged_q8_plain(
            q, pools['k'], pools['v'], pools['kq'], pools['vq'], pools['ks'],
            pools['vs'], posv, win, bt,
            torch.tensor([hot_window], dtype=torch.int32), scale=scale)
        got, live = paged_split_mirror(q, pools, posv, win, bt, scale=scale,
                                       hot_window=hot_window)
    assert live >= int((posv >= 0).sum())
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('target', [tfd.CONTIG_TARGET_BLOCKS, 16],
                         ids=['serving_plan', 'multi_tile_splits'])
def test_dead_splits_exist_where_the_live_range_is_short(monkeypatch,
                                                         target):
    """The dead-split case really has splits with no live key (they write
    m = -inf and exit in the kernel), and the small target really gives
    splits of several tiles; a negative position has no live split and
    gives 0, as the old body did."""
    monkeypatch.setattr(tfd, 'CONTIG_TARGET_BLOCKS', target)
    q, pools, posv, win, bt = _inputs(*CASES[2])
    plan = tfd.paged_split_plan(2, 75, 8, 1, 1, 64, 4)
    assert plan['n_splits'] > 1
    assert (plan['tiles_per_split'] > 1) == (target == 16)
    _, live = paged_split_mirror(q, _fp(pools), posv, win, bt, scale=0.125)
    assert plan['n_splits'] * 2 > live
    q, pools, posv, win, bt = _inputs(*CASES[5])
    got, live = paged_split_mirror(q, _fp(pools), posv, win, bt, scale=0.3)
    assert live == 1 and bool((got[0] == 0).all())


def _reference_case(dtype):
    """CASES[0] (a 5-key and a 9-key window, an idle slot) with the pools
    rounded through ``dtype``: the mirror's inputs and the reference's."""
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    q, pools, posv, win, bt = _inputs(*CASES[0], dtype=tdt)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    ref = {k: jnp.asarray(v.float().numpy() if v.dtype == torch.bfloat16
                          else v.numpy(), jdt if k in ('k', 'v') else None)
           for k, v in pools.items()}
    return q, pools, posv, win, bt, ref


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
def test_k1_mirror_matches_reference_kernel(dtype, tol):
    q, pools, posv, win, bt, ref = _reference_case(dtype)
    b, hkv, g, dh = q.shape
    got, _ = paged_split_mirror(q, _fp(pools), posv, win, bt, scale=0.25)
    want = rfd.flash_decode_paged(
        jnp.asarray(q.reshape(b, 1, hkv * g, dh).numpy()), ref['k'],
        ref['v'], jnp.asarray(posv.numpy()), jnp.asarray(bt.numpy()),
        scale=0.25, window=jnp.asarray(win.numpy()), interpret=True)
    assert bool(torch.isfinite(got).all())          # idle slot stays finite
    np.testing.assert_allclose(got.reshape(b, 1, hkv * g, dh).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
def test_k6_mirror_matches_reference_kernel(dtype, tol):
    q, pools, posv, win, bt, ref = _reference_case(dtype)
    b, hkv, g, dh = q.shape
    hw = 1
    got, _ = paged_split_mirror(q, pools, posv, win, bt, scale=0.25,
                                hot_window=hw)
    assert int((torch.maximum(posv, torch.zeros_like(posv)) // 8
                - hw + 1).max()) > 0, 'no slot has a cold page'
    want = rfd.flash_decode_paged_q8(
        jnp.asarray(q.reshape(b, 1, hkv * g, dh).numpy()), ref['k'],
        ref['v'], ref['kq'], ref['vq'], ref['ks'], ref['vs'],
        jnp.asarray(posv.numpy()), jnp.asarray(bt.numpy()),
        jnp.asarray([hw], jnp.int32), scale=0.25,
        window=jnp.asarray(win.numpy()), interpret=True)
    assert bool(torch.isfinite(got).all())          # idle slot stays finite
    np.testing.assert_allclose(got.reshape(b, 1, hkv * g, dh).numpy(),
                               np.asarray(want, np.float32), rtol=tol,
                               atol=tol)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', [CASES[0], CASES[1], CASES[3]],
                         ids=['idle_and_window', 'g4', 'windowed'])
def test_k6_mirror_bit_equal_to_k1_when_hot_window_covers_table(case,
                                                                 dtype):
    """A hot window covering the table never reads the int8 tier: the K6
    mirror then equals the K1 mirror bit for bit over int8 pools of 127
    and NaN scales."""
    q, pools, posv, win, bt = _inputs(*case, dtype=dtype)
    pools['kq'].fill_(127)
    pools['vq'].fill_(127)
    pools['ks'].fill_(float('nan'))
    pools['vs'].fill_(float('nan'))
    k1, _ = paged_split_mirror(q, _fp(pools), posv, win, bt, scale=0.2)
    k6, _ = paged_split_mirror(q, pools, posv, win, bt, scale=0.2,
                               hot_window=bt.shape[1])
    assert bool(torch.isfinite(k1).all())
    assert torch.equal(k6, k1)


@pytest.mark.parametrize('itemsize,dh,g,lpk,rows',
                         [(2, 64, 1, 8, 1), (2, 128, 4, 16, 2),
                          (4, 64, 1, 16, 1), (4, 128, 4, 32, 2),
                          (4, 12, 1, 4, 1), (2, 160, 4, 32, 2),
                          (4, 160, 4, 32, 2), (4, 256, 2, 32, 2)])
@pytest.mark.parametrize('ps', [1, 4, 8, 12, 16, 128])
def test_plan_tiles_whole_pages_and_covers_the_table(itemsize, dh, g, lpk,
                                                     rows, ps):
    """Lanes a key row and row groups as K7's plan; tiles of whole pages
    in whole steps of the kernel (4 warps, 4 keys a lane group); splits
    covering the W * page_size keys exactly once, at most PAGED_SPLIT_PAGES
    pages each."""
    for b, w in ((8, 20), (8, 512), (1, 4096), (128, 512), (1, 1)):
        plan = tfd.paged_split_plan(b, w, ps, 32 // g, g, dh, itemsize)
        assert plan['lpk'] == lpk
        assert plan['pieces'] * lpk * (16 // itemsize) >= dh
        assert plan['rows'] == rows
        span = tfd.CONTIG_WARPS * (32 // lpk) * tfd.CONTIG_STEP_KEYS
        tile = plan['tile']
        assert tile % span == 0 and tile % ps == 0 and tile >= 64
        n_tiles = -(-w * ps // tile)
        assert (plan['n_splits'] - 1) * plan['tiles_per_split'] < n_tiles \
            <= plan['n_splits'] * plan['tiles_per_split']
        assert plan['tiles_per_split'] * tile // ps \
            <= max(tfd.PAGED_SPLIT_PAGES, tile // ps)


def test_plan_takes_no_positions_and_matches_k7_on_one_key_pages():
    """The plan depends on the shapes only; at page size 1 it is K7's plan
    over the W keys (until the stage cap)."""
    params = set(inspect.signature(tfd.paged_split_plan).parameters)
    assert params == {'b', 'w', 'page_size', 'hkv', 'g', 'dh', 'itemsize'}
    for b, w, hkv, g, dh, itemsize in ((8, 160, 32, 1, 64, 2),
                                       (8, 200, 8, 4, 128, 4),
                                       (2, 256, 2, 1, 16, 4)):
        assert tfd.paged_split_plan(b, w, 1, hkv, g, dh, itemsize) \
            == tfd.contig_split_plan(b, w, hkv, g, dh, itemsize)


def test_plan_refuses_a_head_wider_than_a_warp_reads():
    """f32 rows up to dh=256 take two 16-byte pieces a lane (stablelm-12b's
    dh=160 among them); past 256 both element sizes are refused."""
    assert tfd.paged_split_plan(1, 4, 8, 1, 1, 136, 4)['pieces'] == 2
    assert tfd.paged_split_plan(1, 4, 8, 1, 1, 160, 2)['pieces'] == 1
    for itemsize in (2, 4):
        with pytest.raises(ValueError, match='dh=264'):
            tfd.paged_split_plan(1, 4, 8, 1, 1, 264, itemsize)


# ----------------------------------------------------------------------------
# K5: a chunk's query rows on the key split (chunk_split_plan)
# ----------------------------------------------------------------------------
def chunk_split_mirror(q, pools, pos, win, off, bt, *, chunk, scale):
    """K5's split-and-combine arithmetic in plain PyTorch at
    ``chunk_split_plan``'s cut. q (B, Hkv, R, dh) f32 with R = chunk * G,
    row r at ``off + r // G``; pos/win the fetch-union scalars (B,). A block
    of ``rows`` query rows narrows the live keys [max(pos - win + 1, 0),
    min(pos, S - 1)] to what its own rows can see, and each row masks its
    own keys (window win - (chunk - 1)); a row with no valid key in a split
    leaves m = -inf there and weighs 0 in the combine. Returns f32
    (B, Hkv, R, dh) and the number of (row group, split) blocks that held
    live keys."""
    b, hkv, n_rows, dh = q.shape
    g = n_rows // chunk
    ps, w = pools['k'].shape[1], bt.shape[1]
    s = w * ps
    plan = tfd.chunk_split_plan(b, w, ps, hkv, chunk, g, dh,
                                pools['k'].element_size())
    tile, tps, kr = plan['tile'], plan['tiles_per_split'], plan['rows']
    n_tiles = -(-s // tile)
    assert tile % ps == 0 and n_rows > 0
    assert plan['n_splits'] * tps >= n_tiles > (plan['n_splits'] - 1) * tps
    out, live_blocks = torch.empty_like(q), 0
    for bi in range(b):
        p_, w_, o_ = int(pos[bi]), int(win[bi]), int(off[bi])
        load = _row_loader(bi, pools, bt, ps, None)
        row_win = w_ - (chunk - 1)
        for r0 in range(0, n_rows, kr):
            rr = torch.arange(r0, min(r0 + kr, n_rows))
            qp = o_ + rr // g                                   # (nr,)
            lo = max(p_ - w_ + 1, 0, int(qp[0]) - row_win + 1)
            hi = min(p_, s - 1, int(qp[-1]))
            parts = []
            for split in range(plan['n_splits']):
                t0 = max(split * tps, lo // tile)
                t1 = min(split * tps + tps, n_tiles, hi // tile + 1) \
                    if lo <= hi else t0
                if t0 >= t1:
                    continue                    # a dead split: m = -inf
                m = torch.full((hkv, len(rr), 1), NEG_INF)
                l = torch.zeros((hkv, len(rr), 1))
                acc = torch.zeros((hkv, len(rr), dh))
                for t in range(t0, t1):
                    keys = torch.arange(max(t * tile, lo),
                                        min((t + 1) * tile, hi + 1))
                    if not len(keys):
                        continue
                    k, v = load(keys)
                    valid = ((keys[None, :] <= qp[:, None])
                             & (keys[None, :] > qp[:, None] - row_win))
                    logits = torch.einsum('hgd,shd->hgs', q[bi, :, rr],
                                          k) * scale
                    logits = torch.where(valid[None], logits, NEG_INF)
                    m_new = torch.maximum(m, logits.amax(-1, keepdim=True))
                    alpha = torch.where(torch.isfinite(m),
                                        torch.exp(m - m_new), 0.0)
                    p = torch.where(valid[None], torch.exp(logits - m_new),
                                    0.0)
                    l = l * alpha + p.sum(-1, keepdim=True)
                    acc = acc * alpha + torch.einsum('hgs,shd->hgd', p, v)
                    m = m_new
                parts.append((m, l, acc))
            live_blocks += len(parts)
            m_all = torch.full((hkv, len(rr), 1), NEG_INF)
            for m, _, _ in parts:
                m_all = torch.maximum(m_all, m)
            l_all = torch.zeros((hkv, len(rr), 1))
            a_all = torch.zeros((hkv, len(rr), dh))
            for m, l, acc in parts:             # split order
                fin = torch.isfinite(m)
                wt = torch.where(fin, torch.exp(m - m_all), 0.0)
                l_all = l_all + torch.where(fin, l * wt, 0.0)
                a_all = a_all + torch.where(fin, acc * wt, 0.0)
            out[bi, :, rr] = a_all / torch.clamp_min(l_all, 1e-30)
    return out, live_blocks


# two requests of Hkv=2, dh=16 over W=20 pages of 8 (160 keys), limit 128;
# request 1 is idle (limit 0, its table row the garbage page 0)
CHUNK_W, CHUNK_LIMIT = 20, 128


def _chunk_inputs(c, g, off, window, dtype=torch.float32):
    b, hkv, dh, ps, w = 2, 2, 16, 8, CHUNK_W
    rng = np.random.RandomState(c * 7 + g + off)
    n_pages = 1 + b * w
    q = torch.from_numpy(rng.randn(b, hkv, c * g, dh).astype(np.float32))
    shape = (n_pages, ps, hkv, dh)
    pools = dict(
        k=torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype),
        v=torch.from_numpy(rng.randn(*shape).astype(np.float32)).to(dtype))
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w).astype(np.int32)
    bt[1] = 0
    offv, posv, winv = tfd._chunk_scalars(
        torch.tensor([off, 0]), torch.tensor([CHUNK_LIMIT, 0]), window, b, c,
        w * ps, torch.device('cpu'))
    return q, pools, posv, winv, offv, torch.from_numpy(bt)


def _valid_rows(c, g, off):
    return (off + torch.arange(c * g) // g) < CHUNK_LIMIT


@pytest.mark.parametrize('window', [None, 24], ids=['causal', 'window24'])
@pytest.mark.parametrize('g', [1, 4])
@pytest.mark.parametrize('c,off', [(c, o) for c in (7, 8, 32)
                                   for o in (0, 96, 120, 124)])
def test_chunk_mirror_matches_plain(c, off, g, window):
    q, pools, posv, winv, offv, bt = _chunk_inputs(c, g, off, window)
    got, live = chunk_split_mirror(q, pools, posv, winv, offv, bt, chunk=c,
                                   scale=0.25)
    want = tfd.flash_decode_gqa_paged_plain(
        q, pools['k'], pools['v'], posv, winv, bt, offv, scale=0.25,
        chunk=c)
    # padding rows and the idle slot (its row at position 0 against the
    # garbage page) stay finite
    assert live > 0 and bool(torch.isfinite(got).all())
    valid = _valid_rows(c, g, off)
    np.testing.assert_allclose(got[0][:, valid].numpy(),
                               want[0][:, valid].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('target', [1, 16, tfd.CONTIG_TARGET_BLOCKS],
                         ids=['one_split', 'target16', 'serving_plan'])
@pytest.mark.parametrize('c,off,g', [(8, 96, 1), (32, 120, 4), (7, 124, 4)])
def test_chunk_mirror_at_every_cut(monkeypatch, target, c, off, g):
    """One split (the whole table a block), a small block target, and the
    serving plan's (a split a tile), with a 24-key window: the same
    output."""
    serving = target == tfd.CONTIG_TARGET_BLOCKS
    monkeypatch.setattr(tfd, 'CONTIG_TARGET_BLOCKS', target)
    plan = tfd.chunk_split_plan(2, CHUNK_W, 8, 2, c, g, 16, 4)
    n_tiles = -(-CHUNK_W * 8 // plan['tile'])
    if target == 1:
        assert plan['n_splits'] == 1
    if serving:
        assert plan['n_splits'] == n_tiles > 1
    q, pools, posv, winv, offv, bt = _chunk_inputs(c, g, off, 24)
    got, _ = chunk_split_mirror(q, pools, posv, winv, offv, bt, chunk=c,
                                scale=0.3)
    want = tfd.flash_decode_gqa_paged_plain(
        q, pools['k'], pools['v'], posv, winv, bt, offv, scale=0.3, chunk=c)
    valid = _valid_rows(c, g, off)
    np.testing.assert_allclose(got[0][:, valid].numpy(),
                               want[0][:, valid].numpy(), rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('c,off,g,window', [(7, 124, 4, None),
                                            (8, 96, 1, 24),
                                            (32, 96, 4, None)])
def test_k5_mirror_matches_reference_kernel(c, off, g, window, dtype, tol):
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    q, pools, posv, winv, offv, bt = _chunk_inputs(c, g, off, window, tdt)
    got, _ = chunk_split_mirror(q, pools, posv, winv, offv, bt, chunk=c,
                                scale=0.25)
    b, hkv, _, dh = q.shape
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    # the reference's (B, C, H, dh) query: row r of head h is position
    # r // G, query head h * G + r % G
    qc = q.reshape(b, hkv, c, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, c, hkv * g, dh)
    want = rfd.flash_chunk_paged(
        jnp.asarray(qc.numpy()), jnp.asarray(pools['k'].float().numpy(), jdt),
        jnp.asarray(pools['v'].float().numpy(), jdt),
        jnp.asarray([off, 0]), jnp.asarray([CHUNK_LIMIT, 0]),
        jnp.asarray(bt.numpy()), scale=0.25, window=window, interpret=True)
    want = torch.from_numpy(np.array(want, np.float32)) \
        .reshape(b, c, hkv, g, dh).permute(0, 2, 1, 3, 4) \
        .reshape(b, hkv, c * g, dh)
    valid = _valid_rows(c, g, off)
    np.testing.assert_allclose(got[0][:, valid].numpy(),
                               want[0][:, valid].numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize('itemsize', [2, 4])
def test_chunk_plan_rows_and_cover(itemsize):
    """K5's plan: K1's tiles of whole pages and lanes a key row,
    CHUNK_ROWS query rows a block, splits covering the table once; shapes
    only."""
    params = set(inspect.signature(tfd.chunk_split_plan).parameters)
    assert params == {'b', 'w', 'page_size', 'hkv', 'c', 'g', 'dh',
                      'itemsize'}
    for b, w, c, g in ((1, 20, 8, 1), (1, 20, 32, 1), (1, 512, 32, 1),
                       (2, 20, 7, 4), (4, 512, 8, 4)):
        plan = tfd.chunk_split_plan(b, w, 8, 32 // g, c, g, 64, itemsize)
        k1 = tfd.paged_split_plan(b, w, 8, 32 // g, g, 64, itemsize)
        assert plan['rows'] == tfd.CHUNK_ROWS == 2
        assert (plan['lpk'], plan['tile']) == (k1['lpk'], k1['tile'])
        n_tiles = -(-w * 8 // plan['tile'])
        assert (plan['n_splits'] - 1) * plan['tiles_per_split'] < n_tiles \
            <= plan['n_splits'] * plan['tiles_per_split']


@pytest.mark.parametrize('c,g,dh,itemsize', [(1, 1, 64, 2), (8, 0, 64, 2),
                                             (8, 1, 64, 1), (8, 1, 264, 4)])
def test_chunk_plan_refuses(c, g, dh, itemsize):
    with pytest.raises(ValueError, match='flash_chunk_paged'):
        tfd.chunk_split_plan(1, 20, 8, 32, c, g, dh, itemsize)
