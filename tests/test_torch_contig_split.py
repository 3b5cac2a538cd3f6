"""Kernel K7's key split, on the CPU. The CUDA kernel cuts the key axis of
the contiguous cache into absolute tiles (``contig_split_plan``), gives a
block ``tiles_per_split`` of them, visits only the tiles holding the live
keys [max(pos - win + 1, 0), min(pos, S - 1)] (every tile when streamed),
writes a split with none m = -inf, and merges the splits' (m, l, acc)
partials in split order, a split whose m is -inf weighing 0. A plain
mirror of that arithmetic, here, equals ``flash_decode_gqa_plain`` within
1e-6 in f32 (only the order of the sums differs), and its streamed walk
equals its prefetch walk bit for bit."""

import numpy as np
import pytest
import torch

from repro_torch.kernels import flash_decode as tfd

NEG_INF = float('-inf')


def _split_partials(q, k, v, lo, hi, t0, t1, tile, scale):
    """(m, l, acc) of one split of one request over its tiles [t0, t1), one
    online-softmax update a tile as the kernel makes one a step (so a fully
    masked tile leaves the state bit-unchanged); q (Hkv, G, dh), k/v (S,
    Hkv, dh) f32."""
    hkv, g, dh = q.shape
    m = torch.full((hkv, g, 1), NEG_INF)
    l = torch.zeros((hkv, g, 1))
    acc = torch.zeros((hkv, g, dh))
    for t in range(t0, t1):
        keys = torch.arange(t * tile, min((t + 1) * tile, k.shape[0]))
        valid = (keys >= lo) & (keys <= hi)
        logits = torch.einsum('hgd,shd->hgs', q, k[keys]) * scale
        logits = torch.where(valid, logits, NEG_INF)
        m_new = torch.maximum(m, logits.amax(dim=-1, keepdim=True))
        # all-masked guards: exp(-inf - -inf) must contribute 0, not 1
        alpha = torch.where(torch.isfinite(m), torch.exp(m - m_new), 0.0)
        p = torch.where(valid, torch.exp(logits - m_new), 0.0)
        l = l * alpha + p.sum(-1, keepdim=True)
        acc = acc * alpha + torch.einsum('hgs,shd->hgd', p, v[keys])
        m = m_new
    return m, l, acc


def split_mirror(q, k, v, pos, win, *, scale, streamed=False):
    """K7's split-and-combine arithmetic in plain PyTorch; q (B, Hkv, G,
    dh) f32, k/v (B, S, Hkv, dh), pos/win (B,). Returns f32 (B, Hkv, G,
    dh) and the number of splits that held live keys."""
    b, hkv, g, dh = q.shape
    s = k.shape[1]
    plan = tfd.contig_split_plan(b, s, hkv, g, dh, k.element_size())
    tile, tps = plan['tile'], plan['tiles_per_split']
    n_tiles = -(-s // tile)
    assert plan['n_splits'] * tps >= n_tiles > (plan['n_splits'] - 1) * tps
    out, live_splits = torch.empty_like(q), 0
    for bi in range(b):
        p_, w_ = int(pos[bi]), int(win[bi])
        lo, hi = max(p_ - w_ + 1, 0), min(p_, s - 1)
        parts = []
        for split in range(plan['n_splits']):
            t0 = split * tps
            t1 = min(t0 + tps, n_tiles)
            if not streamed:
                t0 = max(t0, lo // tile)
                t1 = min(t1, hi // tile + 1) if lo <= hi else t0
            if t0 >= t1:
                parts.append(None)         # a dead split writes m = -inf
                continue
            parts.append(_split_partials(q[bi], k[bi].float(), v[bi].float(),
                                         lo, hi, t0, t1, tile, scale))
        ms = [pt[0] for pt in parts if pt is not None]
        live_splits += sum(bool(torch.isfinite(m).all()) for m in ms)
        m_all = torch.full((hkv, g, 1), NEG_INF)
        for m in ms:
            m_all = torch.maximum(m_all, m)
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


# (case, B, S, Hkv, G, dh, pos, window); window None = S + 1
CASES = [
    ('pos0', 2, 300, 2, 1, 16, [0, 0], None),
    ('window_crosses_splits', 2, 300, 2, 2, 16, [250, 130], [70, 40]),
    ('s_not_split_multiple', 3, 200, 2, 4, 32, [199, 63, 150], None),
    ('dead_splits', 2, 600, 1, 1, 64, [10, 70], None),
    ('windowed_dead_prefix', 2, 600, 2, 1, 8, [599, 400], [33, 5]),
    ('smoke_width', 4, 20, 4, 1, 12, [19, 0, 7, 12], [5, None, None, 1]),
]


def _inputs(case, b, s, hkv, g, dh, pos, window):
    rng = np.random.RandomState(len(case) + s)
    q = torch.from_numpy(rng.randn(b, hkv, g, dh).astype(np.float32))
    k = torch.from_numpy(rng.randn(b, s, hkv, dh).astype(np.float32))
    v = torch.from_numpy(rng.randn(b, s, hkv, dh).astype(np.float32))
    if window is None:
        window = [s + 1] * b
    win = torch.tensor([s + 1 if w is None else w for w in window],
                       dtype=torch.int32)
    return q, k, v, torch.tensor(pos, dtype=torch.int32), win


@pytest.mark.parametrize('target', [tfd.CONTIG_TARGET_BLOCKS, 16],
                         ids=['serving_plan', 'multi_tile_splits'])
@pytest.mark.parametrize('case,b,s,hkv,g,dh,pos,window', CASES,
                         ids=[c[0] for c in CASES])
def test_split_mirror_matches_plain(monkeypatch, case, b, s, hkv, g, dh,
                                    pos, window, target):
    monkeypatch.setattr(tfd, 'CONTIG_TARGET_BLOCKS', target)
    q, k, v, posv, win = _inputs(case, b, s, hkv, g, dh, pos, window)
    scale = 1.0 / dh ** 0.5
    want = tfd.flash_decode_gqa_plain(q, k, v, posv, win, scale=scale)
    got, live = split_mirror(q, k, v, posv, win, scale=scale)
    streamed, _ = split_mirror(q, k, v, posv, win, scale=scale,
                               streamed=True)
    assert live >= b
    np.testing.assert_allclose(got.numpy(), want.numpy(), rtol=1e-6,
                               atol=1e-6)
    assert torch.equal(streamed, got)


@pytest.mark.parametrize('target', [tfd.CONTIG_TARGET_BLOCKS, 16],
                         ids=['serving_plan', 'multi_tile_splits'])
def test_dead_splits_exist_where_the_live_range_is_short(monkeypatch,
                                                         target):
    """The dead-split case really has splits with no live key (they exit at
    once in the kernel), and the small target really gives splits of
    several tiles."""
    monkeypatch.setattr(tfd, 'CONTIG_TARGET_BLOCKS', target)
    q, k, v, posv, win = _inputs(*CASES[3])
    plan = tfd.contig_split_plan(2, 600, 1, 1, 64, 4)
    assert plan['n_splits'] > 1
    assert (plan['tiles_per_split'] > 1) == (target == 16)
    _, live = split_mirror(q, k, v, posv, win, scale=0.125)
    assert plan['n_splits'] * 2 > live


@pytest.mark.parametrize('itemsize,dh,lpk', [(2, 64, 8), (2, 128, 16),
                                             (4, 64, 16), (4, 128, 32),
                                             (4, 12, 4), (2, 12, 2),
                                             (2, 160, 32), (2, 256, 32),
                                             (4, 160, 32), (4, 256, 32),
                                             (4, 136, 32)])
def test_plan_covers_the_cache_in_whole_steps(itemsize, dh, lpk):
    """Lanes a key row and the 16-byte pieces each lane holds (two only
    for an f32 row of more than 32 pieces, dh > 128), tiles in whole steps
    of the kernel (4 warps, 4 keys a lane group), splits covering [0, S)
    exactly once, independent of the positions (it takes none)."""
    vec = 16 // itemsize
    for s in (1, 20, 160, 200, 4096):
        plan = tfd.contig_split_plan(8, s, 32, 1, dh, itemsize)
        pieces = 2 if itemsize == 4 and dh > 128 else 1
        assert plan['lpk'] == lpk and plan['pieces'] == pieces
        # the kernel's own count, ceil(dh / (lpk * vec)), is the plan's
        assert -(-dh // (lpk * vec)) == pieces
        assert pieces * lpk * vec >= dh > (pieces - 1) * lpk * vec
        span = tfd.CONTIG_WARPS * (32 // lpk) * tfd.CONTIG_STEP_KEYS
        assert plan['tile'] % span == 0 and plan['tile'] >= 64
        n_tiles = -(-s // plan['tile'])
        assert (plan['n_splits'] - 1) * plan['tiles_per_split'] < n_tiles \
            <= plan['n_splits'] * plan['tiles_per_split']


def test_plan_refuses_a_head_wider_than_a_warp_reads():
    """32 lanes of one bf16 piece or two f32 pieces read 256 elements: a
    wider head is refused for both element sizes, by every plan."""
    for itemsize in (2, 4):
        for plan in (lambda dh: tfd.contig_split_plan(1, 16, 1, 1, dh,
                                                      itemsize),
                     lambda dh: tfd.paged_split_plan(1, 2, 8, 1, 1, dh,
                                                     itemsize),
                     lambda dh: tfd.chunk_split_plan(1, 2, 8, 1, 2, 1, dh,
                                                     itemsize)):
            assert plan(256)['lpk'] == 32
            with pytest.raises(ValueError, match='dh=264.*limit of 256'):
                plan(264)
