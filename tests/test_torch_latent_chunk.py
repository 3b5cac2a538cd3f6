"""Kernel K9 (absorbed-MLA chunked prefill) on the latent key split, on the
CPU. On the card K9 is ``latent_split_kernel``'s chunk instance: a chunk's
C * H query rows (row i at ``offset + i // H``) cut into blocks of 32 rows
and ``latent_split_plan``'s key splits, the fetch-union scalars of
``_chunk_scalars`` giving the live keys; each block narrows them to the
union of its rows' ranges [qp_first - row_win + 1, qp_last] (row window
win - (C - 1)), which its dead-split test, its 32-key step walk and the
zeroing of masked rows use, and each row masks its own keys in the step's
softmax. The splits' partials are merged by the key split's combine.

``latent_split_mirror`` (``test_torch_latent_split.py``) with ``chunk``
is that arithmetic in plain PyTorch. It equals
``flash_decode_mla_paged_plain(chunk=C)`` within 1e-6 on the rows below
the chunk's limit (only the order of the sums differs) and the JAX
reference's ``flash_chunk_paged_mla`` in interpret mode within 2e-5 (the
reference's own tolerance for its MLA kernel), every row finite, padding
included; with the kernel's three-part bf16 products it holds 2e-5 at
deepseek-v3's width. The wrapper's CUDA branch is driven on meta tensors
(no data, so no position can be read back to the host) to show the plan
and arguments it launches with."""

import inspect

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as tfd
from test_torch_latent_split import FULL, KERNEL_ATOL, SMOKE, \
    latent_split_mirror

# (case, W, page_size, widths, C, offsets, limits, window) for two requests;
# a limit of 0 is an idle slot (its table row the garbage page 0, every
# row padding). At H=4 a 32-row block spans 8 positions.
CASES = [
    ('two_row_groups', 6, 8, SMOKE, 16, [24, 5], [40, 21], None),
    ('window', 6, 8, SMOKE, 16, [24, 8], [40, 24], 5),
    ('padded_c7', 6, 8, SMOKE, 7, [36, 0], [40, 0], None),
    ('crosses_pages', 4, 8, SMOKE, 8, [13, 2], [21, 10], None),
    ('page_of_4', 10, 4, SMOKE, 16, [20, 0], [36, 0], 9),
    ('page_of_12', 4, 12, SMOKE, 8, [30, 11], [38, 19], None),
    ('long_table_dead_splits', 40, 8, SMOKE, 8, [100, 40], [108, 46], None),
]


def _inputs(case, w, ps, widths, c, offsets, limits, window,
            dtype=torch.float32):
    rng = np.random.RandomState(len(case) + 7 * c + w * ps)
    b = 2
    h, r, dk = widths['h'], widths['r'], widths['r'] + widths['dr']
    n_pages = 1 + b * w
    q = rng.randn(b, c, h, dk).astype(np.float32)
    cl = torch.from_numpy(rng.randn(n_pages, ps, dk).astype(np.float32)) \
        .to(dtype)
    bt = rng.permutation(np.arange(1, n_pages)).reshape(b, w).astype(np.int32)
    bt[np.asarray(limits) == 0] = 0
    off, lim = torch.tensor(offsets), torch.tensor(limits)
    offv, posv, winv = tfd._chunk_scalars(off, lim, window, b, c, w * ps,
                                          torch.device('cpu'))
    return dict(q=q, qr=torch.from_numpy(q).reshape(b, 1, c * h, dk),
                cl=cl, bt=torch.from_numpy(bt), off=offv, pos=posv,
                win=winv, r=r, c=c, h=h, limits=limits, window=window,
                scale=1.0 / (r // 4 + widths['dr']) ** 0.5)


def _valid(x):
    """(B, C·H) rows below their request's limit."""
    c, h = x['c'], x['h']
    rowpos = x['off'][:, None] + torch.arange(c * h)[None] // h
    return rowpos < torch.tensor(x['limits'])[:, None]


def _mirror(x, **kw):
    return latent_split_mirror(x['qr'], dict(cl=x['cl']), x['pos'], x['win'],
                               x['bt'], scale=x['scale'], r=x['r'],
                               offset=x['off'], chunk=x['c'], **kw)


def _plain(x):
    return tfd.flash_decode_mla_paged_plain(
        x['qr'], x['cl'], x['pos'], x['win'], x['bt'], x['off'],
        scale=x['scale'], r=x['r'], chunk=x['c'])


@pytest.fixture
def sms(request, monkeypatch):
    """The plan at the card's 132 SMs, or at 4 (fewer splits of several
    tiles each)."""
    monkeypatch.setattr(tfd, 'LATENT_SMS', request.param)
    return request.param


@pytest.mark.parametrize('sms', [132, 4], indirect=True,
                         ids=['serving_plan', 'multi_tile_splits'])
@pytest.mark.parametrize('case', CASES, ids=[c[0] for c in CASES])
def test_chunk_mirror_matches_plain(case, sms):
    x = _inputs(*case)
    got, live = _mirror(x)
    want = _plain(x)
    valid = _valid(x)
    assert live > 0 and bool(torch.isfinite(got).all())   # padding too
    assert bool(valid.any())
    np.testing.assert_allclose(got[:, 0][valid].numpy(),
                               want[:, 0][valid].numpy(), rtol=1e-6,
                               atol=1e-6)


@pytest.mark.parametrize('sms', [132, 4], indirect=True,
                         ids=['serving_plan', 'multi_tile_splits'])
def test_dead_splits_and_row_groups(sms):
    """The long table's chunk has splits with no key of its row group
    (they write m = -inf and exit in the kernel), of one tile at the
    card's SM count and of several at 4; the H=4 chunk of 16 positions
    fills two 32-row blocks, 8 positions each, whose key ranges differ."""
    x = _inputs(*CASES[-1])
    plan = tfd.latent_split_plan(2, 40, 8, 8 * 4, 40, 32, 4)
    assert (plan['tiles_per_split'] > 1) == (sms == 4)
    _, live = _mirror(x)
    groups = 2 * -(-8 * 4 // tfd.LATENT_ROWS)
    assert 0 < live < groups * plan['n_splits']
    x = _inputs(*CASES[0])
    assert -(-x['c'] * x['h'] // tfd.LATENT_ROWS) == 2
    rowpos = x['off'][0] + torch.arange(x['c'] * x['h']) // x['h']
    assert int(rowpos[31]) < int(rowpos[32])   # the second block starts later


def _reference(x, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = rfd.flash_chunk_paged_mla(
        jnp.asarray(x['q']), jnp.asarray(x['cl'].float().numpy(), jdt),
        jnp.asarray(x['off'].numpy()),
        jnp.asarray(np.asarray(x['limits'], np.int32)),
        jnp.asarray(x['bt'].numpy()), r=x['r'], scale=x['scale'],
        window=x['window'], interpret=True)
    b, c, h, r = want.shape
    return torch.from_numpy(np.array(want, np.float32)).reshape(b, 1,
                                                                c * h, r)


@pytest.mark.parametrize('dtype', [torch.float32, torch.bfloat16],
                         ids=['f32', 'bf16'])
@pytest.mark.parametrize('case', [CASES[1], CASES[2], CASES[3], CASES[5]],
                         ids=['window', 'padded_c7', 'crosses_pages',
                              'page_of_12'])
def test_chunk_mirror_matches_reference_kernel(case, dtype):
    x = _inputs(*case, dtype=dtype)
    got, _ = _mirror(x)
    want = _reference(x, dtype)
    valid = _valid(x)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[:, 0][valid].numpy(),
                               want[:, 0][valid].numpy(), atol=KERNEL_ATOL,
                               rtol=0)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
def test_split_products_hold_f32_tolerance_at_deepseek_width(dtype):
    """The mirror with the kernel's three-part products (three on a bf16
    latent, six on an f32 one) at H=128, DK=576, r=512, C=3 (384 rows: 12
    blocks of one position each, the last position padding) against the
    f32 plain version: within 2e-5."""
    case = ('deepseek_width', 3, 8, FULL, 3, [10, 4], [12, 6], None)
    x = _inputs(*case, dtype=dtype)
    got, _ = _mirror(x, split_products=True)
    want = _plain(x)
    valid = _valid(x)
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got[:, 0][valid].numpy(),
                               want[:, 0][valid].numpy(), atol=KERNEL_ATOL,
                               rtol=0)


@pytest.mark.parametrize('itemsize', [2, 4])
@pytest.mark.parametrize('b,w,ps,c,h', [(1, 20, 8, 8, 128), (1, 20, 8, 32, 128),
                                       (1, 512, 8, 32, 128),
                                       (1, 512, 8, 8, 128), (2, 6, 8, 16, 4),
                                       (3, 9, 12, 7, 4)])
def test_chunk_plan_row_groups_and_cover(b, w, ps, c, h, itemsize):
    """K9's cut is the latent split's for C·H rows: 32 rows a block, so
    ⌈C·H / 32⌉ row groups a request, tiles of whole pages in whole 32-key
    steps, splits covering the table once with at most LATENT_SPLIT_PAGES
    pages each, and no more splits than fill the SMs unless the stage cap
    forces them."""
    plan = tfd.latent_split_plan(b, w, ps, c * h, 40 if h == 4 else 576,
                                 32 if h == 4 else 512, itemsize)
    tile, tps = plan['tile'], plan['tiles_per_split']
    assert plan['rows'] == tfd.LATENT_ROWS == 32
    assert tile % tfd.LATENT_STEP == 0 and tile % ps == 0
    n_tiles = -(-w * ps // tile)
    assert (plan['n_splits'] - 1) * tps < n_tiles <= plan['n_splits'] * tps
    assert tps * tile // ps <= tfd.LATENT_SPLIT_PAGES
    groups = b * -(-c * h // 32)
    if tps * tile // ps < tfd.LATENT_SPLIT_PAGES // 2:
        assert plan['n_splits'] <= max(1, -(-tfd.LATENT_SMS // groups))


def test_chunk_plan_at_the_serving_chunks():
    """A prefix hit's page-size chunk (C=8, H=128, W=20 pages of 8): 32 row
    groups of 5 one-tile splits, 160 blocks; the --chunk-prefill 32 chunk:
    128 row groups of one split, one wave of 128 blocks. At W=512, C=8 takes
    K8's W=512 grid (4 splits of 32 tiles); C=32 is cut in two by the stage
    cap of 256 pages a split."""
    cut = {c: tfd.latent_split_plan(1, 20, 8, c * 128, 576, 512, 2)
           for c in (8, 32)}
    assert (cut[8]['tiles_per_split'], cut[8]['n_splits']) == (1, 5)
    assert (cut[32]['tiles_per_split'], cut[32]['n_splits']) == (5, 1)
    assert tfd.latent_split_plan(1, 512, 8, 8 * 128, 576, 512, 2) \
        == tfd.latent_split_plan(8, 512, 8, 128, 576, 512, 2)
    long = tfd.latent_split_plan(1, 512, 8, 32 * 128, 576, 512, 2)
    assert (long['tiles_per_split'], long['n_splits']) == (64, 2)


def _launches(monkeypatch):
    """Drive the wrappers' CUDA branch without a card: every launch is
    recorded as (symbol, argument types, arguments) and succeeds."""
    calls = []

    def function(lib, symbol, argtypes):
        return lambda *args: calls.append((symbol, argtypes, args)) or 0
    monkeypatch.setattr(build, 'function', function)
    monkeypatch.setattr(build, 'require_cuda', lambda *a, **k: None)
    monkeypatch.setattr(build, 'stream_of', lambda t: 0)
    monkeypatch.setattr(build, 'count', lambda name: None)
    return calls


@pytest.mark.parametrize('c', [8, 32])
def test_chunk_wrapper_launches_the_latent_split(monkeypatch, c):
    """On a device other than the CPU, flash_chunk_paged_mla launches
    ``flash_chunk_paged_mla`` with the plan of its C·H rows, the chunk and
    the splits' scratch, one argument for each of the C entry point's
    types; the tensors are meta tensors, which hold no data, so nothing is
    read back to the host, and the plan takes no positions."""
    calls = _launches(monkeypatch)
    b, h, dk, r, ps, w = 1, 128, 576, 512, 8, 20
    meta = dict(device='meta')
    q = torch.empty((b, c, h, dk), **meta)
    cl = torch.empty((1 + w, ps, dk), dtype=torch.bfloat16, **meta)
    bt = torch.empty((b, w), dtype=torch.int32, **meta)
    off = torch.empty((b,), dtype=torch.int32, **meta)
    out = tfd.flash_chunk_paged_mla(q, cl, off, off, bt, r=r, scale=0.1)
    assert tuple(out.shape) == (b, c, h, r) and out.dtype == torch.float32
    (symbol, argtypes, args), = calls
    assert symbol == 'flash_chunk_paged_mla' and argtypes is tfd._K9_ARGS
    assert len(args) == len(argtypes)
    plan = tfd.latent_split_plan(b, w, ps, c * h, dk, r, 2)
    assert args[10:21] == (b, c * h, dk, r, ps, w, c,
                           *tfd._latent_plan_args(plan))
    assert args[22] == 1                                  # bf16 pool
    params = set(inspect.signature(tfd.latent_split_plan).parameters)
    assert params == {'b', 'w', 'page_size', 'h', 'dk', 'dv', 'itemsize'}


def test_decode_wrapper_launches_k8_with_the_same_plan(monkeypatch):
    """The decode branch that shares the chunk's launch code: K8's entry
    point, its H rows' plan, no offset and no chunk argument."""
    calls = _launches(monkeypatch)
    b, h, dk, r, ps, w = 8, 128, 576, 512, 8, 20
    meta = dict(device='meta')
    out = tfd.flash_decode_paged_mla(
        torch.empty((b, 1, h, dk), **meta),
        torch.empty((1 + b * w, ps, dk), **meta),
        torch.empty((b,), dtype=torch.int32, **meta),
        torch.empty((b, w), dtype=torch.int32, **meta), r=r, scale=0.1)
    assert tuple(out.shape) == (b, 1, h, r)
    (symbol, argtypes, args), = calls
    assert symbol == 'flash_decode_paged_mla' and argtypes is tfd._K8_ARGS
    assert len(args) == len(argtypes)
    plan = tfd.latent_split_plan(b, w, ps, h, dk, r, 4)
    assert args[9:19] == (b, h, dk, r, ps, w, *tfd._latent_plan_args(plan))
    assert args[20] == 0                                  # f32 pool
