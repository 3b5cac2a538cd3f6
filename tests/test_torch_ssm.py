"""The port's Mamba2 / SSD module (``repro_torch/models/ssm.py``) and its
blocks against the reference's (``repro/models/ssm.py``, ``blocks.py``),
on the same numpy inputs, in f32:

* ``ssd_chunked`` at chunks 8/16/64, with and without an initial state,
  and ``ssd_step`` (and the port's own ``ssd_reference``) within 2e-4, the
  reference's tolerance for chunked against sequential (the port's
  inter-chunk loop and einsums round differently from its associative
  scan);
* ``softplus`` (``jax.nn.softplus``'s, with no threshold), ``_segsum`` and
  ``_causal_conv`` with and without a history;
* ``mamba2_forward`` with and without ``last_pos`` (each row's state
  equal to its truncated prompt's), and from a carried state, the state
  written in place; ``mamba2_decode``; the slot ops; ``mamba_block`` and
  ``shared_block``: 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig as RYoco
from repro.models import blocks as rblocks
from repro.models import ssm as rssm
from repro_torch import configs as tconfigs
from repro_torch.core.yoco_linear import YocoConfig as TYoco
from repro_torch.models import blocks as tblocks
from repro_torch.models import ssm as tssm

SSM, HYB = 'mamba2-780m', 'zamba2-1.2b'
RY = RYoco(compute_dtype=jnp.float32)
TY = TYoco(compute_dtype=torch.float32)
TOL = 1e-5
SSD_TOL = 2e-4


def _t(a):
    return torch.from_numpy(np.array(a))


def _tree_np(tree):
    return jax.tree.map(lambda a: np.array(a, np.float32), tree)


def _tree_t(tree):
    if isinstance(tree, dict):
        return {k: _tree_t(v) for k, v in tree.items()}
    return _t(tree)


def _close(got, want, tol=TOL, msg=''):
    if isinstance(got, torch.Tensor):
        got = got.detach().numpy()
    np.testing.assert_allclose(got, np.asarray(want, np.float32), rtol=0,
                               atol=tol, err_msg=msg)


def _ssd_inputs(seed, b=2, s=64, h=4, p=8, g=1, n=16):
    rng = np.random.RandomState(seed)
    x = rng.randn(b, s, h, p).astype(np.float32)
    dt = np.log1p(np.exp(rng.randn(b, s, h) - 1.0)).astype(np.float32)
    a = (-np.exp(rng.randn(h) * 0.3)).astype(np.float32)
    bm = (rng.randn(b, s, g, n) * 0.5).astype(np.float32)
    cm = (rng.randn(b, s, g, n) * 0.5).astype(np.float32)
    init = rng.randn(b, h, p, n).astype(np.float32)
    return (x, dt, a, bm, cm), init


@pytest.mark.parametrize('chunk', [8, 16, 64])
@pytest.mark.parametrize('with_init', [False, True])
def test_ssd_chunked_matches_reference(chunk, with_init):
    args, init = _ssd_inputs(chunk + with_init, g=2 if chunk == 16 else 1)
    init = init if with_init else None
    y_r, f_r = jax.jit(lambda *a: rssm.ssd_chunked(*a[:5], chunk, *a[5:]))(
        *args, *(() if init is None else (init,)))
    y_t, f_t = tssm.ssd_chunked(*map(_t, args), chunk,
                                None if init is None else _t(init))
    _close(y_t, y_r, SSD_TOL, 'y')
    _close(f_t, f_r, SSD_TOL, 'final state')
    # and against the sequential recurrence, the port's own oracle
    y_s, f_s = tssm.ssd_reference(*map(_t, args),
                                  None if init is None else _t(init))
    _close(y_t, y_s.numpy(), SSD_TOL, 'y vs sequential')
    _close(f_t, f_s.numpy(), SSD_TOL, 'state vs sequential')


def test_ssd_step_matches_reference():
    (x, dt, a, bm, cm), init = _ssd_inputs(3, s=1, g=2)
    y_r, s_r = rssm.ssd_step(*(jnp.asarray(v[:, 0]) for v in (x, dt)),
                             jnp.asarray(a), jnp.asarray(bm[:, 0]),
                             jnp.asarray(cm[:, 0]), jnp.asarray(init))
    y_t, s_t = tssm.ssd_step(_t(x[:, 0]), _t(dt[:, 0]), _t(a),
                             _t(bm[:, 0]), _t(cm[:, 0]), _t(init))
    _close(y_t, y_r, msg='y')
    _close(s_t, s_r, msg='state')


def test_softplus_segsum_and_causal_conv_match_reference():
    rng = np.random.RandomState(4)
    v = np.concatenate([rng.randn(64) * 10, [30.0, 50.0, -50.0, 0.0]]) \
        .astype(np.float32)
    # no threshold: past it F.softplus returns x, jax.nn.softplus does not
    np.testing.assert_allclose(tssm.softplus(_t(v)).numpy(),
                               np.asarray(jax.nn.softplus(jnp.asarray(v))),
                               rtol=1e-6, atol=1e-7)
    seg = rng.randn(3, 8).astype(np.float32)
    want = np.asarray(rssm._segsum(jnp.asarray(seg)))
    got = tssm._segsum(_t(seg)).numpy()
    assert np.array_equal(np.isinf(got), np.isinf(want))
    _close(np.where(np.isinf(got), 0, got), np.where(np.isinf(want), 0,
                                                      want))
    xbc = rng.randn(2, 9, 12).astype(np.float32)
    w = rng.randn(4, 12).astype(np.float32)
    bias = rng.randn(12).astype(np.float32)
    hist = rng.randn(2, 3, 12).astype(np.float32)
    for h in (None, hist):
        want = rssm._causal_conv(jnp.asarray(xbc), jnp.asarray(w),
                                 jnp.asarray(bias),
                                 None if h is None else jnp.asarray(h))
        got = tssm._causal_conv(_t(xbc), _t(w), _t(bias),
                                None if h is None else _t(h))
        _close(got, want, msg=f'history {h is not None}')
    # bf16 activations times the f32 taps: f32 out, as the reference's
    got = tssm._causal_conv(_t(xbc).to(torch.bfloat16), _t(w), _t(bias),
                            _t(hist))
    want = rssm._causal_conv(jnp.asarray(xbc, jnp.bfloat16), jnp.asarray(w),
                             jnp.asarray(bias), jnp.asarray(hist))
    assert got.dtype == torch.float32 and want.dtype == jnp.float32
    _close(got, want, 1e-6)


def _mixer(arch, seed):
    cfg = rconfigs.get(arch, smoke=True)
    p = _tree_np(rssm.init_mamba2(jax.random.key(seed), cfg))
    # a non-trivial gate norm and conv bias, so both are exercised
    rng = np.random.RandomState(seed)
    p['gate_norm'] = (rng.randn(*p['gate_norm'].shape) * 0.1) \
        .astype(np.float32)
    p['conv_b'] = (rng.randn(*p['conv_b'].shape) * 0.1).astype(np.float32)
    return cfg, tconfigs.get(arch, smoke=True), p


def _state_np(cfg, b, seed):
    st = _tree_np(rssm.init_ssm_state(cfg, b))
    rng = np.random.RandomState(seed)
    return {k: (rng.randn(*v.shape) * 0.3).astype(np.float32)
            for k, v in st.items()}


@pytest.mark.parametrize('arch', [SSM, HYB])
def test_mamba2_forward_matches_reference(arch):
    """With no state, and from a carried state (written in place)."""
    rcfg, tcfg, p = _mixer(arch, 5)
    x = np.random.RandomState(6).randn(2, 40, rcfg.d_model) \
        .astype(np.float32)
    fwd = jax.jit(lambda p, x, st=None, lp=None: rssm.mamba2_forward(
        p, x, rcfg, RY, state=st, last_pos=lp))
    want, _ = fwd(p, x)
    got, none = tssm.mamba2_forward(_tree_t(p), _t(x), tcfg, TY)
    assert none is None
    _close(got, want)
    st = _state_np(rcfg, 2, 7)
    want, wst = fwd(p, x, st)
    tst = _tree_t(st)
    got, gst = tssm.mamba2_forward(_tree_t(p), _t(x), tcfg, TY, state=tst)
    assert gst is tst
    _close(got, want)
    for k in ('conv', 'ssm'):
        _close(tst[k], wst[k], SSD_TOL, k)


def test_mamba2_forward_last_pos_matches_per_row_truncation():
    """Right-padded rows of different lengths: each row's output and state
    equal the reference's with the same mask, and the truncated prompt's
    alone (the padded steps carry the state through)."""
    rcfg, tcfg, p = _mixer(SSM, 8)
    x = np.random.RandomState(9).randn(3, 40, rcfg.d_model) \
        .astype(np.float32)
    lens = [40, 23, 7]
    lp = np.array([n - 1 for n in lens], np.int32)
    st0 = _state_np(rcfg, 3, 10)
    want, wst = jax.jit(lambda p, x, st, lp: rssm.mamba2_forward(
        p, x, rcfg, RY, state=st, last_pos=lp))(p, x, st0, lp)
    tst = _tree_t(st0)
    got, _ = tssm.mamba2_forward(_tree_t(p), _t(x), tcfg, TY, state=tst,
                                 last_pos=_t(lp))
    _close(got, want)
    for k in ('conv', 'ssm'):
        _close(tst[k], wst[k], SSD_TOL, k)
    for b, n in enumerate(lens):
        row = {k: _t(v[b:b + 1]) for k, v in st0.items()}
        out, _ = tssm.mamba2_forward(_tree_t(p), _t(x[b:b + 1, :n]), tcfg,
                                     TY, state=row)
        _close(got[b, :n], out[0].numpy(), msg=f'row {b} output')
        for k in ('conv', 'ssm'):
            _close(tst[k][b], row[k][0].numpy(), SSD_TOL, f'{k} row {b}')


@pytest.mark.parametrize('arch', [SSM, HYB])
def test_mamba2_decode_matches_reference(arch):
    rcfg, tcfg, p = _mixer(arch, 11)
    st = _state_np(rcfg, 3, 12)
    x = np.random.RandomState(13).randn(3, 4, rcfg.d_model) \
        .astype(np.float32)
    rst, tst = jax.tree.map(jnp.asarray, st), _tree_t(st)
    dec = jax.jit(lambda p, x, st: rssm.mamba2_decode(p, x, rcfg, RY,
                                                      state=st))
    for t in range(x.shape[1]):
        want, rst = dec(p, x[:, t:t + 1], rst)
        got, _ = tssm.mamba2_decode(_tree_t(p), _t(x[:, t:t + 1]), tcfg, TY,
                                    state=tst)
        _close(got, want, msg=f'step {t}')
        for k in ('conv', 'ssm'):
            _close(tst[k], rst[k], msg=f'{k} step {t}')


@pytest.mark.parametrize('axis', [0, 1])
def test_slot_ops_match_reference(axis):
    rng = np.random.RandomState(14)
    lead = (3,) if axis else ()
    st = dict(conv=rng.randn(*lead, 4, 3, 5).astype(np.float32),
              ssm=rng.randn(*lead, 4, 2, 3, 6).astype(np.float32))
    rst, tst = jax.tree.map(jnp.asarray, st), _tree_t(st)
    want = rssm.slot_reset(rst, [1, 3], axis=axis)
    got = tssm.slot_reset(tst, [1, 3], axis=axis)
    assert got is tst
    for k in st:
        _close(tst[k], want[k], 0.0, k)
    rsnap = rssm.slot_snapshot(want, 2, axis=axis)
    tsnap = tssm.slot_snapshot(tst, 2, axis=axis)
    for k in st:
        _close(tsnap[k], rsnap[k], 0.0, k)
        tsnap[k].add_(1.0)              # a copy: the full tree is untouched
        _close(tst[k], want[k], 0.0, k)
    rback = rssm.slot_restore(want, jax.tree.map(lambda a: a + 1.0, rsnap),
                              0, axis=axis)
    tssm.slot_restore(tst, tsnap, 0, axis=axis)
    for k in st:
        _close(tst[k], rback[k], 0.0, k)


@pytest.mark.parametrize('decode', [False, True])
def test_mamba_block_matches_reference(decode):
    rcfg = rconfigs.get(SSM, smoke=True)
    tcfg = tconfigs.get(SSM, smoke=True)
    p = _tree_np(rblocks.init_mamba_block(jax.random.key(15), rcfg))
    s = 1 if decode else 20
    x = np.random.RandomState(16).randn(2, s, rcfg.d_model) \
        .astype(np.float32)
    st = _state_np(rcfg, 2, 17)
    want, wst = jax.jit(lambda p, x, st: rblocks.mamba_block(
        p, x, rcfg, RY, state=st, decode=decode))(p, x, st)
    tst = _tree_t(st)
    got, _ = tblocks.mamba_block(_tree_t(p), _t(x), tcfg, TY, state=tst,
                                 decode=decode)
    _close(got, want)
    for k in ('conv', 'ssm'):
        _close(tst[k], wst[k], SSD_TOL, k)


def test_shared_block_matches_reference():
    """zamba2's shared attention+MLP block at each site on a prompt (no
    cache): the per-site in_proj of concat(x, x0), the block, and the
    residual on the block's own delta."""
    rcfg = rconfigs.get(HYB, smoke=True)
    tcfg = tconfigs.get(HYB, smoke=True)
    n_sites = rcfg.n_layers // rcfg.hybrid_group
    p = _tree_np(rblocks.init_shared_block(jax.random.key(18), rcfg,
                                           n_sites))
    rng = np.random.RandomState(19)
    x = rng.randn(2, 12, rcfg.d_model).astype(np.float32)
    x0 = rng.randn(2, 12, rcfg.d_model).astype(np.float32)
    for site in range(n_sites):
        want, _ = jax.jit(lambda p, x, x0: rblocks.shared_block(
            p, x, x0, site, rcfg, RY))(p, x, x0)
        got, _ = tblocks.shared_block(_tree_t(p), _t(x), _t(x0), site, tcfg,
                                      TY)
        _close(got, want, msg=f'site {site}')
