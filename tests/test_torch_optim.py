"""The port's AdamW (``repro_torch.optim.adamw``) against the reference's, on
the CPU: the reference's ``tests/test_optim.py`` cases run on the port, each
also held to the reference's function on the same numpy inputs.

* The schedule is bit-equal to the jitted reference's (XLA's constant
  reciprocals and its fused multiply-add copied) but where XLA's f32
  cosine, which is not correctly rounded, is an ulp off the correctly
  rounded one the port takes: there the rates differ by at most 2 ulps
  (measured: 1 step of 130 at warmup 10, total 100).
* Clipping, the update direction, decay on matrices only and the EF
  compression of those cases are bit-equal to the reference's.
* Five chained random updates (with and without clipping, with the EF
  compression) agree with the jitted reference's within 1e-6: its XLA
  fuses some products into adds and sums the global norm in another
  order, so single elements move by an ulp or two (measured: params 2.4e-7
  at most).
* Gradient accumulation: A = 2 microbatches give the A = 1 step's params
  within the reference's own bound for bf16 forwards (2e-2).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.optim import adamw as radamw
from repro_torch.optim import adamw as tadamw

UPDATE_TOL = 1e-6


def _t(tree):
    return tadamw.tree_map(lambda a: torch.from_numpy(np.array(a)), tree)


def _pair(**kw):
    return radamw.OptConfig(**kw), tadamw.OptConfig(**kw)


@pytest.mark.parametrize('warmup,total', ((10, 100), (0, 10), (7, 100),
                                          (1, 8), (100, 10000)))
def test_schedule_bit_equal_to_jitted_reference(warmup, total):
    rc, tc = _pair(lr=1e-3, warmup_steps=warmup, total_steps=total,
                   min_lr_ratio=0.1)
    f = jax.jit(lambda s: radamw.schedule(s, rc))
    steps = np.arange(0, total + 30, max(1, total // 200), dtype=np.float32)
    want = np.array([f(jnp.float32(s)) for s in steps], np.float32)
    got = np.array([tadamw.schedule(torch.tensor(s), tc).item()
                    for s in steps], np.float32)
    np.testing.assert_array_less(np.abs(got - want),
                                 2.5 * np.spacing(np.abs(want)) + 1e-30)
    assert (got == want).mean() >= 0.97


def test_schedule_warmup_and_decay():
    cfg = tadamw.OptConfig(lr=1e-3, warmup_steps=10, total_steps=100,
                           min_lr_ratio=0.1)
    assert float(tadamw.schedule(torch.tensor(0.0), cfg)) == 0.0
    assert abs(float(tadamw.schedule(torch.tensor(10.0), cfg)) - 1e-3) < 1e-9
    end = float(tadamw.schedule(torch.tensor(100.0), cfg))
    assert abs(end - 1e-4) < 1e-8                 # min_lr_ratio * lr


def test_clip_by_global_norm():
    g = {'a': np.ones((10,), np.float32) * 10.0}
    clipped, gn = tadamw.clip_by_global_norm(_t(g), 1.0)
    assert abs(float(gn) - 10.0 * np.sqrt(10)) < 1e-3
    assert abs(float(tadamw.global_norm(clipped)) - 1.0) < 1e-4
    want, wgn = jax.jit(lambda g: radamw.clip_by_global_norm(g, 1.0))(
        jax.tree.map(jnp.asarray, g))
    assert float(gn) == float(wgn)
    np.testing.assert_array_equal(clipped['a'].numpy(),
                                  np.asarray(want['a']))


def _both_updates(params, grads, rc, tc):
    want = jax.jit(lambda p, g, s: radamw.update(p, g, s, rc))(
        jax.tree.map(jnp.asarray, params), jax.tree.map(jnp.asarray, grads),
        radamw.init(jax.tree.map(jnp.asarray, params), rc))
    tp = _t(params)
    got = tadamw.update(tp, _t(grads), tadamw.init(tp, tc), tc)
    return want, got


def test_update_moves_against_gradient():
    rc, tc = _pair(lr=0.1, warmup_steps=0, weight_decay=0.0, total_steps=10)
    params = {'w': np.ones((4, 4), np.float32)}
    grads = {'w': np.ones((4, 4), np.float32)}
    (wp, ws, wm), (tp, ts, tm) = _both_updates(params, grads, rc, tc)
    assert float(tp['w'].max()) < 1.0
    np.testing.assert_array_equal(tp['w'].numpy(), np.asarray(wp['w']))
    np.testing.assert_array_equal(ts.mu['w'].numpy(), np.asarray(ws.mu['w']))
    np.testing.assert_array_equal(ts.nu['w'].numpy(), np.asarray(ws.nu['w']))
    assert int(ts.step) == int(ws.step) == 1
    assert float(tm['lr']) == float(wm['lr'])


def test_weight_decay_only_on_matrices():
    rc, tc = _pair(lr=0.1, warmup_steps=0, weight_decay=1.0, total_steps=10)
    params = {'w': np.ones((4, 4), np.float32), 'b': np.ones((4,), np.float32)}
    grads = {'w': np.zeros((4, 4), np.float32),
             'b': np.zeros((4,), np.float32)}
    (wp, _, _), (tp, _, _) = _both_updates(params, grads, rc, tc)
    assert float(tp['w'].max()) < 1.0                  # decayed
    np.testing.assert_array_equal(tp['b'].numpy(), 1.0)
    for k in params:
        np.testing.assert_array_equal(tp[k].numpy(), np.asarray(wp[k]))


def test_ef_compression_unbiased_over_time():
    """Error feedback: the residual re-enters, so the accumulated update
    converges to the accumulated gradient; each step bit-equal to the
    jitted reference's."""
    g = np.array([1e-4, 1.0, -0.5, 3e-5], np.float32)
    ref = jax.jit(radamw.compress_decompress)
    ef, ref_ef = torch.zeros(4), jnp.zeros(4)
    total = torch.zeros(4)
    for _ in range(64):
        wire, ef = tadamw.compress_decompress(torch.from_numpy(g), ef)
        want, ref_ef = ref(jnp.asarray(g), ref_ef)
        np.testing.assert_array_equal(wire.numpy(), np.asarray(want))
        np.testing.assert_array_equal(ef.numpy(), np.asarray(ref_ef))
        total += wire
    np.testing.assert_allclose((total / 64).numpy(), g, atol=1e-4)


def _random_tree(rs):
    return {'w': rs.randn(64, 32).astype(np.float32),
            'b': rs.randn(32).astype(np.float32),
            'layers': {'a': rs.randn(2, 8, 8).astype(np.float32)}}


@pytest.mark.parametrize('kw', (
    dict(lr=1e-3, warmup_steps=7, total_steps=100),
    dict(lr=0.1, warmup_steps=0, total_steps=10, weight_decay=0.0,
         clip_norm=1e9),
    dict(lr=1e-3, warmup_steps=3, total_steps=20, compress_grads=True)),
    ids=('clipped', 'unclipped', 'compressed'))
def test_chained_updates_match_jitted_reference(kw):
    rc, tc = _pair(**kw)
    rs = np.random.RandomState(0)
    params = _random_tree(rs)
    rp = jax.tree.map(jnp.asarray, params)
    rstate = radamw.init(rp, rc)
    tp = _t(params)
    tstate = tadamw.init(tp, tc)
    update = jax.jit(lambda p, g, s: radamw.update(p, g, s, rc))
    for _ in range(5):
        grads = jax.tree.map(
            lambda a: (rs.randn(*a.shape) * 0.3).astype(np.float32), params)
        rp, rstate, rm = update(rp, jax.tree.map(jnp.asarray, grads), rstate)
        tp, tstate, tm = tadamw.update(tp, _t(grads), tstate, tc)
        assert float(tm['lr']) == float(rm['lr'])
        assert abs(float(tm['grad_norm']) - float(rm['grad_norm'])) <= \
            1e-6 * float(rm['grad_norm'])
        for want, got in ((rp, tp), (rstate.mu, tstate.mu),
                          (rstate.nu, tstate.nu), (rstate.ef, tstate.ef)):
            for a, b in zip(jax.tree.leaves(want), tadamw.tree_leaves(got)):
                np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                           atol=UPDATE_TOL)
    assert int(tstate.step) == int(rstate.step) == 5


def test_update_writes_in_place_and_keeps_strides():
    """The masters and moments keep their tensors: a K-major (transposed
    view) master stays K-major, with K-major moments."""
    tc = tadamw.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10)
    w = torch.randn(16, 8).t().contiguous().t()
    assert w.t().is_contiguous() and not w.is_contiguous()
    params = {'w': w, 'b': torch.zeros(8)}
    state = tadamw.init(params, tc)
    assert state.mu['w'].stride() == w.stride()
    ptrs = [t.data_ptr() for t in tadamw.tree_leaves(
        (params, state.mu, state.nu))]
    out, state, _ = tadamw.update(params, _t({'w': np.ones((16, 8),
                                                           np.float32),
                                              'b': np.ones(8, np.float32)}),
                                  state, tc)
    assert out is params and out['w'] is w and w.t().is_contiguous()
    assert [t.data_ptr() for t in tadamw.tree_leaves(
        (out, state.mu, state.nu))] == ptrs


def test_tree_leaves_follow_the_reference_order():
    tree = {'z': torch.zeros(1), 'a': [{'y': torch.ones(1),
                                        'b': torch.full((1,), 2.0)}],
            'm': (torch.full((1,), 3.0), None)}
    assert [float(t) for t in tadamw.tree_leaves(tree)] == [2.0, 1.0, 3.0,
                                                            0.0]
    mapped = tadamw.tree_map(lambda t: t + 1, tree)
    assert list(mapped) == ['z', 'a', 'm'] and mapped['m'][1] is None


def test_grad_accum_equivalence():
    """A=2 microbatches equal one full batch up to bf16 forward rounding,
    the reference's own bound (its tests/test_optim.py)."""
    from repro_torch import configs
    from repro_torch.core.yoco_linear import YocoConfig
    from repro_torch.data import synthetic
    from repro_torch.launch.train import init_state
    from repro_torch.runtime import train_step as TS

    cfg = configs.get('stablelm-1.6b', smoke=True)
    batch = synthetic.make_batch(synthetic.for_arch(cfg, global_batch=4,
                                                    seq_len=16), 0)
    out = []
    for accum in (1, 2):
        oc = tadamw.OptConfig(lr=1e-2, warmup_steps=0, total_steps=10,
                              grad_accum=accum, clip_norm=1e9)
        params, state = init_state(cfg, oc, 0, 'cpu')
        p, _, m = TS.make_train_step(cfg, YocoConfig(), opt_cfg=oc)(
            params, state, batch)
        out.append(tadamw.tree_leaves(p))
    d = max(float((a - b).abs().max()) for a, b in zip(*out))
    assert d < 2e-2, d
