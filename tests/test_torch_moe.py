"""The port's Mixture-of-Experts FFN (``repro_torch/models/moe.py``) held to
the reference's (``repro/models/moe.py``) on the CPU, on the same numpy
weights (the reference's ``init_moe``, carried across by
``params_from_numpy``), for qwen2-moe and deepseek-v3 SMOKE.

* ``route``: equal expert ids; gates, ``aux_loss`` and ``router_entropy``
  within 1e-6 in f32. ``_positions_in_expert``: equal.
* ``_expert_ffn``, ``_shared_ffn`` (bf16 mode and w8a8 with prequantized
  weights) and ``moe_dense``: 1e-5 in f32; in bf16 compute the
  reference's own bf16 bound for two MoE executions, BF16_TOL.
* ``dispatch_combine``: at capacity T·k equal to ``moe_dense`` (no drop);
  at capacities 1 and 2 outputs and ``drop_fraction`` as the reference's.
* A padded stack's dummy experts are zero and never routed.
* A NaN in one token's row leaves every other token's output bit-equal
  to a clean run (the chaos quarantine relies on it)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.models import moe as rmoe
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.models import model as tmodel
from repro_torch.models import moe as tmoe

ARCHS = ['qwen2-moe-a2.7b', 'deepseek-v3-671b']
F32_TOL = 1e-5
# the reference's own bound between two MoE executions in bf16
# (tests/test_moe.py::test_dispatch_combine_matches_dense_when_no_drops)
BF16_TOL = 2e-2
T = 12


def _cfgs(arch, pad=0):
    r, t = rconfigs.get(arch, smoke=True), tconfigs.get(arch, smoke=True)
    if pad:
        r = dataclasses.replace(r, moe=dataclasses.replace(
            r.moe, pad_experts_to=pad))
        t = dataclasses.replace(t, moe=dataclasses.replace(
            t.moe, pad_experts_to=pad))
    return r, t


@functools.lru_cache(maxsize=None)
def _params_np(arch, pad=0, prequant=False):
    """The reference's MoE params as numpy (quantized as its serve does:
    ``quantize_tree`` on a tree that names the ``moe`` dict). A padded
    stack's dummy experts are zeroed, as the port draws them."""
    rcfg, _ = _cfgs(arch, pad)
    p = rmoe.init_moe(jax.random.key(3), rcfg)
    if pad:
        n = rcfg.moe.n_experts
        p = {k: v.at[n:].set(0.0) if k in tmoe.STACKS else v
             for k, v in p.items()}
    if prequant:
        p = ryl.quantize_tree(dict(moe=p))['moe']
    return jax.tree.map(np.asarray, p)


def _pair(arch, pad=0, prequant=False):
    rcfg, tcfg = _cfgs(arch, pad)
    p_np = _params_np(arch, pad, prequant)
    pj = jax.tree.map(jnp.asarray, p_np)
    pt = tmodel.params_from_numpy(dict(moe=p_np), tcfg, 'cpu')['moe']
    return rcfg, tcfg, pj, pt


def _x(cfg, t=T, seed=0):
    return (np.random.RandomState(seed).randn(t, cfg.d_model) * 0.5) \
        .astype(np.float32)


def _yoco(mode, dtype):
    return (ryl.YocoConfig(mode=mode, compute_dtype=jnp.dtype(dtype)),
            tyl.YocoConfig(mode=mode, compute_dtype=getattr(torch, dtype)))


def _np(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize('arch', ARCHS)
def test_route_matches_reference(arch):
    rcfg, tcfg, pj, pt = _pair(arch)
    x = _x(tcfg)
    g_r, i_r, m_r = jax.jit(lambda p, x: rmoe.route(p, x, rcfg))(
        pj, jnp.asarray(x))
    g_t, i_t, m_t = tmoe.route(pt, torch.from_numpy(x), tcfg)
    assert i_t.dtype == torch.int32
    np.testing.assert_array_equal(i_t.numpy(), np.asarray(i_r))
    np.testing.assert_allclose(g_t.numpy(), np.asarray(g_r), rtol=0,
                               atol=1e-6)
    for key in ('aux_loss', 'router_entropy'):
        np.testing.assert_allclose(float(m_t[key]), float(m_r[key]),
                                   rtol=0, atol=1e-6)


def test_positions_in_expert_match_reference():
    ids = np.random.RandomState(4).randint(0, 8, 40).astype(np.int32)
    want = np.asarray(rmoe._positions_in_expert(jnp.asarray(ids), 8))
    got = tmoe._positions_in_expert(torch.from_numpy(ids), 8)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        tmoe._positions_in_expert(torch.tensor([2, 0, 2, 2, 1, 0],
                                               dtype=torch.int32), 4),
        [0, 0, 1, 2, 0, 1])


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('arch', ARCHS)
def test_expert_ffn_matches_reference(arch, dtype):
    rcfg, tcfg, pj, pt = _pair(arch)
    e = tcfg.moe.stack_size
    x = (np.random.RandomState(1).randn(e, 3, tcfg.d_model) * 0.5) \
        .astype(np.float32)
    want = jax.jit(lambda p, x: rmoe._expert_ffn(p, x, rcfg))(
        pj, jnp.asarray(x).astype(dtype))
    got = tmoe._expert_ffn(pt, torch.from_numpy(x).to(getattr(torch, dtype)),
                           tcfg)
    tol = F32_TOL if dtype == 'float32' else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('mode,prequant,dtype', [
    ('bf16', False, 'float32'), ('bf16', False, 'bfloat16'),
    ('w8a8', True, 'float32'), ('w8a8', True, 'bfloat16')])
@pytest.mark.parametrize('arch', ARCHS)
def test_shared_ffn_matches_reference(arch, mode, prequant, dtype):
    rcfg, tcfg, pj, pt = _pair(arch, prequant=prequant)
    if prequant:
        assert isinstance(pt['sh_gate'], tyl.QuantizedWeight)
        assert not isinstance(pt['w_gate'], tyl.QuantizedWeight)
    ry, ty = _yoco(mode, dtype)
    x = _x(tcfg)
    want = jax.jit(lambda p, x: rmoe._shared_ffn(p, x, rcfg, ry))(
        pj, jnp.asarray(x).astype(dtype))
    got = tmoe._shared_ffn(pt, torch.from_numpy(x).to(getattr(torch, dtype)),
                           tcfg, ty)
    tol = F32_TOL if dtype == 'float32' else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


@pytest.mark.parametrize('mode,prequant,dtype', [
    ('bf16', False, 'float32'), ('bf16', False, 'bfloat16'),
    ('w8a8', True, 'float32'), ('w8a8', False, 'float32')])
@pytest.mark.parametrize('arch', ARCHS)
def test_moe_dense_matches_reference(arch, mode, prequant, dtype):
    rcfg, tcfg, pj, pt = _pair(arch, prequant=prequant)
    ry, ty = _yoco(mode, dtype)
    x = _x(tcfg).reshape(2, T // 2, -1)
    want, m_r = jax.jit(lambda p, x: rmoe.moe_dense(p, x, rcfg, ry))(
        pj, jnp.asarray(x).astype(dtype))
    if mode == 'w8a8' and not prequant:
        pt = tmodel.k_major_linear_weights(pt)      # as dynamic w8a8 serves
    got, m_t = tmoe.moe_apply(pt, torch.from_numpy(x).to(
        getattr(torch, dtype)), tcfg, ty)
    assert got.shape == x.shape and got.dtype == getattr(torch, dtype)
    tol = F32_TOL if dtype == 'float32' else BF16_TOL
    np.testing.assert_allclose(_np(got), np.asarray(want, np.float32),
                               rtol=tol, atol=tol)
    np.testing.assert_allclose(float(m_t['aux_loss']),
                               float(m_r['aux_loss']), rtol=0, atol=1e-6)


@pytest.mark.parametrize('arch', ARCHS)
def test_dispatch_combine_matches_reference_and_dense(arch):
    """At capacity T·k nothing drops and the capacity dispatch equals the
    dense execution; at capacities 1 and 2 slots drop, and outputs and
    ``drop_fraction`` equal the reference's."""
    rcfg, tcfg, pj, pt = _pair(arch)
    ry, ty = _yoco('bf16', 'float32')
    x = _x(tcfg, t=16, seed=2)
    xt = torch.from_numpy(x)
    k = tcfg.moe.top_k
    dense, _ = tmoe.moe_dense(pt, xt[None], tcfg, ty)
    full, m = tmoe.dispatch_combine(pt, xt, tcfg, ty, capacity=16 * k)
    assert float(m['drop_fraction']) == 0.0
    np.testing.assert_allclose(full.numpy(), dense[0].numpy(), rtol=F32_TOL,
                               atol=F32_TOL)
    for cap in (1, 2):
        want, m_r = jax.jit(lambda p, x, cap=cap: rmoe.dispatch_combine(
            p, x, rcfg, ry, capacity=cap))(pj, jnp.asarray(x))
        got, m_t = tmoe.dispatch_combine(pt, xt, tcfg, ty, capacity=cap)
        assert float(m_t['drop_fraction']) > 0.0
        assert float(m_t['drop_fraction']) == float(m_r['drop_fraction'])
        np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                   rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize('arch', ARCHS)
def test_padded_dummy_experts_are_zero_and_never_routed(arch):
    """A stack padded past the router's experts: the port draws the dummies
    zero, the router never picks them, and ``moe_dense`` equals the
    reference's on the padded stack."""
    n = tconfigs.get(arch, smoke=True).moe.n_experts
    rcfg, tcfg, pj, pt = _pair(arch, pad=n + 4)
    assert tcfg.moe.stack_size == rcfg.moe.stack_size == n + 4
    drawn = tmoe.init_moe(torch.Generator().manual_seed(0), tcfg,
                          device='cpu')
    assert tuple(drawn['router'].shape) == (tcfg.d_model, n)
    for name in tmoe.STACKS:
        if name in drawn:
            assert drawn[name].shape[0] == n + 4
            assert not drawn[name][n:].any() and drawn[name][:n].all()
    x = _x(tcfg, t=64, seed=5)
    _, ids, _ = tmoe.route(pt, torch.from_numpy(x), tcfg)
    assert int(ids.max()) < n
    ry, ty = _yoco('bf16', 'float32')
    want, _ = rmoe.moe_dense(pj, jnp.asarray(x)[None], rcfg, ry)
    got, _ = tmoe.moe_dense(pt, torch.from_numpy(x)[None], tcfg, ty)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=F32_TOL,
                               atol=F32_TOL)


@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('w8a8', True)])
@pytest.mark.parametrize('arch', ARCHS)
def test_nan_row_stays_in_its_lane(arch, mode, prequant):
    _, tcfg, _, pt = _pair(arch, prequant=prequant)
    _, ty = _yoco(mode, 'float32')
    x = torch.from_numpy(_x(tcfg))[None]
    clean, _ = tmoe.moe_dense(pt, x, tcfg, ty)
    poisoned = x.clone()
    poisoned[0, 3, 5] = float('nan')
    got, _ = tmoe.moe_dense(pt, poisoned, tcfg, ty)
    assert torch.isnan(got[0, 3]).all()
    others = [i for i in range(T) if i != 3]
    assert torch.equal(got[0, others], clean[0, others])


def test_expert_parallel_context_is_refused():
    """An expert-parallel context whose EP axis does not divide the
    expert stack is refused with the reference's assertion (moe_ep runs
    on a rank mesh: tests/test_torch_moe_ep.py); a context on a config
    whose ``impl`` is not 'ep' takes the dense execution, as in the
    reference."""
    from repro_torch.launch import mesh as tmesh
    _, tcfg, _, pt = _pair(ARCHS[0])
    x = torch.from_numpy(_x(tcfg))[None]
    ctx = tmoe.EPContext(tmesh.shape_mesh(dict(data=1, model=3), 0),
                         ('data',))
    ep = dataclasses.replace(tcfg, moe=dataclasses.replace(tcfg.moe,
                                                           impl='ep'))
    with pytest.raises(AssertionError, match='must divide EP=3'):
        tmoe.moe_apply(pt, x, ep, tyl.DEFAULT_YOCO, ctx=ctx)
    dense = dataclasses.replace(tcfg, moe=dataclasses.replace(
        tcfg.moe, impl='dense'))
    got, _ = tmoe.moe_apply(pt, x, dense, tyl.DEFAULT_YOCO, ctx=ctx)
    want, _ = tmoe.moe_dense(pt, x, dense, tyl.DEFAULT_YOCO)
    assert torch.equal(got, want)
    # a stack not stored as moe_dense reads it is refused, not copied
    bad = dict(pt, w_gate=pt['w_gate'].contiguous())
    with pytest.raises(ValueError, match='stack_layout'):
        tmoe.moe_dense(bad, x, tcfg, tyl.DEFAULT_YOCO)
