"""Port quantization core and ``yoco_linear`` against the reference:
exact in f32 (``compute_dtype=float32``), 2e-2 in bf16."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as rquant
from repro.core import yoco_linear as ryl
from repro.models import model as rmodel
from repro import configs as rconfigs
from repro_torch.core import quant as tquant
from repro_torch.core import yoco_linear as tyl
from repro_torch.models import model as tmodel


def _xw(seed=0, lead=(2, 5), k=64, n=48):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    return x, w


def test_absmax_quantize_dequantize_match_reference():
    x, w = _xw()
    for axis in (None, 1, (0, 1)):
        rs = rquant.absmax_scale(jnp.asarray(x), axis=axis)
        ts = tquant.absmax_scale(torch.from_numpy(x), axis=axis)
        np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
        rq = rquant.quantize(jnp.asarray(x), rs)
        tq = tquant.quantize(torch.from_numpy(x), ts)
        np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
        np.testing.assert_array_equal(
            tquant.dequantize(tq, ts).numpy(),
            np.asarray(rquant.dequantize(rq, rs)))


def test_int8_dot_and_w8a8_matmul_match_reference():
    """The plain core functions follow the reference's eager semantics (a
    true division by 127 in the scale)."""
    x, w = _xw(1)
    want = np.asarray(rquant.w8a8_matmul(jnp.asarray(x), jnp.asarray(w)))
    got = tquant.w8a8_matmul(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_equal(got.numpy(), want)
    xq = np.random.RandomState(2).randint(-127, 128, (4, 30)).astype(np.int8)
    wq = np.random.RandomState(3).randint(-127, 128, (30, 7)).astype(np.int8)
    np.testing.assert_array_equal(
        tquant.int8_dot(torch.from_numpy(xq), torch.from_numpy(wq)).numpy(),
        np.asarray(rquant.int8_dot(jnp.asarray(xq), jnp.asarray(wq))))


def test_prequantize_weight_bit_equal():
    _, w = _xw(4)
    r = ryl.prequantize_weight(jnp.asarray(w))
    t = tyl.prequantize_weight(torch.from_numpy(w))
    np.testing.assert_array_equal(t.wq.numpy(), np.asarray(r.wq))
    np.testing.assert_array_equal(t.scale.numpy(), np.asarray(r.scale))


@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('bf16', True),
                                           ('w8a8', False), ('w8a8', True)])
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('bias', [False, True])
def test_linear_matches_reference(mode, prequant, dtype, bias):
    """Exact for f32 w8a8 without bias. With a bias XLA contracts the
    epilogue's last multiply and the bias add into one FMA, so that case
    (like the f32 bf16-mode float matmul) is held to 1e-6."""
    x, w = _xw(5)
    b = (np.random.RandomState(6).randn(w.shape[1]).astype(np.float32)
         if bias else None)
    bj = None if b is None else jnp.asarray(b)
    bt = None if b is None else torch.from_numpy(b)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    rw = ryl.prequantize_weight(jnp.asarray(w)) if prequant else jnp.asarray(w)
    tw = (tyl.prequantize_weight(torch.from_numpy(w)) if prequant
          else torch.from_numpy(w))
    xj = jnp.asarray(x).astype(jdt)
    xt = torch.from_numpy(x).to(tdt)
    # jitted, as the reference model runs it: XLA compiles the activation
    # scale's division by 127 into a multiply by f32(1/127)
    rcfg = ryl.YocoConfig(mode=mode, compute_dtype=jdt)
    want = jax.jit(lambda x_, w_, b_: ryl.linear(x_, w_, b_, cfg=rcfg))(
        xj, rw, bj)
    got = tyl.linear(xt, tw, bt,
                     cfg=tyl.YocoConfig(mode=mode, compute_dtype=tdt))
    assert got.dtype == tdt
    want = np.asarray(want.astype(jnp.float32))
    if dtype == 'float32' and mode == 'w8a8' and not bias:
        np.testing.assert_array_equal(got.numpy(), want)
    elif dtype == 'float32':
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)
    else:
        np.testing.assert_allclose(got.float().numpy(), want, atol=2e-2,
                                   rtol=2e-2)


def test_quantize_tree_converts_the_same_leaves():
    """Name dispatch over the stablelm smoke tree: the same weights become
    QuantizedWeights, bit-equal per layer, and norms/embeddings stay."""
    cfg = rconfigs.get('stablelm-1.6b', smoke=True)
    rp = rmodel.init_params(jax.random.key(0), cfg)
    rq = jax.tree.map(np.asarray, ryl.quantize_tree(rp))
    tp = tmodel.params_from_numpy(jax.tree.map(np.asarray, rp), cfg, 'cpu')
    tq = tyl.quantize_tree(tp)
    assert isinstance(tq['lm_head'], tyl.QuantizedWeight)
    assert isinstance(tq['embed'], torch.Tensor)
    np.testing.assert_array_equal(tq['lm_head'].wq.numpy(), rq['lm_head'].wq)
    for l in range(cfg.n_layers):
        for grp, names in (('attn', ('wq', 'wk', 'wv', 'wo')),
                           ('mlp', ('w_gate', 'w_up', 'w_down'))):
            for name in names:
                leaf = tq['layers'][l][grp][name]
                assert isinstance(leaf, tyl.QuantizedWeight), (grp, name)
                np.testing.assert_array_equal(leaf.wq.numpy(),
                                              rq['layers'][grp][name].wq[l])
                np.testing.assert_array_equal(
                    leaf.scale.numpy(), rq['layers'][grp][name].scale[l])
        assert isinstance(tq['layers'][l]['attn_norm']['scale'], torch.Tensor)
