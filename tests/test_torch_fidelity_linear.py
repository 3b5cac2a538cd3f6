"""The paper-fidelity layer against the reference, on the CPU: ``fake_quant``
and its straight-through gradient, ``_w8a8_ste``'s gradient, and the
``qat`` and ``analog_sim`` modes of ``yoco_linear``.

* ``fake_quant``: bit-equal to ``jax.jit(quant.fake_quant)`` (the scale in
  its compiled form) over per-token, per-channel and per-tensor axes and
  bits 2-8; its gradient equal to ``jax.vjp``'s.
* ``w8a8_ste``: the gradient within 1e-5 of ``jax.grad`` of the reference.
* ``qat``: the fake-quantized operands are bit-equal, so the output differs
  only by the float matmul's summation order: within 1e-6 of the output's
  full scale in f32 (measured: 3.1e-6 at a full scale of 4.9, K = 2048),
  and in bf16 by at most one bf16 step of the value on at most 1% of
  outputs (measured: 132 of 720,896 at K = 2048).
* ``analog_sim``: with JAX's draws patched in (:func:`jax_normals`), bit-
  equal to the jitted reference for float and prequantized weights at
  K = 2048 (where the VTC gain term is on); at K = 128 and K = 1100 (gain
  on) XLA contracts the share-line gain into the noise add at these small
  shapes, which moves the TDC scale by one ulp: TDC codes equal, values
  within 2 ulps of the full scale (:func:`assert_analog_equal`); with the
  port's own draws, deterministic in the seed, standard normal, and within
  the reference's (0, 3%) error bound."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import quant as rquant
from repro.core import yoco_linear as ryl
from repro_torch.core import quant as tquant
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import ops as tops


@functools.lru_cache(maxsize=None)
def _jax_draws(noise_seed, word, shape, need_gain):
    k1, k2, _ = jax.random.split(
        jax.random.fold_in(jax.random.key(noise_seed), word), 3)
    return (np.asarray(jax.random.normal(k1, shape)),
            np.asarray(jax.random.normal(k2, shape)) if need_gain else None)


def jax_normals(noise_seed, word, shape, need_gain, device):
    """``yoco_linear.analog_normals`` with the reference's draws:
    ``split(fold_in(key(noise_seed), word), 3)``, then ``normal(k1)`` and
    ``normal(k2)`` (the split into three keys matters although the third
    is unused). Cached: a model draws the same shapes every step."""
    n1, n2 = _jax_draws(int(noise_seed), int(word), tuple(shape),
                        bool(need_gain))
    return (torch.from_numpy(n1.copy()).to(device),
            None if n2 is None else torch.from_numpy(n2.copy()).to(device))


def _xw(lead, k, n, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(*lead, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    return x, w


AXES = {'per_token': lambda nd: tuple(range(nd - 1)),
        'per_channel': lambda nd: nd - 1, 'per_tensor': lambda nd: None}


# ----------------------------------------------------------------------------
# fake_quant
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('bits', range(2, 9))
@pytest.mark.parametrize('axis', sorted(AXES))
def test_fake_quant_bit_equal_to_jitted_reference(axis, bits):
    x = np.random.RandomState(bits).randn(3, 7, 40).astype(np.float32) * 3
    ax = AXES[axis](x.ndim)
    want = jax.jit(lambda a: rquant.fake_quant(a, ax, bits))(jnp.asarray(x))
    got = tquant.fake_quant(torch.from_numpy(x), ax, bits)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    # the compiled scale is the f32 reciprocal's multiply, not the division
    np.testing.assert_array_equal(
        tquant.jit_absmax_scale(torch.from_numpy(x), ax, bits).numpy(),
        np.asarray(jax.jit(lambda a: rquant.absmax_scale(a, ax, bits))(
            jnp.asarray(x))))


def test_fake_quant_keeps_bf16():
    x = np.random.RandomState(1).randn(4, 64).astype(np.float32)
    want = jax.jit(lambda a: rquant.fake_quant(a, 0))(
        jnp.asarray(x).astype(jnp.bfloat16))
    got = tquant.fake_quant(torch.from_numpy(x).to(torch.bfloat16), 0)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('bits', [4, 8])
@pytest.mark.parametrize('axis', sorted(AXES))
def test_fake_quant_ste_gradient_equals_jax_vjp(axis, bits):
    rng = np.random.RandomState(7)
    x = rng.randn(5, 33).astype(np.float32)
    g = rng.randn(5, 33).astype(np.float32)
    ax = AXES[axis](x.ndim)
    _, vjp = jax.vjp(lambda a: rquant.fake_quant(a, ax, bits),
                     jnp.asarray(x))
    want = np.asarray(vjp(jnp.asarray(g))[0])
    xt = torch.from_numpy(x).requires_grad_()
    tquant.fake_quant(xt, ax, bits).backward(torch.from_numpy(g))
    np.testing.assert_array_equal(xt.grad.numpy(), want)
    # outside the clip range (a wider x than the scale saw) the mask is 0
    scale = tquant.jit_absmax_scale(torch.from_numpy(x), ax, bits)
    q = tquant.quantize(torch.from_numpy(x), scale, bits)
    xw = (torch.from_numpy(x) * 2).requires_grad_()
    tquant.dequantize_ste(xw, q, scale, bits).sum().backward()
    qmax = 2 ** (bits - 1) - 1
    np.testing.assert_array_equal(
        xw.grad.numpy(),
        (np.abs(x * 2) <= scale.numpy() * qmax + 1e-6).astype(np.float32))


def test_w8a8_ste_gradient_matches_jax_grad():
    x, w = _xw((2, 6), 48, 24, seed=3)
    g = np.random.RandomState(4).randn(2, 6, 24).astype(np.float32)

    def loss(a, b):
        return jnp.sum(ryl._w8a8_ste(a, b, False) * jnp.asarray(g))
    want_dx, want_dw = jax.grad(loss, argnums=(0, 1))(jnp.asarray(x),
                                                      jnp.asarray(w))
    xt = torch.from_numpy(x).requires_grad_()
    wt = torch.from_numpy(w).requires_grad_()
    y = tyl.w8a8_ste(xt, wt)
    np.testing.assert_array_equal(
        y.detach().numpy(), np.asarray(jax.jit(
            lambda a, b: ryl._w8a8_ste(a, b, False))(x, w)))
    (y * torch.from_numpy(g)).sum().backward()
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(want_dx),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(wt.grad.numpy(), np.asarray(want_dw),
                               rtol=1e-5, atol=1e-5)


def test_w8a8_mode_trains_through_the_ste():
    """``linears`` in w8a8 and qat give gradients to x and a float w."""
    x, w = _xw((3,), 32, 16, seed=5)
    for mode in ('w8a8', 'qat', 'analog_sim'):
        xt = torch.from_numpy(x).requires_grad_()
        wt = torch.from_numpy(w).requires_grad_()
        cfg = tyl.YocoConfig(mode=mode, compute_dtype=torch.float32)
        tyl.yoco_matmul(xt, wt, cfg).pow(2).sum().backward()
        assert wt.grad.shape == wt.shape
        if mode != 'analog_sim':   # the TDC's round has no gradient
            assert float(wt.grad.abs().max()) > 0, mode


# ----------------------------------------------------------------------------
# qat
# ----------------------------------------------------------------------------
def _run(mode, x, w, prequant, dtype, bias=None, **cfg_kw):
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)
    rw = ryl.prequantize_weight(jnp.asarray(w)) if prequant \
        else jnp.asarray(w)
    tw = tyl.prequantize_weight(torch.from_numpy(w)) if prequant \
        else torch.from_numpy(w)
    rc = ryl.YocoConfig(mode=mode, compute_dtype=jdt, **cfg_kw)
    bj = None if bias is None else jnp.asarray(bias)
    want = jax.jit(lambda a, b, c: ryl.linear(a, b, c, cfg=rc))(
        jnp.asarray(x).astype(jdt), rw, bj)
    got = tyl.linear(torch.from_numpy(x).to(tdt), tw,
                     None if bias is None else torch.from_numpy(bias),
                     cfg=tyl.YocoConfig(mode=mode, compute_dtype=tdt,
                                        **cfg_kw))
    assert got.dtype == tdt
    return got.float().numpy(), np.asarray(want.astype(jnp.float32))


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('prequant', [False, True])
@pytest.mark.parametrize('shape', [((4, 16), 128, 64), ((8, 1), 2048, 256)],
                         ids=['K128', 'K2048'])
def test_qat_matches_jitted_reference(shape, prequant, dtype):
    x, w = _xw(*shape, seed=6)
    got, want = _run('qat', x, w, prequant, dtype)
    fs = np.abs(want).max()
    if dtype == 'float32':
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-6 * fs)
    else:
        # one bf16 step of the value, on at most 1% of the outputs
        diff = np.abs(got - want)
        assert (diff <= _bf16_steps(want)).all()
        assert (diff > 0).mean() <= 0.01


def test_qat_operands_are_the_reference_fake_quant():
    """What the qat matmul reads: x per token and w per output channel,
    bit-equal to the reference's fake_quant (a QuantizedWeight first
    dequantized to f32)."""
    x, w = _xw((2, 5), 64, 24, seed=8)
    xt = torch.from_numpy(x)
    xq, sx = tops.quantize_rows(xt)
    np.testing.assert_array_equal(
        tquant.dequantize_ste(xt, xq, sx).numpy(),
        np.asarray(jax.jit(lambda a: rquant.fake_quant(a, (0, 1)))(x)))
    for pre in (False, True):
        rw = ryl.prequantize_weight(jnp.asarray(w)) if pre else jnp.asarray(w)
        rwf = rquant.dequantize(rw.wq, rw.scale) if pre else rw
        tw = tyl.prequantize_weight(torch.from_numpy(w)) if pre \
            else torch.from_numpy(w)
        np.testing.assert_array_equal(
            tyl._fake_quant_weight(tyl._float_weight(tw)).numpy(),
            np.asarray(jax.jit(lambda a: rquant.fake_quant(a, 1))(rwf)))


# ----------------------------------------------------------------------------
# analog_sim
# ----------------------------------------------------------------------------
def _bf16_steps(want):
    """One bf16 step of each value."""
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 1e-30))) - 7)


def _tdc_codes(y, bits=8):
    """The TDC codes behind a dequantized analog output (its absmax maps to
    the top code)."""
    y = y.astype(np.float64)
    return np.round(y / (np.abs(y).max() / (2 ** (bits - 1) - 1)))


def assert_analog_equal(got, want, exact, bf16=False):
    """Bit-equal where ``exact``. Else XLA has contracted the share-line
    gain into the noise add (an FMA) at this small shape, which can move
    the TDC scale by one ulp: the codes must still be equal, the values
    within 2 ulps of the full scale (bf16: one bf16 step, on at most 1%)."""
    if exact:
        np.testing.assert_array_equal(got, want)
    elif bf16:
        diff = np.abs(got - want)
        assert (diff <= _bf16_steps(want)).all()
        assert (diff > 0).mean() <= 0.01
    else:
        np.testing.assert_array_equal(_tdc_codes(got), _tdc_codes(want))
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=2.4e-7 * np.abs(want).max())


@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('prequant', [False, True])
@pytest.mark.parametrize('shape', [((4, 16), 128, 64), ((8, 1), 2048, 256),
                                   ((3, 5), 1100, 40)],
                         ids=['K128', 'K2048', 'K1100'])
def test_analog_sim_with_jax_draws_matches_jitted_reference(
        monkeypatch, shape, prequant, dtype):
    """Bit-equal at a serving shape (K = 2048, N = 256, the gain term on);
    at the two small shapes within :func:`assert_analog_equal`'s bound,
    TDC codes equal."""
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)
    x, w = _xw(*shape, seed=9)
    got, want = _run('analog_sim', x, w, prequant, dtype)
    assert_analog_equal(got, want, exact=shape[1] == 2048,
                        bf16=dtype == 'bfloat16')


def test_analog_sim_bias_and_seed_and_tdc_bits(monkeypatch):
    """A bias (XLA contracts its add into an FMA: 1e-6), another noise
    seed and a 6-bit TDC, with JAX's draws."""
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)
    x, w = _xw((2, 3), 96, 32, seed=10)
    b = np.random.RandomState(11).randn(32).astype(np.float32)
    got, want = _run('analog_sim', x, w, False, 'float32', bias=b,
                     noise_seed=5, tdc_bits=6)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    got, want = _run('analog_sim', x, w, True, 'float32', noise_seed=5,
                     tdc_bits=6)
    assert_analog_equal(got, want, exact=False)
    np.testing.assert_array_equal(_tdc_codes(got, 6), _tdc_codes(want, 6))
    assert np.abs(_tdc_codes(got, 6)).max() == 31


def test_analog_sim_own_draws_deterministic_per_seed():
    x, w = _xw((4, 16), 2048, 64, seed=12)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)

    def run(seed):
        return tyl.yoco_matmul(xt, wt, tyl.YocoConfig(
            mode='analog_sim', noise_seed=seed, compute_dtype=torch.float32))
    assert torch.equal(run(0), run(0))
    assert not torch.equal(run(0), run(1))


def test_analog_normals_are_standard_and_keyed_by_k_and_n():
    shape = (64, 512)
    n1, n2 = tyl.analog_normals(0, 2048 * 131 + 512, shape, True, 'cpu')
    m = n1.numel()
    for n in (n1, n2):
        assert abs(float(n.mean())) < 4 / np.sqrt(m)
        assert abs(float(n.std()) - 1) < 4 / np.sqrt(m)
    assert not torch.equal(n1, n2)
    again, none = tyl.analog_normals(0, 2048 * 131 + 512, shape, False, 'cpu')
    assert torch.equal(again, n1) and none is None
    other, _ = tyl.analog_normals(0, 2048 * 131 + 511, shape, False, 'cpu')
    assert not torch.equal(other, n1)


def test_equal_k_and_n_give_equal_noise():
    """wq, wk and wv of one activation share (K, N), so the reference gives
    them the same draws; the port too (not decorrelated)."""
    x, w = _xw((3, 4), 64, 64, seed=13)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    cfg = tyl.YocoConfig(mode='analog_sim', compute_dtype=torch.float32)
    w8 = tyl.YocoConfig(mode='w8a8', compute_dtype=torch.float32)
    a, b = tyl.linears(xt, [wt, wt * 2], cfg=cfg)
    da = a - tyl.yoco_matmul(xt, wt, w8)
    db = b - tyl.yoco_matmul(xt, wt * 2, w8)
    # the same normals scaled by each output's full scale (up to the TDC)
    np.testing.assert_allclose(db.numpy(), 2 * da.numpy(),
                               atol=4 * float(b.abs().max()) / 127)


def test_analog_sim_error_within_reference_bound():
    """The reference's test_analog_sim_mode_adds_bounded_noise on the
    port's own draws: bf16, relative to the float product's full scale."""
    key = jax.random.key(0)
    x = np.array(jax.random.normal(key, (4, 16, 128), jnp.float32))
    w = np.array(jax.random.normal(jax.random.fold_in(key, 1), (128, 64),
                                   jnp.float32))
    ref = x @ w
    y = tyl.yoco_matmul(torch.from_numpy(x), torch.from_numpy(w),
                        tyl.YocoConfig(mode='analog_sim'))
    assert y.dtype == torch.bfloat16
    rel = np.abs(y.float().numpy() - ref).max() / np.abs(ref).max()
    assert 0.0 < rel < 0.03, rel


# ----------------------------------------------------------------------------
# K3 calls a mode makes, and the refusals
# ----------------------------------------------------------------------------
def _count_calls(monkeypatch):
    seen = {'quantize_rows': 0, 'int8_matmul': 0, 'yoco_vmm_codes': 0}
    for name in seen:
        orig = getattr(tops, name)

        def counted(*a, _orig=orig, _name=name, **k):
            seen[_name] += 1
            return _orig(*a, **k)
        monkeypatch.setattr(tops, name, counted)
    return seen


@pytest.mark.parametrize('mode,prequant,want', [
    ('qat', False, (1 + 3, 0, 0)), ('qat', True, (1 + 3, 0, 0)),
    ('analog_sim', False, (1 + 3, 0, 3)), ('analog_sim', True, (1, 3, 0))])
def test_kernel_calls_a_mode_makes(monkeypatch, mode, prequant, want):
    """qat: K3 once for the activation and once a weight, no K2 or K4;
    analog_sim: the w8a8 mode's calls (a dynamic weight's K3 inside
    ``yoco_vmm_codes``, then K4)."""
    x, w = _xw((2, 3), 64, 32, seed=14)
    ws = [torch.from_numpy(w) * s for s in (1, 2, 3)]
    if prequant:
        ws = [tyl.prequantize_weight(t) for t in ws]
    seen = _count_calls(monkeypatch)
    tyl.linears(torch.from_numpy(x), ws,
                cfg=tyl.YocoConfig(mode=mode, compute_dtype=torch.float32))
    assert (seen['quantize_rows'], seen['int8_matmul'],
            seen['yoco_vmm_codes']) == want


def test_modes_checked():
    x, w = _xw((2,), 16, 8)
    xt, wt = torch.from_numpy(x), torch.from_numpy(w)
    with pytest.raises(ValueError, match='unknown yoco mode'):
        tyl.linear(xt, wt, cfg=tyl.YocoConfig(mode='fp8'))
    for mode in ('qat', 'w8a8', 'analog_sim'):
        with pytest.raises(NotImplementedError, match='bits=8'):
            tyl.linear(xt, wt, cfg=tyl.YocoConfig(mode=mode, bits=4))
    assert tyl.linear(xt, wt, cfg=tyl.YocoConfig(
        bits=4, compute_dtype=torch.float32)).shape == (2, 8)
