"""``core/analog.py`` against the reference, on the CPU.

* Fed the reference's own ``ChipSample`` (``chip_from_numpy``) and its
  standard normals, each stage and the whole ``analog_vmm`` agree with the
  reference (run eagerly, as its own tests run it): volts within 1e-6
  (measured 2.4e-7 at most, no code flipped), TDC codes equal except
  one-step flips where
  the volts lie within 1e-6 of a TDC boundary, counted and asserted few.
* With ideal circuits the codes are equal.
* The reference's calibration tests (``tests/test_analog.py``) on the
  port's own ``torch.Generator`` draws, under the same bounds: INL/DNL
  < 2 LSB, input-conversion 3-sigma < 1 LSB, MAC <= 0.68% + 0.2%, VTC
  <= 0.11% + 0.05%, total VMM <= 0.79% + 0.4% of full scale."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import analog as ran
from repro_torch.core import analog as tan

VOLT_TOL = 1e-6


def _ref_chip(seed, **kw):
    chip = ran.sample_chip(jax.random.key(seed), **kw)
    return chip, tan.chip_from_numpy(chip, 'cpu')


def _normal(key, shape):
    return np.asarray(jax.random.normal(key, shape))


def _t(a):
    return torch.from_numpy(np.array(a))


def test_constants_and_summary_equal_reference():
    for name in ('VDD', 'NBITS', 'LSB', 'MACRO_ROWS', 'MACRO_COLS', 'CB_COLS',
                 'MACRO_CBS', 'SIGMA_VNOISE', 'SIGMA_UNIT_CAP', 'INL_BOW_LSB',
                 'MAC_GAIN_LOSS', 'SIGMA_MAC_NOISE', 'SIGMA_VTC_GAIN',
                 'TDC_BITS'):
        assert getattr(tan, name) == getattr(ran, name), name
    assert tan.error_model_summary() == ran.error_model_summary()
    assert abs(tan.LSB - 3.52e-3) < 0.02e-3


def test_chip_from_numpy_carries_the_reference_chip():
    rchip, tchip = _ref_chip(1, cbs=40, n_macros_v=3)
    for f in dataclasses.fields(tan.ChipSample):
        got = getattr(tchip, f.name)
        assert got.dtype == torch.float32
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(rchip, f.name)))


# ----------------------------------------------------------------------------
# stages, fed the reference's chip and normals
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('circuit', ['chip', 'chip+noise', 'ideal'])
def test_input_conversion_matches_reference(circuit):
    codes = np.random.RandomState(0).randint(0, 256, (5, 128)).astype(
        np.int32)
    rchip, tchip = _ref_chip(2)
    nkey = jax.random.key(3)
    noise = 'noise' in circuit
    want = ran.input_conversion(jnp.asarray(codes),
                                None if circuit == 'ideal' else rchip,
                                nkey if noise else None)
    got = tan.input_conversion(
        _t(codes), None if circuit == 'ideal' else tchip,
        _t(_normal(nkey, codes.shape)) if noise else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VOLT_TOL)
    np.testing.assert_array_equal(
        tan.input_conversion_ideal(_t(codes)).numpy(),
        np.asarray(ran.input_conversion_ideal(jnp.asarray(codes))))


@pytest.mark.parametrize('circuit', ['chip', 'chip+noise', 'ideal'])
def test_macro_mac_matches_reference(circuit):
    rng = np.random.RandomState(1)
    codes = rng.randint(0, 256, (3, 128)).astype(np.int32)
    w = rng.randint(0, 256, (128, 24)).astype(np.int32)
    rchip, tchip = _ref_chip(4, cbs=32)
    v_in = np.asarray(ran.input_conversion(jnp.asarray(codes), rchip))
    nkey = jax.random.key(5)
    noise = 'noise' in circuit
    want = ran.macro_mac(jnp.asarray(v_in), jnp.asarray(w),
                         None if circuit == 'ideal' else rchip,
                         nkey if noise else None)
    got = tan.macro_mac(_t(v_in), _t(w), None if circuit == 'ideal'
                        else tchip,
                        _t(_normal(nkey, (3, 24, 8))) if noise else None)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=VOLT_TOL)
    np.testing.assert_allclose(
        tan.macro_mac_ideal(_t(codes), _t(w)).numpy(),
        np.asarray(ran.macro_mac_ideal(jnp.asarray(codes), jnp.asarray(w))),
        rtol=1e-6)


def test_time_accumulate_and_tdc_match_reference():
    rchip, tchip = _ref_chip(6, n_macros_v=8)
    parts = np.random.RandomState(2).rand(8, 4, 16).astype(np.float32)
    for axis in (0, 1):
        p = parts if axis == 0 else parts.transpose(1, 0, 2)
        want = ran.time_accumulate(jnp.asarray(p), rchip, axis=axis)
        got = tan.time_accumulate(_t(p), tchip, axis=axis)
        np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                                   atol=VOLT_TOL)
    np.testing.assert_array_equal(
        tan.time_accumulate(_t(parts)).numpy(),
        np.asarray(ran.time_accumulate(jnp.asarray(parts))))
    t = np.linspace(-0.1, 3.0, 997).astype(np.float32)
    t[::7] = (np.round(t[::7] / 2.7 * 255) + 0.5) / 255 * 2.7  # ties
    np.testing.assert_array_equal(tan.tdc(_t(t), 2.7).numpy(),
                                  np.asarray(ran.tdc(jnp.asarray(t), 2.7)))


def _reference_draws(key, lead, k, n):
    """The chip and normals the reference's ``analog_vmm(..., key)`` draws,
    in ``tan.vmm_draws``' order."""
    n_macros = -(-k // ran.MACRO_ROWS)
    key, ck = jax.random.split(key)
    chip = ran.sample_chip(ck, cbs=max(n, ran.MACRO_CBS),
                           n_macros_v=n_macros)
    nkeys = jax.random.split(key, 2 * n_macros)
    normals = []
    for m in range(n_macros):
        normals.append(_t(_normal(nkeys[2 * m], (*lead, ran.MACRO_ROWS))))
        normals.append(_t(_normal(nkeys[2 * m + 1], (*lead, n, ran.NBITS))))
    return tan.chip_from_numpy(chip, 'cpu'), normals


def _boundary_flips(got, want, volts, full_scale):
    """Code differences: each must be one step, with its volts within
    VOLT_TOL of a TDC boundary; returns their count."""
    diff = np.abs(got.astype(np.int64) - want)
    assert diff.max(initial=0) <= 1
    lvl = volts / full_scale * 255
    near = np.abs(lvl - np.floor(lvl) - 0.5) <= VOLT_TOL / full_scale * 255
    assert near[diff > 0].all()
    return int((diff > 0).sum())


@pytest.mark.parametrize('shape', [((4,), 1024, 32), ((2, 3), 200, 40)],
                         ids=['1024x32', 'ragged'])
def test_analog_vmm_matches_reference_with_its_draws(shape):
    lead, k, n = shape
    rng = np.random.RandomState(k)
    x = rng.randint(0, 256, (*lead, k)).astype(np.int32)
    w = rng.randint(0, 256, (k, n)).astype(np.int32)
    key = jax.random.key(11)
    want, want_v = ran.analog_vmm(jnp.asarray(x), jnp.asarray(w), key=key,
                                  return_volts=True)
    chip, normals = _reference_draws(key, lead, k, n)
    got, got_v = tan.analog_vmm(_t(x), _t(w), chip=chip, normals=normals,
                                return_volts=True)
    assert got.dtype == torch.int32 and got.shape == (*lead, n)
    np.testing.assert_allclose(got_v.numpy(), np.asarray(want_v), rtol=0,
                               atol=VOLT_TOL)
    fs = -(-k // ran.MACRO_ROWS) * ran.VDD
    flips = _boundary_flips(got.numpy(), np.asarray(want), got_v.numpy(), fs)
    assert flips <= max(1, got.numel() // 1000), flips


@pytest.mark.parametrize('k', [256, 1000])
def test_ideal_circuits_give_the_reference_codes(k):
    rng = np.random.RandomState(k)
    x = rng.randint(0, 256, (3, k)).astype(np.int32)
    w = rng.randint(0, 256, (k, 16)).astype(np.int32)
    want = np.asarray(ran.analog_vmm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_equal(tan.analog_vmm(_t(x), _t(w)).numpy(), want)
    np.testing.assert_array_equal(
        tan.analog_vmm_ideal_codes(_t(x), _t(w)).numpy(),
        np.asarray(ran.analog_vmm_ideal_codes(jnp.asarray(x),
                                              jnp.asarray(w))))


def test_analog_vmm_generator_draws_on_its_device():
    x = torch.randint(0, 256, (2, 300))
    w = torch.randint(0, 256, (300, 8))
    a = tan.analog_vmm(x, w, torch.Generator().manual_seed(1))
    b = tan.analog_vmm(x, w, torch.Generator().manual_seed(1))
    assert torch.equal(a, b)
    chip, normals = tan.vmm_draws(torch.Generator().manual_seed(1), (2,),
                                  300, 8)
    assert torch.equal(tan.analog_vmm(x, w, chip=chip, normals=normals), a)
    assert len(normals) == 6 and chip.vtc_gain_err.shape == (3,)
    with pytest.raises(ValueError, match='not both'):
        tan.analog_vmm(x, w, torch.Generator(), chip=chip)


# ----------------------------------------------------------------------------
# the calibration, on the port's own draws (tests/test_analog.py's bounds)
# ----------------------------------------------------------------------------
def test_ideal_input_conversion_is_eq2():
    np.testing.assert_allclose(
        tan.input_conversion_ideal(torch.arange(256)).numpy(),
        np.arange(256) / 255.0 * tan.VDD, rtol=1e-6)


def test_input_conversion_inl_dnl_under_2lsb():
    codes = torch.arange(256)
    chip = tan.sample_chip(torch.Generator().manual_seed(7))
    v = tan.input_conversion(codes[None, :].repeat(tan.MACRO_ROWS, 1).T,
                             chip)[:, 0].numpy()
    ideal = tan.input_conversion_ideal(codes).numpy()
    inl = np.abs(v - ideal) / tan.LSB
    dnl = np.abs(np.diff(v) - tan.LSB) / tan.LSB
    assert inl.max() < 2.0, inl.max()
    assert dnl.max() < 2.0, dnl.max()


def test_input_conversion_3sigma_under_1lsb():
    """2K Monte-Carlo chips, each with its thermal noise."""
    gen = torch.Generator().manual_seed(0)
    code = torch.full((1, 1), 128)
    vs = []
    for _ in range(2000):
        chip = tan.sample_chip(gen, rows=1)
        vs.append(tan.input_conversion(
            code, chip, torch.randn((1, 1), generator=gen)))
    vs = torch.cat(vs).reshape(-1).double().numpy()
    bow = tan.INL_BOW_LSB * tan.LSB * np.sin(np.pi * 128 / 255)
    err = vs - float(tan.input_conversion_ideal(torch.tensor(128))) - bow
    sigma3 = 3 * err.std()
    assert 0.2 * tan.LSB < sigma3 < tan.LSB, (sigma3, tan.LSB)


def test_mac_error_under_paper_bound():
    """Weight scan: input all 255, weights 0..255, 128 channels."""
    w = torch.arange(256)[None, :].repeat(tan.MACRO_ROWS, 1)
    x = torch.full((tan.MACRO_ROWS,), 255)
    chip = tan.sample_chip(torch.Generator().manual_seed(3), cbs=256)
    v = tan.macro_mac(tan.input_conversion(x), w, chip)
    ideal = tan.macro_mac_ideal(x, w)
    err = ((v - ideal).abs() / ideal.abs().max()).numpy()
    assert err.max() <= 0.0068 + 2e-3, err.max()


def test_time_accumulation_error_under_paper_bound():
    chip = tan.sample_chip(torch.Generator().manual_seed(5), n_macros_v=8)
    parts = torch.full((8, 32), tan.VDD / 2)
    got = tan.time_accumulate(parts, chip)
    ideal = parts.sum(0)
    rel = ((got - ideal).abs() / ideal.abs().max()).numpy()
    assert rel.max() <= 0.0011 + 5e-4, rel.max()


def test_full_vmm_error_under_total_bound():
    gen = torch.Generator().manual_seed(11)
    x = torch.randint(0, 256, (4, 1024), generator=gen)
    w = torch.randint(0, 256, (1024, 32), generator=gen)
    codes = tan.analog_vmm(x, w, gen)
    ideal = tan.analog_vmm_ideal_codes(x, w)
    rel = ((codes - ideal).abs().double() / 255.0).numpy()
    assert rel.max() <= 0.0079 + 0.004, rel.max()


def test_analog_vmm_ideal_matches_int_matmul():
    gen = torch.Generator().manual_seed(13)
    x = torch.randint(0, 256, (2, 256), generator=gen)
    w = torch.randint(0, 256, (256, 8), generator=gen)
    assert int((tan.analog_vmm(x, w) - tan.analog_vmm_ideal_codes(x, w))
               .abs().max()) <= 1
