"""``core/bitplane.py`` against the reference: every function bit-equal on
random signed and unsigned codes at several bit widths, and the
compute-block product equal to the direct integer product."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import bitplane as rbp
from repro_torch.core import bitplane as tbp

BITS = [2, 4, 8, 10]


def _codes(bits, signed, shape=(6, 9), seed=0):
    rng = np.random.RandomState(seed + bits)
    lo, hi = (-(2 ** (bits - 1)), 2 ** (bits - 1)) if signed \
        else (0, 2 ** bits)
    return rng.randint(lo, hi, shape).astype(np.int32)


@pytest.mark.parametrize('bits', BITS)
def test_unsigned_planes_bit_equal(bits):
    w = _codes(bits, signed=False)
    want = np.asarray(rbp.decompose_unsigned(jnp.asarray(w), bits))
    got = tbp.decompose_unsigned(torch.from_numpy(w), bits)
    assert got.dtype == torch.int8 and got.shape == w.shape + (bits,)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tbp.recombine_unsigned(got, bits)
    assert back.dtype == torch.int32
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        rbp.recombine_unsigned(jnp.asarray(want), bits)))
    np.testing.assert_array_equal(back.numpy(), w)


@pytest.mark.parametrize('bits', BITS)
def test_signed_planes_bit_equal(bits):
    w = _codes(bits, signed=True)
    want = np.asarray(rbp.decompose_signed(jnp.asarray(w), bits))
    got = tbp.decompose_signed(torch.from_numpy(w), bits)
    np.testing.assert_array_equal(got.numpy(), want)
    back = tbp.recombine_signed(got, bits)
    np.testing.assert_array_equal(back.numpy(), np.asarray(
        rbp.recombine_signed(jnp.asarray(want), bits)))
    np.testing.assert_array_equal(back.numpy(), w)


def test_full_ranges_round_trip():
    u = torch.arange(256)
    assert torch.equal(tbp.recombine_unsigned(tbp.decompose_unsigned(u)),
                       u.to(torch.int32))
    s = torch.arange(-128, 128)
    assert torch.equal(tbp.recombine_signed(tbp.decompose_signed(s)),
                       s.to(torch.int32))


@pytest.mark.parametrize('bits', BITS)
@pytest.mark.parametrize('lead', [(), (5,)], ids=['vector', 'batch'])
def test_bitplane_matmul_equals_reference_and_direct(bits, lead):
    rng = np.random.RandomState(bits)
    x = rng.randint(0, 2 ** bits, lead + (37,)).astype(np.int32)
    w = rng.randint(0, 2 ** bits, (37, 7)).astype(np.int32)
    got = tbp.bitplane_matmul_unsigned(torch.from_numpy(x),
                                       torch.from_numpy(w), bits)
    assert got.dtype == torch.int32 and got.shape == lead + (7,)
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        rbp.bitplane_matmul_unsigned(jnp.asarray(x), jnp.asarray(w), bits)))
    np.testing.assert_array_equal(got.numpy(), x @ w)
