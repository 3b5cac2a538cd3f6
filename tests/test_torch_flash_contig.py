"""Kernel K7 (flash decode over a contiguous KV cache), plain version on
the CPU, against the reference's Pallas kernel run as its own tests run it
(interpret mode, ``bs=128``), on the reference's edge grid
(tests/test_flash_decode.py: pos 0, tile boundaries, a window smaller than
a tile, unaligned S 200 and 328), both impls, f32 and bf16 caches, G = 1
and 2.

Tolerances: the f32 core (``flash_decode_gqa`` in both packages) within
1e-5, f32 sums taken over other tiles (the port's 32 keys against the
reference's 128); the wrapper's bf16 output within the reference's 2e-2;
``impl='streamed'`` bit-equal to ``'prefetch'``."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as tfd

IMPLS = ['prefetch', 'streamed']
EDGES = [
    ('pos0', 384, [0, 0], None),
    ('tile_boundary', 384, [128, 127], None),
    ('tile_boundary_hi', 384, [256, 255], None),
    ('window_lt_tile', 384, [383, 130], 5),
    ('unaligned_smax', 200, [199, 63], None),
    ('unaligned_windowed', 328, [327, 40], 33),
]
B, HKV, DH = 2, 2, 32
SCALE = 1.0 / DH ** 0.5


def _case(name, s_max, g, bf16):
    rng = np.random.RandomState(len(name) + 7 * g)
    q = rng.randn(B, 1, HKV * g, DH).astype(np.float32)
    k = rng.randn(B, s_max, HKV, DH).astype(np.float32)
    v = rng.randn(B, s_max, HKV, DH).astype(np.float32)
    if bf16:                      # both packages read the same bf16 values
        k = torch.from_numpy(k).to(torch.bfloat16).float().numpy()
        v = torch.from_numpy(v).to(torch.bfloat16).float().numpy()
    return q, k, v


def _cache_pair(a, bf16):
    dt_j, dt_t = (jnp.bfloat16, torch.bfloat16) if bf16 else (jnp.float32,
                                                              torch.float32)
    return jnp.asarray(a, dt_j), torch.from_numpy(a).to(dt_t)


def _win(window, s_max):
    return np.full((B,), s_max + 1 if window is None else window, np.int32)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('g', [1, 2])
@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('name,s_max,pos,window', EDGES,
                         ids=[e[0] for e in EDGES])
def test_k7_core_matches_reference_kernel(name, s_max, pos, window, impl, g,
                                          bf16):
    """The f32 cores on the same (B, Hkv, G, dh) query: the reference's
    padded to its 128-key tile (its wrapper's pad), the port's unpadded."""
    q, k, v = _case(name, s_max, g, bf16)
    qg = q[:, 0].reshape(B, HKV, g, DH)
    posv = np.asarray(pos, np.int32)
    win = _win(window, s_max)
    pad = (-s_max) % 128
    kj, kt = _cache_pair(k, bf16)
    vj, vt = _cache_pair(v, bf16)
    padding = ((0, 0), (0, pad), (0, 0), (0, 0))
    want = np.asarray(rfd.flash_decode_gqa(
        jnp.asarray(qg), jnp.pad(kj, padding), jnp.pad(vj, padding),
        jnp.asarray(posv), jnp.asarray(win), scale=SCALE, bs=128,
        prefetch=impl == 'prefetch', interpret=True))
    got = tfd.flash_decode_gqa(torch.from_numpy(qg), kt, vt,
                               torch.from_numpy(posv), torch.from_numpy(win),
                               scale=SCALE, prefetch=impl == 'prefetch')
    assert got.dtype == torch.float32 and got.shape == want.shape
    assert bool(torch.isfinite(got).all())
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize('g', [1, 2])
@pytest.mark.parametrize('impl', IMPLS)
@pytest.mark.parametrize('name,s_max,pos,window', EDGES,
                         ids=[e[0] for e in EDGES])
def test_k7_wrapper_matches_reference_bf16(name, s_max, pos, window, impl,
                                           g):
    """The shape-flexible wrappers on a bf16 cache: (B, 1, H, dh) query,
    (B,) positions, the window filled with S + 1; output in the cache
    dtype."""
    q, k, v = _case(name, s_max, g, True)
    kj, kt = _cache_pair(k, True)
    vj, vt = _cache_pair(v, True)
    want = rfd.flash_decode(jnp.asarray(q), kj, vj, jnp.asarray(pos,
                                                                jnp.int32),
                            scale=SCALE, window=window, bs=128,
                            interpret=True, impl=impl)
    got = tfd.flash_decode(torch.from_numpy(q), kt, vt,
                           torch.tensor(pos, dtype=torch.int32), scale=SCALE,
                           window=window, impl=impl)
    assert got.dtype == torch.bfloat16 and tuple(got.shape) == want.shape
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), atol=2e-2)


@pytest.mark.parametrize('bf16', [False, True], ids=['f32', 'bf16'])
@pytest.mark.parametrize('name,s_max,pos,window', EDGES,
                         ids=[e[0] for e in EDGES])
def test_k7_streamed_bit_equal_to_prefetch(name, s_max, pos, window, bf16):
    q, k, v = _case(name, s_max, 2, bf16)
    _, kt = _cache_pair(k, bf16)
    _, vt = _cache_pair(v, bf16)
    out = [tfd.flash_decode(torch.from_numpy(q), kt, vt,
                            torch.tensor(pos, dtype=torch.int32),
                            scale=SCALE, window=window, impl=impl)
           for impl in IMPLS]
    assert torch.equal(out[0], out[1])


def test_k7_wrapper_shapes_and_scalar_pos():
    """(B, H, dh) queries and a scalar position give the (B, 1, H, dh)
    result without its query axis; an unknown impl is refused."""
    q, k, v = _case('shapes', 200, 2, False)
    kt, vt = torch.from_numpy(k), torch.from_numpy(v)
    a = tfd.flash_decode(torch.from_numpy(q), kt, vt, 150, scale=SCALE)
    b_ = tfd.flash_decode(torch.from_numpy(q[:, 0]), kt, vt,
                          torch.tensor(150), scale=SCALE)
    assert tuple(a.shape) == q.shape and tuple(b_.shape) == q[:, 0].shape
    assert torch.equal(a[:, 0], b_)
    with pytest.raises(ValueError, match='impl'):
        tfd.flash_decode(torch.from_numpy(q), kt, vt, 3, scale=SCALE,
                         impl='dense')


def test_k7_takes_the_plain_version_only_on_the_cpu():
    """Tensors neither all on the CPU nor all on the meta device go to the
    kernel path, which takes CUDA tensors only: it raises and counts no
    launch. All on the meta device: the shape-only route, no launch."""
    build.reset_counts()
    q = torch.empty((B, HKV, 1, DH), device='meta')
    k = torch.empty((B, 64, HKV, DH), device='meta')
    pos = torch.zeros((B,), dtype=torch.int32)
    with pytest.raises(ValueError, match='CUDA tensors'):
        tfd.flash_decode_gqa(q, k, k, pos, pos, scale=SCALE)
    out = tfd.flash_decode_gqa(q, k, k, pos.to('meta'), pos.to('meta'),
                               scale=SCALE)
    assert (out.device.type, out.dtype, tuple(out.shape)) == (
        'meta', torch.float32, tuple(q.shape))
    assert build.LAUNCHES['flash_decode_contig'] == 0
