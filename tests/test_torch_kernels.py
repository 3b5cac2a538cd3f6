"""Port kernels K1-K4, plain versions on the CPU, against the JAX kernels
run as the reference's own tests run them (Pallas interpret mode off the
TPU). Tolerances: K2/K3 bit-exact, K4 within 1 ulp, K1 1e-5 on f32 pools
and 2e-2 on bf16 pools (the reference's own, tests/test_flash_decode.py)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import flash_decode as rfd
from repro.kernels import ops as rops
from repro.kernels import yoco_vmm as ryv
from repro.runtime import kv_cache as rkvc
from repro_torch.kernels import build
from repro_torch.kernels import flash_decode as tfd
from repro_torch.kernels import ops as tops
from repro_torch.kernels import quantize as tq
from repro_torch.kernels import ref as tref
from repro_torch.kernels import yoco_vmm as tyv


def _quant_input(rng, m, k):
    x = rng.randn(m, k).astype(np.float32)
    x[0] = 0.0                                   # all-zero row: scale 1e-8/127
    # a row whose quotients x / scale land exactly on .5: absmax 127 gives
    # scale 1.0, so 2.5 / 1.0 rounds half-to-even to 2, -3.5 to -4
    x[1] = 0.0
    x[1, 0] = 127.0
    x[1, 1:6] = [2.5, -3.5, 0.5, -0.5, 126.5]
    return x


@pytest.mark.parametrize('m,k', [(2, 7), (13, 300), (40, 1000)])
def test_quantize_rows_bit_equal(m, k):
    x = _quant_input(np.random.RandomState(m), m, k)
    rq, rs = rops.quantize_rows(jnp.asarray(x))
    tq_, ts = tops.quantize_rows(torch.from_numpy(x))
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))
    assert tq_.dtype == torch.int8 and tuple(ts.shape) == (m, 1)
    assert tq_.numpy()[1, 1:6].tolist() == [2, -4, 0, 0, 126]


def test_quantize_rows_bf16_input_bit_equal():
    x = np.random.RandomState(3).randn(9, 200).astype(np.float32)
    xb = torch.from_numpy(x).to(torch.bfloat16)
    rq, rs = rops.quantize_rows(jnp.asarray(xb.float().numpy(),
                                            jnp.bfloat16))
    tq_, ts = tq.quantize_rows(xb)
    np.testing.assert_array_equal(tq_.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(rs))


@pytest.mark.parametrize('m,k,n', [(5, 130, 200), (17, 300, 129), (8, 256, 128)])
def test_int8_matmul_bit_equal(m, k, n):
    rng = np.random.RandomState(k)
    xq = rng.randint(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    want = np.asarray(rops.int8_matmul(jnp.asarray(xq), jnp.asarray(wq)))
    got = tops.int8_matmul(torch.from_numpy(xq), torch.from_numpy(wq))
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_yoco_vmm_int8_within_one_ulp():
    rng = np.random.RandomState(1)
    m, k, n = 8, 256, 128
    xq = rng.randint(-127, 128, size=(m, k)).astype(np.int8)
    wq = rng.randint(-127, 128, size=(k, n)).astype(np.int8)
    sx = rng.rand(m, 1).astype(np.float32) * 0.1
    sw = rng.rand(1, n).astype(np.float32) * 0.1
    want = np.asarray(ryv.yoco_vmm_int8(
        jnp.asarray(xq), jnp.asarray(wq), jnp.asarray(sx), jnp.asarray(sw),
        bm=8, bn=128, bk=128, interpret=True))
    got = tyv.yoco_vmm_int8(*(torch.from_numpy(a) for a in (xq, wq, sx, sw)))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)


@pytest.mark.parametrize('m,k,n', [(3, 100, 70), (19, 300, 260)])
def test_yoco_vmm_end_to_end_matches_reference(m, k, n):
    """Dynamic w8a8: K3 on x and on w.T, then K4 (reference ops.yoco_vmm)."""
    rng = np.random.RandomState(m)
    x = rng.randn(m, k).astype(np.float32)
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    want = np.asarray(rops.yoco_vmm(jnp.asarray(x), jnp.asarray(w)))
    got = tops.yoco_vmm(torch.from_numpy(x), torch.from_numpy(w))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    np.testing.assert_array_equal(
        got.numpy(), tref.yoco_vmm_ref(torch.from_numpy(x),
                                       torch.from_numpy(w)).numpy())


def test_ops_fold_leading_dims():
    rng = np.random.RandomState(0)
    x = torch.from_numpy(rng.randn(2, 3, 40).astype(np.float32))
    q, s = tops.quantize_rows(x)
    assert tuple(q.shape) == (2, 3, 40) and tuple(s.shape) == (2, 3, 1)
    wq = torch.from_numpy(rng.randint(-127, 128, (40, 9)).astype(np.int8))
    acc = tops.int8_matmul(q, wq)
    assert tuple(acc.shape) == (2, 3, 9)
    np.testing.assert_array_equal(
        acc.reshape(6, 9).numpy(),
        tyv.int8_matmul_plain(q.reshape(6, 40), wq).numpy())


def _paged_case(dtype, seed=7):
    """Shuffled block tables over a fragmented pool, one idle slot at pos 0
    against the garbage page (its table row all zeros)."""
    ps, w, b, h, hkv, dh = 8, 6, 4, 8, 2, 16
    rng = np.random.RandomState(seed)
    n_pages = b * w + 1
    q = rng.randn(b, 1, h, dh).astype(np.float32)
    kc = rng.randn(b, w * ps, hkv, dh).astype(np.float32)
    vc = rng.randn(b, w * ps, hkv, dh).astype(np.float32)
    perm = rng.permutation(np.arange(1, n_pages))
    bt = perm.reshape(b, w).astype(np.int32)
    bt[3] = 0                                        # idle slot
    kp = np.array(rkvc.scatter_pages(jnp.zeros((n_pages, ps, hkv, dh)),
                                       jnp.asarray(kc), jnp.asarray(bt)))
    vp = np.array(rkvc.scatter_pages(jnp.zeros((n_pages, ps, hkv, dh)),
                                       jnp.asarray(vc), jnp.asarray(bt)))
    kp[0] = rng.randn(ps, hkv, dh)                   # garbage page content
    vp[0] = rng.randn(ps, hkv, dh)
    pos = np.array([w * ps - 1, 21, 8, 0], np.int32)
    if dtype == 'bfloat16':
        kp = np.array(jnp.asarray(kp, jnp.bfloat16).astype(jnp.float32))
        vp = np.array(jnp.asarray(vp, jnp.bfloat16).astype(jnp.float32))
    return q, kp, vp, pos, bt, 1.0 / dh ** 0.5


@pytest.mark.parametrize('dtype,tol', [('float32', 1e-5), ('bfloat16', 2e-2)])
@pytest.mark.parametrize('window', [None, 9])
def test_flash_decode_paged_matches_reference(dtype, tol, window):
    q, kp, vp, pos, bt, scale = _paged_case(dtype)
    jdt = jnp.float32 if dtype == 'float32' else jnp.bfloat16
    tdt = torch.float32 if dtype == 'float32' else torch.bfloat16
    want = rfd.flash_decode_paged(jnp.asarray(q), jnp.asarray(kp, jdt),
                                  jnp.asarray(vp, jdt), jnp.asarray(pos),
                                  jnp.asarray(bt), scale=scale,
                                  window=window, interpret=True)
    got = tfd.flash_decode_paged(torch.from_numpy(q),
                                 torch.from_numpy(kp).to(tdt),
                                 torch.from_numpy(vp).to(tdt),
                                 torch.from_numpy(pos), torch.from_numpy(bt),
                                 scale=scale, window=window)
    assert got.dtype == tdt and tuple(got.shape) == q.shape
    assert bool(torch.isfinite(got).all())           # idle slot stays finite
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32),
                               rtol=tol, atol=tol)


def test_plain_k1_skips_dead_pages_bitwise():
    """Pages outside a request's live range leave its state untouched: the
    result equals the same call with those block-table entries pointed at
    NaN-filled pages."""
    q, kp, vp, pos, bt, scale = _paged_case('float32', seed=3)
    qg = torch.from_numpy(q[:, 0].reshape(4, 2, 4, 16))
    win = torch.full((4,), 9, dtype=torch.int32)
    args = [torch.from_numpy(a) for a in (kp, vp)]
    base = tfd.flash_decode_gqa_paged_plain(
        qg, *args, torch.from_numpy(pos), win, torch.from_numpy(bt),
        scale=scale)
    kp2, vp2 = kp.copy(), vp.copy()
    nan_page = kp.shape[0] - 1
    bt2 = bt.copy()
    bt2[0, 0] = nan_page                  # pos 47, window 9: block 0 dead
    kp2[nan_page] = np.nan
    vp2[nan_page] = np.nan
    got = tfd.flash_decode_gqa_paged_plain(
        qg, torch.from_numpy(kp2), torch.from_numpy(vp2),
        torch.from_numpy(pos), win, torch.from_numpy(bt2), scale=scale)
    np.testing.assert_array_equal(got[0].numpy(), base[0].numpy())


def test_wrappers_take_plain_version_only_on_cpu():
    """Tensors that are neither all on the CPU nor all on the meta device
    go to the kernel path, which checks devices before it would build or
    launch anything; meta tensors take the shape-only route, which
    launches nothing either."""
    build.reset_counts()
    x = torch.zeros((2, 4), device='meta')
    q, s = tq.quantize_rows(x)
    assert (q.device.type, q.dtype, tuple(q.shape)) == ('meta', torch.int8,
                                                        (2, 4))
    assert (s.dtype, tuple(s.shape)) == (torch.float32, (2, 1))
    with pytest.raises(ValueError, match='CUDA'):
        tyv.int8_matmul(torch.zeros((2, 4), dtype=torch.int8, device='meta'),
                        torch.zeros((4, 3), dtype=torch.int8))
    tq.quantize_rows(torch.zeros((2, 4)))            # CPU: plain, no launch
    assert all(v == 0 for v in build.LAUNCHES.values())
