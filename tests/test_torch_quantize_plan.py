"""Kernel K3's cut (``kernels/quantize.py::quantize_plan``), on the CPU.

The CUDA kernel reads each row once, in 16-byte pieces held in registers:
thread t of a row's ``row_threads`` holds pieces t, t + row_threads, ... of
its CTA's slice (a cluster CTA's contiguous ``slice`` of the row, or the
whole row), takes their absmax, merges it per warp, then across the row's
warps (in shared memory, or, for a cluster, in the slots every warp of
every CTA writes into each CTA's shared memory), and quantizes the pieces
it holds. A plain mirror of that cut, here, gives codes and scales
bit-equal to ``quantize_rows_plain`` and to the reference's
``repro.kernels.ops.quantize_rows`` in Pallas interpret mode (as
``tests/test_torch_kernels.py`` runs it): max is exact in any order, and
the codes come from the held values with the reference's true division
and half-to-even rounding."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as rops
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import quantize as tq


def quantize_mirror(x: torch.Tensor):
    """K3's arithmetic at ``quantize_plan``'s cut: (codes, scales, plan)."""
    m, k = x.shape
    plan = tq.quantize_plan(m, k, x.element_size())
    cs, tpr, sl, vecs = (plan['cluster'], plan['row_threads'], plan['slice'],
                         plan['vecs'])
    v = 16 // x.element_size()
    nv = -(-k // v)
    # the plan's contract with the kernel
    assert tpr % 32 == 0 and plan['rows'] * tpr <= tq.QUANT_MAX_THREADS
    assert cs == 1 or plan['rows'] == 1
    assert cs * sl >= nv > (cs - 1) * sl and vecs * tpr >= sl
    assert vecs in (1, 2, 4, 8, 16)
    pieces = torch.zeros((m, nv * v), dtype=torch.float32)
    pieces[:, :k] = x.float()                       # the ragged tail pads 0
    pieces = pieces.view(m, nv, v)
    # who holds piece p: CTA rank p // slice, thread (p % slice) % tpr, its
    # (p % slice) // tpr-th piece; every piece exactly once
    p = torch.arange(nv)
    rank, local = p // sl, p % sl
    thread, held = local % tpr, local // tpr
    assert bool((held < vecs).all()) and bool((rank < cs).all())
    # per thread, per warp, then the row's slots (rank, warp), merged
    nw = tpr // 32
    slot = rank * nw + thread // 32
    piece_amax = pieces.abs().amax(dim=-1)                       # (m, nv)
    slots = torch.zeros((m, cs * nw)).scatter_reduce(
        1, slot.expand(m, nv), piece_amax, reduce='amax')
    amax = slots.amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * tq.INV_INT8_MAX
    codes = torch.clamp(torch.round(pieces / scale[:, :, None]), -127, 127)
    return codes.view(m, nv * v)[:, :k].to(torch.int8), scale, plan


def _rows(m, k, seed):
    x = np.random.RandomState(seed).randn(m, k).astype(np.float32)
    x[0] = 0.0                                     # all-zero row
    if m > 1:
        x[-1, -1] = 50.0                           # absmax in the last slice
    if m > 2 and k >= 6:
        # quotients landing on .5: absmax 127 gives scale 1.0
        x[1] = 0.0
        x[1, 0] = 127.0
        x[1, 1:6] = [2.5, -3.5, 0.5, -0.5, 126.5]
    return x


def _reference(x_np, dtype):
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    q, s = rops.quantize_rows(jnp.asarray(x_np, jdt))
    return np.asarray(q), np.asarray(s)


@pytest.mark.parametrize('dtype', [torch.bfloat16, torch.float32],
                         ids=['bf16', 'f32'])
@pytest.mark.parametrize('k', [7, 512, 2048, 5632, 7168])
@pytest.mark.parametrize('m', [1, 8, 1024])
def test_mirror_bit_equal_to_plain_and_reference(m, k, dtype):
    x = torch.from_numpy(_rows(m, k, m + k)).to(dtype)
    q, s, plan = quantize_mirror(x)
    qp, sp = tq.quantize_rows_plain(x)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    rq, rs = _reference(x.float().numpy(), dtype)
    np.testing.assert_array_equal(q.numpy(), rq)
    np.testing.assert_array_equal(s.numpy(), rs)
    assert float(s[0, 0]) == float(np.float32(1e-8) * np.float32(1 / 127))
    if m > 2 and k >= 6:
        assert q[1, 1:6].tolist() == [2, -4, 0, 0, 126]   # half to even


def test_mirror_on_a_transposed_k_major_weight():
    """Dynamic w8a8 quantizes wᵀ of a K-major (K, N) weight in place: the
    (N, K) rows of an (N, K)-contiguous tensor."""
    w = torch.from_numpy(np.random.RandomState(5).randn(2048, 96)
                         .astype(np.float32))
    wt = tyl.k_major(w).t()
    assert wt.is_contiguous()
    q, s, _ = quantize_mirror(wt)
    qp, sp = tq.quantize_rows_plain(wt)
    assert torch.equal(q, qp) and torch.equal(s, sp)
    rq, rs = rops.quantize_rows(jnp.asarray(w.numpy()).T)
    np.testing.assert_array_equal(q.numpy(), np.asarray(rq))
    np.testing.assert_array_equal(s.numpy(), np.asarray(rs))


@pytest.mark.parametrize('m,k,itemsize,cluster,rows,vecs', [
    (8, 2048, 2, 1, 1, 1),          # stablelm decode: one CTA a row
    (8, 7168, 2, 8, 1, 1),          # dense prefix decode: an 8-CTA cluster
    (8, 18432, 2, 8, 1, 1),
    (128, 2048, 2, 1, 1, 1),        # a 128-token prefill: a CTA a row
    (1024, 2048, 2, 1, 2, 2),       # static prefill: several rows a block
    (1024, 5632, 2, 1, 1, 4),
    (100352, 2048, 4, 1, 4, 8),     # lm_head wᵀ, streamed: 8 pieces
    (129280, 7168, 4, 1, 1, 8),
])
def test_plan_cuts_of_the_serving_shapes(m, k, itemsize, cluster, rows,
                                         vecs):
    plan = tq.quantize_plan(m, k, itemsize)
    assert (plan['cluster'], plan['rows'], plan['vecs']) == (cluster, rows,
                                                             vecs)
    if cluster > 1:
        assert m * cluster <= tq.QUANT_SMS          # one wave of CTAs


@pytest.mark.parametrize('m,k,itemsize', [
    (-1, 8, 2), (4, 0, 2), (4, 8, 1), (4, 8, 8),
    (1, 32769, 2), (1, 32769, 4), (5000, 65544, 2)])
def test_plan_refuses(m, k, itemsize):
    with pytest.raises(ValueError, match='quantize_rows'):
        tq.quantize_plan(m, k, itemsize)


@pytest.mark.parametrize('itemsize,most', [(2, 8), (4, 16)])
def test_plan_takes_the_longest_rows_it_accepts(itemsize, most):
    """Up to K = 32768 a thread holds at most 8 bf16 or 16 f32 pieces (the
    kernel's instances; 16 bf16 pieces would spill), a cluster 2."""
    for k in (18432, 32768):
        for m in (1, 8, 128, 5000):
            plan = tq.quantize_plan(m, k, itemsize)
            assert plan['vecs'] <= most
            assert plan['cluster'] == 1 or plan['vecs'] <= 2
