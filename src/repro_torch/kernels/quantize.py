"""K3: fused row-wise dynamic int8 quantization — the DAC-less input
conversion (paper Eq. 2) of the digital pipeline.

Port of ``repro/kernels/quantize.py::quantize_rows``. The CUDA kernel is
``csrc/quantize.cu``; :func:`quantize_rows_plain` is the same function in
plain PyTorch. :func:`quantize_rows` launches the kernel for CUDA tensors,
takes the plain version only for CPU tensors and the shape-only route
(``kernels/meta.py``) for meta tensors. :func:`quantize_plan` is the
kernel's cut of the rows, from the shapes only.
"""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import build, meta

INT8_MAX = 127.0
# The reference kernel writes max(absmax, 1e-8) / 127, and XLA compiles a
# division by a constant into a multiplication by the constant's f32
# reciprocal; this is the scale the reference actually produces (under jit
# and in Pallas interpret mode alike), so the port computes it that way.
INV_INT8_MAX = float(torch.tensor(1.0) / torch.tensor(INT8_MAX))


def quantize_rows_plain(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (M, K) float -> (codes int8 (M, K), scale f32 (M, 1)).
    scale = max(absmax, 1e-8) * f32(1/127); codes = clip(round_half_even(
    x / scale), ±127), a true division as in the reference."""
    x = x.to(torch.float32)
    amax = x.abs().amax(dim=-1, keepdim=True)
    scale = torch.clamp_min(amax, 1e-8) * INV_INT8_MAX
    q = torch.clamp(torch.round(x / scale), -INT8_MAX, INT8_MAX)
    return q.to(torch.int8), scale


#: K3's cut (``csrc/quantize.cu``): the card's SMs and L2 bytes, the
#: longest row, a block's most threads, the threads of a several-rows
#: block, the 16-byte pieces a several-rows thread aims at (rows read from
#: L2, rows streamed from device memory), the pieces a row may have on one
#: CTA before it takes a cluster, the most CTAs a cluster, and the pieces a
#: cluster CTA aims at (one a thread). The numbers are the H100's and the
#: fastest of the cuts timed on it (PERF.md §6).
QUANT_SMS = 132
QUANT_L2_BYTES = 50 << 20
QUANT_MAX_K = 32768
QUANT_MAX_THREADS = 512
QUANT_BLOCK = 256
QUANT_ROW_VECS = 2
QUANT_STREAM_VECS = 8
QUANT_CTA_PIECES = 256
QUANT_MAX_CLUSTER = 8
QUANT_CLUSTER_PIECES = 128


def _pow2(n: int) -> int:
    """The least power of two >= n (n >= 1)."""
    return 1 << (n - 1).bit_length()


def quantize_plan(m: int, k: int, itemsize: int) -> dict:
    """How K3 cuts M rows of K values of ``itemsize`` bytes (2: bf16, 4:
    f32) into 16-byte pieces held in registers; shapes only.

    * ``cluster``: CTAs a row. Rows few enough that a CTA a row fits one
      wave on the SMs (decode: M=8) take one CTA a row of one piece a
      thread up to QUANT_CTA_PIECES pieces (K=2048 bf16), and past that a
      thread-block cluster of up to 8 CTAs a row of about
      QUANT_CLUSTER_PIECES pieces each (K=7168 bf16: 8); each CTA reads the
      contiguous ``slice`` of pieces at its rank, and the CTAs merge their
      absmax through distributed shared memory. 1 otherwise.
    * ``rows``: rows a block (1 with a cluster), ``row_threads`` threads a
      row (whole warps), ``vecs`` the pieces a thread holds at most (a
      power of two; thread t holds pieces t, t + row_threads, ... of its
      slice). Several-rows blocks give a row one warp or more, at most
      QUANT_BLOCK threads (QUANT_MAX_THREADS for rows of more than
      QUANT_BLOCK * 8 pieces), so that it holds about
      QUANT_ROW_VECS pieces a thread, or QUANT_STREAM_VECS when the
      matrix is larger than the L2 and streams from device memory (more
      bytes in flight a thread); several rows share a block as far as M
      spreads over the SMs.

    Refuses M < 0, K < 1 or K > QUANT_MAX_K (a thread then holds at most
    8 bf16 or 16 f32 pieces, which its registers hold without a spill),
    and other element sizes."""
    if m < 0 or not 1 <= k <= QUANT_MAX_K or itemsize not in (2, 4):
        raise ValueError(f'quantize_rows: no cut for M={m}, K={k}, '
                         f'itemsize={itemsize} (bf16 or f32 rows, '
                         f'1 <= K <= {QUANT_MAX_K})')
    nv = -(-k // (16 // itemsize))                 # 16-byte pieces a row
    cs = 1 if nv <= QUANT_CTA_PIECES else min(
        QUANT_MAX_CLUSTER, _pow2(-(-nv // QUANT_CLUSTER_PIECES)))
    if m * cs <= QUANT_SMS:
        piece_slice = -(-nv // cs)
        tpr = min(QUANT_MAX_THREADS, -(-piece_slice // 32) * 32)
        rows = 1
    else:
        cs, piece_slice = 1, nv
        per = (QUANT_STREAM_VECS if m * k * itemsize > QUANT_L2_BYTES
               else QUANT_ROW_VECS)
        cap = QUANT_BLOCK if nv <= QUANT_BLOCK * 8 else QUANT_MAX_THREADS
        tpr = min(cap, max(32, _pow2(-(-nv // per))))
        rows = max(1, min(QUANT_BLOCK // tpr, m // QUANT_SMS))
    return dict(cluster=cs, rows=rows, row_threads=tpr, slice=piece_slice,
                vecs=_pow2(-(-piece_slice // tpr)))


_ARGS = [build.P, build.P, build.P] + [build.I] * 8 + [build.P]


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """x: (M, K) float32/bfloat16 -> (codes int8 (M, K), scale f32 (M, 1)),
    at :func:`quantize_plan`'s cut on the card."""
    if x.device.type == 'cpu':
        return quantize_rows_plain(x)
    if x.ndim != 2:
        raise ValueError(f'quantize_rows takes (M, K), got {tuple(x.shape)}')
    if meta.on_meta(x):
        return meta.quantize_rows(x)
    build.require_cuda('quantize_rows', x,
                       dtypes=[(torch.float32, torch.bfloat16)])
    m, k = x.shape
    q = torch.empty((m, k), dtype=torch.int8, device=x.device)
    s = torch.empty((m, 1), dtype=torch.float32, device=x.device)
    plan = quantize_plan(m, k, x.element_size())
    fn = build.function('quantize', 'quantize_rows', _ARGS)
    err = fn(x.data_ptr(), q.data_ptr(), s.data_ptr(), m, k,
             int(x.dtype == torch.bfloat16), plan['cluster'], plan['rows'],
             plan['row_threads'], plan['slice'], plan['vecs'],
             build.stream_of(x))
    build.check(err, 'quantize', 'quantize_rows')
    build.count('quantize_rows')
    return q, s
