"""K2 and K4: the YOCO int8 VMM — the digital twin of an AiDAC core.

Port of ``repro/kernels/yoco_vmm.py``: ``int8_matmul`` (int8 x int8 ->
int32, no epilogue; the prequantized serving path) and ``yoco_vmm_int8``
(the same product with the fused f32 scale epilogue ``acc * sx * sw``, the
single output conversion; the dynamic ``w8a8`` path). The CUDA kernels are
``csrc/yoco_vmm.cu``, one launch a call (K4's epilogue is fused); they
take ragged M, N and K themselves, so nothing here pads to a block
multiple. On the card both take their weight K-major: a (K, N) view whose
transpose is contiguous, as ``prequantize_weight`` stores K2's int8 weight
and as K3 yields K4's codes from the K-major float weight's transpose; any
other layout raises instead of being copied on every call. The ``*_plain``
functions are the same functions in plain PyTorch, for any layout; the
wrappers take them only for CPU tensors, and meta tensors take the
shape-only route (``kernels/meta.py``).
"""

from __future__ import annotations

import torch

from repro_torch.kernels import build, meta


def int8_matmul_plain(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N), exact. On the CPU an int32
    ``torch.matmul``; CUDA has no integer matmul, so there the product runs
    in float64, exact while K * 127**2 < 2**53 (every shape of this repo)."""
    if xq.device.type == 'cpu':
        return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))
    assert xq.shape[-1] * 127 * 127 < 2 ** 53, xq.shape
    return torch.matmul(xq.to(torch.float64),
                        wq.to(torch.float64)).to(torch.int32)


def yoco_vmm_int8_plain(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                        sw: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8, wq (K, N) int8, sx (M, 1) f32, sw (1, N) f32 ->
    (M, N) f32 = (xq @ wq) * sx * sw, multiplied in that order."""
    return int8_matmul_plain(xq, wq).to(torch.float32) * sx * sw


def _check_layout(name, xq, wq) -> torch.Tensor:
    """Shapes, then on the card (and on the meta device, which stands for
    it) the K-major layout of ``wq``; returns the (N, K)-contiguous tensor
    behind it, which the kernel reads."""
    if xq.ndim != 2 or wq.ndim != 2 or xq.shape[1] != wq.shape[0]:
        raise ValueError(f'{name}: shapes {tuple(xq.shape)} x '
                         f'{tuple(wq.shape)} do not multiply')
    w_nk = wq.t()
    if wq.device.type in ('cuda', 'meta') and not w_nk.is_contiguous():
        raise ValueError(
            f'{name}: the weight must be K-major, a (K, N) view of an '
            f'(N, K)-contiguous tensor (prequantize_weight and '
            f'k_major_linear_weights store it so); got strides '
            f'{wq.stride()} for shape {tuple(wq.shape)}')
    return w_nk


def _check_operands(name, xq, wq) -> torch.Tensor:
    """:func:`_check_layout`, then every operand on one CUDA device."""
    w_nk = _check_layout(name, xq, wq)
    build.require_cuda(name, xq, w_nk, dtypes=[(torch.int8,), (torch.int8,)])
    return w_nk


_MM_ARGS = [build.P, build.P, build.P, build.I, build.I, build.I, build.P]
_VMM_ARGS = [build.P] * 5 + [build.I, build.I, build.I, build.P]


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (M, K) @ int8 (K, N) -> int32 (M, N). On the card ``wq`` must be
    K-major (``wq.t()`` contiguous): the kernel reads the (N, K) tensor
    behind the view."""
    if xq.device.type == 'cpu' and wq.device.type == 'cpu':
        return int8_matmul_plain(xq, wq)
    if meta.on_meta(xq, wq):
        _check_layout('int8_matmul', xq, wq)
        return meta.int8_matmul(xq, wq)
    w_nk = _check_operands('int8_matmul', xq, wq)
    m, k = xq.shape
    n = wq.shape[1]
    out = torch.empty((m, n), dtype=torch.int32, device=xq.device)
    fn = build.function('yoco_vmm', 'int8_matmul', _MM_ARGS)
    err = fn(xq.data_ptr(), w_nk.data_ptr(), out.data_ptr(), m, n, k,
             build.stream_of(xq))
    build.check(err, 'yoco_vmm', 'int8_matmul')
    build.count('int8_matmul')
    return out


def yoco_vmm_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    """xq (M, K) int8; wq (K, N) int8; sx (M, 1) f32; sw (1, N) f32.
    Returns (M, N) f32 = (xq @ wq) * sx * sw. On the card ``wq`` must be
    K-major (``wq.t()`` contiguous): the kernel reads the (N, K) tensor
    behind the view."""
    if all(t.device.type == 'cpu' for t in (xq, wq, sx, sw)):
        return yoco_vmm_int8_plain(xq, wq, sx, sw)
    if meta.on_meta(xq, wq, sx, sw):
        _check_layout('yoco_vmm_int8', xq, wq)
        return meta.yoco_vmm_int8(xq, wq, sx, sw)
    w_nk = _check_operands('yoco_vmm_int8', xq, wq)
    m, k = xq.shape
    n = wq.shape[1]
    if tuple(sx.shape) != (m, 1) or tuple(sw.shape) != (1, n):
        raise ValueError(f'yoco_vmm_int8: scales {tuple(sx.shape)}, '
                         f'{tuple(sw.shape)} for a ({m}, {n}) product')
    build.require_cuda('yoco_vmm_int8', xq, sx, sw,
                       dtypes=[None, (torch.float32,), (torch.float32,)])
    out = torch.empty((m, n), dtype=torch.float32, device=xq.device)
    fn = build.function('yoco_vmm', 'yoco_vmm_int8', _VMM_ARGS)
    err = fn(xq.data_ptr(), w_nk.data_ptr(), sx.data_ptr(), sw.data_ptr(),
             out.data_ptr(), m, n, k, build.stream_of(xq))
    build.check(err, 'yoco_vmm', 'yoco_vmm_int8')
    build.count('yoco_vmm_int8')
    return out
