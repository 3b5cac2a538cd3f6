"""Public wrappers around the kernels, with the reference's leading-dim
folding (port of ``repro/kernels/ops.py``). The CUDA kernels take ragged
shapes, so unlike the reference nothing is padded to a block multiple."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.kernels import quantize as _quantize
from repro_torch.kernels import yoco_vmm as _yoco


def quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., K) float -> (int8 codes (..., K), per-row scale (..., 1))."""
    lead, k = x.shape[:-1], x.shape[-1]
    xq, s = _quantize.quantize_rows(x.reshape(-1, k).contiguous())
    return xq.reshape(*lead, k), s.reshape(*lead, 1)


def int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) @ int8 (K, N) -> int32 (..., N); on the card ``wq`` is
    K-major (see :func:`yoco_vmm.int8_matmul`) and reaches the kernel
    uncopied."""
    lead, k = xq.shape[:-1], xq.shape[-1]
    out = _yoco.int8_matmul(xq.reshape(-1, k).contiguous(), wq)
    return out.reshape(*lead, wq.shape[-1])


def _check_k_major(w: torch.Tensor) -> None:
    if w.device.type in ('cuda', 'meta') and not w.t().is_contiguous():
        raise ValueError(
            f'yoco_vmm: the weight must be K-major, a (K, N) view of an '
            f'(N, K)-contiguous tensor (k_major_linear_weights stores it '
            f'so); got strides {w.stride()} for shape {tuple(w.shape)}')


def yoco_vmm_codes(xq: torch.Tensor, sx: torch.Tensor,
                   w: torch.Tensor) -> torch.Tensor:
    """:func:`yoco_vmm` from the activation's codes ``xq`` (..., K) and
    scales ``sx`` (..., 1) (:func:`quantize_rows`), so that several weights
    share one quantization of x: K3 on the rows of w.T (per-out-channel
    scales), then K4. On the card ``w`` must be K-major."""
    _check_k_major(w)
    lead, k = xq.shape[:-1], xq.shape[-1]
    n = w.shape[-1]
    wq_t, sw_t = quantize_rows(w.t())           # per-out-channel scales
    out = _yoco.yoco_vmm_int8(xq.reshape(-1, k), wq_t.t(), sx.reshape(-1, 1),
                              sw_t.reshape(1, n))
    return out.reshape(*lead, n)


def yoco_vmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """End-to-end YOCO matmul: dynamic per-token quantization of x and
    per-out-channel quantization of w (K3 on the rows of w.T), the int8
    product and one fused f32 dequant epilogue (K4). x: (..., K) float,
    w: (K, N) float. On the card ``w`` must be K-major (``w.t()``
    contiguous, as ``models.model.k_major_linear_weights`` stores dynamic
    w8a8's weights at load): K3 then reads w.T in place and its (N, K)
    codes reach K4 as the K-major view, so no call copies the weight. The
    CPU takes any layout."""
    _check_k_major(w)
    xq, sx = quantize_rows(x)
    return yoco_vmm_codes(xq, sx, w)
