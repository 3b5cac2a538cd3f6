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


def yoco_vmm(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """End-to-end YOCO matmul: dynamic per-token quantization of x and
    per-out-channel quantization of w (rows of w.T), the int8 product and
    one fused f32 dequant epilogue. x: (..., K) float, w: (K, N) float."""
    lead, k = x.shape[:-1], x.shape[-1]
    n = w.shape[-1]
    xq, sx = quantize_rows(x.reshape(-1, k))
    wq_t, sw_t = quantize_rows(w.t())           # per-out-channel scales
    out = _yoco.yoco_vmm_int8(xq, wq_t.t().contiguous(), sx,
                              sw_t.reshape(1, n))
    return out.reshape(*lead, n)
