"""Int8 symmetric quantization primitives — the digital contract of the
YOCO/AiDAC execution model (port of ``repro/core/quant.py``):

    y = dequant( int32_accumulate( q8(x) @ q8(w) ) )

with no intermediate rounding. Numerics copy the reference exactly: codes
are ``round(x / scale)`` (a division, rounded half to even by
``torch.round``) clipped to ±(2^(b-1) - 1). The scale comes in the two
forms the reference produces: :func:`absmax_scale` is its source's
``max(absmax, 1e-8) / qmax``, what it computes eagerly
(``prequantize_weight``); :func:`jit_absmax_scale` is what XLA compiles
that into under ``jax.jit``, ``max(absmax, 1e-8) * f32(1 / qmax)``, which
its jitted serve steps compute (``fake_quant``, the analog TDC, kernel K3).
The two differ by one ulp on a few percent of rows.

:func:`fake_quant` is the QAT quantize-dequantize with the reference's
straight-through backward. These are the plain functions. On the serving
path ``core/yoco_linear.py`` reaches the same arithmetic through the
kernels in ``kernels/ops.py``.
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch

Axis = Union[None, int, Sequence[int]]

INT8_MAX = 127.0


def _reduce_axes(x: torch.Tensor, axis: Axis) -> Tuple[int, ...]:
    """Axes reduced when computing the scale. ``axis`` lists the axes that
    KEEP their own scale (quantization granularity)."""
    if axis is None:
        return tuple(range(x.ndim))
    if isinstance(axis, int):
        axis = (axis,)
    keep = {a % x.ndim for a in axis}
    return tuple(a for a in range(x.ndim) if a not in keep)


def absmax_scale(x: torch.Tensor, axis: Axis = None, bits: int = 8,
                 eps: float = 1e-8) -> torch.Tensor:
    """Symmetric absmax scale; ``axis`` = axes that keep independent
    scales. Keeps x's rank (broadcastable)."""
    qmax = float(2 ** (bits - 1) - 1)
    red = _reduce_axes(x, axis)
    amax = x.to(torch.float32).abs().amax(dim=red, keepdim=True)
    return torch.clamp_min(amax, eps) / qmax


def _f32_reciprocal(v: float) -> float:
    """``1 / v`` rounded to f32, as XLA folds a division by a constant."""
    return float(torch.tensor(1.0) / torch.tensor(v))


def jit_absmax_scale(x: torch.Tensor, axis: Axis = None, bits: int = 8,
                     eps: float = 1e-8) -> torch.Tensor:
    """:func:`absmax_scale` in the form the reference computes it under
    ``jax.jit``: the division by the constant ``qmax`` becomes a multiply
    by its f32 reciprocal (every ``bits`` from 2 to 8)."""
    qmax = float(2 ** (bits - 1) - 1)
    red = _reduce_axes(x, axis)
    amax = x.to(torch.float32).abs().amax(dim=red, keepdim=True)
    return torch.clamp_min(amax, eps) * _f32_reciprocal(qmax)


def quantize(x: torch.Tensor, scale: torch.Tensor,
             bits: int = 8) -> torch.Tensor:
    """Round-to-nearest-even symmetric quantization: int8 for bits <= 8."""
    qmax = 2 ** (bits - 1) - 1
    q = torch.clamp(torch.round(x.to(torch.float32) / scale), -qmax, qmax)
    return q.to(torch.int8 if bits <= 8 else torch.int32)


def dequantize(q: torch.Tensor, scale: torch.Tensor,
               dtype: torch.dtype = torch.float32) -> torch.Tensor:
    return (q.to(torch.float32) * scale).to(dtype)


class _FakeQuantSTE(torch.autograd.Function):
    """``dequantize(q, scale, x.dtype)`` forward; the reference's
    straight-through backward, ``g * mask`` with ``mask = |x| <= scale *
    qmax + 1e-6`` (identity inside the clip range, zero outside)."""

    @staticmethod
    def forward(ctx, x, q, scale, qmax):
        ctx.save_for_backward(
            x.to(torch.float32).abs() <= scale * qmax + 1e-6)
        return dequantize(q, scale, x.dtype)

    @staticmethod
    def backward(ctx, g):
        mask, = ctx.saved_tensors
        return g * mask.to(g.dtype), None, None, None


def dequantize_ste(x: torch.Tensor, q: torch.Tensor, scale: torch.Tensor,
                   bits: int = 8) -> torch.Tensor:
    """x's codes ``q`` and ``scale`` back to x's dtype, with the
    straight-through gradient to ``x`` where autograd asks for one (a
    plain :func:`dequantize` otherwise: serving builds no graph)."""
    if torch.is_grad_enabled() and x.requires_grad:
        return _FakeQuantSTE.apply(x, q, scale, float(2 ** (bits - 1) - 1))
    return dequantize(q, scale, x.dtype)


def fake_quant(x: torch.Tensor, axis: Axis = None,
               bits: int = 8) -> torch.Tensor:
    """Quantize-dequantize with a straight-through estimator (port of the
    reference's ``fake_quant``), for any ``axis`` (the axes that keep their
    own scale) and ``bits``. The scale is :func:`jit_absmax_scale`'s, the
    form of the reference's jitted steps; the result has x's dtype."""
    scale = jit_absmax_scale(x, axis, bits)
    return dequantize_ste(x, quantize(x, scale, bits), scale, bits)


def int8_dot(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    """int8 (..., K) x int8 (K, N) -> int32, never rounded mid-reduction.
    The plain oracle (CPU); the card computes it with kernel K2."""
    return torch.matmul(xq.to(torch.int32), wq.to(torch.int32))


def w8a8_matmul(x: torch.Tensor, w: torch.Tensor, *,
                out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Dynamic-quantized W8A8 matmul: per-token activation scales x
    per-out-channel weight scales. x: (..., K) float; w: (K, N) float."""
    sx = absmax_scale(x, axis=tuple(range(x.ndim - 1)))
    sw = absmax_scale(w, axis=1)
    acc = int8_dot(quantize(x, sx), quantize(w, sw))
    return (acc.to(torch.float32) * sx * sw).to(out_dtype)
