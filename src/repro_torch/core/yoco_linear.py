"""``yoco_linear`` — the paper's technique as a composable layer (port of
``repro/core/yoco_linear.py``). Every matmul of the model routes here.

Modes ported so far:

  bf16   digital baseline: ``x @ w`` in the compute dtype;
  w8a8   YOCO inference: activations quantized ONCE per row (kernel K3;
         :func:`linears` shares that quantization between the weights
         that read one activation),
         int8 x int8 -> int32 with no mid-reduction rounding, ONE dequant.
         With a float weight (dynamic quantization) the weight's output
         channels go through K3 as well and the product is K4 with its
         fused scale epilogue: serving stores that weight K-major at load
         (``models.model.k_major_linear_weights``), so K3 reads ``w.T``
         in place and its (N, K) codes are K4's K-major operand; with a
         prequantized ``QuantizedWeight`` (int8 weights resident, the
         in-situ analogue) the product is K2 and the epilogue
         ``acc * sx * w.scale`` follows it. On the card both kernels
         refuse a weight that is not K-major rather than copy it.

The reference routes w8a8 through its Pallas kernels only when
``use_pallas=True`` and through XLA otherwise; both compute the same
function. The port always goes through its kernels (``kernels/ops.py``): on
the card the hand-written CUDA kernels, on the CPU their plain versions.

``qat`` and ``analog_sim`` are the paper-fidelity slice (``ROADMAP.md``
Queue 1 item 12) and raise here.
"""

from __future__ import annotations

import dataclasses
from typing import NamedTuple, Optional, Union

import torch

from repro_torch.core import quant
from repro_torch.kernels import ops


class QuantizedWeight(NamedTuple):
    """int8 weight + per-out-channel scale: weights 'in situ'."""
    wq: torch.Tensor        # (..., K, N) int8, K-major (see k_major)
    scale: torch.Tensor     # (..., 1, N) f32


def k_major(wq: torch.Tensor) -> torch.Tensor:
    """The same (..., K, N) values as a view of a (..., N, K)-contiguous
    tensor: each output column's K values are contiguous, the layout
    kernels K2 and K4 read (Hopper's 8-bit wgmma takes B only K-major).
    A tensor already K-major is returned uncopied."""
    return wq.transpose(-1, -2).contiguous().transpose(-1, -2)


#: f32 bytes of a column slice :func:`prequantize_weight` quantizes at once
PREQUANT_SLICE_BYTES = 1 << 28


def prequantize_weight(w: torch.Tensor) -> QuantizedWeight:
    """Per-out-channel scales; the contraction dim is axis -2. ``wq`` keeps
    the reference's (..., K, N) shape and values, stored K-major. The
    output columns are quantized a slice of at most
    ``PREQUANT_SLICE_BYTES`` of f32 at a time straight into the K-major
    codes: each column's scale reads only that column, so the result is
    the same, and the temporaries stay one slice wide (a 152064-wide
    lm_head's would be 5 GB each whole)."""
    *lead, k, n = w.shape
    keep = tuple(a for a in range(w.ndim) if a != w.ndim - 2)
    codes = torch.empty((*lead, n, k), dtype=torch.int8, device=w.device)
    sw = torch.empty((*lead, 1, n), dtype=torch.float32, device=w.device)
    step = max(1, PREQUANT_SLICE_BYTES // (4 * w[..., :1].numel()))
    for j in range(0, n, step):
        part = w[..., j:j + step]
        s = quant.absmax_scale(part, axis=keep)
        codes[..., j:j + step, :] = quant.quantize(part, s).transpose(-1, -2)
        sw[..., j:j + step] = s
    return QuantizedWeight(codes.transpose(-1, -2), sw)


@dataclasses.dataclass(frozen=True)
class YocoConfig:
    mode: str = 'bf16'              # bf16 | w8a8 (qat | analog_sim: later)
    bits: int = 8
    compute_dtype: torch.dtype = torch.bfloat16


DEFAULT_YOCO = YocoConfig()

_LATER_MODES = ('qat', 'analog_sim')


def _check_mode(cfg: YocoConfig) -> None:
    if cfg.mode in _LATER_MODES:
        raise NotImplementedError(
            f'yoco mode {cfg.mode!r} belongs to the paper-fidelity slice '
            f'(ROADMAP.md Queue 1 item 12); this port serves bf16 and w8a8')
    if cfg.mode not in ('bf16', 'w8a8'):
        raise ValueError(f'unknown yoco mode: {cfg.mode}')
    if cfg.mode == 'w8a8' and cfg.bits != 8:
        raise NotImplementedError('the int8 kernels take bits=8 only')


def _w8a8_product(xq: torch.Tensor, sx: torch.Tensor, w,
                  cfg: YocoConfig) -> torch.Tensor:
    """One w8a8 product from the activation's codes and scales (K3's). A
    ``QuantizedWeight`` (weights already int8 in memory): K2, then the
    reference's ``acc * sx * w.scale``. A float weight (dynamic
    quantization): K3 on its output channels, then K4."""
    if isinstance(w, QuantizedWeight):
        acc = ops.int8_matmul(xq, w.wq)
        y = acc.to(torch.float32) * sx * w.scale
    else:
        y = ops.yoco_vmm_codes(xq, sx, w)
    return y.to(cfg.compute_dtype)


def linears(x: torch.Tensor, ws, bs=None,
            cfg: YocoConfig = DEFAULT_YOCO) -> list:
    """``[x @ w + b for w, b in zip(ws, bs)]`` under the configured mode, in
    the compute dtype (``bs`` None, or a list with None entries: no bias).
    w8a8 quantizes x ONCE (K3) for all the weights, as the reference's
    compiled step computes one quantization of an activation that several
    linears read (XLA merges the duplicates); bf16 runs one matmul a
    weight. Anything that runs several linears on one x uses this form:
    the q/k/v projections, an MLP's gate and up, MLA's w_dq and w_dkv."""
    _check_mode(cfg)
    if cfg.mode == 'w8a8':
        xq, sx = ops.quantize_rows(x)
        ys = [_w8a8_product(xq, sx, w, cfg) for w in ws]
    else:
        cd = cfg.compute_dtype
        ys = [torch.matmul(x.to(cd), (quant.dequantize(w.wq, w.scale,
                                                       torch.float32)
                                      if isinstance(w, QuantizedWeight)
                                      else w).to(cd))
              for w in ws]
    bs = [None] * len(ws) if bs is None else bs
    return [y if b is None else y + b.to(y.dtype) for y, b in zip(ys, bs)]


def yoco_matmul(x: torch.Tensor, w: Union[torch.Tensor, QuantizedWeight],
                cfg: YocoConfig = DEFAULT_YOCO) -> torch.Tensor:
    """(..., K) @ (K, N) under the configured mode; returns compute dtype."""
    return linears(x, [w], cfg=cfg)[0]


def linear(x: torch.Tensor, w, b: Optional[torch.Tensor] = None,
           cfg: YocoConfig = DEFAULT_YOCO) -> torch.Tensor:
    return linears(x, [w], [b], cfg)[0]


_WEIGHT_NAMES = ('wq', 'wk', 'wv', 'wo', 'w_gate', 'w_up', 'w_down', 'w_in',
                 'w_out', 'sh_gate', 'sh_up', 'sh_in', 'sh_down', 'sh_out',
                 'w_dq', 'w_uq', 'w_dkv', 'w_ukv', 'in_proj', 'out_proj',
                 'lm_head')


def is_linear_weight(name: str, leaf) -> bool:
    """A float (K, N) weight that the linears read, by parameter NAME as in
    the reference (biases, norms and embeddings are not)."""
    return (isinstance(leaf, torch.Tensor) and leaf.is_floating_point()
            and leaf.ndim == 2 and name in _WEIGHT_NAMES)


def quantize_leaf(name: str, leaf, mult: int = 1, min_size: int = 1024,
                  under_moe: bool = False):
    """``quantize_tree``'s rule for one leaf: a linear weight of at least
    ``min_size`` values (``mult`` stacked copies counted) becomes a
    QuantizedWeight, a leaf under an MoE's experts and anything else stays
    as it is."""
    if (is_linear_weight(name, leaf) and leaf.numel() * mult >= min_size
            and not (under_moe and name in ('w_gate', 'w_up', 'w_down',
                                            'w_in', 'w_out'))):
        return prequantize_weight(leaf)
    return leaf


def quantize_tree(params, min_size: int = 1024):
    """Convert every linear weight into a QuantizedWeight — the 'load the
    network into the array' step for serving. Dispatch is by parameter
    NAME, as in the reference (biases, norms and embeddings stay float).
    The port keeps layers as a list of per-layer dicts; a weight inside that
    list counts ``len(list) * numel`` against ``min_size``, which is the size
    the reference sees on its stacked (L, K, N) leaf."""
    def conv(name, leaf, mult, under_moe):
        out = quantize_leaf(name, leaf, mult, min_size, under_moe)
        return out if out is not leaf else walk(leaf, name, mult, under_moe)

    def walk(node, name, mult, under_moe):
        if isinstance(node, dict):
            moe = under_moe or name == 'moe'
            return {k: conv(k, v, mult, moe) for k, v in node.items()}
        if isinstance(node, list):
            return [walk(v, name, len(node), under_moe) for v in node]
        return node

    return walk(params, '', 1, False)
