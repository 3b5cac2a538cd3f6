"""The shape-only routes of the kernels a dry run reaches (K2, K3, K4 and
K7): each wrapper sends tensors on the meta device here, never to a launch
and never to its plain version. Each route is a ``torch.library`` custom op
whose fake implementation returns the kernel's outputs as empty meta
tensors of the kernel's shapes and dtypes; called on any other device it
raises. K2, K4 and K7 carry a FLOP formula
(``torch.utils.flop_counter.register_flop_formula``), so
``FlopCounterMode`` counts them as it counts ``aten.mm``: ``2 M K N`` for
the int8 products, ``4 B Hkv G S dh`` for K7's two products over the whole
cache of S keys (the einsum route's count; the kernel itself reads only
the live keys). K3 does no matrix product and has none.
"""

from __future__ import annotations

from typing import Tuple

import torch
from torch.utils.flop_counter import register_flop_formula


def _shape_only(name: str):
    raise RuntimeError(f'{name}: the shape-only route takes meta tensors; '
                       f'the wrapper sends CPU tensors to the plain version '
                       f'and CUDA tensors to the kernel')


@torch.library.custom_op('repro_torch::int8_matmul', mutates_args=())
def _int8_matmul(xq: torch.Tensor, wq: torch.Tensor) -> torch.Tensor:
    _shape_only('int8_matmul')


@_int8_matmul.register_fake
def _(xq, wq):
    return xq.new_empty((xq.shape[0], wq.shape[1]), dtype=torch.int32)


@torch.library.custom_op('repro_torch::yoco_vmm_int8', mutates_args=())
def _yoco_vmm_int8(xq: torch.Tensor, wq: torch.Tensor, sx: torch.Tensor,
                  sw: torch.Tensor) -> torch.Tensor:
    _shape_only('yoco_vmm_int8')


@_yoco_vmm_int8.register_fake
def _(xq, wq, sx, sw):
    return xq.new_empty((xq.shape[0], wq.shape[1]), dtype=torch.float32)


@torch.library.custom_op('repro_torch::quantize_rows', mutates_args=())
def _quantize_rows(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    _shape_only('quantize_rows')


@_quantize_rows.register_fake
def _(x):
    return (x.new_empty(x.shape, dtype=torch.int8),
            x.new_empty((x.shape[0], 1), dtype=torch.float32))


@torch.library.custom_op('repro_torch::flash_decode_gqa', mutates_args=())
def _flash_decode_gqa(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                     pos: torch.Tensor, window: torch.Tensor) -> torch.Tensor:
    _shape_only('flash_decode_gqa')


@_flash_decode_gqa.register_fake
def _(q, k, v, pos, window):
    return q.new_empty(q.shape, dtype=torch.float32)


@register_flop_formula(torch.ops.repro_torch.int8_matmul)
def _mm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


@register_flop_formula(torch.ops.repro_torch.yoco_vmm_int8)
def _vmm_flops(x_shape, w_shape, *args, out_shape=None, **kwargs) -> int:
    return 2 * x_shape[0] * x_shape[1] * w_shape[1]


@register_flop_formula(torch.ops.repro_torch.flash_decode_gqa)
def _k7_flops(q_shape, k_shape, *args, out_shape=None, **kwargs) -> int:
    b, hkv, g, dh = q_shape
    return 4 * b * hkv * g * k_shape[1] * dh


def _detached(op):
    """``op`` outside autograd: the kernels' outputs are new tensors with
    no graph behind them, on the card as here."""
    def run(*args):
        with torch.no_grad():
            return op(*args)
    return run


int8_matmul = _detached(_int8_matmul)
yoco_vmm_int8 = _detached(_yoco_vmm_int8)
quantize_rows = _detached(_quantize_rows)
flash_decode_gqa = _detached(_flash_decode_gqa)


def on_meta(*tensors) -> bool:
    """Every tensor on the meta device."""
    return all(t.device.type == 'meta' for t in tensors)
