"""Weight bit-plane decomposition: the digital twin of AiDAC's compute
blocks (port of ``repro/core/bitplane.py``).

In the array an N-bit weight lives as N single-bit columns, and a compute
block recombines the per-bit-plane MAC voltages with capacitor-ratio
weights 2^j (paper Eq. 4). In integer arithmetic the recombination is
exact:

    x @ W  ==  sum_j 2^j * (x @ B_j)        where W = sum_j 2^j * B_j

for unsigned codes and for signed two's complement codes (the MSB plane
weighted -2^(N-1)). Everything here is exact int32 arithmetic.
"""

from __future__ import annotations

import torch


def _shifts(bits: int, device) -> torch.Tensor:
    return torch.arange(bits, dtype=torch.int32, device=device)


def decompose_unsigned(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Unsigned codes (...,) in [0, 2^bits) -> int8 bit planes (..., bits),
    LSB first: plane j holds bit 2^j, the j-th column of a compute block."""
    w = w.to(torch.int32)
    return ((w[..., None] >> _shifts(bits, w.device)) & 1).to(torch.int8)


def recombine_unsigned(planes: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Inverse of :func:`decompose_unsigned` (Eq. 4 without the analog
    1/(2^N - 1) normalization): int32 (...,)."""
    weights = 1 << _shifts(bits, planes.device)
    return (planes.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def decompose_signed(w: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Signed ints (...,) in [-2^(bits-1), 2^(bits-1)) -> two's complement
    int8 planes (..., bits), LSB first."""
    w = w.to(torch.int32) & ((1 << bits) - 1)
    return ((w[..., None] >> _shifts(bits, w.device)) & 1).to(torch.int8)


def recombine_signed(planes: torch.Tensor, bits: int = 8) -> torch.Tensor:
    """Inverse of :func:`decompose_signed`: the MSB plane weighs
    -2^(bits-1)."""
    weights = 1 << _shifts(bits, planes.device)
    weights[bits - 1] *= -1
    return (planes.to(torch.int32) * weights).sum(dim=-1, dtype=torch.int32)


def bitplane_matmul_unsigned(x: torch.Tensor, w_codes: torch.Tensor,
                             bits: int = 8) -> torch.Tensor:
    """x @ W by per-bit-plane MACs and binary recombination, the dataflow
    of a compute block. x: (M,) or (B, M) unsigned codes; w_codes: (M, N).
    Returns int32 (..., N), equal to ``x @ w_codes``."""
    planes = decompose_unsigned(w_codes, bits).to(torch.int32)  # (M, N, b)
    per_plane = torch.einsum('...m,mnb->...nb', x.to(torch.int32), planes)
    weights = 1 << _shifts(bits, planes.device)
    return (per_plane * weights).sum(dim=-1, dtype=torch.int32)
