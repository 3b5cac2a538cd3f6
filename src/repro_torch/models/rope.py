"""Rotary position embeddings: standard RoPE, partial RoPE (stablelm) and
M-RoPE (qwen2-vl's multimodal sections); port of
``repro/models/rope.py``."""

from __future__ import annotations

from typing import Optional, Sequence

import torch


def rope_freqs(dim: int, theta: float, device=None) -> torch.Tensor:
    """(dim/2,) inverse frequencies."""
    return 1.0 / (theta ** (torch.arange(0, dim, 2, dtype=torch.float32,
                                         device=device) / dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor, theta: float,
               fraction: float = 1.0) -> torch.Tensor:
    """x: (B, S, H, dh); positions: (B, S) int. Rotates the first
    ``fraction * dh`` dims (partial rotary), leaves the rest."""
    dh = x.shape[-1]
    rot = int(dh * fraction) // 2 * 2
    if rot == 0:
        return x
    xr, xp = x[..., :rot], x[..., rot:]
    inv = rope_freqs(rot, theta, device=x.device)
    ang = positions[..., None].to(torch.float32) * inv     # (B, S, rot/2)
    cos = torch.cos(ang)[..., None, :]                     # (B, S, 1, rot/2)
    sin = torch.sin(ang)[..., None, :]
    x1f = xr[..., : rot // 2].to(torch.float32)
    x2f = xr[..., rot // 2:].to(torch.float32)
    out = torch.cat([x1f * cos - x2f * sin,
                     x2f * cos + x1f * sin], dim=-1).to(x.dtype)
    return torch.cat([out, xp], dim=-1) if xp.shape[-1] else out


MROPE_SECTIONS = (16, 24, 24)   # qwen2-vl @ dh=128: (t, h, w) half-dims


def mrope_sections(half: int) -> tuple:
    """(t, h, w) partition of the half head dim, 1:1.5:1.5 as in qwen2-vl
    (16:24:24 at dh=128); scales to reduced smoke head dims ((1, 2, 1) at
    dh=8)."""
    t = max(half // 4, 1) if half >= 4 else half
    h = (half - t + 1) // 2
    w = half - t - h
    return (t, h, w)


def apply_mrope(x: torch.Tensor, positions3: torch.Tensor, theta: float,
                sections: Optional[Sequence[int]] = None) -> torch.Tensor:
    """M-RoPE: the dh/2 frequency slots are partitioned into (t, h, w)
    sections, each rotated by its own position stream; the rotation
    always covers the whole head (no partial rotary).

    x: (B, S, H, dh); positions3: (B, S, 3). With three equal streams it
    is RoPE."""
    dh = x.shape[-1]
    half = dh // 2
    if sections is None:
        sections = mrope_sections(half)
    assert sum(sections) == half, (sections, half)
    inv = rope_freqs(dh, theta, device=x.device)            # (half,)
    # each slot takes its section's stream (device ops only: no index
    # tensor is copied to the card)
    p3 = positions3.to(torch.float32)
    pos = torch.cat([p3[..., i:i + 1].expand(*p3.shape[:-1], n)
                     for i, n in enumerate(sections)], dim=-1)  # (B, S, half)
    ang = pos * inv
    cos = torch.cos(ang)[..., None, :]                      # (B, S, 1, half)
    sin = torch.sin(ang)[..., None, :]
    x1 = x[..., :half].to(torch.float32)
    x2 = x[..., half:].to(torch.float32)
    return torch.cat([x1 * cos - x2 * sin,
                      x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def default_positions(batch: int, seq: int, offset=0,
                      device=None) -> torch.Tensor:
    return (torch.arange(seq, dtype=torch.int32, device=device)[None, :]
            + torch.zeros((batch, 1), dtype=torch.int32, device=device)
            + offset)


def default_positions3(batch: int, seq: int, offset=0,
                       device=None) -> torch.Tensor:
    """(B, S, 3): the text positions in every M-RoPE stream."""
    p = default_positions(batch, seq, offset, device=device)
    return torch.stack([p, p, p], dim=-1)
