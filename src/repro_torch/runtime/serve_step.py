"""Serving-step builders: prefill, chunked prefill and greedy single-token
decode (port of
``repro/runtime/serve_step.py``). PyTorch runs eagerly, so a "step" is a
closure over the config; sampling comes with a later slice."""

from __future__ import annotations

from typing import Tuple

import torch

from repro_torch.core.yoco_linear import DEFAULT_YOCO, YocoConfig
from repro_torch.models import model as model_mod
from repro_torch.models.model import DEFAULT_RT, ModelRuntime


def make_prefill_step(cfg, yoco: YocoConfig = DEFAULT_YOCO,
                      rt: ModelRuntime = DEFAULT_RT):
    def prefill_step(params, batch, cache, last_pos=None):
        return model_mod.prefill(params, batch, cache, cfg, yoco, rt,
                                 last_pos=last_pos)
    return prefill_step


def make_chunk_prefill_step(cfg, yoco: YocoConfig = DEFAULT_YOCO,
                            rt: ModelRuntime = DEFAULT_RT):
    """Chunked-prefill step ``(params, batch, offset, limit, cache) ->
    (logits, cache)``: one C-token slice of a longer prompt at absolute
    positions [offset, min(offset + C, limit)). The serve loop runs it over a
    prompt's chunks; prefix-cache hits prefill only the unshared suffix.
    The logits are meaningful on the final chunk only."""
    def chunk_prefill_step(params, batch, offset, limit, cache):
        return model_mod.prefill_chunk(params, batch, offset, limit, cache,
                                       cfg, yoco, rt)
    return chunk_prefill_step


def logits_health(logits: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B,) bool: every logit of the row finite, () f32 max |finite
    logit|) — the per-step integrity sentinel and its drift gauge."""
    lf = logits.to(torch.float32)
    finite = torch.isfinite(lf)
    return (finite.all(dim=-1),
            torch.where(finite, lf.abs(), 0.0).amax())


def make_decode_step(cfg, yoco: YocoConfig = DEFAULT_YOCO,
                     rt: ModelRuntime = DEFAULT_RT):
    """Greedy decode step ``(params, token, pos, cache) -> (next_tok int32,
    logits, cache)``; the cache is updated in place."""

    def decode_step(params, token, pos, cache):
        logits, cache = model_mod.decode_step(params, token, pos, cache,
                                              cfg, yoco, rt)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache
    return decode_step
