"""Serving steps: prefill, chunked prefill and single-token decode,
greedy or sampled (port of ``repro/runtime/serve_step.py``). PyTorch runs
eagerly, so a "step" is a closure over the config. The decode step's
``pos`` is 0-d for a lock-step batch over a contiguous cache (the static
``serve()`` path) or (B,) for per-request positions (``--ragged``, and
every paged cache); ``rt.attn_impl == 'flash'`` reads the cache through
the layout's kernel (K7 contiguous, K1/K6 paged, K8/K10 latent).

Sampling draws from a ``torch.Generator`` where the reference splits a JAX
PRNG key; the two streams differ, so tests hold the sampler to its
distribution, not to the reference's draws."""

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


def sample_tokens(logits: torch.Tensor, generator: torch.Generator, *,
                  temperature: float = 1.0, top_k: int = 0) -> torch.Tensor:
    """Temperature / top-k sampling over (..., V) logits -> int32 ids
    ((B, V) -> (B,), a codebook model's (B, CB, V) -> (B, CB)).

    ``temperature <= 0`` is the argmax (the greedy limit); ``top_k`` in
    (0, V) keeps the k largest logits (ties with the k-th included) and
    masks the rest with -inf; otherwise every logit stays. The draw is
    categorical over ``softmax(logits / temperature)``, taken by the
    Gumbel-max rule as ``jax.random.categorical`` takes it, from uniforms
    of ``generator`` (which must live on the logits' device)."""
    lf = logits.to(torch.float32)
    if temperature <= 0.0:
        return torch.argmax(lf, dim=-1).to(torch.int32)
    if top_k and 0 < top_k < lf.shape[-1]:
        kth = torch.topk(lf, top_k, dim=-1).values[..., -1:]
        lf = torch.where(lf < kth, float('-inf'), lf)
    u = torch.rand(lf.shape, generator=generator, device=lf.device)
    tiny = torch.finfo(torch.float32).tiny
    gumbel = -torch.log(-torch.log(u.clamp_min(tiny)))
    return torch.argmax(lf / temperature + gumbel, dim=-1).to(torch.int32)


def make_decode_step(cfg, yoco: YocoConfig = DEFAULT_YOCO,
                     rt: ModelRuntime = DEFAULT_RT, *, greedy: bool = True,
                     temperature: float = 1.0, top_k: int = 0):
    """Greedy steps keep the 4-argument signature ``(params, token, pos,
    cache) -> (next_tok int32, logits, cache)``; sampling steps take a
    ``torch.Generator`` as a 5th argument and draw from the temperature /
    top-k filtered logits (:func:`sample_tokens`). The cache is updated in
    place. Either picks over the last axis: (B,) ids from (B, V) logits,
    (B, CB) from a codebook model's (B, CB, V). ``token`` is what the model
    takes ((B,) or (B, CB) ids, or (B, d) embeddings); for embeddings
    input the step still returns token ids, and the (stubbed) frontend
    owns the id-to-embedding map."""
    def decode_logits(params, token, pos, cache):
        return model_mod.decode_step(params, token, pos, cache, cfg, yoco,
                                     rt)

    if greedy:
        def decode_step(params, token, pos, cache):
            logits, cache = decode_logits(params, token, pos, cache)
            return (torch.argmax(logits, dim=-1).to(torch.int32), logits,
                    cache)
        return decode_step

    def decode_step_sampled(params, token, pos, cache, generator):
        logits, cache = decode_logits(params, token, pos, cache)
        return (sample_tokens(logits, generator, temperature=temperature,
                              top_k=top_k), logits, cache)
    return decode_step_sampled
