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


# ----------------------------------------------------------------------------
# tensor-parallel serving steps: head-parallel over a torch.distributed group
# ----------------------------------------------------------------------------
# The reference's make_tp_prefill_step / make_tp_chunk_prefill_step /
# make_tp_decode_step wrap its steps in shard_map. Here a rank's steps are
# the builders above with a runtime that carries the rank's group
# (ModelRuntime(tp_group=...)) over the rank's tree
# (distributed/sharding.py) and pool part (init_paged_cache_tree(tp=)):
# the attention all-gathers its heads before the replicated wo, once a
# layer, and tokens, positions and logits are whole on every rank.


def tp_step_logits(shard, *, arch: str, smoke: bool, params, prompts,
                   lens, steps: int, page_size: int = 4, mode: str = 'bf16',
                   attn_impl: str = 'flash', compute_dtype=torch.float32,
                   kv_dtype=None, hot_window: int = 1):
    """A rank job (``distributed/ranks.py``; ``shard`` None runs on one
    device): the TP steps on one batch, a paged prefill of ``prompts``
    (B, S) whose logits are taken at ``lens - 1``, then ``steps`` greedy
    decode steps at ``lens + i``, each request on pages of its own.
    ``params`` is an f32 tree on the CPU, put in its serving form on the
    rank's device. Returns the (steps + 1, B, V) f32 logits as numpy."""
    import numpy as np

    from repro_torch import configs
    from repro_torch.distributed import sharding
    from repro_torch.runtime import layouts
    cfg = configs.get(arch, smoke=smoke)
    dev = torch.device('cpu') if shard is None else shard.device
    group, rank, tp = ((None, 0, 1) if shard is None
                       else (shard.group, shard.rank, shard.tp))
    prompts = torch.as_tensor(prompts).to(dev)
    lens = torch.as_tensor(lens, dtype=torch.int32).to(dev)
    b, s = prompts.shape
    w = -(-(s + steps) // page_size)
    cache = model_mod.init_paged_cache_tree(
        cfg, b, num_pages=1 + b * w, page_size=page_size, max_blocks=w,
        dtype=compute_dtype, kv_dtype=kv_dtype, hot_window=hot_window,
        device=dev, tp=tp)
    cache = layouts.with_block_tables(
        cache, np.arange(1, 1 + b * w, dtype=np.int32).reshape(b, w))
    params = sharding.shard_serve_params(
        model_mod.serving_form(_to_device(params, dev), mode, False,
                               compute_dtype), rank, tp)
    yoco = YocoConfig(mode=mode, compute_dtype=compute_dtype)
    rt = ModelRuntime(attn_impl=attn_impl, compute_dtype=compute_dtype,
                      tp_group=group)
    prefill = make_prefill_step(cfg, yoco, rt)
    decode = make_decode_step(cfg, yoco, rt)
    logits, cache = prefill(params, dict(inputs=prompts), cache,
                            last_pos=lens - 1)
    rows = [logits]
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    for i in range(steps):
        tok, logits, cache = decode(params, tok, lens + i, cache)
        rows.append(logits)
    return torch.stack(rows).to(torch.float32).cpu().numpy()


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)
