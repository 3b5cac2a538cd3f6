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

import dataclasses
import time
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


def static_serve_loop(prefill, decode, steps: int, position, *,
                      first_token=None, step_input=None, after=None) -> list:
    """The static serve's loop, shared by every caller: ``prefill() ->
    (logits, cache)``, the first token ``first_token(logits)`` (greedy by
    default), then ``steps`` decode steps ``decode(x, position(i), cache)
    -> (tok, logits, cache)`` on ``x = step_input(tok)`` (the token by
    default). ``after(logits, tok)`` runs after the prefill and after
    every step. Returns the tokens, one (B, ...) tensor a step."""
    logits, cache = prefill()
    tok = (first_token(logits) if first_token is not None
           else torch.argmax(logits, dim=-1).to(torch.int32))
    if after is not None:
        after(logits, tok)
    toks = [tok]
    for i in range(steps):
        x = step_input(tok) if step_input is not None else tok
        tok, logits, cache = decode(x, position(i), cache)
        if after is not None:
            after(logits, tok)
        toks.append(tok)
    return toks


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
    rows = []
    static_serve_loop(
        lambda: prefill(params, dict(inputs=prompts), cache,
                        last_pos=lens - 1),
        lambda x, pos, c: decode(params, x, pos, c), steps,
        lambda i: lens + i,
        after=lambda logits, _: rows.append(logits))
    return torch.stack(rows).to(torch.float32).cpu().numpy()


def _to_device(tree, dev):
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_to_device(v, dev) for v in tree]
    return tree.to(dev)


# ----------------------------------------------------------------------------
# mesh-sharded static serving: prefill and decode over a rank mesh
# ----------------------------------------------------------------------------
# The reference's jit_prefill_step / jit_decode_step are GSPMD steps: every
# weight sharded over ('data', 'model') by sharding.param_specs and the
# static cache over the batch, the KV heads or the sequence by
# sharding.cache_specs. Here a rank holds its blocks of both
# (sharding.shard_tree, sharding.zeros_blocks), gathers each weight block
# over the axes it does not compute on (sharding.compute_specs with
# serve=True: a GQA rank keeps its heads, the MLP its hidden units, the
# embedding and lm_head their vocab, under expert parallelism the expert
# stacks their experts), runs on its rows of the batch (the whole batch
# where the batch is smaller than the dp axes) and writes only its cache
# block; the logits come back whole on every rank.
def abstract_serve_state(cfg, batch: int, max_seq: int,
                         cache_dtype=torch.bfloat16, prequant: bool = False,
                         *, mode: str = 'bf16', dtype=torch.bfloat16):
    """(params, cache) on the meta device: the weights in the form a serve
    keeps them (``model.serving_transform``: int8 codes under
    ``prequant``, the ``quantize_tree`` rule; bf16 in bf16 mode; K-major
    f32 masters in the dynamic modes) and the static cache
    (``init_cache_tree``), shapes and dtypes only."""
    params = model_mod.init_params(
        None, cfg, device='meta',
        transform=model_mod.serving_transform(mode, prequant, dtype))
    cache = model_mod.init_cache_tree(cfg, batch, max_seq, cache_dtype,
                                      device='meta')
    return params, cache


def serve_shardings(mesh, cfg, params_abs, cache_abs, batch: int,
                    layout: str = 'tp'):
    """(param specs, cache specs): ``sharding.param_specs`` under
    ``layout`` and ``sharding.cache_specs`` for ``batch`` rows."""
    from repro_torch.distributed import sharding
    pspecs = sharding.param_specs(params_abs, mesh, layout)
    cspecs = sharding.cache_specs(cache_abs, batch=batch,
                                  dp_axes=sharding.dp_axes_of(mesh),
                                  mesh=mesh)
    return pspecs, cspecs


def _cache_cuts(cspecs, tp_axis: str) -> tuple:
    """(kv_seq_axes, state_cut) of a rank's cache under its specs: the axes
    the attention caches' sequence dim (dim 2 of a stacked ``k``/``ckv``)
    is cut over, () where it is whole; and each recurrent leaf's
    (name, dim) of one layer that is cut over ``tp_axis`` (``conv``'s
    channels, ``ssm``'s heads), () without recurrent state."""
    from repro_torch.distributed import sharding
    seq, state = (), ()

    def walk(node):
        nonlocal seq, state
        for k, v in node.items():
            if isinstance(v, dict):
                walk(v)
            elif k in ('k', 'ckv'):
                seq = tuple(dict(sharding.spec_axes(v, 3)).get(2, ()))
            elif k in ('conv', 'ssm'):
                state += tuple((k, d - 1) for d, axes in
                               sharding.spec_axes(v, len(tuple(v)))
                               if tp_axis in axes)
    walk(cspecs)
    return seq, state


def _gather_tree(tree, plans):
    """Each block of ``tree`` all-gathered along each (dim, group) of its
    plan."""
    from repro_torch.distributed import collectives
    from repro_torch.optim import adamw

    def one(p, plan):
        for dim, group, _ in plan:
            p = collectives.all_gather_dim(p, dim, group)
        return p
    return adamw.tree_map(one, tree, plans)


class _GatheredLayers:
    """A layer list whose layers are gathered (:func:`_gather_tree`) when
    they are read, by index, slice or iteration."""

    def __init__(self, layers: list, plans: list):
        self.layers, self.plans = layers, plans

    def __len__(self) -> int:
        return len(self.layers)

    def __getitem__(self, i):
        if isinstance(i, slice):
            return _GatheredLayers(self.layers[i], self.plans[i])
        return _gather_tree(self.layers[i], self.plans[i])

    def __iter__(self):
        for i in range(len(self.layers)):
            yield self[i]


class _MeshServe:
    """What the two sharded steps share: the runtime, the gather plans,
    the rank's rows and the whole logits."""

    def __init__(self, mesh, cfg, batch, max_seq, yoco, layout, prequant,
                 attn_impl, cache_dtype):
        from repro_torch.distributed import sharding
        from repro_torch.runtime import train_step
        self.mesh, self.cfg, self.yoco = mesh, cfg, yoco
        self.params_abs, self.cache_abs = abstract_serve_state(
            cfg, batch, max_seq, cache_dtype, prequant, mode=yoco.mode,
            dtype=yoco.compute_dtype)
        self.pspecs, self.cspecs = serve_shardings(
            mesh, cfg, self.params_abs, self.cache_abs, batch, layout)
        rt = train_step.mesh_runtime(mesh, cfg, layout, 'none',
                                     compute_dtype=yoco.compute_dtype,
                                     attn_impl=attn_impl)
        kv_seq_axes, state_cut = _cache_cuts(self.cspecs, rt.tp_axis)
        self.rt = dataclasses.replace(rt, kv_seq_axes=kv_seq_axes,
                                      state_cut=state_cut)
        cspec = sharding.compute_specs(self.params_abs, self.pspecs, cfg,
                                       mesh, self.rt.act_layout,
                                       self.rt.use_ep, serve=True)
        from repro_torch.optim import adamw
        self.plans = adamw.tree_map(
            lambda p, sp, cs: train_step._gather_plan(sp, cs, p.ndim, mesh,
                                                      ()),
            self.params_abs, self.pspecs, cspec)
        dp = sharding.dp_axes_of(mesh)
        self.dp = dp
        n = mesh.axis_size(dp)
        # the batch is cut over the dp axes where the cache's batch dim is
        self.split_rows = batch >= n and batch % n == 0 and n > 1

    def weights(self, params):
        """The blocks this rank computes on, each gathered by its plan; a
        layer list's layers are gathered one at a time as the stack
        reaches them (:class:`_GatheredLayers`), so a rank never holds
        more than a layer gathered beside its blocks."""
        return {k: (_GatheredLayers(v, self.plans[k]) if isinstance(v, list)
                    else _gather_tree(v, self.plans[k]))
                for k, v in params.items()}

    def rows(self, x: torch.Tensor) -> torch.Tensor:
        if not self.split_rows:
            return x
        n = self.mesh.axis_size(self.dp)
        per = x.shape[0] // n
        lo = self.mesh.index(self.dp) * per
        return x[lo:lo + per]

    def whole_logits(self, logits: torch.Tensor) -> torch.Tensor:
        """(B_rank, [CB,] V_rank) -> (B, [CB,] V): the vocab blocks of a
        cut lm_head gathered over 'model', the rows over the dp axes."""
        from repro_torch.distributed import collectives
        if logits.shape[-1] < self.cfg.vocab_size:
            logits = collectives.all_gather_dim(logits, logits.ndim - 1,
                                                self.rt.model_group())
        if self.split_rows:
            logits = collectives.all_gather_dim(logits, 0,
                                                self.mesh.group(self.dp))
        return logits


def sharded_prefill_step(mesh, cfg, batch: int, max_seq: int,
                         yoco: YocoConfig = DEFAULT_YOCO,
                         layout: str = 'tp', prequant: bool = False, *,
                         attn_impl: str = 'einsum',
                         cache_dtype=torch.bfloat16):
    """The reference's ``jit_prefill_step`` on a rank mesh: returns
    ``(step, (params_abs, cache_abs))``. ``step(params, batch, cache) ->
    (logits, cache)`` runs in every rank on its blocks of the serving
    weights (``sharding.shard_tree`` of a tree in ``params_abs``' form
    under :func:`serve_shardings`' param specs) and of the cache
    (``sharding.zeros_blocks`` under its cache specs), given the whole
    ``batch`` (``inputs`` of (B, S) positions, S <= ``max_seq``); the
    cache is written in place and the (B, V) logits at the last position
    are whole on every rank. The runtime is ``layout``'s
    (``train_step.mesh_runtime``); ``step.specs`` holds the (param,
    cache) spec trees."""
    ms = _MeshServe(mesh, cfg, batch, max_seq, yoco, layout, prequant,
                    attn_impl, cache_dtype)

    @torch.no_grad()
    def prefill_step(params, batch, cache):
        inputs = ms.rows(batch['inputs'])
        logits, cache = model_mod.prefill(ms.weights(params),
                                          dict(inputs=inputs), cache, cfg,
                                          yoco, ms.rt)
        return ms.whole_logits(logits), cache

    prefill_step.specs = (ms.pspecs, ms.cspecs)
    return prefill_step, (ms.params_abs, ms.cache_abs)


def sharded_decode_step(mesh, cfg, batch: int, max_seq: int,
                        yoco: YocoConfig = DEFAULT_YOCO,
                        layout: str = 'tp', prequant: bool = False, *,
                        attn_impl: str = 'einsum',
                        cache_dtype=torch.bfloat16):
    """The reference's ``jit_decode_step`` on a rank mesh: returns
    ``(step, (params_abs, cache_abs))``; ``step(params, token, pos, cache)
    -> (next_tok, logits, cache)``, greedy, with the whole ``token`` of
    the batch and a 0-d or (B,) ``pos``, blocks as in
    :func:`sharded_prefill_step`. A cache cut on its sequence is scored
    a block a rank and merged (``attention.sdpa_decode_blocks``); a GQA
    cache cut on its heads is read by kernel K7 under ``attn_impl
    'flash'``."""
    ms = _MeshServe(mesh, cfg, batch, max_seq, yoco, layout, prequant,
                    attn_impl, cache_dtype)

    @torch.no_grad()
    def decode_step(params, token, pos, cache):
        pos = torch.as_tensor(pos, dtype=torch.int32, device=token.device)
        if pos.ndim:
            pos = ms.rows(pos)
        logits, cache = model_mod.decode_step(ms.weights(params),
                                              ms.rows(token), pos, cache,
                                              cfg, yoco, ms.rt)
        logits = ms.whole_logits(logits)
        return torch.argmax(logits, dim=-1).to(torch.int32), logits, cache

    decode_step.specs = (ms.pspecs, ms.cspecs)
    return decode_step, (ms.params_abs, ms.cache_abs)


def sharded_serve_job(mesh, *, cfg, prompts, steps: int, params=None,
                      seed: int = 0, mode: str = 'bf16',
                      prequant: bool = False, attn_impl: str = 'einsum',
                      compute_dtype=torch.bfloat16, max_seq=None,
                      reference: bool = False, device=None) -> dict:
    """A mesh job (``distributed/ranks.py::mesh_job``): a static serve of
    ``prompts`` ((B, S) numpy ids) through :func:`sharded_prefill_step`
    and ``steps`` greedy :func:`sharded_decode_step`\\ s at positions S,
    S + 1, ..., on ``cfg``'s weights (``params``, the reference's tree as
    numpy, or ``init_params`` of ``seed``) in their serving form, each rank
    on its blocks under the 'tp' layout. Returns this rank's tokens
    (steps + 1, B) and f32 logits (steps + 1, B, V) (numpy, whole), its
    collective calls and bytes, kernel launches and seconds of each step,
    its weight and cache block bytes and the job's seconds; with
    ``reference``, on rank 0, the same serve on one device (the whole
    weights and cache through ``make_prefill_step`` /
    ``make_decode_step``) beside it."""
    from repro_torch import device as device_mod
    from repro_torch.distributed import collectives, sharding
    from repro_torch.kernels import build
    t_job = time.perf_counter()
    dev = device_mod.resolve(device or mesh.device)
    yoco = YocoConfig(mode=mode, compute_dtype=compute_dtype)
    b, s = prompts.shape
    max_seq = max_seq or s + steps
    transform = model_mod.serving_transform(mode, prequant, compute_dtype)
    if params is None:
        gen = torch.Generator(device=dev).manual_seed(seed)
        whole = model_mod.init_params(gen, cfg, device=dev,
                                      transform=transform)
    else:
        whole = model_mod.serving_form(
            model_mod.params_from_numpy(params, cfg, dev), mode, prequant,
            compute_dtype)
    kw = dict(yoco=yoco, prequant=prequant, attn_impl=attn_impl,
              cache_dtype=compute_dtype)
    prefill, (_, cabs) = sharded_prefill_step(mesh, cfg, b, max_seq, **kw)
    decode, _ = sharded_decode_step(mesh, cfg, b, max_seq, **kw)
    pspecs, cspecs = prefill.specs
    blocks = sharding.shard_tree(whole, pspecs, mesh)
    reference = reference and mesh.rank == 0
    if not reference:
        del whole
    cache = sharding.zeros_blocks(cabs, cspecs, mesh, dev)
    out = dict(rank=mesh.rank, param_bytes=sharding.nbytes(blocks),
               cache_bytes=sharding.nbytes(cache), calls=[], bytes=[],
               launches=[], seconds=[])
    prompts_t = torch.as_tensor(prompts).to(dev)
    positions = torch.arange(s, s + steps, dtype=torch.int32, device=dev)

    def counted(fn, *args):
        collectives.reset_counts()
        build.reset_counts()
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        t0 = time.perf_counter()
        got = fn(*args)
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)
        out['seconds'].append(time.perf_counter() - t0)
        out['calls'].append(dict(collectives.CALLS))
        out['bytes'].append(dict(collectives.BYTES))
        out['launches'].append({k: v for k, v in build.LAUNCHES.items()
                                if v})
        return got

    def serve(prefill, decode):
        rows = []
        toks = static_serve_loop(prefill, decode, steps,
                                 lambda i: positions[i],
                                 after=lambda logits, _: rows.append(logits))
        return (torch.stack(toks).cpu().numpy(),
                torch.stack(rows).to(torch.float32).cpu().numpy())

    out['tokens'], out['logits'] = serve(
        lambda: counted(prefill, blocks, dict(inputs=prompts_t), cache),
        lambda x, pos, c: counted(decode, blocks, x, pos, c))
    del blocks, cache
    if reference:
        rt = ModelRuntime(attn_impl=attn_impl, compute_dtype=compute_dtype)
        one = model_mod.init_cache_tree(cfg, b, max_seq, compute_dtype,
                                        device=dev)
        prefill1 = make_prefill_step(cfg, yoco, rt)
        decode1 = make_decode_step(cfg, yoco, rt)
        with torch.no_grad():
            out['ref_tokens'], out['ref_logits'] = serve(
                lambda: prefill1(whole, dict(inputs=prompts_t), one),
                lambda x, pos, c: decode1(whole, x, pos, c))
    out['job_s'] = time.perf_counter() - t_job
    return out
