"""Serving entry points (port of ``repro/launch/serve.py``): the static
``serve()`` path, lock-step or ``--ragged``, over a contiguous KV cache,
and continuous batching over the paged KV cache (``--continuous``).

``serve()`` prefills a batch of prompts and decodes ``gen_len`` tokens in
lock-step (one 0-d position for the batch) or, with ``ragged``, with
per-request prompt lengths (a padded prefill whose logits are gathered at
each request's last prompt position, then a (B,) position vector). Its
decode reads the contiguous cache through kernel K7
(``attn_impl='flash'``) or the einsum oracle (the default, as in the
reference); MLA configs are einsum-only there, as in the reference.

``--continuous`` serves a stream of heterogeneous-length requests over a
fixed number of decode *slots*: admit-on-release, per-slot positions,
page-granular cache growth, eviction on EOS or budget, youngest-first
preempt-and-requeue when the pool runs dry, deadlines, a retry budget and
queue backpressure, with ``EventLog.terminal_accounting()`` audited on
every run. Each admission runs a batch-1 prefill of the padded prompt;
each step runs one decode over every slot (idle slots decode at pos 0
against the garbage page).

``--kv-quant`` keeps the last ``--hot-window`` pages of each request full
precision and quantizes older pages once into the int8 tier.
``--prefix-cache`` shares sealed prompt pages between requests by content
(copy-on-write for a fully covered prompt), and hits prefill only the
unshared suffix in chunks; ``--chunk-prefill C`` chunks every admission.

Continuous decode attention reads the cache through kernel K1, or K6 over
the int8 tier (``attn_impl='flash'``, the default there), or the einsum
oracle; chunked prefill reads it through kernel K5 or the oracle. The
dense GQA configs served so far: stablelm-1.6b, stablelm-12b (G = 4,
dh = 160), starcoder2-15b (G = 12, biases, a GELU MLP) and gemma3-27b
(G = 2; 5 sliding-window layers to 1 global, each layer's window a view
of one device tensor, so no step copies it to the card). Seeded weights
are drawn straight into their serving form (:func:`_serving_params`), so
a 27 B model's f32 tree never exists whole, and a weight of any mode is
refused up front where it exceeds the card's free memory in its serving
form (:func:`_refuse_oversize`: gemma3-27b's dynamic w8a8 f32 masters,
113.7 GB; qwen2-vl-72b in bf16, 142.9 GB). MLA
configs (deepseek-v3) take the latent twins: K8, K10 over the int8
latent tier, K9 for chunks. Mixture-of-Experts configs (qwen2-moe-a2.7b;
deepseek-v3 with its MoE layers, served cut in depth) run every expert
on every token (``models/moe.py``), their expert stacks stored once in the
compute dtype in every mode (never int8: the reference's ``quantize_tree``
skips them), so dynamic w8a8's refusal prices them at that dtype's
bytes. Recurrent configs: mamba2-780m (a pure
SSM) and zamba2-1.2b (Mamba2 layers and six applications of one shared
attention+MLP block, whose sites read their paged pools through K1, K6 on
the int8 tier, or K7 in ``serve()``) carry per-slot f32 state
(``runtime/layouts.py``'s ``RecurrentLayout``): admission zeroes the
slot's rows and prefills a batch-1 copy of them, an evict or preempt marks
the rows dirty and they are zeroed before the next decode step, and a
requeued request recomputes from its prompt. A pure SSM has no pool to
tier, zero, scrub or poison. The path is layout-driven: nothing here is
family-specific except the refusals of ``--prequantize`` on MLA and
hybrid configs (:func:`_refuse_mla_prequantize`,
:func:`_refuse_hybrid_prequantize`), of ``--kv-quant`` on a pure SSM and
of ``--prefix-cache`` and ``--chunk-prefill`` on recurrent state
(:func:`_refuse_recurrent_paging`), and of ``--attn-impl flash`` on MLA
and on a pure SSM in ``serve()``. ``--mode w8a8`` routes every linear through the
int8 kernels (K3 + K2 with ``--prequantize``, K3 + K4 without);
``--mode analog_sim`` adds the paper-calibrated analog noise and 8-bit TDC
to each of those products (``core/yoco_linear.py``), and ``--mode qat``
fake-quantizes each linear's activation and weight through K3 before one
float matmul. Both serve wherever bf16 and w8a8 do, and are refused where
the reference fails (``--prequantize`` on MLA and hybrid configs).
``--sample`` (with ``--temperature`` / ``--top-k``) replaces the greedy
argmax with temperature / top-k sampling on both paths. The two
non-token frontends serve through ``serve()`` only, as in the reference:
qwen2-vl-72b (precomputed (B, S, d) patch embeddings, M-RoPE; each
generated id fed back as the stubbed frontend's one-hot row; served whole
on one card with ``--prequantize``, 71.5 GB of int8 weights) and
musicgen-large ((B, S, 4) codebook grids, four heads, (B, gen, 4)
tokens); ``--continuous`` refuses them.
``--chaos`` (``--chaos-seed``) serves the stream under
``runtime/faults.py``'s deterministic fault injector; every step a NaN/Inf
sentinel on the logits quarantines poisoned lanes (pages scrubbed, request
requeued). ``--metrics`` (on by default) adds ``runtime/telemetry.py``'s
spans, gauges and the YOCO hardware model's energy and traffic (modelled
figures, not the card's), ``--metrics-out`` writes them and ``--trace`` a
Chrome trace. Unlike the reference there is no flash->einsum degrade: a
kernel that fails to build or launch raises, and a simulated kernel fault
is refused.

Usage (the card is the default device; ``--device cpu`` runs the plain
versions of the kernels):
  python -m repro_torch.launch.serve --arch stablelm-1.6b --no-smoke \
      --batch 8 --prompt-len 128 --gen-len 32 --attn-impl flash --ragged \
      [--sample --temperature 0.8 --top-k 40]
  python -m repro_torch.launch.serve --arch stablelm-1.6b --continuous \
      --no-smoke --slots 8 --requests 16 --prompt-len 128 --gen-len 32 \
      --mode w8a8 --prequantize [--kv-quant --hot-window 2] \
      [--prefix-cache] [--chunk-prefill 32] [--shared-prefix 96] \
      [--chaos --chaos-seed 0] [--metrics-out m.prom] [--trace t.json]
  python -m repro_torch.launch.serve --arch gemma3-27b --continuous \
      --no-smoke --slots 8 --requests 2 --prompt-len 1152 --gen-len 16 \
      --chunk-prefill 128 [--mode w8a8 --prequantize] [--kv-quant]
  python -m repro_torch.launch.serve --arch stablelm-1.6b --no-smoke \
      --continuous --mode {qat | analog_sim} [--prequantize]
  python -m repro_torch.launch.serve --arch qwen2-moe-a2.7b --continuous \
      --no-smoke --slots 8 --requests 8 --prompt-len 128 --gen-len 16 \
      [--mode w8a8 [--prequantize]]
  python -m repro_torch.launch.serve --arch zamba2-1.2b --continuous \
      --no-smoke --slots 8 --requests 8 --prompt-len 128 --gen-len 16 \
      [--mode w8a8] [--kv-quant --hot-window 2]
  python -m repro_torch.launch.serve --arch qwen2-vl-72b --no-smoke \
      --batch 8 --prompt-len 128 --gen-len 32 --mode w8a8 --prequantize \
      --attn-impl flash [--ragged]
  python -m repro_torch.launch.serve --arch musicgen-large --no-smoke \
      --batch 8 --prompt-len 128 --gen-len 32 --attn-impl flash \
      [--mode w8a8 [--prequantize]] [--ragged] [--sample --top-k 40]
  (--arch stablelm-12b, starcoder2-15b, gemma3-27b, qwen2-moe-a2.7b,
  mamba2-780m, zamba2-1.2b, qwen2-vl-72b or musicgen-large: the
  reference's other configs; their smoke widths with --smoke, the
  default; deepseek-v3-671b at --smoke, its 3-layer SMOKE config with one
  dense and two MoE layers)
"""

from __future__ import annotations

import argparse
import dataclasses
import inspect
import json
import time
from collections import Counter, deque
from typing import List, Optional

import numpy as np
import torch

from repro_torch import configs
from repro_torch import device as device_mod
from repro_torch.configs import base as configs_base
from repro_torch.core.yoco_linear import YocoConfig
from repro_torch.data import synthetic
from repro_torch.distributed import collectives, ranks, sharding
from repro_torch.kernels import build
from repro_torch.models import model as model_mod
from repro_torch.models.model import ModelRuntime
from repro_torch.runtime import faults as faults_mod
from repro_torch.runtime import kv_cache as kvc
from repro_torch.runtime import kv_quant as kvq
from repro_torch.runtime import layouts as layouts_mod
from repro_torch.runtime import serve_step as SS
from repro_torch.runtime import telemetry as telemetry_mod


def _ragged_lens(batch: int, prompt_len: int) -> torch.Tensor:
    """Deterministic per-request prompt lengths in [~half, prompt_len]."""
    lo = max(4, prompt_len // 2)
    lens = [prompt_len - (i * 3) % max(1, prompt_len - lo)
            for i in range(batch)]
    return torch.tensor([max(lo, min(prompt_len, n)) for n in lens],
                        dtype=torch.int32)


_DYNAMIC_HINT = 'serve bf16 or a dynamic --mode (w8a8, qat or analog_sim)'


def _refuse_mla_prequantize(arch: str, cfg, prequantize: bool) -> None:
    """The reference fails on MLA with ``--prequantize``, in every mode:
    quantize_tree turns w_ukv into a QuantizedWeight, which
    mla_attention_decode/_chunk then reshape
    (src/repro/models/attention.py:608, :670) -> AttributeError. The port
    refuses it up front, on both paths (ROADMAP Queue 3)."""
    if prequantize and cfg.mla is not None:
        raise ValueError(
            f'{arch}: --prequantize is not served on MLA configs: the '
            f'reference quantizes w_ukv and its absorbed decode then '
            f'reshapes the QuantizedWeight (src/repro/models/attention.py:'
            f'608), an AttributeError in every mode (ROADMAP Queue 3); '
            f'{_DYNAMIC_HINT}')


def _refuse_hybrid_prequantize(arch: str, cfg, prequantize: bool) -> None:
    """The reference fails on hybrid configs with ``--prequantize``, in
    every mode: quantize_tree turns the shared block's per-site in_proj
    (n_sites, 2d, d), named in its _WEIGHT_NAMES, into a QuantizedWeight,
    which shared_block then indexes by site and feeds to a float einsum
    (src/repro/models/blocks.py:136) -> ValueError. The port refuses it up
    front, on both paths (ROADMAP Queue 3)."""
    if prequantize and cfg.hybrid_group:
        raise ValueError(
            f'{arch}: --prequantize is not served on hybrid configs: the '
            f'reference quantizes the shared block\'s per-site in_proj and '
            f'shared_block then feeds the QuantizedWeight to an einsum '
            f'(src/repro/models/blocks.py:136), a ValueError in every mode '
            f'(ROADMAP Queue 3); {_DYNAMIC_HINT}')


def _refuse_recurrent_paging(arch: str, cfg, kv_quant: bool,
                             prefix_cache: bool, chunk_prefill) -> None:
    """As the reference: a pure SSM has no attention pool to tier, and
    recurrent state folds the whole prompt into one state, so it has no
    per-position cache to share or to prefill a suffix of."""
    if kv_quant and cfg.family == 'ssm':
        raise ValueError(f'--kv-quant tiers paged attention KV; {arch} is '
                         f'family=ssm with recurrent state only (no int8 '
                         f'tier: drop --kv-quant)')
    if (prefix_cache or chunk_prefill is not None) and \
            model_mod._recurrent(cfg):
        flag = '--prefix-cache' if prefix_cache else '--chunk-prefill'
        raise ValueError(f'{flag} needs random-access paged attention '
                         f'state; {arch} (family={cfg.family}, '
                         f'hybrid_group={cfg.hybrid_group}) carries '
                         f'recurrent state that must see every prompt '
                         f'position')


def _refuse_oversize(cfg, dev, mode: str, prequantize: bool,
                     compute_dtype=torch.bfloat16) -> None:
    """Refuse, before any draw, weights that exceed the card's free memory
    in their serving form (``model.serving_bytes``, the drawn leaves
    counted on the meta device): qwen2-vl-72b's 80 layers take 142.9 GB
    in bf16 and 285.8 GB as dynamic w8a8's f32 masters (gemma3-27b's
    113.7 GB too, as are qat's and dynamic analog_sim's, which keep the
    same masters), and 71.5 GB with ``--prequantize``, which one 80 GB card
    holds."""
    if dev.type != 'cuda':
        return
    need = model_mod.serving_bytes(cfg, mode, prequantize, compute_dtype)
    free, _ = torch.cuda.mem_get_info(dev)
    if need <= free:
        return
    form = (f'{mode} --prequantize' if prequantize
            else mode if mode == 'bf16'
            else f'dynamic {mode} (f32 masters)')
    raise ValueError(
        f'{cfg.name}: its weights take {need} bytes in {form} (the drawn '
        f'leaves in their serving form), and the card has {free} bytes '
        f'free (torch.cuda.mem_get_info); serve a mode whose weights fit '
        f'(--prequantize stores int8), or cut its depth')


def _refuse_oversize_tp(cfg, devs, mode: str, prequantize: bool,
                        compute_dtype, pool: dict) -> None:
    """:func:`_refuse_oversize` for a tensor-parallel group, before any
    draw and any spawn: on each card, the bytes of every rank placed there
    (a rank's weights, head leaves / tp, and its pool part,
    ``distributed/sharding.py``'s ``serving_bytes`` and ``pool_bytes``)
    against the card's free memory, checked once here rather than in each
    rank, where the ranks' own allocations would race the check. A rank
    allocates no more: it draws its head projections cut
    (``sharding.rank_transform``) and its pool part alone
    (``model.init_paged_cache_tree(tp=)``)."""
    tp = len(devs)
    per_rank = (sharding.serving_bytes(cfg, mode, prequantize,
                                       compute_dtype, tp)
                + sharding.pool_bytes(cfg, tp, dtype=compute_dtype, **pool))
    for dev in sorted(set(devs), key=str):
        if dev.type != 'cuda':
            continue
        n = devs.count(dev)
        free, _ = torch.cuda.mem_get_info(dev)
        if n * per_rank > free:
            raise ValueError(
                f'{cfg.name} at tp={tp}: the {n} ranks on {dev} take '
                f'{n * per_rank} bytes ({per_rank} a rank: weights in '
                f'{mode}{" --prequantize" if prequantize else ""} with '
                f'their head projections / {tp}, and the KV pool / {tp}), '
                f'and the card has {free} bytes free '
                f'(torch.cuda.mem_get_info); serve fewer ranks a card or a '
                f'mode whose weights fit')


def _serving_params(cfg, params, dev, *, seed: int, mode: str,
                    prequantize: bool, compute_dtype,
                    shard: Optional[ranks.Shard] = None) -> dict:
    """Seeded random weights on ``dev`` unless ``params`` is given,
    quantized in situ (``prequantize``: the network loaded "into the
    array"), in bf16 mode cast once to the compute dtype, or in the dynamic
    modes (w8a8, qat, analog_sim) stored K-major once, as kernel K3 (and
    K4) read them with no per-call copy; expert stacks cast once to the
    compute dtype in every
    mode. Seeded weights take that form as each is drawn
    (``model.serving_transform``), so no f32 tree is ever whole on the
    card; given ``params`` are converted tree-wise (``model.serving_form``;
    a tree already in that form is not copied). With a tensor-parallel
    ``shard``, the rank's tree (``distributed/sharding.py``): seeded head
    projections cut as they are drawn, given ones cut after; the memory
    check is then the caller's, made for all ranks at once."""
    drawn = params is None
    if drawn:
        if shard is None:
            _refuse_oversize(cfg, dev, mode, prequantize, compute_dtype)
        gen = torch.Generator(device=dev).manual_seed(seed)
        transform = model_mod.serving_transform(mode, prequantize,
                                                compute_dtype)
        if shard is not None:
            transform = sharding.rank_transform(transform, shard.rank,
                                                shard.tp)
        params = model_mod.init_params(gen, cfg, device=dev,
                                       transform=transform)
    else:
        params = model_mod.serving_form(params, mode, prequantize,
                                        compute_dtype)
    if shard is None:
        return params
    return sharding.shard_serve_params(params, shard.rank, shard.tp,
                                       drawn=drawn)


def _refuse_kernel_fault(faults) -> None:
    """The reference degrades a failed flash decode to the layout's einsum
    oracle (src/repro/launch/serve.py:1088-1111); the port keeps the
    decision not to port that as a silent fallback (ROADMAP Queue 1 item
    10): a kernel that fails raises. An injector that would simulate a
    kernel failure is refused before serving."""
    if faults is None:
        return
    if faults.profile.kernel_fault_step is not None or any(
            kind == 'kernel_fault' for _, kind, _ in faults.schedule):
        raise ValueError(
            'kernel_fault is not served: the port does not degrade from the '
            'flash kernels to the einsum oracle (kept decision, ROADMAP '
            'Queue 1 item 10: a kernel that fails raises; a degrade, if '
            'ever ported, is an explicit, logged mode, off by default)')


def _check_attn_impl(attn_impl: str) -> None:
    if attn_impl not in ('flash', 'einsum'):
        raise ValueError(f'attn_impl must be flash or einsum, got '
                         f'{attn_impl!r}')


def _prompt_shape(cfg, batch: int, prompt_len: int) -> tuple:
    """The prompt a config takes: (B, S) token ids, (B, S, CB) codebook
    ids, or (B, S, d) embeddings (the stubbed frontend's rows)."""
    if cfg.input_kind == 'codebooks':
        return (batch, prompt_len, cfg.n_codebooks)
    if cfg.input_kind == 'embeddings':
        return (batch, prompt_len, cfg.d_model)
    return (batch, prompt_len)


def _step_input(cfg, tok: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """What a decode step feeds the model after the ids ``tok``: the ids,
    or for embeddings input the stubbed frontend's row of each id, the
    reference's ``one_hot(tok % d_model, d_model)`` in bf16, compared on
    the card against ``ids`` (arange(d_model) there): no host round
    trip."""
    if cfg.input_kind != 'embeddings':
        return tok
    return ((tok.to(torch.int64) % cfg.d_model)[:, None] == ids).to(
        torch.bfloat16)


def serve(arch: str, *, smoke: bool = True, batch: int = 4,
          prompt_len: int = 32, gen_len: int = 32, mode: str = 'bf16',
          prequantize: bool = False, seed: int = 0, noise_seed: int = 0,
          attn_impl: str = 'einsum', ragged: bool = False,
          greedy: bool = True, temperature: float = 1.0, top_k: int = 0,
          quiet: bool = False, device=None, compute_dtype=torch.bfloat16,
          params: Optional[dict] = None, prompts=None,
          step_hook=None) -> dict:
    """Prefill ``batch`` prompts of ``prompt_len`` tokens into a contiguous
    cache and decode ``gen_len`` tokens, on ``device`` (default: the CUDA
    card; ``'cpu'`` runs the kernels' plain versions). ``ragged`` gives
    the requests the lengths of :func:`_ragged_lens` (padded prompts, the
    prefill's logits gathered at ``lens - 1``, decode at ``lens + i``).
    ``greedy=False`` samples (``temperature``, ``top_k``; generator seeded
    ``seed + 1``). ``params`` (the port's f32 param tree on ``device``)
    replaces the seeded random init; ``prompts`` ((batch, prompt_len)
    int) replaces the synthetic batch. ``noise_seed`` seeds ``analog_sim``'s
    draws (``YocoConfig.noise_seed``; the reference's CLI keeps it 0 and
    has no flag for it). ``step_hook(logits, tokens)`` runs
    after the prefill and after every decode step. Prints the reference's
    report keys plus ``device``, then attaches the (batch, gen_len) int32
    token array under ``tokens``.

    Non-token frontends, as the reference serves them: musicgen's prompts
    are (batch, prompt_len, CB) codebook ids and its tokens (batch,
    gen_len, CB); qwen2-vl's prompts are (batch, prompt_len, d_model)
    float embeddings, its tokens ids, each fed back to the next decode
    step as the stubbed frontend's one-hot row (:func:`_step_input`)."""
    cfg = configs.get(arch, smoke=smoke)
    if attn_impl == 'flash' and (cfg.mla is not None
                                 or cfg.family == 'ssm'):
        kind = 'MLA' if cfg.mla is not None else 'SSM'
        hint = ('MLA flash decode is the paged kernel — serve it with '
                '--continuous' if cfg.mla is not None
                else 'a pure-SSM decode has no attention cache to '
                     'flash-read; drop --attn-impl')
        raise ValueError(f'--attn-impl flash covers GQA decode on the '
                         f'contiguous cache; {arch} uses {kind} layers '
                         f'({hint})')
    _refuse_mla_prequantize(arch, cfg, prequantize)
    _refuse_hybrid_prequantize(arch, cfg, prequantize)
    _check_attn_impl(attn_impl)
    dev = device_mod.resolve(device)
    yoco = YocoConfig(mode=mode, noise_seed=noise_seed,
                      compute_dtype=compute_dtype)
    rt = ModelRuntime(attn_impl=attn_impl, compute_dtype=compute_dtype)
    max_seq = prompt_len + gen_len

    params = _serving_params(cfg, params, dev, seed=seed, mode=mode,
                             prequantize=prequantize,
                             compute_dtype=compute_dtype)
    if prompts is None:
        dc = synthetic.for_arch(cfg, global_batch=batch, seq_len=prompt_len)
        prompts = synthetic.make_batch(dc, 0)['inputs']
    prompts = torch.as_tensor(
        np.asarray(prompts), dtype=(torch.float32
                                    if cfg.input_kind == 'embeddings'
                                    else torch.int32)).to(dev)
    want = _prompt_shape(cfg, batch, prompt_len)
    if tuple(prompts.shape) != want:
        raise ValueError(f'prompts {tuple(prompts.shape)}, expected {want} '
                         f'for {arch}\'s {cfg.input_kind} input')

    prefill_fn = SS.make_prefill_step(cfg, yoco, rt)
    decode_fn = SS.make_decode_step(cfg, yoco, rt, greedy=greedy,
                                    temperature=temperature, top_k=top_k)
    sample_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def sync():
        if dev.type == 'cuda':
            torch.cuda.synchronize(dev)

    cache = model_mod.init_cache_tree(cfg, batch, max_seq,
                                      dtype=compute_dtype, device=dev)
    lens = _ragged_lens(batch, prompt_len).to(dev) if ragged else None
    # lock-step positions, made once: no host-to-device copy per step
    steps_pos = torch.arange(prompt_len, max_seq, dtype=torch.int32,
                             device=dev)
    embed_ids = torch.arange(cfg.d_model, device=dev)
    marks = {}

    def after(logits, tok):
        # the prefill's end, the hook, then the decode's start
        if 'prefill' not in marks:
            sync()
            marks['prefill'] = time.time()
        if step_hook is not None:
            step_hook(logits, tok)
        marks.setdefault('decode', time.time())

    def first_token(logits):
        if greedy:
            return torch.argmax(logits, dim=-1).to(torch.int32)
        return SS.sample_tokens(logits, sample_gen, temperature=temperature,
                                top_k=top_k)

    def decode(x, pos, cache):
        if greedy:
            return decode_fn(params, x, pos, cache)
        return decode_fn(params, x, pos, cache, sample_gen)

    sync()
    t0 = time.time()
    # ragged: padded prompts; K/V beyond each request's length stay masked
    # (kpos > pos) and are overwritten as that request advances
    generated = SS.static_serve_loop(
        lambda: prefill_fn(params, dict(inputs=prompts), cache,
                           last_pos=lens - 1 if ragged else None),
        decode, gen_len - 1,
        lambda i: lens + i if ragged else steps_pos[i],
        first_token=first_token,
        step_input=lambda tok: _step_input(cfg, tok, embed_ids),
        after=after)
    sync()
    t_prefill = marks['prefill'] - t0
    t_decode = time.time() - marks['decode']
    toks = torch.stack(generated, dim=1).cpu()
    out = dict(
        prefill_s=round(t_prefill, 4),
        decode_s=round(t_decode, 4),
        tokens_per_s=round(batch * (gen_len - 1) / max(t_decode, 1e-9), 1),
        generated_shape=list(toks.shape),
        sample=[int(x) for x in toks.reshape(-1)[:8]],
        attn_impl=attn_impl,
        ragged=bool(ragged),
    )
    if ragged:
        out['prompt_lens'] = [int(x) for x in lens]
    out['device'] = str(dev)
    if not quiet:
        print(json.dumps(out))
    out['tokens'] = toks.numpy()
    return out


# ----------------------------------------------------------------------------
# continuous batching over a paged KV cache
# ----------------------------------------------------------------------------
@dataclasses.dataclass
class Request:
    """One serving request: a prompt and a generation budget."""
    rid: int
    prompt: np.ndarray          # (plen,) int32, unpadded
    target_gen: int             # generation budget
    ttl_steps: Optional[int] = None   # deadline in scheduler steps


@dataclasses.dataclass
class _SlotState:
    req: Request
    pos: int                    # absolute position the next decode writes at
    tokens: List[int]
    admit_seq: int              # admission order (preemption picks youngest)


class ContinuousScheduler:
    """Admit-on-release continuous batching over ``slots`` decode lanes —
    host-side only, the same contract as the reference scheduler:

    * **admit**: a pending request takes a free slot iff the pool covers its
      padded prompt (all-or-nothing); the driver prefills and :meth:`seed`\\ s
      the slot with the first greedy token at ``pos = plen``.
    * **grow**: before each decode step every active slot is ``ensure``\\ d a
      page for the position it writes; a dry pool preempts the *youngest*
      other lane (release + requeue at the queue front).
    * **evict**: EOS or the generation budget releases the slot.
    * **deadline / retry budget / backpressure**: ``ttl_steps`` expires
      pending and active requests, ``retry_budget`` bounds requeues,
      ``max_queue`` rejects over-cap submissions; every request ends in
      exactly one terminal event of :attr:`events`.
    * **quarantine**: a lane with non-finite logits is released and
      requeued, and its pages are handed back for scrubbing first.
    * **chaos hooks**: :meth:`cancel` ends a pending or active request
      mid-stream, :meth:`force_preempt` preempts the youngest lane.
    * **tier** (``hot_window``): :meth:`aged_out` lists the pages that left
      each lane's hot window; a released lane's tracker resets.
    * **recurrent state**: every release marks the slot in
      :attr:`dirty_slots` (the driver zeroes those rows before the next
      decode step); an admission drops its slot's mark (it zeroes the rows
      itself, and a later zeroing would wipe the prefilled state).
    """

    def __init__(self, kv: kvc.PagedKVCache, *, prompt_pad: int,
                 eos_id: Optional[int] = None,
                 hot_window: Optional[int] = None,
                 retry_budget: Optional[int] = None,
                 max_queue: Optional[int] = None,
                 vocab_size: Optional[int] = None,
                 events: Optional[faults_mod.EventLog] = None):
        if kv.blocks_for(prompt_pad) > kv.max_blocks:
            raise ValueError(
                f'padded prompt ({prompt_pad} positions, '
                f'{kv.blocks_for(prompt_pad)} blocks) exceeds the '
                f'block-table width ({kv.max_blocks} blocks * '
                f'{kv.page_size} positions); size max_blocks to the '
                f'longest admissible sequence')
        self.kv = kv
        self.prompt_pad = prompt_pad
        self.eos_id = eos_id
        self.retry_budget = retry_budget
        self.max_queue = max_queue
        self.vocab_size = vocab_size
        self.events = events if events is not None else faults_mod.EventLog()
        self.pending: deque = deque()
        self.active: dict = {}                 # slot -> _SlotState
        self.free_slots = list(range(kv.slots - 1, -1, -1))
        self._admit_seq = 0
        self.completed: List[_SlotState] = []
        self.dirty_slots: List[int] = []       # recurrent rows to zero
        self.step_no = 0
        self._retries: dict = {}               # rid -> requeue count
        self._deadline_at: dict = {}           # rid -> step it expires at
        self._queue_age: dict = {}             # rid -> steps spent pending
        self.tier = (kvq.KVTierTracker(hot_window, kv.page_size)
                     if hot_window is not None else None)

    # -- terminal bookkeeping ------------------------------------------------
    def _terminal(self, req: Request, kind: str, **detail) -> None:
        self._forget(req.rid)
        self.events.emit(kind, step=self.step_no, rid=req.rid, **detail)

    def _forget(self, rid: int) -> None:
        self._retries.pop(rid, None)
        self._deadline_at.pop(rid, None)
        self._queue_age.pop(rid, None)

    def _release_slot(self, slot: int, *, reason: str) -> _SlotState:
        st = self.active.pop(slot)
        self.kv.release(slot)
        self.free_slots.append(slot)
        self.dirty_slots.append(slot)
        if self.tier is not None:
            self.tier.reset(slot)
        self.events.emit('evict', step=self.step_no, rid=st.req.rid,
                         slot=slot, reason=reason, pos=st.pos)
        return st

    def _expired(self, rid: int) -> bool:
        at = self._deadline_at.get(rid)
        return at is not None and self.step_no >= at

    def begin_step(self, step: int) -> None:
        """Open step ``step``: age the queue and expire deadlines, pending
        and active alike, before admissions."""
        self.step_no = step
        for req in list(self.pending):
            age = self._queue_age.get(req.rid, 0) + 1
            self._queue_age[req.rid] = age
            if self._expired(req.rid):
                self.pending.remove(req)
                self._terminal(req, 'fail', reason='deadline', waited=age)
        for slot, st in list(self.active.items()):
            if self._expired(st.req.rid):
                self._release_slot(slot, reason='deadline')
                self._terminal(st.req, 'fail', reason='deadline',
                               pos=st.pos)

    def submit(self, req: Request) -> bool:
        """Validate and enqueue; False (with a terminal ``reject``) on
        backpressure or a prompt no slot can serve."""
        self.events.emit('submit', step=self.step_no, rid=req.rid,
                         plen=len(req.prompt), gen=req.target_gen)
        if len(req.prompt) == 0:
            self._terminal(req, 'reject', reason='empty_prompt')
            return False
        if len(req.prompt) > self.prompt_pad:
            self._terminal(req, 'reject', reason='oversized_prompt',
                           plen=len(req.prompt), prompt_pad=self.prompt_pad)
            return False
        if self.vocab_size is not None:
            ids = np.asarray(req.prompt)
            if int(ids.min()) < 0 or int(ids.max()) >= self.vocab_size:
                self._terminal(req, 'reject', reason='garbage_prompt',
                               vocab=self.vocab_size)
                return False
        if self.max_queue is not None and len(self.pending) >= self.max_queue:
            self._terminal(req, 'reject', reason='queue_full',
                           queued=len(self.pending))
            return False
        if req.ttl_steps is not None:
            self._deadline_at[req.rid] = self.step_no + req.ttl_steps
        self.pending.append(req)
        return True

    def cancel(self, rid: int) -> bool:
        """Mid-stream cancellation: drop the request wherever it is
        (pending queue or an active lane). False for an unknown or
        already-terminal rid."""
        for req in self.pending:
            if req.rid == rid:
                self.pending.remove(req)
                self._terminal(req, 'cancel', where='pending')
                return True
        for slot, st in list(self.active.items()):
            if st.req.rid == rid:
                self._release_slot(slot, reason='cancel')
                self._terminal(st.req, 'cancel', where='active', pos=st.pos)
                return True
        return False

    @property
    def done(self) -> bool:
        return not self.pending and not self.active

    def try_admit(self, limit: Optional[int] = None):
        """Pop (request, slot, plan) triples that fit the pool right now; the
        plan is the allocator's (``PagedKVCache.admit_prompt``: COW copy,
        shared-suffix start). ``limit`` caps the triples per call: under the
        prefix cache the serve loop admits one at a time, prefilling and
        sealing in between, so a burst of same-prompt requests shares the
        first tenant's pages."""
        admitted = []
        while self.pending and self.free_slots and \
                (limit is None or len(admitted) < limit):
            slot = self.free_slots[-1]
            req = self.pending[0]
            plan = self.kv.admit_prompt(slot, req.prompt,
                                        pad_positions=self.prompt_pad)
            if plan is None:
                break                           # pool dry: wait for release
            self.free_slots.pop()
            self.dirty_slots = [s for s in self.dirty_slots if s != slot]
            self.pending.popleft()
            self.events.emit('admit', step=self.step_no, rid=req.rid,
                             slot=slot,
                             retries=self._retries.get(req.rid, 0),
                             shared=plan['shared'],
                             prefill_start=plan['prefill_start'])
            admitted.append((req, slot, plan))
        return admitted

    def seed(self, req: Request, slot: int, first_token: int) -> None:
        self._admit_seq += 1
        self.active[slot] = _SlotState(req=req, pos=len(req.prompt),
                                       tokens=[int(first_token)],
                                       admit_seq=self._admit_seq)
        self._maybe_finish(slot, int(first_token))

    def grow_for_decode(self) -> None:
        """Back every active slot's next write position with a page,
        preempting youngest-first when the pool runs dry."""
        for slot in sorted(self.active,
                           key=lambda s: self.active[s].admit_seq):
            st = self.active.get(slot)
            if st is None:
                continue            # preempted by an earlier iteration
            if st.pos // self.kv.page_size >= self.kv.max_blocks:
                raise ValueError(
                    f'request {st.req.rid} at pos {st.pos} exceeds the '
                    f'block-table width ({self.kv.max_blocks} blocks * '
                    f'{self.kv.page_size} positions); size max_blocks to '
                    f'the longest admissible sequence')
            while slot in self.active and not self.kv.ensure(slot, st.pos):
                self._preempt_youngest(exclude=slot)

    def _preempt_youngest(self, exclude: Optional[int] = None) -> None:
        """Preempt the youngest lane other than the grower ``exclude``; the
        grower yields itself only when it is the last lane."""
        others = [s for s in self.active if s != exclude]
        victim = (max(others, key=lambda s: self.active[s].admit_seq)
                  if others else exclude)
        self._requeue(victim, kind='preempt')

    def force_preempt(self) -> bool:
        """Chaos hook (preemption storm): preempt the youngest active lane
        unconditionally. False when nothing is active."""
        if not self.active:
            return False
        self._preempt_youngest()
        return True

    def quarantine(self, slot: int) -> List[int]:
        """Poisoned lane: release-and-requeue it and return the pages safe
        to scrub now, before the free list hands them out again."""
        self.kv.defer_scrub(slot)
        self._requeue(slot, kind='quarantine')
        return self.kv.drain_scrub_queue()

    def _requeue(self, victim: int, *, kind: str) -> None:
        """Release ``victim`` and requeue its request at the queue front
        (recompute-style), unless its retry budget is spent."""
        st = self._release_slot(victim, reason=kind)
        self.events.emit(kind, step=self.step_no, rid=st.req.rid,
                         slot=victim, pos=st.pos)
        r = self._retries.get(st.req.rid, 0) + 1
        self._retries[st.req.rid] = r
        if self.retry_budget is not None and r > self.retry_budget:
            self._terminal(st.req, 'fail', reason='retry_budget', retries=r)
        else:
            self.pending.appendleft(st.req)
            self.events.emit('retry', step=self.step_no, rid=st.req.rid,
                             attempt=r)

    def aged_out(self) -> dict:
        """``slot -> physical pages`` that just crossed the hot-window
        boundary (int8 tier only). Call once after admissions and
        :meth:`grow_for_decode`, before the decode step, which reads these
        pages as cold. The tracker advances on this call."""
        if self.tier is None:
            return {}
        out: dict = {}
        for slot, st in self.active.items():
            pages = self.tier.aged_out(slot, st.pos, self.kv.tables[slot])
            if pages:
                out[slot] = pages
        return out

    def aged_out_pages(self) -> List[int]:
        """Flat-list view of :meth:`aged_out` (the tracker advances)."""
        return [p for ps_ in self.aged_out().values() for p in ps_]

    def step_vectors(self):
        """(token, pos) vectors for the decode step; idle slots get (0, 0)."""
        toks = np.zeros((self.kv.slots,), np.int32)
        pos = np.zeros((self.kv.slots,), np.int32)
        for slot, st in self.active.items():
            toks[slot] = st.tokens[-1]
            pos[slot] = st.pos
        return toks, pos

    def absorb(self, tok_np: np.ndarray) -> None:
        """Fold one decode step's tokens back into the slot states."""
        for slot in list(self.active):
            st = self.active[slot]
            tok = int(tok_np[slot])
            st.tokens.append(tok)
            st.pos += 1
            self._maybe_finish(slot, tok)

    def _maybe_finish(self, slot: int, tok: int) -> None:
        st = self.active.get(slot)
        if st is None:
            return
        hit_eos = self.eos_id is not None and tok == self.eos_id
        if hit_eos or len(st.tokens) >= st.req.target_gen:
            self._release_slot(slot, reason='finished')
            self.completed.append(st)
            self._forget(st.req.rid)
            self.events.emit('finish', step=self.step_no, rid=st.req.rid,
                             slot=slot, tokens=len(st.tokens))


def _refuse_continuous(arch: str, *, smoke: bool, tp: int,
                       prequantize: bool, kv_quant: bool, prefix_cache: bool,
                       chunk_prefill, faults, attn_impl: str):
    """Every refusal of a continuous serve, before anything is drawn or
    spawned; returns the config."""
    cfg = configs.get(arch, smoke=smoke)
    if cfg.input_kind != 'tokens':
        raise ValueError(f'--continuous schedules token streams; {arch} '
                         f'has input_kind={cfg.input_kind} (the stubbed '
                         f'frontend cannot requeue/re-prefill non-token '
                         f'prompts)')
    _refuse_mla_prequantize(arch, cfg, prequantize)
    _refuse_hybrid_prequantize(arch, cfg, prequantize)
    _refuse_recurrent_paging(arch, cfg, kv_quant, prefix_cache,
                             chunk_prefill)
    _refuse_kernel_fault(faults)
    sharding.validate_serve_tp(cfg, tp)
    _check_attn_impl(attn_impl)
    return cfg


#: the arguments that cannot cross a process boundary or that only rank 0
#: acts on; the other ranks run with these defaults
_LEAD_ONLY = dict(step_hook=None, registry=None, metrics_out=None,
                  trace=None, quiet=True)


def serve_continuous_group(runs: List[dict], *, tp: int,
                           device=None) -> List[dict]:
    """Serve each of ``runs`` (keyword arguments of
    :func:`serve_continuous`, without ``tp`` and ``device``) in turn on one
    group of ``tp`` ranks, started once for all of them; returns rank 0's
    reports. Rank r runs on ``cuda:(r % device_count)`` or, with
    ``device='cpu'``, on the CPU (``distributed/ranks.py``: ``nccl`` when
    every rank has a card of its own, else ``gloo``). Every refusal and
    the memory check of all ranks on each card come before the spawn,
    and the kernels are built here once, so the ranks load them built.
    ``faults`` and ``request_stream`` are pickled to every rank (a seeded
    injector draws the same faults in each); see :data:`_LEAD_ONLY` for
    what only rank 0 gets."""
    placed = ranks.placement(tp, device)
    lead, rest = serve_jobs(runs, placed)
    return ranks.run(lead, placed, worker_jobs=rest)


def serve_jobs(runs: List[dict], placed) -> tuple:
    """(rank 0's jobs, the other ranks' jobs) that serve ``runs`` on the
    group ``placed`` (``ranks.placement``'s result), for ``ranks.run``
    alone or beside other jobs: every run refused or checked for memory
    here, before any spawn, and the kernels built."""
    devs = placed[0]
    tp = len(devs)
    defaults = {k: p.default for k, p in
                inspect.signature(serve_continuous).parameters.items()
                if p.default is not p.empty}
    lead, rest = [], []
    for run in runs:
        run = dict(run)
        a = dict(defaults, **run)
        cfg = _refuse_continuous(
            a['arch'], smoke=a['smoke'], tp=tp, prequantize=a['prequantize'],
            kv_quant=a['kv_quant'], prefix_cache=a['prefix_cache'],
            chunk_prefill=a['chunk_prefill'], faults=a['faults'],
            attn_impl=a['attn_impl'])
        if devs[0].type == 'cuda' and a['params'] is None:
            max_blocks = -(-(a['prompt_len'] + a['gen_len'])
                           // a['page_size'])
            _refuse_oversize_tp(
                cfg, devs, a['mode'], a['prequantize'], a['compute_dtype'],
                dict(batch=a['slots'], page_size=a['page_size'],
                     num_pages=(a['num_pages']
                                or 1 + a['slots'] * max_blocks),
                     max_blocks=max_blocks,
                     kv_dtype='int8' if a['kv_quant'] else None,
                     hot_window=a['hot_window']))
        # the rank registers the config where it is not (a cut registered
        # at run time lives only in this process)
        run['cfgs'] = (configs.get(run['arch']),
                       configs.get(run['arch'], smoke=True))
        lead.append(('repro_torch.launch.serve:_serve_rank', run))
        rest.append(('repro_torch.launch.serve:_serve_rank',
                     dict(run, **_LEAD_ONLY)))
    if devs[0].type == 'cuda':
        build.build()
    return lead, rest


def _serve_rank(shard: ranks.Shard, *, cfgs, **run) -> dict:
    """One rank's serve of a :func:`serve_continuous_group` run."""
    full, smoke = cfgs
    if full.name not in configs_base.names():
        configs_base.register(full, smoke)
    return serve_continuous(**run, tp=shard.tp, device=shard.device,
                            _shard=shard)


def _rank_view(shard: ranks.Shard, launches0: dict, calls0: dict,
               outputs: dict) -> dict:
    """The group's part of the report: each rank's device, kernel
    launches and collectives since its serve began, gathered on every rank
    (one ``gather_objects``, after the steps and counted apart from them),
    and every rank's tokens held to rank 0's."""
    mine = dict(rank=shard.rank, device=str(shard.device),
                launches={k: v - launches0[k]
                          for k, v in build.LAUNCHES.items()},
                collectives={k: collectives.CALLS[k] - calls0[k]
                             for k in collectives.SERVING})
    views = collectives.gather_objects(dict(mine, outputs=outputs),
                                       shard.group)
    for view in views[1:]:
        if view['outputs'] != outputs:
            raise RuntimeError(
                f'tensor-parallel rank {view["rank"]} served other tokens '
                f'than rank 0: the ranks\' replicated logits diverged')
    return dict(backend=shard.backend, collectives=mine['collectives'],
                ranks=[{k: v for k, v in view.items() if k != 'outputs'}
                       for view in views])


def _ragged_stream(n_requests: int, prompt_len: int, gen_len: int,
                   prompts: np.ndarray) -> List[Request]:
    """Deterministic heterogeneous request stream: prompt lengths in
    [~half, prompt_len], generation budgets in [~half, gen_len]."""
    lo_p = max(4, prompt_len // 2)
    lo_g = max(2, gen_len // 2)
    reqs = []
    for i in range(n_requests):
        plen = lo_p + (i * 5) % max(1, prompt_len - lo_p + 1)
        glen = lo_g + (i * 3) % max(1, gen_len - lo_g + 1)
        reqs.append(Request(rid=i, prompt=np.asarray(prompts[i, :plen]),
                            target_gen=glen))
    return reqs


def serve_continuous(arch: str, *, smoke: bool = True, slots: int = 4,
                     n_requests: int = 8, prompt_len: int = 32,
                     gen_len: int = 32, page_size: int = 8,
                     num_pages: Optional[int] = None, mode: str = 'bf16',
                     prequantize: bool = False, seed: int = 0,
                     noise_seed: int = 0, attn_impl: str = 'flash',
                     tp: int = 1,
                     greedy: bool = True, temperature: float = 1.0,
                     top_k: int = 0,
                     eos_id: Optional[int] = None,
                     kv_quant: bool = False, hot_window: int = 2,
                     prefix_cache: bool = False,
                     chunk_prefill: Optional[int] = None,
                     shared_prefix: Optional[int] = None,
                     request_stream: Optional[List[Request]] = None,
                     deadline: Optional[int] = None,
                     retry_budget: Optional[int] = 8,
                     max_queue: Optional[int] = None,
                     faults: Optional[faults_mod.FaultInjector] = None,
                     step_hook=None,
                     metrics: bool = True,
                     metrics_out: Optional[str] = None,
                     trace: Optional[str] = None,
                     registry=None,
                     max_steps: Optional[int] = None,
                     quiet: bool = False,
                     device=None, compute_dtype=torch.bfloat16,
                     params: Optional[dict] = None,
                     _shard: Optional[ranks.Shard] = None) -> dict:
    """Serve a stream of requests end to end (admit, decode, evict,
    re-admit) on ``device`` (default: the CUDA card; ``'cpu'`` runs the
    kernels' plain versions). ``compute_dtype`` is the activation and KV
    pool dtype. ``greedy=False`` samples every first and decoded token
    (``temperature``, ``top_k``; generator seeded ``seed + 1``).

    ``kv_quant`` adds the int8 KV tier: pages older than ``hot_window``
    pages are quantized as they age out (``hot_window >= max_blocks``
    never reads the tier). ``prefix_cache`` shares sealed prompt pages by
    content; ``chunk_prefill`` C prefills every admission in C-token chunks
    (prefix hits always take chunks, of the page size by default);
    ``shared_prefix`` N makes every synthetic prompt open with the same N
    tokens. ``params`` (the port's f32 param tree on ``device``, e.g.
    from ``model.params_from_numpy``) replaces the seeded random init.
    ``noise_seed`` seeds ``analog_sim``'s draws, as in :func:`serve`.
    ``step_hook(sched, kv, cache)`` runs after every absorbed step;
    ``max_steps`` caps the scheduler steps (the run then raises as
    stalled).

    Robustness: ``faults`` (a ``runtime.faults.FaultInjector``) applies its
    faults at the scheduler's edges in the reference's order: mangled
    prompts at submission, a pool squeeze and a cancellation as each step
    opens, a preemption storm after admission, dropped quantize chunks
    (the pages stay zero in the int8 tier; their requests are marked
    ``touched``), a NaN pool page before the decode and a NaN logits row
    after it. Every step the ``logits_health`` sentinel quarantines lanes
    with non-finite logits (pages scrubbed, request requeued). A
    ``kernel_fault`` is refused (:func:`_refuse_kernel_fault`).

    Recurrent configs (:func:`_refuse_recurrent_paging` refuses what they
    cannot serve): each admission zeroes the slot's state rows, prefills
    a batch-1 copy of them (``layouts.slice_state_slot``) and writes it
    back (``merge_state_slot``); released slots' rows are zeroed before
    the next decode step. A pure SSM has no pool: no tail zeroing, scrub or
    page poisoning.

    Observability: ``metrics=True`` threads ``runtime.telemetry.
    ServeTelemetry`` through the loop (span histograms from the event log,
    scheduler/pool/tier gauges, the hardware model's per-step energy and
    traffic; the report gains ``telemetry`` and ``telemetry_summary``, and
    ``metrics_out`` writes the snapshot, Prometheus text for a ``.prom``
    name, JSON otherwise); ``trace`` writes a Chrome trace of the run;
    ``registry`` takes a ``MetricsRegistry`` to fill. ``metrics=False``
    and no ``trace`` skip every hook. No hook reads the device: the max
    |logit| gauge keeps the sentinel's device scalar until the end.

    Tensor parallelism: ``tp`` N > 1 serves on N rank processes
    (:func:`serve_continuous_group`; this process is rank 0 and returns the
    report): each rank holds its heads of the attention projections and
    its part of the GQA pools, every other weight whole, and gathers the
    heads once a layer; the report adds the group's ``backend`` and each
    rank's device, kernel launches and collectives (``ranks``), and
    ``collectives``, rank 0's calls in its steps. ``step_hook``,
    ``registry``, ``metrics_out`` and ``trace`` act on rank 0 only.
    ``_shard`` is set by the rank job alone.

    Pools are updated in place. Returns the reference's report keys.
    Only token streams are scheduled: qwen2-vl's embeddings and musicgen's
    codebook grids are refused, as the reference refuses them, before
    anything is drawn (serve them with :func:`serve`)."""
    call = dict(locals())       # the arguments, for the ranks' jobs
    cfg = _refuse_continuous(arch, smoke=smoke, tp=tp,
                             prequantize=prequantize, kv_quant=kv_quant,
                             prefix_cache=prefix_cache,
                             chunk_prefill=chunk_prefill, faults=faults,
                             attn_impl=attn_impl)
    if tp > 1 and _shard is None:
        run = {k: v for k, v in call.items()
               if k not in ('tp', 'device', '_shard')}
        return serve_continuous_group([run], tp=tp, device=device)[0]
    dev = device_mod.resolve(device) if _shard is None else _shard.device
    launches0, calls0 = dict(build.LAUNCHES), dict(collectives.CALLS)
    yoco = YocoConfig(mode=mode, noise_seed=noise_seed,
                      compute_dtype=compute_dtype)
    rt = ModelRuntime(attn_impl=attn_impl, compute_dtype=compute_dtype,
                      tp_group=None if _shard is None else _shard.group)
    max_seq = prompt_len + gen_len
    max_blocks = -(-max_seq // page_size)
    if num_pages is None:
        num_pages = 1 + slots * max_blocks      # garbage page + full lanes
    if max_blocks > num_pages - 1:
        raise ValueError(f'pool too small: a full {max_seq}-token sequence '
                         f'needs {max_blocks} pages, pool has '
                         f'{num_pages - 1} allocatable')
    kv = kvc.PagedKVCache(num_pages, page_size, max_blocks, slots,
                          prefix_cache=prefix_cache)
    events = faults_mod.EventLog()
    telem = None
    if metrics or trace:
        telem = telemetry_mod.ServeTelemetry(
            cfg, slots=slots, page_size=page_size, kv_quant=kv_quant,
            hot_window=hot_window, tp=tp, metrics=metrics,
            trace_path=trace, registry=registry)
        telem.attach(events)
    injector = faults
    sched = ContinuousScheduler(kv, prompt_pad=prompt_len, eos_id=eos_id,
                                hot_window=hot_window if kv_quant else None,
                                retry_budget=retry_budget,
                                max_queue=max_queue,
                                vocab_size=cfg.vocab_size, events=events)

    params = _serving_params(cfg, params, dev, seed=seed, mode=mode,
                             prequantize=prequantize,
                             compute_dtype=compute_dtype, shard=_shard)
    if request_stream is None:
        dc = synthetic.for_arch(cfg, global_batch=max(n_requests, 1),
                                seq_len=prompt_len)
        prompts = synthetic.make_batch(dc, 0)['inputs'].numpy()
        if shared_prefix:
            # every prompt opens with the same "system prompt"
            prompts = prompts.copy()
            prompts[:, :shared_prefix] = prompts[0, :shared_prefix]
        stream = _ragged_stream(n_requests, prompt_len, gen_len, prompts)
    else:
        stream = request_stream
        n_requests = len(request_stream)
    for req in stream:
        req.ttl_steps = deadline
        if injector is not None:
            mangled = injector.mangle(req, prompt_pad=prompt_len,
                                      vocab=cfg.vocab_size)
            if mangled is not req:
                events.emit('fault', step=0, rid=req.rid,
                            fault='mangle_prompt',
                            plen=len(mangled.prompt))
                req = mangled
        sched.submit(req)

    cache = model_mod.init_paged_cache_tree(
        cfg, slots, num_pages=num_pages, page_size=page_size,
        max_blocks=max_blocks, dtype=compute_dtype,
        kv_dtype='int8' if kv_quant else None, hot_window=hot_window,
        device=dev, tp=tp)
    n_pages_quantized = 0
    n_pages_quant_dropped = 0
    has_recurrent = model_mod._recurrent(cfg)
    has_pool = cfg.family != 'ssm'      # a pure SSM's tree has no fp pool

    def scrub_pages(cache, pages):
        if not pages or not has_pool:
            return cache
        return layouts_mod.scrub_tree_pages(cache, pages)

    def in_page_chunks(fn, cache, pages):
        """Apply ``fn(cache, (max_blocks,) pages)`` over an arbitrary-length
        page list in fixed-width chunks padded with the garbage page."""
        while pages:
            chunk, pages = pages[:max_blocks], pages[max_blocks:]
            idx = np.zeros((max_blocks,), np.int64)
            idx[:len(chunk)] = chunk
            cache = fn(cache, torch.from_numpy(idx).to(dev))
        return cache

    def quantize_aged_out(cache):
        nonlocal n_pages_quantized, n_pages_quant_dropped
        by_slot = sched.aged_out()
        pages = [p for ps_ in by_slot.values() for p in ps_]
        if prefix_cache:
            # a sealed page ages out of every owner's hot window, but its
            # int8 twin is content-addressed like the page: quantize it the
            # first time only (release/eviction clears the mark); the
            # dict dedupes same-step age-outs of a burst-admitted prefix
            pages = [p for p in dict.fromkeys(pages)
                     if p not in kv.quantized_pages]
        if pages and injector is not None and injector.drop_quant_now():
            # the tracker already advanced: these pages stay zero in the
            # int8 tier, so their requests' outputs may legitimately change
            rids = sorted(sched.active[s].req.rid for s in by_slot)
            injector.touched.update(rids)
            events.emit('fault', step=sched.step_no, fault='drop_quant',
                        pages=len(pages), rids=rids)
            n_pages_quant_dropped += len(pages)
            return cache
        n_pages_quantized += len(pages)
        if prefix_cache:
            kv.quantized_pages.update(pages)
        return in_page_chunks(kvq.quantize_tree_pages, cache, pages)

    prefill_fn = SS.make_prefill_step(cfg, yoco, rt)
    decode_fn = SS.make_decode_step(cfg, yoco, rt, greedy=greedy,
                                    temperature=temperature, top_k=top_k)
    sample_gen = torch.Generator(device=dev).manual_seed(seed + 1)

    def next_tokens(logits):
        """The first token of an admission, by the step's rule."""
        if greedy:
            return torch.argmax(logits, dim=-1)
        return SS.sample_tokens(logits, sample_gen, temperature=temperature,
                                top_k=top_k)

    # chunked prefill: prefix hits must take it (a monolithic padded prefill
    # would rewrite the shared pages they acquired); misses take it only
    # when chunk_prefill asks for it
    chunk_c = max(1, chunk_prefill if chunk_prefill is not None
                  else page_size)
    chunk_fn = (SS.make_chunk_prefill_step(cfg, yoco, rt)
                if prefix_cache or chunk_prefill is not None else None)

    def run_prefill(part, req, slot, plan):
        """Admission prefill following the allocator's plan: copy-on-write
        the boundary page, compute only [prefill_start, plen) (in chunks
        when the plan or chunk_prefill asks), then zero the padded tail
        rows of the last owned page before sealing can publish them."""
        plen = len(req.prompt)
        if plan['cow'] is not None:
            part = layouts_mod.copy_tree_pages(part, *plan['cow'])
        if chunk_fn is not None and (plan['hit']
                                     or chunk_prefill is not None):
            lim = torch.tensor([plen], dtype=torch.int32, device=dev)
            for off in range(plan['prefill_start'], plen, chunk_c):
                ck = np.zeros((1, chunk_c), np.int32)
                seg = req.prompt[off:off + chunk_c]
                ck[0, :len(seg)] = seg
                logits, part = chunk_fn(
                    params, dict(inputs=torch.from_numpy(ck).to(dev)),
                    torch.tensor([off], dtype=torch.int32, device=dev), lim,
                    part)
        else:
            pad = np.zeros((1, prompt_len), np.int32)
            pad[0, :plen] = req.prompt
            logits, part = prefill_fn(
                params, dict(inputs=torch.from_numpy(pad).to(dev)), part,
                torch.tensor([plen - 1], device=dev))
        stop = int(kv.counts[slot]) * page_size
        if has_pool and plen < stop:
            part = layouts_mod.zero_tree_tail(part, kv.tables[slot], plen,
                                              stop)
        return logits, part

    steps = busy_slot_steps = 0
    peak_pages = 0
    t_prefill = 0.0

    def _admit_one(req, slot, plan):
        nonlocal cache, t_prefill
        tp = time.perf_counter()
        cache = layouts_mod.reset_state_slots(cache, [slot])
        part = layouts_mod.slice_state_slot(
            kvc.with_block_tables(cache, kv.tables[slot:slot + 1]), slot)
        logits, part = run_prefill(part, req, slot, plan)
        cache = layouts_mod.merge_state_slot(cache, part, slot)
        # sealing right after prefill lets the next admission share it
        kv.seal_slot(slot, req.prompt)
        first = int(next_tokens(logits)[0])             # synchronises
        tp_end = time.perf_counter()
        t_prefill += tp_end - tp
        events.annotate_last('admit', req.rid, prefill_s=tp_end - tp)
        if telem is not None:
            telem.prefill(rid=req.rid, slot=slot, t_start=tp, t_end=tp_end)
        sched.seed(req, slot, first)

    t0 = time.time()
    limit = max_steps if max_steps is not None else \
        n_requests * (prompt_len + gen_len) * 4 + 64
    while not sched.done and steps < limit:
        t_step0 = time.perf_counter()
        sched.begin_step(steps)
        if telem is not None:
            telem.begin_step(steps, t_step0)
        if injector is not None:
            injector.begin_step(steps)
            # pool squeeze: the injector holds free pages hostage; the
            # scheduler sees a smaller pool and must queue or preempt
            delta = injector.squeeze_pages() - len(kv.reserved)
            if delta > 0:
                if kv.reserve_pages(delta):
                    events.emit('fault', step=steps, fault='pool_squeeze',
                                held=len(kv.reserved))
            elif delta < 0:
                kv.unreserve_pages(-delta)
            # mid-stream cancellation of a live (pending or active) rid
            want_cancel = injector.cancel_now()
            if want_cancel:
                live = sorted({st.req.rid for st in sched.active.values()}
                              | {r.rid for r in sched.pending})
                rid = want_cancel if not isinstance(want_cancel, bool) \
                    else (injector.pick(live) if live else None)
                if rid is not None:
                    sched.cancel(rid)
        if has_pool:
            cache = scrub_pages(cache, kv.drain_scrub_queue())
        # the prefix cache admits one at a time (prefill and seal between
        # admissions) so same-step bursts share the first tenant's pages
        admit_limit = 1 if prefix_cache else None
        while True:
            batch = sched.try_admit(limit=admit_limit)
            for req, slot, plan in batch:
                _admit_one(req, slot, plan)
            if not batch or admit_limit is None:
                break
        if sched.done:
            break
        if injector is not None:
            # preemption storm: force-preempt lanes (fresh admissions too)
            for _ in range(injector.storm_count()):
                if sched.force_preempt():
                    events.emit('fault', step=steps, fault='preempt_storm')
        sched.grow_for_decode()
        if has_recurrent and sched.dirty_slots:
            # released lanes decode against zeroed state until re-admission
            cache = layouts_mod.reset_state_slots(
                cache, sorted(set(sched.dirty_slots)))
        sched.dirty_slots.clear()
        if kv_quant:
            # pages that just left the hot window become int8 before the
            # step reads them as cold (fresh admissions included)
            tq = time.perf_counter()
            quantized_before = n_pages_quantized
            cache = quantize_aged_out(cache)
            if telem is not None and n_pages_quantized > quantized_before:
                telem.phase('quantize', tq, time.perf_counter(),
                            pages=n_pages_quantized - quantized_before)
        if (injector is not None and has_pool and sched.active
                and injector.poison_page_now()):
            # NaN an owned fp pool page (a corrupted in-memory read): the
            # sentinel below must catch every lane that reads it; a shared
            # page poisons every owner
            cand = [(s, int(p)) for s in sorted(sched.active)
                    for p in kv.tables[s, :int(kv.counts[s])]]
            if cand:
                slot, page = injector.pick(cand)
                cache = layouts_mod.poison_tree_pages(cache, [page])
                owners = kv.owners_of(page) if prefix_cache else [slot]
                events.emit('fault', step=steps, fault='poison_page',
                            slot=slot, page=page,
                            rid=sched.active[slot].req.rid, owners=owners)
        poison_slot = None
        if (injector is not None and sched.active
                and injector.poison_logits_now()):
            poison_slot = injector.pick(sorted(sched.active))
            events.emit('fault', step=steps, fault='poison_logits',
                        slot=poison_slot,
                        rid=sched.active[poison_slot].req.rid)
        peak_pages = max(peak_pages, kv.used_pages)
        if telem is not None:
            # gauges and the energy meter over the step's actual batch
            telem.sample(sched, kv)
        toks, pos = sched.step_vectors()
        cache = kvc.with_block_tables(cache, kv.tables)
        busy_slot_steps += len(sched.active)
        active_now = sorted(sched.active)
        td0 = time.perf_counter()
        step_args = (params, torch.from_numpy(toks).to(dev),
                     torch.from_numpy(pos).to(dev), cache)
        tok, logits, cache = decode_fn(*step_args) if greedy else \
            decode_fn(*step_args, sample_gen)
        if telem is not None:
            telem.decode(td0, time.perf_counter(), active_now)
        if poison_slot is not None:
            # the poisoned row, NaN'd on the device before the sentinel
            logits[poison_slot] = float('nan')
        ok, logit_max = SS.logits_health(logits)
        if telem is not None:
            telem.logits_gauge(logit_max)       # a device scalar, kept
        ok = ok.cpu().numpy()
        for slot in [s for s in sorted(sched.active) if not ok[s]]:
            # quarantine BEFORE absorb, scrub before the pages are reused
            tsb = time.perf_counter()
            pages = sched.quarantine(slot)
            cache = scrub_pages(cache, pages)
            if telem is not None:
                telem.phase('scrub', tsb, time.perf_counter(), slot=slot,
                            pages=len(pages))
        sched.absorb(tok.cpu().numpy())
        steps += 1
        if step_hook is not None:
            step_hook(sched, kv, cache)
        if telem is not None:
            telem.step_done(time.perf_counter())
    if dev.type == 'cuda':
        torch.cuda.synchronize(dev)
    wall = time.time() - t0
    if not sched.done:
        raise RuntimeError(f'continuous serve stalled after {steps} steps: '
                           f'{len(sched.pending)} pending, '
                           f'{len(sched.active)} active')

    outputs = {st.req.rid: st.tokens
               for st in sorted(sched.completed, key=lambda s: s.req.rid)}
    rank_view = None
    if _shard is not None:
        # counted before the check below, which is outside the steps
        rank_view = _rank_view(_shard, launches0, calls0, outputs)
    term = events.terminal_accounting()
    tcounts = Counter(term.values())
    evc = events.counts()
    out = dict(
        requests=n_requests,
        completed=tcounts.get('finish', 0),
        failed=tcounts.get('fail', 0),
        rejected=tcounts.get('reject', 0),
        cancelled=tcounts.get('cancel', 0),
        steps=steps,
        decode_tokens=busy_slot_steps,
        wall_s=round(wall, 4),
        prefill_s=round(t_prefill, 4),
        tokens_per_s=round(busy_slot_steps / max(wall - t_prefill, 1e-9), 1),
        slot_utilization=round(busy_slot_steps / max(steps * slots, 1), 3),
        peak_pages=peak_pages,
        total_pages=num_pages - 1,
        page_size=page_size,
        preempted=evc.get('preempt', 0),
        quarantined=evc.get('quarantine', 0),
        attn_impl=attn_impl,
        attn_impl_effective=attn_impl,
        tp=tp,
        kv_quant=bool(kv_quant),
        hot_window=hot_window if kv_quant else None,
        pages_quantized=n_pages_quantized,
        pages_quant_dropped=n_pages_quant_dropped,
        prefix=(dict(hits=kv.prefix_hits, misses=kv.prefix_misses,
                     evictions=kv.prefix_evictions,
                     cow_copies=kv.cow_copies,
                     cached_pages=kv.cached_pages,
                     shared_pages=kv.shared_pages)
                if prefix_cache else None),
        chunk_prefill=(chunk_c if prefix_cache or chunk_prefill is not None
                       else None),
        events=evc,
        faults=(dict(injector.counts) if injector is not None else None),
        decode_compilations=None,
        out_lens={r: len(t) for r, t in outputs.items()},
        sample={r: t[:4] for r, t in list(outputs.items())[:4]},
        device=str(dev),
    )
    if rank_view is not None:
        out.update(rank_view)
    snap = telem.finish(events) if telem is not None else None
    if snap is not None:
        out['telemetry_summary'] = telemetry_mod.summarize(snap)
    if not quiet:
        print(json.dumps(out))
    out['outputs'] = outputs
    out['event_log'] = events.records()
    out['terminal'] = term
    if snap is not None:
        out['telemetry'] = snap
        if metrics_out:
            with open(metrics_out, 'w') as f:
                if metrics_out.endswith('.prom'):
                    f.write(telem.reg.render_prometheus())
                else:
                    json.dump(snap, f, indent=1)
            out['metrics_out'] = metrics_out
    if telem is not None:
        trace_path = telem.close_trace()
        if trace_path is not None:
            out['trace'] = trace_path
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(
        description='Static and continuous paged serving on the CUDA card '
                    '(PyTorch port of repro.launch.serve).')
    ap.add_argument('--arch', default='stablelm-1.6b')
    ap.add_argument('--smoke', action=argparse.BooleanOptionalAction,
                    default=True,
                    help='--no-smoke serves the published width')
    ap.add_argument('--batch', type=int, default=4)
    ap.add_argument('--prompt-len', type=int, default=32)
    ap.add_argument('--gen-len', type=int, default=32)
    ap.add_argument('--mode', default='bf16',
                    choices=['bf16', 'qat', 'w8a8', 'analog_sim'])
    ap.add_argument('--prequantize', action='store_true')
    ap.add_argument('--attn-impl', default=None, choices=['einsum', 'flash'],
                    help='default: flash under --continuous (kernels K1, '
                         'K5, K6; K8-K10 on MLA), einsum otherwise (flash: '
                         'kernel K7)')
    ap.add_argument('--ragged', action='store_true',
                    help='per-request prompt lengths (static path)')
    ap.add_argument('--sample', action='store_true',
                    help='temperature/top-k sampling instead of greedy')
    ap.add_argument('--temperature', type=float, default=1.0)
    ap.add_argument('--top-k', type=int, default=0)
    ap.add_argument('--continuous', action='store_true',
                    help='continuous batching over a paged KV cache')
    ap.add_argument('--slots', type=int, default=4)
    ap.add_argument('--requests', type=int, default=8)
    ap.add_argument('--page-size', type=int, default=8)
    ap.add_argument('--num-pages', type=int, default=None)
    ap.add_argument('--eos-id', type=int, default=None)
    ap.add_argument('--tp', type=int, default=1,
                    help='continuous mode: head-parallel tensor parallelism '
                         'over N rank processes (attention projections and '
                         'GQA pools split by head, one all-gather a layer; '
                         'gloo on the CPU or ranks sharing a card, nccl on '
                         'a card each)')
    ap.add_argument('--deadline', type=int, default=None)
    ap.add_argument('--retry-budget', type=int, default=8,
                    help='-1: unlimited')
    ap.add_argument('--max-queue', type=int, default=None)
    ap.add_argument('--seed', type=int, default=0)
    ap.add_argument('--device', default=None,
                    help='default: the CUDA card; "cpu" runs the plain '
                         'versions of the kernels')
    ap.add_argument('--kv-quant', action='store_true',
                    help='hybrid-precision KV: int8 cold pages + fp hot '
                         'window')
    ap.add_argument('--hot-window', type=int, default=2,
                    help='pages kept full precision per request with '
                         '--kv-quant')
    ap.add_argument('--prefix-cache', action='store_true',
                    help='share sealed prompt pages between requests')
    ap.add_argument('--chunk-prefill', type=int, default=None, metavar='C',
                    help='prefill admissions in C-token chunks (implied '
                         'for prefix-cache hits)')
    ap.add_argument('--shared-prefix', type=int, default=None, metavar='N',
                    help='synthetic prompts share their first N tokens')
    ap.add_argument('--chaos', action='store_true',
                    help='continuous mode: serve under the default fault-'
                         'injection profile (runtime.faults.chaos_profile)')
    ap.add_argument('--chaos-seed', type=int, default=0)
    ap.add_argument('--metrics', action=argparse.BooleanOptionalAction,
                    default=True,
                    help='continuous mode: lifecycle, tier and modelled '
                         'energy metrics (--no-metrics strips every hook)')
    ap.add_argument('--metrics-out', default=None, metavar='FILE',
                    help='write the final metrics snapshot (.prom: '
                         'Prometheus text exposition, else JSON)')
    ap.add_argument('--trace', default=None, metavar='FILE',
                    help='write a Chrome-trace JSON of the run (load it at '
                         'ui.perfetto.dev)')
    args = ap.parse_args(argv)
    if args.tp != 1 and not args.continuous:
        raise ValueError('--tp serves the continuous path (--continuous); '
                         'the static serve() has no tensor parallelism, as '
                         'in the reference')
    if not args.continuous:
        return serve(args.arch, smoke=args.smoke, batch=args.batch,
                     prompt_len=args.prompt_len, gen_len=args.gen_len,
                     mode=args.mode, prequantize=args.prequantize,
                     seed=args.seed, attn_impl=args.attn_impl or 'einsum',
                     ragged=args.ragged, greedy=not args.sample,
                     temperature=args.temperature, top_k=args.top_k,
                     device=args.device)
    return serve_continuous(
        args.arch, smoke=args.smoke, slots=args.slots,
        n_requests=args.requests, prompt_len=args.prompt_len,
        gen_len=args.gen_len, page_size=args.page_size,
        num_pages=args.num_pages, mode=args.mode,
        prequantize=args.prequantize, seed=args.seed,
        attn_impl=args.attn_impl or 'flash', tp=args.tp,
        greedy=not args.sample,
        temperature=args.temperature, top_k=args.top_k, eos_id=args.eos_id,
        kv_quant=args.kv_quant, hot_window=args.hot_window,
        prefix_cache=args.prefix_cache, chunk_prefill=args.chunk_prefill,
        shared_prefix=args.shared_prefix, deadline=args.deadline,
        retry_budget=None if args.retry_budget < 0 else args.retry_budget,
        max_queue=args.max_queue,
        faults=(faults_mod.FaultInjector(seed=args.chaos_seed,
                                         profile=faults_mod.chaos_profile())
                if args.chaos else None),
        metrics=args.metrics, metrics_out=args.metrics_out, trace=args.trace,
        device=args.device)


if __name__ == '__main__':
    main()
