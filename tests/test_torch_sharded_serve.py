"""The mesh-sharded static serve (``runtime/serve_step.py::
sharded_prefill_step`` / ``sharded_decode_step``) on a 2x2 gloo rank mesh
against one device's port and the reference's ``model.prefill`` /
``decode_step``, on the CPU, in f32, on the same numpy weights (the port's
seed-0 draw).

Each row is a prefill of a (B, 6) prompt into a static cache of 12
positions and 3 greedy decode steps:

* heads split (stablelm smoke: its KV heads divide 'model'), in bf16 mode,
  w8a8 with prequantized weights, dynamic w8a8 and through kernel K7's
  plain version (``attn_impl='flash'``);
* the sequence split over 'model' (stablelm smoke with one KV head);
* a batch smaller than the dp axes (B = 1: the sequence split over
  'data', the rows replicated);
* MLA (deepseek-v3 smoke: the latent cache split on the sequence), also
  with int8 weights resident, held to one device only (the reference's
  absorbed decode fails on int8 ``w_ukv``);
* mamba2 and zamba2 smoke (the recurrent state split on channels and
  heads, zamba2's attention sites on heads).

The tokens equal one device's and the reference's; the logits are within
``ONE_DEVICE_TOL`` of one device's port (the row-parallel ``wo`` and
``w_down`` sum their f32 blocks in another order; w8a8 sums int32
accumulators and is exact) and within ``REFERENCE_TOL`` of the
reference's. Every rank returns the same tokens and logits. The
collectives a decode step makes are counted against their closed form,
and the ranks' cache blocks against the specs.

One spawned group of four gloo ranks runs every job."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.models import model as rmodel
from repro.models.model import ModelRuntime as RRuntime
from repro_torch import configs as tconfigs
from repro_torch.distributed import ranks, sharding
from repro_torch.launch import mesh as tmesh
from repro_torch.models import model as tmodel
from repro_torch.runtime import serve_step as SS

JOB = 'repro_torch.runtime.serve_step:sharded_serve_job'
PROMPT, STEPS, MAX_SEQ = 6, 3, 12
ONE_DEVICE_TOL = 2e-5
REFERENCE_TOL = 2e-4
# (name, arch, n_kv_heads or None, batch, mode, prequant, attn_impl)
ROWS = (
    ('heads', 'stablelm-1.6b', None, 4, 'bf16', False, 'einsum'),
    ('heads_prequant', 'stablelm-1.6b', None, 4, 'w8a8', True, 'einsum'),
    ('heads_w8a8', 'stablelm-1.6b', None, 4, 'w8a8', False, 'einsum'),
    ('heads_flash', 'stablelm-1.6b', None, 4, 'w8a8', True, 'flash'),
    ('seq_model', 'stablelm-1.6b', 1, 4, 'bf16', False, 'einsum'),
    ('batch_lt_dp', 'stablelm-1.6b', None, 1, 'bf16', False, 'einsum'),
    ('mla', 'deepseek-v3-671b', None, 4, 'bf16', False, 'einsum'),
    ('mla_w8a8', 'deepseek-v3-671b', None, 4, 'w8a8', False, 'einsum'),
    ('mla_prequant', 'deepseek-v3-671b', None, 4, 'w8a8', True, 'einsum'),
    ('mamba2', 'mamba2-780m', None, 4, 'bf16', False, 'einsum'),
    ('zamba2', 'zamba2-1.2b', None, 4, 'bf16', False, 'einsum'),
    ('zamba2_b1', 'zamba2-1.2b', None, 1, 'bf16', False, 'einsum'),
)
NAMES = [r[0] for r in ROWS]


def _cfgs(arch, n_kv):
    r, t = rconfigs.get(arch, smoke=True), tconfigs.get(arch, smoke=True)
    if n_kv is not None:
        r = dataclasses.replace(r, n_kv_heads=n_kv)
        t = dataclasses.replace(t, n_kv_heads=n_kv, name=f'{t.name}-kv1')
    return r, t


@functools.lru_cache(maxsize=None)
def _params(arch, n_kv):
    """The port's seed-0 draw, as the reference's tree of numpy arrays."""
    cfg = _cfgs(arch, n_kv)[1]
    return tmodel.params_to_numpy(tmodel.init_params(
        torch.Generator().manual_seed(0), cfg, device='cpu'), cfg)


def _prompts(rcfg, b):
    return np.random.default_rng(1).integers(
        0, rcfg.vocab_size, size=(b, PROMPT)).astype(np.int32)


@functools.lru_cache(maxsize=None)
def _reference(arch, n_kv, b, mode, prequant):
    """The reference's prefill and greedy decode steps, jitted, in f32:
    (tokens (STEPS + 1, B), logits (STEPS + 1, B, V)); None for MLA with
    int8 weights resident, where the reference's absorbed decode fails
    (it reads ``w_ukv`` as a float array) and the port reads the codes'
    values."""
    rcfg = _cfgs(arch, n_kv)[0]
    if prequant and rcfg.mla is not None:
        return None
    params, prompts = _params(arch, n_kv), _prompts(rcfg, b)
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)
    rt = RRuntime(compute_dtype=jnp.float32)
    p = jax.tree.map(jnp.asarray, params)
    if prequant:
        p = ryl.quantize_tree(p)
    b = prompts.shape[0]
    cache = rmodel.init_cache_tree(rcfg, b, MAX_SEQ, jnp.float32)
    prefill = jax.jit(lambda p, x, c: rmodel.prefill(
        p, dict(inputs=x), c, rcfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(
        p, t, pos, c, rcfg, yoco, rt))
    logits, cache = prefill(p, jnp.asarray(prompts), cache)
    rows, toks = [logits], [jnp.argmax(logits, -1).astype(jnp.int32)]
    for i in range(STEPS):
        logits, cache = decode(p, toks[-1], jnp.int32(PROMPT + i), cache)
        rows.append(logits)
        toks.append(jnp.argmax(logits, -1).astype(jnp.int32))
    return np.stack(toks), np.stack([np.asarray(r, np.float32)
                                     for r in rows])


@pytest.fixture(scope='module')
def served():
    jobs, refs = [], {}
    for name, arch, n_kv, b, mode, prequant, impl in ROWS:
        rcfg, tcfg = _cfgs(arch, n_kv)
        refs[name] = (tcfg, _reference(arch, n_kv, b, mode, prequant))
        jobs.append(ranks.all_ranks_job(ranks.mesh_job(
            JOB, 2, cfg=tcfg, params=_params(arch, n_kv),
            prompts=_prompts(rcfg, b), steps=STEPS,
            mode=mode, prequant=prequant, attn_impl=impl,
            compute_dtype=torch.float32, max_seq=MAX_SEQ, reference=True,
            device='cpu')))
    out = ranks.run(jobs, ranks.placement(4, 'cpu'))
    return {name: (refs[name], got) for name, got in zip(NAMES, out)}


@pytest.mark.parametrize('name', NAMES)
def test_sharded_serve_matches_one_device_and_reference(served, name):
    (cfg, ref), outs = served[name]
    r0 = outs[0]
    for o in outs[1:]:
        np.testing.assert_array_equal(o['tokens'], r0['tokens'])
        np.testing.assert_array_equal(o['logits'], r0['logits'])
    np.testing.assert_array_equal(r0['tokens'], r0['ref_tokens'])
    assert r0['logits'].shape == (STEPS + 1, r0['tokens'].shape[1],
                                  cfg.vocab_size)
    np.testing.assert_allclose(r0['logits'], r0['ref_logits'], rtol=0,
                               atol=ONE_DEVICE_TOL)
    if ref is not None:
        np.testing.assert_array_equal(r0['tokens'], ref[0])
        np.testing.assert_allclose(r0['logits'], ref[1], rtol=0,
                                   atol=REFERENCE_TOL)


def _cache_bytes(cfg, b):
    mesh = tmesh.shape_mesh(dict(data=2, model=2))
    pabs, cabs = SS.abstract_serve_state(cfg, b, MAX_SEQ, torch.float32)
    _, cspecs = SS.serve_shardings(mesh, cfg, pabs, cabs, b)
    return sharding.nbytes(sharding.zeros_blocks(cabs, cspecs, mesh,
                                                 'meta'))


@pytest.mark.parametrize('name', NAMES)
def test_rank_holds_its_cache_block(served, name):
    (cfg, _), outs = served[name]
    b = next(r[3] for r in ROWS if r[0] == name)
    _, cabs = SS.abstract_serve_state(cfg, b, MAX_SEQ, torch.float32)
    whole = sharding.nbytes(cabs)
    for o in outs:
        assert o['cache_bytes'] == _cache_bytes(cfg, b) < whole


def _decode_all_reduces(cfg, row):
    """A decode step's all-reduces on a rank of the 2x2 mesh: the
    vocab-parallel embedding's 1; per layer the row-parallel w_down (the
    hidden units are cut) and, where the KV heads are cut, wo: 1 each in
    bf16, 2 in w8a8 (the absmax MAX and the int32 sum); and per layer 2
    (the merge's MAX and SUM) where the cache's sequence is cut (over
    'model' where the KV heads do not divide it, over 'data' where the
    batch is smaller than it)."""
    _, _, n_kv, b, mode, _, _ = row
    per_row = 2 if mode == 'w8a8' else 1
    heads_cut = n_kv is None
    seq_cut = not heads_cut or b < 2
    return 1 + cfg.n_layers * (per_row * (1 + heads_cut) + 2 * seq_cut)


@pytest.mark.parametrize('name', ['heads', 'heads_prequant', 'heads_w8a8',
                                  'seq_model', 'batch_lt_dp'])
def test_decode_collectives_closed_form(served, name):
    (cfg, _), outs = served[name]
    row = next(r for r in ROWS if r[0] == name)
    got = outs[0]['calls'][1]           # the first decode step
    assert got['all_reduce'] == _decode_all_reduces(cfg, row)
    for o in outs:
        assert o['calls'][1:] == [got] * STEPS
        assert o['calls'][0]['all_gather'] == got['all_gather']
