"""One K3 quantization per distinct activation, on the CPU.

Several linears that read one activation (q/k/v, an MLP's gate and up,
MLA's w_dq and w_dkv) share its int8 codes through
``core.yoco_linear.linears``, as the reference's compiled step computes one
quantization of such an activation (XLA merges the duplicates). Here, at
smoke size, a recorder counts ``quantize_rows`` calls a forward: 4 L + 1
with ``--prequantize`` (stablelm), 4 L + 1 activations plus 7 L + 1
weights in dynamic w8a8, and on deepseek-v3's dense prefix in dynamic w8a8
(5 L + 1) + (7 L + 1) a decode step or chunk, (6 L + 1) + (8 L + 1) a
monolithic prefill. Logits and greedy tokens are bit-equal to the same
forwards with one quantization a linear (the port before the shared form),
and in f32 within 1e-4 of the jitted reference ``repro.models.model`` on
the same numpy weights (``tests/test_torch_model.py``'s tolerance)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.core import yoco_linear as ryl
from repro.models import model as rmodel
from repro.runtime import kv_cache as rkvc
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import quantize as tq
from repro_torch.models import model as tmodel
from repro_torch.runtime import layouts as tlayouts

ARCH = 'stablelm-1.6b'
MLA_ARCH = 'deepseek-v3-dense3-shared-quant-test'
B, PLEN, CHUNK, STEPS, PS = 2, 8, 4, 2, 4


@pytest.fixture(scope='module')
def mla_arch():
    """deepseek-v3 cut to its dense prefix, ``replace(..., n_layers=3,
    moe=None)``, registered in both packages for this module's tests and
    removed afterwards."""
    for base, cfgs in ((rbase, rconfigs), (tbase, tconfigs)):
        full = cfgs.get('deepseek-v3-671b')
        smoke = cfgs.get('deepseek-v3-671b', smoke=True)
        base.register(dataclasses.replace(full, name=MLA_ARCH, n_layers=3,
                                          moe=None),
                      dataclasses.replace(smoke, name=MLA_ARCH, moe=None))
    yield MLA_ARCH
    for base in (rbase, tbase):
        base._REGISTRY.pop(MLA_ARCH)
        base._SMOKE.pop(MLA_ARCH)


@functools.lru_cache(maxsize=None)
def _params_np(arch, prequant):
    p = rmodel.init_params(jax.random.key(0), rconfigs.get(arch, smoke=True))
    return jax.tree.map(np.asarray, ryl.quantize_tree(p) if prequant else p)


def _inputs(vocab):
    rng = np.random.RandomState(7)
    return (rng.randint(0, vocab, (B, PLEN)).astype(np.int32),
            rng.randint(0, vocab, (B, CHUNK)).astype(np.int32))


def _tables(w):
    perm = np.random.RandomState(1).permutation(np.arange(1, 1 + B * w))
    return perm.reshape(B, w).astype(np.int32)


W = -(-(PLEN + CHUNK + STEPS) // PS)


def _port_forwards(arch, mode, prequant):
    """f32 logits and ``quantize_rows`` calls of each forward: a monolithic
    prefill, one chunk continuing the prompt, STEPS greedy decode steps."""
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(attn_impl='flash', compute_dtype=torch.float32)
    params = tmodel.params_from_numpy(_params_np(arch, prequant), cfg, 'cpu')
    if mode == 'w8a8' and not prequant:
        params = tmodel.k_major_linear_weights(params)
    cache = tmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * W,
                                         page_size=PS, max_blocks=W,
                                         dtype=torch.float32, device='cpu')
    cache = tlayouts.with_block_tables(cache, _tables(W))
    prompt, chunk = _inputs(cfg.vocab_size)
    calls = [0]
    quantize = tq.quantize_rows

    def counted(x):
        calls[0] += 1
        return quantize(x)

    rows, counts = [], []

    def forward(fn):
        calls[0] = 0
        tq.quantize_rows = counted
        try:
            logits, new_cache = fn()
        finally:
            tq.quantize_rows = quantize
        rows.append(logits)
        counts.append(calls[0])
        return new_cache

    cache = forward(lambda: tmodel.prefill(
        params, dict(inputs=torch.from_numpy(prompt)), cache, cfg, yoco, rt))
    lim = torch.full((B,), PLEN + CHUNK, dtype=torch.int32)
    cache = forward(lambda: tmodel.prefill_chunk(
        params, dict(inputs=torch.from_numpy(chunk)),
        torch.full((B,), PLEN, dtype=torch.int32), lim, cache, cfg, yoco,
        rt))
    for i in range(STEPS):
        tok = torch.argmax(rows[-1], -1).to(torch.int32)
        pos = torch.full((B,), PLEN + CHUNK + i, dtype=torch.int32)
        cache = forward(lambda: tmodel.decode_step(params, tok, pos, cache,
                                                   cfg, yoco, rt))
    return torch.stack(rows), counts


def _one_quantization_a_linear(monkeypatch):
    """The port before the shared form: every linear quantizes its own x."""
    linears = tyl.linears

    def separate(x, ws, bs=None, cfg=tyl.DEFAULT_YOCO):
        bs = [None] * len(ws) if bs is None else bs
        return [linears(x, [w], [b], cfg)[0] for w, b in zip(ws, bs)]
    monkeypatch.setattr(tyl, 'linears', separate)


@functools.lru_cache(maxsize=None)
def _reference_forwards(arch, mode, prequant):
    """The same forwards through the jitted reference, f32."""
    cfg = rconfigs.get(arch, smoke=True)
    f32 = jnp.float32
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=f32)
    rt = rmodel.ModelRuntime(compute_dtype=f32)
    params = jax.tree.map(jnp.asarray, _params_np(arch, prequant))
    cache = rmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * W,
                                         page_size=PS, max_blocks=W,
                                         dtype=f32)
    cache = rkvc.with_block_tables(cache, jnp.asarray(_tables(W)))
    prompt, chunk = _inputs(cfg.vocab_size)
    logits, cache = jax.jit(lambda p, t, c: rmodel.prefill(
        p, dict(inputs=t), c, cfg, yoco, rt))(params, jnp.asarray(prompt),
                                             cache)
    rows = [np.asarray(logits, np.float32)]
    logits, cache = jax.jit(lambda p, t, c: rmodel.prefill_chunk(
        p, dict(inputs=t), jnp.full((B,), PLEN, jnp.int32),
        jnp.full((B,), PLEN + CHUNK, jnp.int32), c, cfg, yoco, rt))(
            params, jnp.asarray(chunk), cache)
    rows.append(np.asarray(logits, np.float32))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(
        p, t, pos, c, cfg, yoco, rt))
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        logits, cache = decode(params, tok, jnp.full(
            (B,), PLEN + CHUNK + i, jnp.int32), cache)
        rows.append(np.asarray(logits, np.float32))
    return np.stack(rows)


def _want_counts(arch, prequant, shared):
    """K3 calls of each forward (prefill, chunk, decode steps)."""
    n = tconfigs.get(arch, smoke=True).n_layers
    if arch == ARCH:
        acts = (4 if shared else 7) * n + 1
        linears = 7 * n + 1
        per = acts if prequant else acts + linears
        return [per] * (2 + STEPS)
    # MLA, dynamic: the monolithic prefill also runs w_ukv
    acts = ((6 if shared else 8) * n + 1, (5 if shared else 7) * n + 1)
    linears = (8 * n + 1, 7 * n + 1)
    return ([acts[0] + linears[0]]
            + [acts[1] + linears[1]] * (1 + STEPS))


CASES = [('stablelm', True), ('stablelm', False), ('mla', False)]


@pytest.mark.parametrize('which,prequant', CASES,
                         ids=['stablelm_prequant', 'stablelm_dynamic',
                              'mla_dynamic'])
def test_one_quantization_per_distinct_activation(request, monkeypatch,
                                                  which, prequant):
    arch = ARCH if which == 'stablelm' else request.getfixturevalue(
        'mla_arch')
    got, counts = _port_forwards(arch, 'w8a8', prequant)
    assert counts == _want_counts(arch, prequant, shared=True)
    _one_quantization_a_linear(monkeypatch)
    before, counts_before = _port_forwards(arch, 'w8a8', prequant)
    assert counts_before == _want_counts(arch, prequant, shared=False)
    # the codes are the same tensor: logits and tokens bit for bit
    assert torch.equal(got, before)
    assert torch.equal(got.argmax(-1), before.argmax(-1))


def test_stablelm_full_width_counts_are_the_gates():
    """At stablelm's 24 layers the shared form gives the launch gates of
    the full-width runs: 97 a forward with --prequantize, 266 dynamic."""
    n = tconfigs.get(ARCH).n_layers
    assert (4 * n + 1, 4 * n + 1 + 7 * n + 1) == (97, 266)


@pytest.mark.parametrize('which,prequant', CASES,
                         ids=['stablelm_prequant', 'stablelm_dynamic',
                              'mla_dynamic'])
def test_shared_quantization_matches_reference(request, which, prequant):
    arch = ARCH if which == 'stablelm' else request.getfixturevalue(
        'mla_arch')
    got, _ = _port_forwards(arch, 'w8a8', prequant)
    want = _reference_forwards(arch, 'w8a8', prequant)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4, atol=1e-4)
    np.testing.assert_array_equal(got.numpy().argmax(-1), want.argmax(-1))


def test_linears_takes_biases_and_bf16_matmuls():
    """``linears`` adds each weight's bias (None skips it) and, in bf16,
    runs one matmul a weight with no quantization."""
    rng = np.random.RandomState(3)
    x = torch.from_numpy(rng.randn(2, 3, 16).astype(np.float32))
    ws = [torch.from_numpy(rng.randn(16, n).astype(np.float32))
          for n in (8, 12)]
    b = torch.from_numpy(rng.randn(8).astype(np.float32))
    for cfg in (tyl.YocoConfig(mode='w8a8', compute_dtype=torch.float32),
                tyl.YocoConfig(mode='bf16', compute_dtype=torch.float32)):
        got = tyl.linears(x, ws, [b, None], cfg)
        assert torch.equal(got[0], tyl.linear(x, ws[0], b, cfg))
        assert torch.equal(got[1], tyl.linear(x, ws[1], None, cfg))
    cfg = tyl.YocoConfig(mode='bf16', compute_dtype=torch.float32)
    assert torch.equal(tyl.linears(x, ws, cfg=cfg)[1], x @ ws[1])
