"""The static ``serve()`` of the non-token frontends end to end: the port's
``serve(device='cpu')`` against the reference's ``serve()`` on the same
weights (``params_from_numpy``) and the same numpy prompts, for
qwen2-vl-72b ((B, S, d) embeddings in, each generated id fed back as the
stubbed frontend's one-hot row, M-RoPE) and musicgen-large ((B, S, 4)
codebook grids in, (B, gen, 4) tokens out), at their SMOKE configs.

In f32 (the reference's dtype defaults monkeypatched in its serve module's
namespace, as ``tests/test_torch_static_serve.py`` does; no reference file
changes): equal greedy tokens, the reference's taken per step by wrapping
its prefill and decode step builders, over lock-step and ``--ragged``,
``attn_impl`` flash (kernel K7's plain version here, the reference's
Pallas kernel in interpret mode) and einsum, bf16, w8a8 --prequantize and
dynamic w8a8; equal report keys, ``generated_shape``, ``sample`` and
prompt lengths. The CLI serves both configs; sampling keeps the shapes."""

import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro_torch import configs as tconfigs
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

VL, MG = 'qwen2-vl-72b', 'musicgen-large'
KW = dict(batch=3, prompt_len=10, gen_len=5)


@functools.lru_cache(maxsize=None)
def _params_np(arch):
    cfg = rconfigs.get(arch, smoke=True)
    return jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                       cfg))


def _prompts(arch):
    cfg = rconfigs.get(arch, smoke=True)
    rng = np.random.RandomState(5)
    b, s = KW['batch'], KW['prompt_len']
    if cfg.input_kind == 'embeddings':
        return rng.randn(b, s, cfg.d_model).astype(np.float32)
    return rng.randint(0, cfg.vocab_size,
                       (b, s, cfg.n_codebooks)).astype(np.int32)


def _reference(monkeypatch, arch, **kw):
    """The reference's serve() in f32 on ``_prompts(arch)``; returns (its
    report, its (B, gen_len[, CB]) greedy tokens: the prefill's argmax, then
    each decode step's output)."""
    monkeypatch.setattr(rserve, 'YocoConfig',
                        functools.partial(YocoConfig,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(rserve, 'ModelRuntime',
                        functools.partial(ModelRuntime,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(rserve.model_mod, 'init_cache_tree',
                        functools.partial(rmodel.init_cache_tree,
                                          dtype=jnp.float32))
    prompts = _prompts(arch)
    monkeypatch.setattr(rserve.synthetic, 'make_batch',
                        lambda dc, step: dict(inputs=jnp.asarray(prompts)))
    steps = []

    def record(t):
        steps.append(np.asarray(t))

    make_prefill, make_decode = (rserve.SS.make_prefill_step,
                                 rserve.SS.make_decode_step)

    def recording_prefill(*a, **k):
        step = make_prefill(*a, **k)

        def recorded(params, batch, cache, last_pos=None):
            logits, cache = step(params, batch, cache, last_pos=last_pos)
            jax.debug.callback(record, jnp.argmax(logits, -1), ordered=True)
            return logits, cache
        return recorded

    def recording_decode(*a, **k):
        step = make_decode(*a, **k)

        def recorded(params, token, pos, cache, *key):
            tok, logits, cache = step(params, token, pos, cache, *key)
            jax.debug.callback(record, tok, ordered=True)
            return tok, logits, cache
        return recorded

    monkeypatch.setattr(rserve.SS, 'make_prefill_step', recording_prefill)
    monkeypatch.setattr(rserve.SS, 'make_decode_step', recording_decode)
    out = rserve.serve(arch, quiet=True, **KW, **kw)
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(steps) == KW['gen_len']
    return out, np.stack(steps, axis=1)


def _port(arch, **kw):
    cfg = tconfigs.get(arch, smoke=True)
    return tserve.serve(arch, quiet=True, device='cpu',
                        compute_dtype=torch.float32,
                        params=tmodel.params_from_numpy(_params_np(arch),
                                                        cfg, 'cpu'),
                        prompts=_prompts(arch), **KW, **kw)


# (attn_impl, ragged, mode, prequantize): every mode lock-step through
# flash (K7) and --ragged through einsum, and bf16 flash --ragged
RUNS = [(impl, ragged, mode, prequant)
        for impl, ragged in (('flash', False), ('einsum', True))
        for mode, prequant in (('bf16', False), ('w8a8', True),
                               ('w8a8', False))] + [('flash', True, 'bf16',
                                                     False)]


@pytest.mark.parametrize(
    'attn_impl,ragged,mode,prequant', RUNS,
    ids=[f'{i}-{"ragged" if r else "lockstep"}-'
         f'{"prequant" if p else "dynamic" if m == "w8a8" else m}'
         for i, r, m, p in RUNS])
@pytest.mark.parametrize('arch', [VL, MG])
def test_static_serve_f32_tokens_match_reference(monkeypatch, arch,
                                                 attn_impl, ragged, mode,
                                                 prequant):
    kw = dict(ragged=ragged, attn_impl=attn_impl, mode=mode,
              prequantize=prequant)
    ref, want = _reference(monkeypatch, arch, **kw)
    got = _port(arch, **kw)
    shape = (KW['batch'], KW['gen_len']) + ((4,) if arch == MG else ())
    assert got['tokens'].shape == want.shape == shape
    np.testing.assert_array_equal(got['tokens'], want)
    assert got['generated_shape'] == ref['generated_shape'] == list(shape)
    assert got['sample'] == ref['sample']
    assert set(got) == set(ref) | {'device', 'tokens'}
    assert got.get('prompt_lens') == ref.get('prompt_lens')
    if ragged:
        assert len(set(got['prompt_lens'])) > 1


@pytest.mark.parametrize('arch', [VL, MG])
def test_static_serve_checks_the_prompt_kind(arch):
    cfg = tconfigs.get(arch, smoke=True)
    with pytest.raises(ValueError, match=f'expected .*{cfg.input_kind}'):
        tserve.serve(arch, quiet=True, device='cpu', prompts=np.zeros(
            (KW['batch'], KW['prompt_len']), np.int32), **KW)


@pytest.mark.parametrize('arch', [VL, MG])
def test_static_cli_serves_the_frontends(capsys, arch):
    """The CLI's static path prints the reference's keys for both configs,
    greedy, sampled (shapes kept), and with --prequantize."""
    ref = rserve.serve(arch, batch=2, prompt_len=8, gen_len=4, quiet=True,
                       ragged=True, attn_impl='flash')
    base = ['--device', 'cpu', '--arch', arch, '--batch', '2',
            '--prompt-len', '8', '--gen-len', '4']
    out = tserve.main(base + ['--attn-impl', 'flash', '--ragged'])
    printed = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(printed) == set(ref) | {'device'}
    assert printed['generated_shape'] == ref['generated_shape']
    assert printed['prompt_lens'] == ref['prompt_lens']
    sampled = tserve.main(base + ['--sample', '--top-k', '4',
                                  '--temperature', '0.8'])
    quant = tserve.main(base + ['--mode', 'w8a8', '--prequantize'])
    for o in (out, sampled, quant):
        assert list(o['tokens'].shape) == ref['generated_shape']
        assert int(o['tokens'].max()) < tconfigs.get(arch).vocab_size
