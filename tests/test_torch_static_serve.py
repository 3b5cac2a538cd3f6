"""The static ``serve()`` path end to end: the port's ``serve(device='cpu')``
against the reference's ``serve()`` on the same weights
(``params_from_numpy``) and the same numpy-made prompts, lock-step and
``--ragged``, over ``attn_impl`` flash (kernel K7's plain version here,
the reference's Pallas kernel in interpret mode) and einsum, in bf16 and
w8a8 ``--prequantize`` modes.

In f32 (the reference's dtype defaults monkeypatched in its serve module's
namespace, its synthetic prompts replaced by the same numpy prompts; no
reference file changes): equal (B, gen_len) greedy tokens and equal
prompt lengths. The reference's tokens are recorded per decode step by
wrapping its ``make_decode_step``."""

import dataclasses
import functools
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

ARCH = 'stablelm-1.6b'
MLA_ARCH = 'deepseek-v3-dense3-static-test'
KW = dict(batch=3, prompt_len=10, gen_len=6)


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
def _params_np(arch):
    cfg = rconfigs.get(arch, smoke=True)
    return jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                       cfg))


def _prompts(arch):
    vocab = rconfigs.get(arch, smoke=True).vocab_size
    return np.random.RandomState(5).randint(
        0, vocab, (KW['batch'], KW['prompt_len'])).astype(np.int32)


def _reference(monkeypatch, arch, **kw):
    """The reference's serve() in f32 on ``_prompts(arch)``; returns (its
    report, its (B, gen_len) greedy tokens)."""
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
    make = rserve.SS.make_decode_step

    def recording_make(*a, **k):
        step = make(*a, **k)

        def recorded(params, token, pos, cache, *key):
            tok, logits, cache = step(params, token, pos, cache, *key)
            jax.debug.callback(
                lambda t_in, t_out: steps.append((np.asarray(t_in),
                                                  np.asarray(t_out))),
                token, tok, ordered=True)
            return tok, logits, cache
        return recorded

    monkeypatch.setattr(rserve.SS, 'make_decode_step', recording_make)
    out = rserve.serve(arch, quiet=True, **KW, **kw)
    jax.effects_barrier()
    monkeypatch.undo()
    assert len(steps) == KW['gen_len'] - 1
    toks = np.stack([steps[0][0]] + [t_out for _, t_out in steps], axis=1)
    return out, toks


def _port(arch, **kw):
    cfg = tconfigs.get(arch, smoke=True)
    return tserve.serve(arch, quiet=True, device='cpu',
                        compute_dtype=torch.float32,
                        params=tmodel.params_from_numpy(_params_np(arch),
                                                        cfg, 'cpu'),
                        prompts=_prompts(arch), **KW, **kw)


@pytest.mark.parametrize('mode,prequant', [('bf16', False), ('w8a8', True)])
@pytest.mark.parametrize('attn_impl', ['flash', 'einsum'])
@pytest.mark.parametrize('ragged', [False, True], ids=['lockstep', 'ragged'])
def test_static_serve_f32_tokens_match_reference(monkeypatch, ragged,
                                                 attn_impl, mode, prequant):
    kw = dict(ragged=ragged, attn_impl=attn_impl, mode=mode,
              prequantize=prequant)
    ref, want = _reference(monkeypatch, ARCH, **kw)
    got = _port(ARCH, **kw)
    assert got['tokens'].shape == want.shape == (KW['batch'], KW['gen_len'])
    np.testing.assert_array_equal(got['tokens'], want)
    assert got['generated_shape'] == ref['generated_shape']
    assert got['sample'] == ref['sample']
    assert got.get('prompt_lens') == ref.get('prompt_lens')
    if ragged:
        assert len(set(got['prompt_lens'])) > 1


def test_static_serve_mla_einsum_tokens_match_reference(monkeypatch,
                                                        mla_arch):
    """deepseek-v3's dense prefix over the contiguous latent cache
    (``ContiguousMLALayout``), lock-step, einsum."""
    _, want = _reference(monkeypatch, mla_arch, attn_impl='einsum')
    got = _port(mla_arch, attn_impl='einsum')
    np.testing.assert_array_equal(got['tokens'], want)


def test_static_serve_mla_refusals(mla_arch):
    """MLA with --attn-impl flash is refused by both packages with the
    same message; --prequantize on MLA is refused by the port on this path
    as on the continuous one."""
    with pytest.raises(ValueError) as ref_err:
        rserve.serve(mla_arch, attn_impl='flash', quiet=True, **KW)
    with pytest.raises(ValueError) as port_err:
        tserve.serve(mla_arch, attn_impl='flash', device='cpu', quiet=True,
                     **KW)
    assert str(port_err.value) == str(ref_err.value)
    with pytest.raises(ValueError, match='prequantize'):
        tserve.serve(mla_arch, mode='w8a8', prequantize=True, device='cpu',
                     quiet=True, **KW)


def test_static_cli_prints_the_reference_keys(monkeypatch, capsys):
    ref = rserve.serve(ARCH, batch=2, prompt_len=8, gen_len=4, quiet=True,
                       ragged=True, attn_impl='flash')
    out = tserve.main(['--device', 'cpu', '--batch', '2', '--prompt-len',
                       '8', '--gen-len', '4', '--attn-impl', 'flash',
                       '--ragged'])
    lines = capsys.readouterr().out.strip().splitlines()
    assert len(lines) == 1
    printed = json.loads(lines[0])
    assert set(printed) == set(ref) | {'device'}
    assert printed['generated_shape'] == [2, 4]
    assert printed['prompt_lens'] == ref['prompt_lens']
    assert out['tokens'].shape == (2, 4)
    sampled = tserve.main(['--device', 'cpu', '--batch', '2', '--prompt-len',
                           '8', '--gen-len', '4', '--sample', '--top-k',
                           '4'])
    assert sampled['generated_shape'] == [2, 4]
    assert sampled['attn_impl'] == 'einsum'


def test_static_serve_temperature_zero_equals_greedy():
    greedy = _port(ARCH, attn_impl='flash', ragged=True)
    zero = _port(ARCH, attn_impl='flash', ragged=True, greedy=False,
                 temperature=0.0, top_k=7)
    np.testing.assert_array_equal(zero['tokens'], greedy['tokens'])


def test_continuous_temperature_zero_equals_greedy():
    kw = dict(slots=2, n_requests=3, prompt_len=8, gen_len=4, page_size=4,
              device='cpu', quiet=True)
    greedy = tserve.serve_continuous(ARCH, **kw)
    zero = tserve.serve_continuous(ARCH, greedy=False, temperature=0.0,
                                   **kw)
    sampled = tserve.serve_continuous(ARCH, greedy=False, temperature=1.0,
                                      top_k=3, **kw)
    assert zero['outputs'] == greedy['outputs']
    assert sampled['completed'] == 3
