"""The paper-fidelity modes through whole models and the serve entry
points, on the CPU, held to the reference on the same weights and inputs.

* Forward: prefill plus greedy decode over the contiguous cache in f32,
  ``qat`` and ``analog_sim``, with and without ``--prequantize`` where the
  reference serves it, one config a family (stablelm, deepseek-v3's smoke
  config with MLA and MoE layers, qwen2-moe, mamba2, zamba2, qwen2-vl,
  musicgen). ``analog_sim`` runs with JAX's draws patched into the port
  (``test_torch_fidelity_linear.jax_normals``). Greedy tokens equal, logits
  within ``LOGIT_TOL`` (measured at most 1.2e-6: the fake-quantized and
  noised operands are the reference's, and what is left is f32 summation
  order). qwen2-vl's qat cases are held to ``FLIP_TOL``, as zamba2's
  dynamic w8a8 is in ``tests/test_torch_ssm_serve.py``: its biased q/k/v
  epilogue is FMA-contracted under jit (ROADMAP Queue 3), which moves
  layer 0's attention output by 6.3e-7 across a rounding boundary of the
  per-token fake quantization before ``wo``, so one code steps and the
  logits move by up to 4.5e-2 (measured), tokens still equal.
* ``serve_continuous`` in ``qat`` and ``analog_sim --prequantize``: the
  reference's per-request tokens, terminal map and event counts.
* The serving form of the new modes (f32 masters K-major, or int8 with
  ``--prequantize``), the refusals where the reference fails (MLA and
  hybrid ``--prequantize`` in every mode), the oversize message, and the
  CLI."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.core.yoco_linear import YocoConfig
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from test_torch_fidelity_linear import jax_normals

ARCHS = ['stablelm-1.6b', 'deepseek-v3-671b', 'qwen2-moe-a2.7b',
         'mamba2-780m', 'zamba2-1.2b', 'qwen2-vl-72b', 'musicgen-large']
# the reference fails on MLA and hybrid configs with --prequantize
NO_PREQUANT = ('deepseek-v3-671b', 'zamba2-1.2b')
CASES = [(arch, mode, pre) for arch in ARCHS
         for mode in ('qat', 'analog_sim') for pre in (False, True)
         if not (pre and arch in NO_PREQUANT)]
B, PLEN, STEPS = 2, 8, 2
LOGIT_TOL = 2e-5
FLIP_TOL = 5e-2
FLIP_CASES = {('qwen2-vl-72b', 'qat')}


@functools.lru_cache(maxsize=None)
def _params_np(arch, prequant):
    """The reference's weights as numpy, drawn (and quantized) under jit:
    both packages read the same arrays, and one compile costs less than
    the eager draw of the MoE and MLA trees."""
    cfg = rconfigs.get(arch, smoke=True)
    p = jax.jit(lambda k: rmodel.init_params(k, cfg))(jax.random.key(0))
    return jax.tree.map(np.asarray,
                        jax.jit(ryl.quantize_tree)(p) if prequant else p)


def _prompts(cfg):
    rng = np.random.RandomState(1)
    if cfg.input_kind == 'embeddings':
        return rng.randn(B, PLEN, cfg.d_model).astype(np.float32)
    shape = (B, PLEN, cfg.n_codebooks) if cfg.input_kind == 'codebooks' \
        else (B, PLEN)
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


def _step_in(cfg, tok):
    if cfg.input_kind != 'embeddings':
        return tok
    return np.eye(cfg.d_model, dtype=np.float32)[tok % cfg.d_model]


def _reference_forward(arch, mode, prequant):
    """Prefill + STEPS greedy decode steps of the jitted reference in f32:
    (STEPS + 1, B, ...) logits."""
    cfg = rconfigs.get(arch, smoke=True)
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)
    rt = ModelRuntime(compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _params_np(arch, prequant))
    cache = rmodel.init_cache_tree(cfg, B, PLEN + STEPS, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(
        p, t, pos, c, cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts(cfg)), cache)
    rows = [np.asarray(logits)]
    for i in range(STEPS):
        tok = np.asarray(jnp.argmax(logits, -1), np.int32)
        logits, cache = decode(params, jnp.asarray(_step_in(cfg, tok)),
                               jnp.int32(PLEN + i), cache)
        rows.append(np.asarray(logits))
    return np.stack(rows)


def _port_forward(arch, mode, prequant):
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(attn_impl='einsum', compute_dtype=torch.float32)
    params = tmodel.serving_form(
        tmodel.params_from_numpy(_params_np(arch, prequant), cfg, 'cpu'),
        mode, prequant, torch.float32)
    cache = tmodel.init_cache_tree(cfg, B, PLEN + STEPS, dtype=torch.float32,
                                   device='cpu')
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts(cfg))), cache, cfg,
        yoco, rt)
    rows = [logits.numpy()]
    ids = torch.arange(cfg.d_model)
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        logits, cache = tmodel.decode_step(
            params, tserve._step_input(cfg, tok, ids).float(),
            torch.tensor(PLEN + i, dtype=torch.int32), cache, cfg, yoco, rt)
        rows.append(logits.numpy())
    return np.stack(rows)


@pytest.mark.parametrize('arch,mode,prequant', CASES,
                         ids=[f'{a}-{m}{"-prequant" if p else ""}'
                              for a, m, p in CASES])
def test_forward_matches_reference_f32(monkeypatch, arch, mode, prequant):
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)
    want = _reference_forward(arch, mode, prequant)
    got = _port_forward(arch, mode, prequant)
    assert got.shape == want.shape
    assert np.isfinite(got).all()
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))
    tol = FLIP_TOL if (arch, mode) in FLIP_CASES else LOGIT_TOL
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)


# ----------------------------------------------------------------------------
# serve_continuous against the reference's
# ----------------------------------------------------------------------------
ARCH = 'stablelm-1.6b'
KW = dict(slots=3, prompt_len=16, gen_len=6, page_size=4)


def _stream(mod):
    rng = np.random.RandomState(11)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, 256, 6 + (i * 5) % 11).astype(np.int32),
                target_gen=3 + (i * 3) % 4) for i in range(5)]


@pytest.mark.parametrize('mode,prequant', [('qat', False),
                                           ('analog_sim', True)])
def test_serve_continuous_tokens_match_reference(monkeypatch, mode,
                                                 prequant):
    """f32 on both (the reference's dtype defaults monkeypatched in its
    serve module's namespace, as ``tests/test_torch_serve.py`` does)."""
    with monkeypatch.context() as m:
        m.setattr(rserve, 'YocoConfig',
                  functools.partial(YocoConfig, compute_dtype=jnp.float32))
        m.setattr(rserve, 'ModelRuntime',
                  functools.partial(ModelRuntime, compute_dtype=jnp.float32))
        m.setattr(rserve.model_mod, 'init_paged_cache_tree',
                  functools.partial(rmodel.init_paged_cache_tree,
                                    dtype=jnp.float32))
        ref = rserve.serve_continuous(ARCH, mode=mode, prequantize=prequant,
                                      attn_impl='einsum', metrics=False,
                                      quiet=True,
                                      request_stream=_stream(rserve), **KW)
    monkeypatch.setattr(tyl, 'analog_normals', jax_normals)
    cfg = tconfigs.get(ARCH, smoke=True)
    got = tserve.serve_continuous(
        ARCH, mode=mode, prequantize=prequant, quiet=True, metrics=False,
        request_stream=_stream(tserve), device='cpu',
        compute_dtype=torch.float32,
        params=tmodel.params_from_numpy(_params_np(ARCH, False), cfg, 'cpu'),
        **KW)
    assert got['completed'] == ref['completed'] == 5
    assert got['outputs'] == ref['outputs']
    assert got['terminal'] == ref['terminal']
    assert got['events'] == ref['events']


def test_noise_seed_reaches_the_serve():
    """``noise_seed`` (a keyword, no CLI flag, as in the reference) seeds
    the analog draws: the same seed gives the same tokens."""
    kw = dict(mode='analog_sim', quiet=True, metrics=False, device='cpu',
              n_requests=2, compute_dtype=torch.float32, **KW)
    a = tserve.serve_continuous(ARCH, noise_seed=3, **kw)
    b = tserve.serve_continuous(ARCH, noise_seed=3, **kw)
    assert a['outputs'] == b['outputs']
    seen = []
    orig = tyl.analog_normals

    def spy(seed, *a, **k):
        seen.append(seed)
        return orig(seed, *a, **k)
    tyl.analog_normals = spy
    try:
        tserve.serve(ARCH, mode='analog_sim', noise_seed=4, batch=2,
                     prompt_len=4, gen_len=2, quiet=True, device='cpu')
    finally:
        tyl.analog_normals = orig
    assert seen and set(seen) == {4}


# ----------------------------------------------------------------------------
# serving form, refusals, the CLI
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('mode', ['qat', 'analog_sim'])
def test_serving_form_of_the_new_modes(mode):
    """Dynamic: f32 masters stored K-major, as dynamic w8a8; with
    --prequantize: int8 QuantizedWeights; the bytes counted on the meta
    device equal the drawn tree's."""
    cfg = tconfigs.get(ARCH, smoke=True)
    for prequant in (False, True):
        tree = tmodel.init_params(
            torch.Generator().manual_seed(0), cfg, device='cpu',
            transform=tmodel.serving_transform(mode, prequant,
                                               torch.bfloat16))
        wq = tree['layers'][0]['attn']['wq']
        if prequant:
            assert isinstance(wq, tyl.QuantizedWeight)
            assert wq.wq.dtype == torch.int8 and wq.wq.t().is_contiguous()
        else:
            assert wq.dtype == torch.float32 and wq.t().is_contiguous()

        def size(node):
            if isinstance(node, dict):
                node = list(node.values())
            if isinstance(node, (list, tuple)):
                return sum(size(v) for v in node)
            return node.numel() * node.element_size()
        assert tmodel.serving_bytes(cfg, mode, prequant,
                                    torch.bfloat16) == size(tree)


@pytest.mark.parametrize('mode', ['qat', 'analog_sim'])
@pytest.mark.parametrize('arch,msg', [
    ('deepseek-v3-671b', 'not served on MLA configs'),
    ('zamba2-1.2b', 'not served on hybrid configs')])
def test_prequantize_refused_where_the_reference_fails(arch, msg, mode):
    kw = dict(mode=mode, prequantize=True, device='cpu', quiet=True)
    for entry in (tserve.serve_continuous, tserve.serve):
        with pytest.raises(ValueError, match=f'{msg}.*in every mode'):
            entry(arch, **kw)


def test_oversize_names_the_form(monkeypatch):
    cfg = tconfigs.get(ARCH)
    free = 10 ** 9
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev=None: (free, 80 * 10 ** 9))
    for mode, prequant, form in (('qat', False, r'dynamic qat \(f32'),
                                 ('analog_sim', False,
                                  r'dynamic analog_sim \(f32'),
                                 ('analog_sim', True,
                                  'analog_sim --prequantize')):
        need = tmodel.serving_bytes(cfg, mode, prequant, torch.bfloat16)
        with pytest.raises(ValueError,
                           match=f'{need} bytes in {form}.*{free} bytes'):
            tserve._refuse_oversize(cfg, torch.device('cuda'), mode,
                                    prequant)


@pytest.mark.parametrize('flags', [['--mode', 'qat'],
                                   ['--mode', 'analog_sim', '--prequantize'],
                                   ['--mode', 'qat', '--prequantize']],
                         ids=['qat', 'analog_sim-prequant', 'qat-prequant'])
def test_cli_serves_the_new_modes(flags):
    base = ['--device', 'cpu', '--prompt-len', '8', '--gen-len', '3']
    out = tserve.main(base + ['--continuous', '--requests', '2',
                              '--no-metrics'] + flags)
    assert out['completed'] == 2
    out = tserve.main(base + ['--batch', '2', '--attn-impl', 'flash'] + flags)
    assert out['generated_shape'] == [2, 3]
