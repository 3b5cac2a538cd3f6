"""Kernel K4's K-major weight contract (dynamic ``--mode w8a8``), on the CPU.

Dynamic w8a8 stores every float linear weight K-major once, at load
(``models.model.k_major_linear_weights``, from ``serve``'s
``_serving_params``): the reference's (K, N) values as a view of an
(N, K)-contiguous f32 tensor. ``ops.yoco_vmm`` then hands ``w.T`` to K3 in
place and K3's (N, K) codes to K4 as the K-major view, so no call copies
the weight. The CPU plain path takes any layout and gives the same
values, so these tests see the layout only through strides and check it
there.

Tolerances: ``ops.yoco_vmm`` on a K-major weight bit-equal to the same call
on a row-major one and to the port's ``kernels/ref.py::yoco_vmm_ref``,
within 1 ulp of the reference's ``ops.yoco_vmm`` (Pallas interpret mode:
its epilogue multiplies in another association, as
``tests/test_torch_kernels.py`` holds it); serving in f32 gives the
reference's greedy tokens (and, continuous, its events). The CUDA-only
case skips inside the test when no card is visible."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.configs import base as rbase
from repro.core.yoco_linear import YocoConfig
from repro.kernels import ops as rops
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models.model import ModelRuntime
from repro_torch import configs as tconfigs
from repro_torch.configs import base as tbase
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref
from repro_torch.kernels import yoco_vmm as tyv
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel

ARCH = 'stablelm-1.6b'
MLA_ARCH = 'deepseek-v3-dense3-k4-test'


def _is_k_major(w: torch.Tensor) -> bool:
    return w.transpose(-1, -2).is_contiguous()


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


# ----------------------------------------------------------------------------
# the linear: ops.yoco_vmm and K4's plain version on a K-major weight
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('lead,k,n', [
    ((5,), 130, 200), ((17,), 300, 129), ((1,), 7, 3), ((2, 3), 96, 72)],
    ids=['ragged', 'ragged_n', 'tiny', 'batched'])
def test_ops_yoco_vmm_on_a_k_major_weight(monkeypatch, lead, k, n):
    """Bit-equal to the row-major call and to yoco_vmm_ref, within 1 ulp of
    the reference; K3 reads wᵀ in place and K4 gets a K-major view."""
    rng = np.random.RandomState(k + n)
    x = rng.randn(*lead, k).astype(np.float32)
    x.reshape(-1, k)[0] = 0.0                  # all-zero row: scale 1e-8/127
    w = (rng.randn(k, n) / np.sqrt(k)).astype(np.float32)
    w_rm = torch.from_numpy(w)
    w_km = tyl.k_major(w_rm)
    assert _is_k_major(w_km) and not _is_k_major(w_rm)
    seen = []
    quantize, vmm = tops._quantize.quantize_rows, tyv.yoco_vmm_int8

    def spy_quantize(t):
        seen.append(('k3', t.data_ptr(), t.is_contiguous()))
        return quantize(t)

    def spy_vmm(xq, wq, sx, sw):
        seen.append(('k4', _is_k_major(wq), tuple(sw.shape)))
        return vmm(xq, wq, sx, sw)

    monkeypatch.setattr(tops._quantize, 'quantize_rows', spy_quantize)
    monkeypatch.setattr(tops._yoco, 'yoco_vmm_int8', spy_vmm)
    got = tops.yoco_vmm(torch.from_numpy(x), w_km)
    assert seen[1] == ('k3', w_km.data_ptr(), True)     # wᵀ, uncopied
    assert seen[2] == ('k4', True, (1, n))
    monkeypatch.undo()
    row_major = tops.yoco_vmm(torch.from_numpy(x), w_rm)
    assert tuple(got.shape) == (*lead, n) and got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), row_major.numpy())
    x2 = torch.from_numpy(x.reshape(-1, k))
    np.testing.assert_array_equal(
        got.numpy().reshape(-1, n), tref.yoco_vmm_ref(x2, w_km).numpy())
    want = np.asarray(rops.yoco_vmm(jnp.asarray(x), jnp.asarray(w)))
    np.testing.assert_array_max_ulp(got.numpy(), want, maxulp=1)
    assert np.all(got.numpy().reshape(-1, n)[0] == 0.0)


def test_yoco_vmm_int8_plain_takes_either_layout():
    rng = np.random.RandomState(4)
    m, k, n = 9, 70, 33
    xq = torch.from_numpy(rng.randint(-127, 128, (m, k)).astype(np.int8))
    wq = torch.from_numpy(rng.randint(-127, 128, (k, n)).astype(np.int8))
    sx = torch.from_numpy(rng.rand(m, 1).astype(np.float32))
    sw = torch.from_numpy(rng.rand(1, n).astype(np.float32))
    wq_km = tyl.k_major(wq)
    assert _is_k_major(wq_km) and torch.equal(wq_km, wq)
    assert torch.equal(tyv.yoco_vmm_int8_plain(xq, wq_km, sx, sw),
                       tyv.yoco_vmm_int8_plain(xq, wq, sx, sw))
    assert torch.equal(tyv.yoco_vmm_int8(xq, wq_km, sx, sw),
                       tyv.yoco_vmm_int8_plain(xq, wq, sx, sw))


def test_card_refuses_a_row_major_weight():
    """On the card a row-major (K, N) weight raises before any launch, in
    ops.yoco_vmm (float) and in the K4 wrapper (int8): nothing copies it."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA card')
    dev = torch.device('cuda')
    k, n = 64, 48
    w = torch.randn((k, n), device=dev)
    with pytest.raises(ValueError, match='K-major'):
        tops.yoco_vmm(torch.randn((8, k), device=dev), w)
    xq = torch.zeros((8, k), dtype=torch.int8, device=dev)
    sx = torch.ones((8, 1), device=dev)
    sw = torch.ones((1, n), device=dev)
    with pytest.raises(ValueError, match='K-major'):
        tyv.yoco_vmm_int8(xq, torch.zeros((k, n), dtype=torch.int8,
                                          device=dev), sx, sw)


# ----------------------------------------------------------------------------
# the tree served: K-major at load in dynamic w8a8 only
# ----------------------------------------------------------------------------
def _leaves(tree, name=''):
    if isinstance(tree, dict):
        for key, v in tree.items():
            yield from _leaves(v, key)
    elif isinstance(tree, list):
        for v in tree:
            yield from _leaves(v, name)
    else:
        yield name, tree


def _linear_weights(tree):
    return [(name, t) for name, t in _leaves(tree)
            if name in tyl._WEIGHT_NAMES and isinstance(t, torch.Tensor)
            and t.ndim == 2]


@pytest.mark.parametrize('which', ['stablelm', 'mla'])
def test_serving_params_store_dynamic_w8a8_weights_k_major(request, which):
    arch = ARCH if which == 'stablelm' else request.getfixturevalue(
        'mla_arch')
    cfg = tconfigs.get(arch, smoke=True)
    base = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                              device='cpu')
    kw = dict(seed=0, compute_dtype=torch.bfloat16)
    dyn = tserve._serving_params(cfg, base, torch.device('cpu'),
                                 mode='w8a8', prequantize=False, **kw)
    weights = _linear_weights(dyn)
    names = {name for name, _ in weights}
    assert len(weights) == len(_linear_weights(base)) > 0
    if which == 'mla':
        assert 'w_ukv' in names
    for (name, got), (_, w) in zip(weights, _linear_weights(base)):
        assert _is_k_major(got) and got.dtype == torch.float32, name
        assert not _is_k_major(w) and torch.equal(got, w), name
    # what is not a linear weight is the same tensor, untouched
    for (name, got), (_, w) in zip(_leaves(dyn), _leaves(base)):
        if name not in names:
            assert got is w, name
    # bf16 and --prequantize load as before
    bf16 = tserve._serving_params(cfg, base, torch.device('cpu'),
                                  mode='bf16', prequantize=False, **kw)
    want = tmodel.cast_linear_weights(base, torch.bfloat16)
    for (name, got), (_, w) in zip(_leaves(bf16), _leaves(want)):
        assert torch.equal(got, w) and got.stride() == w.stride(), name
    if which == 'stablelm':                    # MLA refuses --prequantize
        pq = tserve._serving_params(cfg, base, torch.device('cpu'),
                                    mode='w8a8', prequantize=True, **kw)
        want = tyl.quantize_tree(base)
        for (name, got), (_, w) in zip(_leaves(pq), _leaves(want)):
            for a, b in zip(got, w) if isinstance(got, tuple) \
                    else ((got, w),):
                assert torch.equal(a, b) and a.stride() == b.stride(), name


def test_k_major_linear_weights_copies_no_k_major_weight():
    w = tyl.k_major(torch.randn(6, 4))
    got = tmodel.k_major_linear_weights(dict(wo=w))["wo"]
    assert got.data_ptr() == w.data_ptr() and got.stride() == w.stride()


# ----------------------------------------------------------------------------
# dynamic w8a8 serving on the K-major tree: the reference's greedy tokens
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _params_np(arch):
    cfg = rconfigs.get(arch, smoke=True)
    return jax.tree.map(np.asarray, rmodel.init_params(jax.random.key(0),
                                                       cfg))


def _f32_reference(monkeypatch, cache_fn):
    monkeypatch.setattr(rserve, 'YocoConfig',
                        functools.partial(YocoConfig,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(rserve, 'ModelRuntime',
                        functools.partial(ModelRuntime,
                                          compute_dtype=jnp.float32))
    monkeypatch.setattr(rserve.model_mod, cache_fn,
                        functools.partial(getattr(rmodel, cache_fn),
                                          dtype=jnp.float32))


def _spy_weights(monkeypatch):
    """Records, for every dynamic w8a8 linear, whether its weight arrived
    K-major (every product goes through ``ops.yoco_vmm_codes``, the ones
    that share an activation's quantization too)."""
    seen = []
    yoco_vmm_codes = tops.yoco_vmm_codes

    def spy(xq, sx, w):
        seen.append(_is_k_major(w))
        return yoco_vmm_codes(xq, sx, w)
    monkeypatch.setattr(tops, 'yoco_vmm_codes', spy)
    return seen


def _stream(mod, vocab):
    rng = np.random.RandomState(13)
    return [mod.Request(rid=i, prompt=rng.randint(
                0, vocab, 6 + (i * 5) % 9).astype(np.int32),
                target_gen=3 + (i * 3) % 4) for i in range(4)]


CONT_KW = dict(slots=2, prompt_len=16, gen_len=6, page_size=4)


@pytest.mark.parametrize('which', ['stablelm', 'mla'])
def test_dynamic_w8a8_continuous_serve_gives_reference_tokens(
        request, monkeypatch, which):
    arch = ARCH if which == 'stablelm' else request.getfixturevalue(
        'mla_arch')
    vocab = rconfigs.get(arch, smoke=True).vocab_size
    _f32_reference(monkeypatch, 'init_paged_cache_tree')
    ref = rserve.serve_continuous(arch, mode='w8a8', attn_impl='einsum',
                                  metrics=False, quiet=True,
                                  request_stream=_stream(rserve, vocab),
                                  **CONT_KW)
    monkeypatch.undo()
    seen = _spy_weights(monkeypatch)
    cfg = tconfigs.get(arch, smoke=True)
    got = tserve.serve_continuous(
        arch, mode='w8a8', quiet=True, device='cpu',
        compute_dtype=torch.float32, request_stream=_stream(tserve, vocab),
        params=tmodel.params_from_numpy(_params_np(arch), cfg, 'cpu'),
        **CONT_KW)
    assert seen and all(seen)
    assert got['completed'] == ref['completed'] == 4
    assert got['outputs'] == ref['outputs']
    assert got['events'] == ref['events']


STATIC_KW = dict(batch=3, prompt_len=10, gen_len=5)


@pytest.mark.parametrize('which', ['stablelm', 'mla'])
def test_dynamic_w8a8_static_serve_gives_reference_tokens(
        request, monkeypatch, which):
    """stablelm ``--ragged`` with flash (K7's plain version), the dense
    prefix lock-step with einsum (its only static route)."""
    arch = ARCH if which == 'stablelm' else request.getfixturevalue(
        'mla_arch')
    kw = (dict(ragged=True, attn_impl='flash') if which == 'stablelm'
          else dict(ragged=False, attn_impl='einsum'))
    vocab = rconfigs.get(arch, smoke=True).vocab_size
    prompts = np.random.RandomState(6).randint(
        0, vocab, (STATIC_KW['batch'], STATIC_KW['prompt_len'])).astype(
            np.int32)
    _f32_reference(monkeypatch, 'init_cache_tree')
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
    rserve.serve(arch, mode='w8a8', quiet=True, **STATIC_KW, **kw)
    jax.effects_barrier()
    monkeypatch.undo()
    want = np.stack([steps[0][0]] + [t for _, t in steps], axis=1)
    seen = _spy_weights(monkeypatch)
    cfg = tconfigs.get(arch, smoke=True)
    got = tserve.serve(
        arch, mode='w8a8', quiet=True, device='cpu',
        compute_dtype=torch.float32, prompts=prompts,
        params=tmodel.params_from_numpy(_params_np(arch), cfg, 'cpu'),
        **STATIC_KW, **kw)
    assert seen and all(seen)
    assert want.shape == (STATIC_KW['batch'], STATIC_KW['gen_len'])
    np.testing.assert_array_equal(got['tokens'], want)
