"""The non-token frontends through the port, on the CPU, held to the
reference on the same numpy inputs: qwen2-vl-72b's embeddings input and
M-RoPE, musicgen-large's four codebooks (SMOKE configs).

* M-RoPE: ``apply_mrope`` with three distinct random position streams
  (equal streams reduce it to RoPE and would hide a wrong section split,
  so they are an extra case only), at dh = 8 (sections (1, 2, 1)) and
  dh = 128 ((16, 24, 24)): within 1e-6.
* Codebooks: the summed embedding bit-equal, the float einsum head within
  1e-6, and never int8 in w8a8.
* Params: ``init_params``' keys and shapes equal the reference's (no
  ``embed`` for qwen2-vl; (CB, V, d) and (CB, d, V) for musicgen);
  ``params_from_numpy`` round-trips; the per-weight serving init equals
  init-then-convert.
* Forward: prefill and decode logits over the contiguous cache in f32,
  bf16 mode within 1e-5, w8a8 within 2e-6 (the biased epilogue's
  tolerance), greedy tokens equal.
* Data, sampling and the bytes that decide the memory refusal
  (``model.serving_bytes``, the serving draw on the meta device, equal
  to the bytes of the same draw on the CPU for every config and mode; qwen2-vl-72b's 80 layers refused in bf16 and dynamic
  w8a8 and admitted with --prequantize on an 80 GB card)."""

import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.data import synthetic as rsynthetic
from repro.launch import serve as rserve
from repro.models import model as rmodel
from repro.models import rope as rrope
from repro.models.model import ModelRuntime
from repro_torch import configs as tconfigs
from repro_torch.core import yoco_linear as tyl
from repro_torch.data import synthetic as tsynthetic
from repro_torch.kernels import ops as tops
from repro_torch.launch import serve as tserve
from repro_torch.models import model as tmodel
from repro_torch.models import rope as trope
from repro_torch.runtime import serve_step as tss

VL, MG = 'qwen2-vl-72b', 'musicgen-large'
ARCHS = [VL, MG]
MODES = [('bf16', False), ('w8a8', True), ('w8a8', False)]
MODE_IDS = ['bf16', 'prequant', 'dynamic']
B, PLEN, STEPS = 2, 10, 3


@functools.lru_cache(maxsize=None)
def _params_np(arch, prequant=False):
    p = rmodel.init_params(jax.random.key(0), rconfigs.get(arch, smoke=True))
    return jax.tree.map(np.asarray, ryl.quantize_tree(p) if prequant else p)


def _port_params(arch, prequant=False):
    return tmodel.params_from_numpy(_params_np(arch, prequant),
                                    tconfigs.get(arch, smoke=True), 'cpu')


def _prompts(arch, b=B, s=PLEN, seed=0):
    """Numpy prompts of the config's kind: (b, s, d) f32 embeddings,
    (b, s, CB) codebook ids or (b, s) ids."""
    cfg = rconfigs.get(arch, smoke=True)
    rng = np.random.RandomState(seed)
    if cfg.input_kind == 'embeddings':
        return rng.randn(b, s, cfg.d_model).astype(np.float32)
    shape = (b, s, cfg.n_codebooks) if cfg.input_kind == 'codebooks' \
        else (b, s)
    return rng.randint(0, cfg.vocab_size, shape).astype(np.int32)


def _step_in(cfg, tok):
    """The decode input after ids ``tok`` (numpy), as both serves make it:
    the stubbed frontend's one-hot row for embeddings input."""
    if cfg.input_kind != 'embeddings':
        return tok
    return np.eye(cfg.d_model, dtype=np.float32)[tok % cfg.d_model]


# ----------------------------------------------------------------------------
# M-RoPE
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('dh', [8, 128])
@pytest.mark.parametrize('streams', ['distinct', 'equal'])
def test_mrope_matches_reference(dh, streams):
    rng = np.random.RandomState(dh)
    x = rng.randn(2, 7, 3, dh).astype(np.float32)
    pos3 = rng.randint(0, 2048, (2, 7, 3)).astype(np.int32)
    if streams == 'equal':
        pos3[..., 1] = pos3[..., 2] = pos3[..., 0]
    want = np.asarray(rrope.apply_mrope(jnp.asarray(x), jnp.asarray(pos3),
                                        1e6))
    got = trope.apply_mrope(torch.from_numpy(x), torch.from_numpy(pos3),
                            1e6).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)
    assert trope.mrope_sections(dh // 2) == rrope.mrope_sections(dh // 2) \
        == {8: (1, 2, 1), 128: trope.MROPE_SECTIONS}[dh]
    if streams == 'equal':
        # three equal streams: RoPE over the whole head
        rope = trope.apply_rope(torch.from_numpy(x),
                                torch.from_numpy(pos3[..., 0]), 1e6)
        np.testing.assert_allclose(got, rope.numpy(), rtol=0, atol=1e-6)
    else:
        # each section rotates by its own stream: moving one stream moves
        # only its section's slots
        moved = pos3.copy()
        moved[..., 2] += 1
        other = trope.apply_mrope(torch.from_numpy(x),
                                  torch.from_numpy(moved), 1e6).numpy()
        half, (t, h, w) = dh // 2, trope.mrope_sections(dh // 2)
        same = np.zeros(dh, bool)
        same[:t + h] = same[half:half + t + h] = True
        np.testing.assert_array_equal(other[..., same], got[..., same])
        assert not np.array_equal(other[..., ~same], got[..., ~same])


def test_mrope_sections_and_positions3_match_reference():
    for half in range(1, 129):
        assert trope.mrope_sections(half) == rrope.mrope_sections(half)
    np.testing.assert_array_equal(
        trope.default_positions3(3, 5, 4).numpy(),
        np.asarray(rrope.default_positions3(3, 5, 4)))


# ----------------------------------------------------------------------------
# codebooks and the embeddings input
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('dtype', ['float32', 'bfloat16'])
@pytest.mark.parametrize('arch', ARCHS)
def test_embed_bit_equal_to_reference(arch, dtype):
    cfg_r, cfg_t = rconfigs.get(arch, smoke=True), tconfigs.get(arch,
                                                                smoke=True)
    inputs = _prompts(arch, seed=3)
    want = rmodel._embed(jax.tree.map(jnp.asarray, _params_np(arch)),
                         dict(inputs=jnp.asarray(inputs)), cfg_r,
                         ModelRuntime(compute_dtype=getattr(jnp, dtype)))
    got = tmodel._embed(_port_params(arch), torch.from_numpy(inputs), cfg_t,
                        tmodel.ModelRuntime(compute_dtype=getattr(torch,
                                                                  dtype)))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


@pytest.mark.parametrize('mode,prequant', MODES, ids=MODE_IDS)
def test_codebook_head_is_a_float_einsum_in_every_mode(monkeypatch, mode,
                                                       prequant):
    """musicgen's (CB, d, V) head: the reference's einsum within 1e-6, in
    every mode the same float product (no int8 kernel runs, the head is
    never quantized, and its serving form is the compute dtype's)."""
    cfg_r, cfg_t = rconfigs.get(MG, smoke=True), tconfigs.get(MG, smoke=True)
    x = np.random.RandomState(4).randn(2, 3, cfg_t.d_model).astype(np.float32)
    params = _params_np(MG, prequant)
    assert not isinstance(params['lm_head'], ryl.QuantizedWeight)
    want = np.asarray(rmodel._head(
        jax.tree.map(jnp.asarray, params), jnp.asarray(x), cfg_r,
        ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)))
    served = tmodel.serving_form(_port_params(MG, prequant), mode, prequant,
                                 torch.float32)
    assert served['lm_head'].shape == (4, cfg_t.d_model, cfg_t.vocab_size)

    def no_kernel(*a, **k):
        raise AssertionError('an int8 kernel ran on the codebook head')
    for name in ('quantize_rows', 'int8_matmul', 'yoco_vmm_codes'):
        monkeypatch.setattr(tops, name, no_kernel)
    got = tmodel._head(served, torch.from_numpy(x), cfg_t,
                       tyl.YocoConfig(mode=mode, compute_dtype=torch.float32))
    assert got.shape == (2, 3, 4, cfg_t.vocab_size)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bf16 = tmodel.serving_form(_port_params(MG, prequant), mode, prequant,
                               torch.bfloat16)
    assert bf16['lm_head'].dtype == torch.bfloat16
    assert bf16['embed'].dtype == torch.float32


def test_step_input_is_the_reference_one_hot():
    """The embeddings decode input: ``one_hot(tok % d_model)`` in bf16,
    made by comparison on the tokens' device."""
    cfg = tconfigs.get(VL, smoke=True)
    tok = torch.tensor([0, 63, 64, 255, 130], dtype=torch.int32)
    got = tserve._step_input(cfg, tok, torch.arange(cfg.d_model))
    want = jax.nn.one_hot(jnp.asarray(tok.numpy()) % cfg.d_model,
                          cfg.d_model, dtype=jnp.bfloat16)
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want, np.float32))
    mg = tconfigs.get(MG, smoke=True)
    codes = torch.zeros((2, 4), dtype=torch.int32)
    assert tserve._step_input(mg, codes, None) is codes


# ----------------------------------------------------------------------------
# params
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('arch', ARCHS)
def test_init_params_tree_matches_reference(arch):
    cfg = tconfigs.get(arch, smoke=True)
    got = tmodel.init_params(torch.Generator().manual_seed(0), cfg,
                             device='cpu')
    want = jax.eval_shape(lambda: rmodel.init_params(
        jax.random.key(0), rconfigs.get(arch, smoke=True)))
    assert set(got) == set(want)
    assert ('embed' in got) == (cfg.input_kind != 'embeddings')
    for key in got:
        if key == 'layers':
            assert len(got[key]) == cfg.n_layers
            paths = jax.tree_util.tree_leaves_with_path(want[key])
            mine = jax.tree_util.tree_leaves_with_path(got[key][0])
            assert [p for p, _ in mine] == [p for p, _ in paths]
            for (_, leaf), (_, w) in zip(mine, paths):
                assert (cfg.n_layers,) + tuple(leaf.shape) == w.shape
        else:
            for leaf, w in zip(jax.tree.leaves(got[key]),
                               jax.tree.leaves(want[key])):
                assert tuple(leaf.shape) == w.shape, key
    if cfg.input_kind == 'codebooks':
        assert got['embed'].shape == (4, cfg.vocab_size, cfg.d_model)
        assert got['lm_head'].shape == (4, cfg.d_model, cfg.vocab_size)
    else:
        assert set(got['layers'][0]['attn']) >= {'bq', 'bk', 'bv'}


@pytest.mark.parametrize('prequant', [False, True], ids=['f32', 'prequant'])
@pytest.mark.parametrize('arch', ARCHS)
def test_params_from_numpy_round_trips(arch, prequant):
    tree = _params_np(arch, prequant)
    got = _port_params(arch, prequant)
    for key, node in tree.items():
        mine = got[key]
        if key == 'layers':
            mine = [mine[l] for l in range(len(mine))]
            pairs = [(jax.tree.leaves(m), jax.tree.leaves(
                jax.tree.map(lambda a, l=l: a[l], node)))
                for l, m in enumerate(mine)]
        else:
            pairs = [(jax.tree.leaves(mine), jax.tree.leaves(node))]
        for ms, ws in pairs:
            assert len(ms) == len(ws)
            for m, w in zip(ms, ws):
                np.testing.assert_array_equal(m.numpy(), np.asarray(w))


@pytest.mark.parametrize('mode,prequant', MODES, ids=MODE_IDS)
@pytest.mark.parametrize('arch', ARCHS)
def test_serving_init_equals_init_then_convert(arch, mode, prequant):
    cfg = tconfigs.get(arch, smoke=True)
    drawn = tmodel.init_params(
        torch.Generator().manual_seed(3), cfg, device='cpu',
        transform=tmodel.serving_transform(mode, prequant, torch.bfloat16))
    converted = tmodel.serving_form(
        tmodel.init_params(torch.Generator().manual_seed(3), cfg,
                           device='cpu'), mode, prequant, torch.bfloat16)
    a, b = jax.tree.leaves(drawn), jax.tree.leaves(converted)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert x.dtype == y.dtype and torch.equal(x, y)


# ----------------------------------------------------------------------------
# forward logits
# ----------------------------------------------------------------------------
@functools.lru_cache(maxsize=None)
def _reference_forward(arch, mode, prequant):
    """Prefill + STEPS greedy decode steps (lock-step, 0-d pos) over the
    contiguous cache, jitted reference in f32: ((STEPS + 1, B, ...) logits,
    the decode inputs)."""
    cfg = rconfigs.get(arch, smoke=True)
    yoco = ryl.YocoConfig(mode=mode, compute_dtype=jnp.float32)
    rt = ModelRuntime(compute_dtype=jnp.float32)
    params = jax.tree.map(jnp.asarray, _params_np(arch, prequant))
    cache = rmodel.init_cache_tree(cfg, B, PLEN + STEPS, dtype=jnp.float32)
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(p, t, pos, c,
                                                             cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts(arch)), cache)
    rows, ins = [np.asarray(logits)], []
    for i in range(STEPS):
        ins.append(_step_in(cfg, np.asarray(jnp.argmax(logits, -1),
                                            np.int32)))
        logits, cache = decode(params, jnp.asarray(ins[-1]),
                               jnp.int32(PLEN + i), cache)
        rows.append(np.asarray(logits))
    return np.stack(rows), ins


@pytest.mark.parametrize('mode,prequant', MODES, ids=MODE_IDS)
@pytest.mark.parametrize('arch', ARCHS)
def test_forward_logits_match_reference_f32(arch, mode, prequant):
    want, want_in = _reference_forward(arch, mode, prequant)
    cfg = tconfigs.get(arch, smoke=True)
    yoco = tyl.YocoConfig(mode=mode, compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(attn_impl='flash', compute_dtype=torch.float32)
    params = _port_params(arch, prequant)
    cache = tmodel.init_cache_tree(cfg, B, PLEN + STEPS, dtype=torch.float32,
                                   device='cpu')
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts(arch))), cache, cfg,
        yoco, rt)
    rows = [logits.numpy()]
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        step_in = tserve._step_input(cfg, tok, torch.arange(cfg.d_model))
        np.testing.assert_array_equal(step_in.float().numpy(), want_in[i])
        logits, cache = tmodel.decode_step(
            params, step_in, torch.tensor(PLEN + i, dtype=torch.int32),
            cache, cfg, yoco, rt)
        rows.append(logits.numpy())
    got = np.stack(rows)
    assert got.shape == want.shape == (
        (STEPS + 1, B) + ((4,) if arch == MG else ()) + (cfg.vocab_size,))
    # w8a8: the int8 products are exact; norms, rope, softmax and the
    # biased epilogue reduce in f32 in another order than XLA's
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-5 if mode == 'bf16' else 2e-6)
    np.testing.assert_array_equal(got.argmax(-1), want.argmax(-1))


# ----------------------------------------------------------------------------
# data and sampling
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('arch', ARCHS)
def test_synthetic_batches_have_the_reference_shapes(arch):
    dc_r = rsynthetic.for_arch(rconfigs.get(arch, smoke=True),
                               global_batch=3, seq_len=6)
    dc_t = tsynthetic.for_arch(tconfigs.get(arch, smoke=True),
                               global_batch=3, seq_len=6)
    want = rsynthetic.make_batch(dc_r, 0)
    got = tsynthetic.make_batch(dc_t, 0)
    again = tsynthetic.make_batch(dc_t, 0)
    for key in ('inputs', 'labels'):
        assert tuple(got[key].shape) == want[key].shape
        assert str(got[key].dtype).split('.')[-1] == str(want[key].dtype)
        assert torch.equal(got[key], again[key])
    if arch == MG:
        assert torch.equal(got['inputs'][:, 1:], got['labels'][:, :-1])
        assert int(got['inputs'].max()) < dc_t.vocab_size
    else:
        assert int(got['labels'].max()) < dc_t.vocab_size


def test_sampling_over_codebooks():
    logits = torch.randn((3, 4, 64), generator=torch.Generator()
                         .manual_seed(0))
    gen = torch.Generator().manual_seed(1)
    toks = tss.sample_tokens(logits, gen, temperature=0.7, top_k=5)
    assert toks.shape == (3, 4) and toks.dtype == torch.int32
    kth = torch.topk(logits, 5, dim=-1).values[..., -1]
    assert bool((logits.gather(-1, toks.long()[..., None])[..., 0]
                 >= kth).all())
    np.testing.assert_array_equal(
        tss.sample_tokens(logits, gen, temperature=0.0).numpy(),
        logits.argmax(-1).numpy())


# ----------------------------------------------------------------------------
# refusals and the serving bytes
# ----------------------------------------------------------------------------
@pytest.mark.parametrize('arch', ARCHS)
def test_continuous_refuses_non_token_input_as_the_reference(arch):
    with pytest.raises(ValueError) as ref_err:
        rserve.serve_continuous(arch, quiet=True)
    with pytest.raises(ValueError) as port_err:
        tserve.serve_continuous(arch, quiet=True)
    assert str(port_err.value) == str(ref_err.value)
    assert 'token streams' in str(port_err.value)


def _tree_bytes(tree):
    return sum(t.numel() * t.element_size() for t in jax.tree.leaves(tree))


@pytest.mark.parametrize('mode,prequant', MODES, ids=MODE_IDS)
@pytest.mark.parametrize('arch', tconfigs.names())
def test_serving_bytes_count_the_drawn_tree(arch, mode, prequant):
    """``serving_bytes`` equals the bytes of the tree the seeded serve
    draws, leaf for leaf, at every SMOKE config (bf16 and f32 compute)."""
    cfg = tconfigs.get(arch, smoke=True)
    for dtype in (torch.bfloat16, torch.float32):
        tree = tmodel.init_params(
            torch.Generator().manual_seed(0), cfg, device='cpu',
            transform=tmodel.serving_transform(mode, prequant, dtype))
        assert tmodel.serving_bytes(cfg, mode, prequant, dtype) == \
            _tree_bytes(tree)


def _forbid_draws(monkeypatch):
    """Fail on a generator or a draw anywhere but on the meta device, where
    the refusal counts the serving form's bytes and allocates nothing."""
    init = tmodel.init_params

    def meta_only(gen, cfg, *, device=None, **kw):
        if torch.device(device).type != 'meta':
            raise AssertionError('drew weights')
        return init(gen, cfg, device=device, **kw)

    class NoGenerator:          # a type: torch's lazy imports annotate with it
        def __init__(self, *a, **k):
            raise AssertionError('made a generator')
    monkeypatch.setattr(tmodel, 'init_params', meta_only)
    monkeypatch.setattr(torch, 'Generator', NoGenerator)


def test_full_qwen2_vl_refused_unless_prequantized(monkeypatch):
    """qwen2-vl-72b's 80 layers on an 80 GB card (84.5e9 bytes free): bf16
    (142.9 GB) and dynamic w8a8 (285.8 GB of f32 masters) are refused
    before any draw, naming the bytes; --prequantize (71.5 GB of int8
    codes and f32 scales) is admitted; musicgen-large in every mode. No
    mode counts the embedding table the reference's parameter count holds
    and qwen2-vl does not draw."""
    free = 84_500_000_000
    monkeypatch.setattr(torch.cuda, 'mem_get_info',
                        lambda dev=None: (free, 85_520_000_000))
    cfg = tconfigs.get(VL)

    def need(mode, prequant, c=cfg):
        return tmodel.serving_bytes(c, mode, prequant, torch.bfloat16)
    assert 142.9e9 < need('bf16', False) < 143.0e9
    # 80 x 877.66 M + 1,245.7 M int8 codes, an f32 scale a column
    codes = 80 * 877_658_112 + 8192 * 152064
    assert codes < need('w8a8', True) < codes + 0.05e9 < free
    dyn = need('w8a8', False)
    table = 4 * cfg.vocab_size * cfg.d_model
    assert 0 <= dyn - (4 * cfg.param_count() - table) < 1e-4 * dyn
    assert 285.8e9 < dyn < 285.9e9
    assert need('bf16', False) < 2 * cfg.param_count()
    _forbid_draws(monkeypatch)
    dev = torch.device('cuda')
    for mode, prequant in (('bf16', False), ('w8a8', False)):
        want = need(mode, prequant)
        with pytest.raises(ValueError, match=f'{want} bytes.*{free} bytes'):
            tserve._serving_params(cfg, None, dev, seed=0, mode=mode,
                                   prequantize=prequant,
                                   compute_dtype=torch.bfloat16)
    tserve._refuse_oversize(cfg, dev, 'w8a8', True)
    for mode, prequant in MODES:
        tserve._refuse_oversize(tconfigs.get(MG), dev, mode, prequant)
    cut = dataclasses.replace(cfg, n_layers=12)
    assert 23.5e9 < need('bf16', False, cut) < 23.6e9
    tserve._refuse_oversize(cut, dev, 'bf16', False)
