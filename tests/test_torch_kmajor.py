"""Kernel K2's K-major weight contract, on the CPU: ``prequantize_weight``
(and every path that builds a ``QuantizedWeight``) stores ``wq`` as a
(K, N) view of an (N, K)-contiguous tensor with the reference's values;
``ops.int8_matmul`` hands that view to the kernel wrapper uncopied and its
result equals the reference's bit for bit; a w8a8 ``--prequantize`` model
run on such weights gives the reference's greedy tokens in f32 (logits
within 1e-4: reduction order differs, so not bitwise)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as rconfigs
from repro.core import yoco_linear as ryl
from repro.kernels import ops as rops
from repro.models import model as rmodel
from repro.runtime import kv_cache as rkvc
from repro_torch.core import yoco_linear as tyl
from repro_torch.kernels import ops as tops
from repro_torch.kernels import yoco_vmm as tyv
from repro_torch.models import model as tmodel
from repro_torch.runtime import layouts as tlayouts

ARCH = 'stablelm-1.6b'


def _is_k_major(wq: torch.Tensor) -> bool:
    return wq.transpose(-1, -2).is_contiguous()


@pytest.mark.parametrize(
    'shape,sliced',
    [((64, 48), False), ((40, 1), False), ((3, 40, 24), False),
     ((64, 48), True), ((3, 40, 24), True)],
    ids=['2d', 'one_column', 'stacked', '2d_sliced', 'stacked_sliced'])
def test_prequantize_weight_is_k_major_with_reference_values(
        monkeypatch, shape, sliced):
    """``sliced``: five output columns a slice, a ragged last one, as a
    weight over ``PREQUANT_SLICE_BYTES`` is quantized; bit-equal all the
    same."""
    if sliced:
        monkeypatch.setattr(tyl, 'PREQUANT_SLICE_BYTES',
                            5 * 4 * int(np.prod(shape[:-1])))
    w = np.random.RandomState(11).randn(*shape).astype(np.float32)
    want = ryl.prequantize_weight(jnp.asarray(w))
    got = tyl.prequantize_weight(torch.from_numpy(w))
    assert tuple(got.wq.shape) == want.wq.shape == shape
    assert got.wq.dtype == torch.int8 and _is_k_major(got.wq)
    np.testing.assert_array_equal(got.wq.numpy(), np.asarray(want.wq))
    np.testing.assert_array_equal(got.scale.numpy(), np.asarray(want.scale))


def _quantized_leaves(tree):
    if isinstance(tree, tyl.QuantizedWeight):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _quantized_leaves(v)
    elif isinstance(tree, list):
        for v in tree:
            yield from _quantized_leaves(v)


def test_every_quantized_weight_of_the_model_is_k_major():
    """The port's quantize_tree and params_from_numpy of the reference's
    quantized tree both give K-major int8 weights, equal to each other."""
    cfg = rconfigs.get(ARCH, smoke=True)
    rp = rmodel.init_params(jax.random.key(0), cfg)
    tp = tmodel.params_from_numpy(jax.tree.map(np.asarray, rp), cfg, 'cpu')
    mine = list(_quantized_leaves(tyl.quantize_tree(tp)))
    loaded = list(_quantized_leaves(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, ryl.quantize_tree(rp)), cfg, 'cpu')))
    assert len(mine) == len(loaded) == 7 * cfg.n_layers + 1
    for a, b in zip(mine, loaded):
        assert _is_k_major(a.wq) and _is_k_major(b.wq)
        assert torch.equal(a.wq, b.wq) and torch.equal(a.scale, b.scale)


@pytest.mark.parametrize('lead', [(5,), (2, 3)], ids=['rows', 'batched'])
def test_ops_int8_matmul_hands_the_k_major_weight_over_uncopied(
        monkeypatch, lead):
    rng = np.random.RandomState(12)
    w = rng.randn(96, 40).astype(np.float32)
    xq = rng.randint(-127, 128, (*lead, 96)).astype(np.int8)
    wq = tyl.prequantize_weight(torch.from_numpy(w)).wq
    seen = []
    kernel = tyv.int8_matmul

    def spy(x, weight):
        seen.append((weight.data_ptr(), weight.stride()))
        return kernel(x, weight)

    monkeypatch.setattr(tops._yoco, 'int8_matmul', spy)
    got = tops.int8_matmul(torch.from_numpy(xq), wq)
    assert seen == [(wq.data_ptr(), wq.stride())]
    want = np.asarray(rops.int8_matmul(jnp.asarray(xq),
                                       jnp.asarray(wq.numpy())))
    assert got.dtype == torch.int32 and tuple(got.shape) == want.shape
    np.testing.assert_array_equal(got.numpy(), want)


def test_int8_matmul_wrapper_checks_before_any_launch():
    """Shapes that do not multiply are refused; operands neither all on
    the CPU nor all on the meta device reach the device check (the K-major
    check is for CUDA and for the meta device, which stands for it)."""
    with pytest.raises(ValueError, match='do not multiply'):
        tyv.int8_matmul(torch.zeros((2, 4), dtype=torch.int8, device='meta'),
                        torch.zeros((5, 3), dtype=torch.int8, device='meta'))
    with pytest.raises(ValueError, match='CUDA'):
        tyv.int8_matmul(torch.zeros((2, 4), dtype=torch.int8, device='meta'),
                        torch.zeros((3, 4), dtype=torch.int8).t())
    with pytest.raises(ValueError, match='K-major'):
        tyv.int8_matmul(torch.zeros((2, 4), dtype=torch.int8, device='meta'),
                        torch.zeros((4, 3), dtype=torch.int8, device='meta'))


B, PLEN, STEPS, PS = 2, 9, 6, 4


def _prompts():
    return np.random.RandomState(5).randint(0, 256, (B, PLEN)).astype(
        np.int32)


def _tables(w):
    return np.arange(1, 1 + B * w, dtype=np.int32).reshape(B, w)


def _reference_tokens(rp, cfg):
    yoco = ryl.YocoConfig(mode='w8a8', compute_dtype=jnp.float32)
    rt = rmodel.ModelRuntime(compute_dtype=jnp.float32)
    params = ryl.quantize_tree(rp)
    w = -(-(PLEN + STEPS) // PS)
    cache = rmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=jnp.float32)
    cache = rkvc.with_block_tables(cache, jnp.asarray(_tables(w)))
    prefill = jax.jit(lambda p, t, c: rmodel.prefill(p, dict(inputs=t), c,
                                                     cfg, yoco, rt))
    decode = jax.jit(lambda p, t, pos, c: rmodel.decode_step(p, t, pos, c,
                                                             cfg, yoco, rt))
    logits, cache = prefill(params, jnp.asarray(_prompts()), cache)
    rows, toks = [np.asarray(logits)], []
    for i in range(STEPS):
        tok = jnp.argmax(logits, -1).astype(jnp.int32)
        toks.append(np.asarray(tok))
        logits, cache = decode(params, tok,
                               jnp.full((B,), PLEN + i, jnp.int32), cache)
        rows.append(np.asarray(logits))
    return np.stack(rows), np.stack(toks)


def test_prequantized_forward_on_k_major_weights_gives_reference_tokens():
    cfg = rconfigs.get(ARCH, smoke=True)
    rp = rmodel.init_params(jax.random.key(3), cfg)
    want_l, want_t = _reference_tokens(rp, cfg)
    params = tyl.quantize_tree(tmodel.params_from_numpy(
        jax.tree.map(np.asarray, rp), cfg, 'cpu'))
    assert all(_is_k_major(q.wq) for q in _quantized_leaves(params))
    yoco = tyl.YocoConfig(mode='w8a8', compute_dtype=torch.float32)
    rt = tmodel.ModelRuntime(attn_impl='flash', compute_dtype=torch.float32)
    w = -(-(PLEN + STEPS) // PS)
    cache = tmodel.init_paged_cache_tree(cfg, B, num_pages=1 + B * w,
                                         page_size=PS, max_blocks=w,
                                         dtype=torch.float32, device='cpu')
    cache = tlayouts.with_block_tables(cache, _tables(w))
    logits, cache = tmodel.prefill(
        params, dict(inputs=torch.from_numpy(_prompts())), cache, cfg, yoco,
        rt)
    rows, toks = [logits.numpy()], []
    for i in range(STEPS):
        tok = torch.argmax(logits, -1).to(torch.int32)
        toks.append(tok.numpy())
        logits, cache = tmodel.decode_step(
            params, tok, torch.full((B,), PLEN + i, dtype=torch.int32), cache,
            cfg, yoco, rt)
        rows.append(logits.numpy())
    np.testing.assert_array_equal(np.stack(toks), want_t)
    np.testing.assert_allclose(np.stack(rows), want_l, rtol=1e-4, atol=1e-4)
