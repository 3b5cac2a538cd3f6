"""Sampled decoding (``runtime/serve_step.py::sample_tokens``) held to its
properties: JAX's PRNG cannot be reproduced in PyTorch, so the draws are
compared with their distribution, not with the reference's."""

import numpy as np
import pytest
import torch

from repro_torch.runtime import serve_step as SS


def _logits(seed, b=6, v=50):
    return torch.from_numpy(np.random.RandomState(seed).randn(b, v)
                            .astype(np.float32) * 3)


@pytest.mark.parametrize('temperature', [0.0, -1.0])
def test_nonpositive_temperature_is_argmax(temperature):
    lf = _logits(0)
    got = SS.sample_tokens(lf, torch.Generator().manual_seed(0),
                           temperature=temperature, top_k=5)
    assert got.dtype == torch.int32
    assert torch.equal(got, torch.argmax(lf, -1).to(torch.int32))


def test_top_k_one_is_argmax():
    lf = _logits(1).to(torch.bfloat16)
    gen = torch.Generator().manual_seed(1)
    for _ in range(20):
        got = SS.sample_tokens(lf, gen, temperature=2.0, top_k=1)
        assert torch.equal(got, torch.argmax(lf.float(), -1).to(torch.int32))


@pytest.mark.parametrize('top_k', [3, 10])
def test_draws_lie_in_the_top_k_set(top_k):
    lf = _logits(2)
    allowed = torch.topk(lf, top_k, dim=-1).indices
    gen = torch.Generator().manual_seed(2)
    seen = set()
    for _ in range(200):
        got = SS.sample_tokens(lf, gen, temperature=1.5, top_k=top_k)
        assert bool((allowed == got[:, None].long()).any(-1).all())
        seen.update(got.tolist())
    assert len(seen) > top_k        # more than one token drawn per row


def test_fixed_generator_seed_repeats_its_draws():
    lf = _logits(3)

    def draws(seed):
        gen = torch.Generator().manual_seed(seed)
        return torch.stack([SS.sample_tokens(lf, gen, temperature=0.8,
                                             top_k=20) for _ in range(10)])

    assert torch.equal(draws(7), draws(7))
    assert not torch.equal(draws(7), draws(8))


@pytest.mark.parametrize('temperature,top_k', [(1.0, 0), (0.7, 0), (1.3, 5)])
def test_frequencies_match_softmax(temperature, top_k):
    """20k draws over V=8 against softmax(l / T) (top-k masked): Pearson
    chi-square, p > 1e-3."""
    from scipy import stats
    lf = torch.tensor([[1.2, -0.3, 0.5, 2.0, -1.0, 0.0, 0.8, -2.5]])
    n = 20000
    got = SS.sample_tokens(lf.expand(n, 8), torch.Generator().manual_seed(4),
                           temperature=temperature, top_k=top_k)
    counts = np.bincount(got.numpy(), minlength=8)
    masked = lf.clone()
    if top_k:
        masked[masked < torch.topk(lf, top_k).values[..., -1:]] = -np.inf
    p = torch.softmax(masked / temperature, -1)[0].double().numpy()
    assert counts[p == 0].sum() == 0
    keep = p > 0
    chi2, pval = stats.chisquare(counts[keep], n * p[keep] / p[keep].sum())
    assert pval > 1e-3, (chi2, pval, counts, n * p)


def test_sampled_decode_step_takes_a_generator():
    """The greedy step keeps four arguments, the sampled step takes the
    generator as a fifth; at temperature 0 both give the argmax."""
    import inspect

    from repro_torch import configs
    from repro_torch.models import model as M
    cfg = configs.get('stablelm-1.6b', smoke=True)
    greedy = SS.make_decode_step(cfg)
    sampled = SS.make_decode_step(cfg, greedy=False, temperature=0.0)
    assert len(inspect.signature(greedy).parameters) == 4
    assert len(inspect.signature(sampled).parameters) == 5
    params = M.init_params(torch.Generator().manual_seed(0), cfg,
                           device='cpu')
    toks = torch.tensor([3, 9], dtype=torch.int32)
    outs = []
    for step, extra in ((greedy, ()), (sampled, (torch.Generator(),))):
        cache = M.init_cache_tree(cfg, 2, 4, device='cpu')
        outs.append(step(params, toks, torch.tensor(0), cache, *extra)[0])
    assert torch.equal(outs[0], outs[1])
