"""Deterministic, seeded synthetic data (port of
``repro/data/synthetic.py``) for every input kind: the same affine token
process — token ``t`` = (start + a * t(t+1)/2 + drift * t) % vocab with
sparse resets — for token streams and for each codebook of a codebook
grid, and standard-normal (B, S, d) rows with random labels for
embeddings input (the stubbed frontend's patch embeddings), drawn from a
seeded ``torch.Generator``. The stream is stateless: shard ``shard`` of
``n_shards`` of batch ``step`` is a pure function of (seed, step, shard),
so a restarted or replaced process replays any step exactly. The draws
differ from JAX's PRNG stream, so tests that compare the two packages
hand both the same numpy-made batches instead."""

from __future__ import annotations

import dataclasses
from typing import Iterator, Optional

import torch


@dataclasses.dataclass(frozen=True)
class DataConfig:
    seed: int = 1234
    global_batch: int = 8
    seq_len: int = 128
    vocab_size: int = 256
    input_kind: str = 'tokens'        # tokens | codebooks | embeddings
    n_codebooks: int = 1
    d_model: int = 0                  # for embeddings input
    n_shards: int = 1
    shard: int = 0

    @property
    def local_batch(self) -> int:
        if self.global_batch % self.n_shards:
            raise ValueError(f'global_batch {self.global_batch} does not '
                             f'split into {self.n_shards} shards')
        return self.global_batch // self.n_shards


def _token_batch(gen: torch.Generator, batch: int, seq: int,
                 vocab: int) -> torch.Tensor:
    a = torch.randint(1, 8, (batch, 1), generator=gen)
    drift = torch.randint(0, vocab, (batch, 1), generator=gen)
    start = torch.randint(0, vocab, (batch, 1), generator=gen)
    idx = torch.arange(seq)[None, :]
    toks = (start + a * idx * (idx + 1) // 2 + drift * idx) % vocab
    resets = torch.rand((batch, seq), generator=gen) < 0.02
    noise = torch.randint(0, vocab, (batch, seq), generator=gen)
    return torch.where(resets, noise, toks).to(torch.int32)


def make_batch(cfg: DataConfig, step: int) -> dict:
    """Batch ``step`` of this shard: dict(inputs, labels) on the CPU, B =
    ``local_batch`` rows. Tokens: (B, S) int32 each; codebooks: (B, S, CB)
    int32 each, codebook c its own token process; embeddings: (B, S, d)
    f32 standard-normal inputs and (B, S) int32 labels in the
    vocabulary."""
    # the CPU generator keeps 32 bits of a seed: the shard is folded in
    gen = torch.Generator().manual_seed(
        (cfg.seed * 1_000_003 + step + cfg.shard * 0x9E3779B1) % (1 << 32))
    b, s = cfg.local_batch, cfg.seq_len
    if cfg.input_kind == 'embeddings':
        x = torch.randn((b, s, cfg.d_model), generator=gen)
        labels = torch.randint(0, cfg.vocab_size, (b, s), generator=gen)
        return dict(inputs=x, labels=labels.to(torch.int32))
    if cfg.input_kind == 'codebooks':
        toks = torch.stack([_token_batch(gen, b, s + 1, cfg.vocab_size)
                            for _ in range(cfg.n_codebooks)], dim=-1)
        return dict(inputs=toks[:, :-1], labels=toks[:, 1:])
    toks = _token_batch(gen, b, s + 1, cfg.vocab_size)
    return dict(inputs=toks[:, :-1], labels=toks[:, 1:])


def iterate(cfg: DataConfig, start_step: int = 0,
            n_steps: Optional[int] = None) -> Iterator[dict]:
    step = start_step
    while n_steps is None or step < start_step + n_steps:
        yield make_batch(cfg, step)
        step += 1


def for_arch(arch_cfg, *, seed: int = 1234, global_batch: int = 8,
             seq_len: int = 128, n_shards: int = 1,
             shard: int = 0) -> DataConfig:
    return DataConfig(seed=seed, global_batch=global_batch, seq_len=seq_len,
                      vocab_size=arch_cfg.vocab_size,
                      input_kind=arch_cfg.input_kind,
                      n_codebooks=arch_cfg.n_codebooks,
                      d_model=arch_cfg.d_model, n_shards=n_shards,
                      shard=shard)
