"""Data pipeline: synthetic corpus -> packed token batches, per-host sharded.

The paper pretrains GPT-2-like models on internet text; for the repro we
ship a deterministic synthetic corpus (a mixture of Zipfian unigrams and
repeated n-gram motifs, so models have real structure to learn and loss
curves are meaningful), a byte-level tokenizer stub for real text, and a
packing loader that emits fixed-length ``{tokens, labels, mask}`` batches
with next-token labels.

For multi-host launches each host reads a disjoint shard
(``shard=(host_id, n_hosts)``).  This module is the port's copy of the
reference's pipeline (numpy only): both packages draw the same batches
from the same seed.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator

import numpy as np


@dataclasses.dataclass
class SyntheticCorpus:
    """Deterministic pseudo-text: Zipf unigrams + injected n-gram motifs."""

    vocab_size: int
    seed: int = 0
    motif_len: int = 8
    n_motifs: int = 64
    motif_prob: float = 0.3

    def __post_init__(self):
        rng = np.random.default_rng(self.seed)
        self._motifs = rng.integers(
            0, self.vocab_size, size=(self.n_motifs, self.motif_len))
        ranks = np.arange(1, self.vocab_size + 1)
        p = 1.0 / ranks**1.1
        self._p = p / p.sum()

    def tokens(self, n: int, *, stream: int = 0) -> np.ndarray:
        rng = np.random.default_rng((self.seed + 1) * 7919 + stream)
        out = np.empty(n, dtype=np.int32)
        i = 0
        while i < n:
            if rng.random() < self.motif_prob:
                m = self._motifs[rng.integers(self.n_motifs)]
                take = min(len(m), n - i)
                out[i : i + take] = m[:take]
                i += take
            else:
                take = min(int(rng.integers(4, 32)), n - i)
                out[i : i + take] = rng.choice(
                    self.vocab_size, size=take, p=self._p)
                i += take
        return out


def byte_tokenize(text: str, vocab_size: int) -> np.ndarray:
    """Byte-level tokenizer stub for real text files (mod-folded)."""
    b = np.frombuffer(text.encode("utf-8"), dtype=np.uint8).astype(np.int32)
    return b % vocab_size


@dataclasses.dataclass
class PackedLMLoader:
    """Packs a token stream into [batch, seq+1] windows -> tokens/labels."""

    corpus: SyntheticCorpus
    batch_size: int
    seq_len: int
    shard: tuple[int, int] = (0, 1)  # (host_id, n_hosts)

    def __iter__(self) -> Iterator[dict]:
        host, n_hosts = self.shard
        step = 0
        while True:
            stream = step * n_hosts + host
            flat = self.corpus.tokens(
                self.batch_size * (self.seq_len + 1), stream=stream)
            window = flat.reshape(self.batch_size, self.seq_len + 1)
            yield {
                "tokens": window[:, :-1].copy(),
                "labels": window[:, 1:].copy(),
                "mask": np.ones((self.batch_size, self.seq_len), np.float32),
            }
            step += 1


def make_batch_fn(cfg, batch_size: int, seq_len: int, *, seed: int = 0,
                  shard: tuple[int, int] = (0, 1)):
    """Arch-aware batch iterator (adds stub modality inputs for vlm/audio)."""
    rng = np.random.default_rng(seed + 1000 * shard[0])
    if cfg.arch_type == "vlm":
        text_len = seq_len - cfg.num_patches
        corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
        loader = iter(PackedLMLoader(corpus, batch_size, text_len, shard=shard))

        def nxt():
            b = next(loader)
            b["patch_embeds"] = rng.standard_normal(
                (batch_size, cfg.num_patches, cfg.vision_dim)).astype(np.float32)
            b["global_tokens"] = np.float32(batch_size * text_len)
            return b
        return nxt
    if cfg.arch_type == "audio":
        frames = min(cfg.encoder_frames, seq_len)
        corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
        loader = iter(PackedLMLoader(corpus, batch_size, seq_len, shard=shard))

        def nxt():
            b = next(loader)
            b["frames"] = rng.standard_normal(
                (batch_size, frames, cfg.frontend_dim)).astype(np.float32)
            b["global_tokens"] = np.float32(batch_size * seq_len)
            return b
        return nxt
    corpus = SyntheticCorpus(cfg.vocab_size, seed=seed)
    loader = iter(PackedLMLoader(corpus, batch_size, seq_len, shard=shard))

    def nxt():
        b = next(loader)
        b["global_tokens"] = np.float32(batch_size * seq_len)
        return b
    return nxt
