"""Deterministic synthetic datasets standing in for the offline-unavailable
MLPerf Tiny datasets (CIFAR-10, ToyADMOS, Speech Commands) and LM token
streams.

A numpy-only copy of ``repro.data.synthetic``: every batch equals the
reference's bit for bit.

All generators are keyed by (seed, step) through a counter-based Philox
bit-generator, so any batch is reproducible from its index alone — which is
what makes checkpoint/restart exact (the data pipeline needs no state beyond
the step number) and multi-host sharding trivial (each host draws its own
shard deterministically).

The class-structured generators plant real signal (class-dependent means /
planted anomalies) so accuracy-like metrics behave qualitatively like the
paper's (quantization cliffs, Pareto fronts) even without the real data.
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Tuple

import numpy as np


def _rng(seed: int, step: int) -> np.random.Generator:
    return np.random.Generator(np.random.Philox(key=seed, counter=step))


@dataclasses.dataclass(frozen=True)
class SyntheticTokens:
    """LM token stream with Zipfian unigram structure + Markov bigram signal
    (so loss decreases measurably during the example trainings)."""

    vocab: int
    seq_len: int
    seed: int = 0

    def batch(self, step: int, batch_size: int) -> Dict[str, np.ndarray]:
        r = _rng(self.seed, step)
        # Zipf-ish marginal
        ranks = np.arange(1, self.vocab + 1)
        probs = 1.0 / ranks
        probs /= probs.sum()
        toks = r.choice(self.vocab, size=(batch_size, self.seq_len + 1), p=probs)
        # plant bigram predictability: with p=0.5, next = (prev*7+3) % vocab
        flip = r.random((batch_size, self.seq_len)) < 0.5
        nxt = (toks[:, :-1] * 7 + 3) % self.vocab
        toks[:, 1:] = np.where(flip, nxt, toks[:, 1:])
        return {
            "tokens": toks[:, :-1].astype(np.int32),
            "labels": toks[:, 1:].astype(np.int32),
        }


@dataclasses.dataclass(frozen=True)
class SyntheticImages:
    """CIFAR-like (32x32x3) images with class-dependent frequency content."""

    n_classes: int = 10
    hw: int = 32
    seed: int = 0

    def batch(self, step: int, batch_size: int) -> Tuple[np.ndarray, np.ndarray]:
        r = _rng(self.seed, step)
        y = r.integers(0, self.n_classes, size=batch_size)
        xs = []
        grid = np.linspace(0, 2 * np.pi, self.hw)
        gx, gy = np.meshgrid(grid, grid)
        for c in y:
            base = (
                np.sin((c + 1) * gx)[..., None]
                + np.cos((c + 1) * gy)[..., None]
                + 0.3 * (c / self.n_classes)
            )
            img = np.repeat(base, 3, axis=-1) + 0.35 * r.standard_normal((self.hw, self.hw, 3))
            xs.append(img)
        x = np.stack(xs).astype(np.float32)
        return x / np.abs(x).max(), y.astype(np.int32)


@dataclasses.dataclass(frozen=True)
class SyntheticMelWindows:
    """AD task stand-in: 128-dim mel windows; normals live on a low-rank
    manifold, anomalies get off-manifold noise (so AUC is meaningful)."""

    dim: int = 128
    rank: int = 8
    seed: int = 0

    def _basis(self) -> np.ndarray:
        r = _rng(self.seed, 0)
        b, _ = np.linalg.qr(r.standard_normal((self.dim, self.rank)))
        return b

    def batch(self, step: int, batch_size: int, anomaly_frac: float = 0.0):
        r = _rng(self.seed, step + 1)
        basis = self._basis()
        z = r.standard_normal((batch_size, self.rank))
        x = z @ basis.T + 0.05 * r.standard_normal((batch_size, self.dim))
        n_anom = int(batch_size * anomaly_frac)
        y = np.zeros(batch_size, np.int32)
        if n_anom:
            x[:n_anom] += 0.7 * r.standard_normal((n_anom, self.dim))
            y[:n_anom] = 1
        return x.astype(np.float32), y


@dataclasses.dataclass(frozen=True)
class SyntheticMFCC:
    """KWS stand-in: 490-dim MFCC-like features, 12 classes with imbalanced
    'unknown' class (paper: ~17x more frequent) and class-dependent means."""

    dim: int = 490
    n_classes: int = 12
    unknown_class: int = 11
    unknown_boost: float = 17.0
    seed: int = 0

    def class_probs(self) -> np.ndarray:
        p = np.ones(self.n_classes)
        p[self.unknown_class] = self.unknown_boost
        return p / p.sum()

    def batch(self, step: int, batch_size: int, balanced: bool = False):
        r = _rng(self.seed, step + 7)
        if balanced:
            y = r.integers(0, self.n_classes, size=batch_size)
        else:
            y = r.choice(self.n_classes, size=batch_size, p=self.class_probs())
        protos = _rng(self.seed, 1).standard_normal((self.n_classes, self.dim))
        x = protos[y] + 0.8 * r.standard_normal((batch_size, self.dim))
        return x.astype(np.float32), y.astype(np.int32)
