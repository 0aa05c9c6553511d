"""Synthetic federated data, numpy copies of
``repro.data.synthetic.federated_classification`` and ``lm_dataset``.

A Gaussian-mixture multi-class task with label-shard non-IID partitioning
(each client holds ``classes_per_client`` classes, paper §2.2).  The draws
are the reference's, draw for draw, so the same seed gives the same arrays.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np


class FederatedClassification(NamedTuple):
    x: np.ndarray           # (N_clients, n_per_client, dim)
    y: np.ndarray           # (N_clients, n_per_client)
    test_x: np.ndarray      # (n_test, dim)
    test_y: np.ndarray      # (n_test,)
    client_classes: np.ndarray  # (N_clients, classes_per_client)
    num_classes: int


def federated_classification(num_clients: int, *, num_classes: int = 10,
                             dim: int = 32, n_per_client: int = 128,
                             classes_per_client: int = 2,
                             n_test: int = 2048, margin: float = 2.2,
                             noise: float = 1.0, partition: str = "shard",
                             dirichlet_alpha: float = 0.3,
                             seed: int = 0) -> FederatedClassification:
    """partition="shard": each client holds ``classes_per_client`` classes
    (paper §2.2); partition="dirichlet": class mixture ~ Dir(α) per client
    (the other standard non-IID protocol)."""
    rng = np.random.RandomState(seed)
    centers = rng.randn(num_classes, dim) * margin

    def sample(cls, n):
        return (centers[cls][None] + noise * rng.randn(n, dim)
                ).astype(np.float32)

    xs, ys, ccls = [], [], []
    for i in range(num_clients):
        if partition == "dirichlet":
            probs = rng.dirichlet(
                np.full(num_classes, dirichlet_alpha))
            classes = np.argsort(-probs)[:classes_per_client]
            ccls.append(classes)
            y = rng.choice(num_classes, n_per_client, p=probs)
            x = np.stack([sample(c, 1)[0] for c in y])
            xs.append(x)
            ys.append(y)
            continue
        # anchor class round-robin guarantees every class is represented
        anchor = i % num_classes
        rest = rng.choice([c for c in range(num_classes) if c != anchor],
                          classes_per_client - 1, replace=False)
        classes = np.concatenate([[anchor], rest])
        ccls.append(classes)
        y = rng.choice(classes, n_per_client)
        x = np.stack([sample(c, 1)[0] for c in y])
        xs.append(x)
        ys.append(y)
    ty = rng.randint(0, num_classes, n_test)
    tx = np.stack([sample(c, 1)[0] for c in ty])
    return FederatedClassification(
        np.stack(xs), np.stack(ys).astype(np.int32),
        tx, ty.astype(np.int32), np.stack(ccls), num_classes)


class LMData(NamedTuple):
    tokens: np.ndarray       # (N_clients, n_seq, seq_len + 1)
    vocab_size: int


def lm_dataset(num_clients: int, *, vocab_size: int = 4096,
               seq_len: int = 128, n_seq: int = 32,
               shard_frac: float = 0.25, seed: int = 0) -> LMData:
    """Bigram-structured token streams; client i only emits tokens from its
    vocabulary shard (non-IID).  The reference's draws, one by one."""
    rng = np.random.RandomState(seed)
    # global bigram successor table: tok -> 4 plausible next tokens
    succ = rng.randint(0, vocab_size, size=(vocab_size, 4))
    shard = max(int(vocab_size * shard_frac), 64)
    out = np.zeros((num_clients, n_seq, seq_len + 1), np.int32)
    for i in range(num_clients):
        lo = rng.randint(0, vocab_size - shard)
        for j in range(n_seq):
            t = rng.randint(lo, lo + shard)
            seq = [t]
            for _ in range(seq_len):
                if rng.rand() < 0.8:
                    t = succ[t, rng.randint(4)]
                else:
                    t = rng.randint(lo, lo + shard)
                seq.append(t)
            out[i, j] = seq
    return LMData(out, vocab_size)
