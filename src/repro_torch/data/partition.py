"""Federated dataset partitioners (`repro.data.partition`, copied: numpy
`Generator` draws, so the port's indices equal the reference's; paper
Sec. IV).

* IID: even random split across K devices.
* by-class: each device gets a random subset of c classes (the paper's
  non-IID setting, c in {2, 4}).
* Dirichlet(alpha): label-distribution skew (beyond-paper, standard in
  the FL literature).
"""
from __future__ import annotations

import numpy as np


def partition_iid(rng: np.random.Generator, labels: np.ndarray, k: int):
    idx = rng.permutation(len(labels))
    return [np.sort(s) for s in np.array_split(idx, k)]


def partition_by_class(rng: np.random.Generator, labels: np.ndarray,
                       k: int, c: int):
    """Each client is assigned c random classes; the pool of each class
    is split evenly among the clients that hold it."""
    n_classes = int(labels.max()) + 1
    holders: dict[int, list[int]] = {cl: [] for cl in range(n_classes)}
    assign = []
    for i in range(k):
        classes = rng.choice(n_classes, size=c, replace=False)
        assign.append(classes)
        for cl in classes:
            holders[int(cl)].append(i)
    out: list[list[int]] = [[] for _ in range(k)]
    for cl in range(n_classes):
        pool = np.where(labels == cl)[0]
        rng.shuffle(pool)
        hs = holders[cl] or [int(rng.integers(k))]
        for j, chunk in enumerate(np.array_split(pool, len(hs))):
            out[hs[j]].extend(chunk.tolist())
    return [np.sort(np.asarray(ix, np.int64)) for ix in out]


def partition_dirichlet(rng: np.random.Generator, labels: np.ndarray,
                        k: int, alpha: float = 0.5):
    n_classes = int(labels.max()) + 1
    out: list[list[int]] = [[] for _ in range(k)]
    for cl in range(n_classes):
        pool = np.where(labels == cl)[0]
        rng.shuffle(pool)
        props = rng.dirichlet([alpha] * k)
        cuts = (np.cumsum(props) * len(pool)).astype(int)[:-1]
        for i, chunk in enumerate(np.split(pool, cuts)):
            out[i].extend(chunk.tolist())
    return [np.sort(np.asarray(ix, np.int64)) for ix in out]
