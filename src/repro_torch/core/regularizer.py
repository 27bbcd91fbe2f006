"""The entropy-proxy regularizer (eq. 12), the empirical Bpp / entropy
meter of a transmitted mask (eq. 13) and its companions."""
from __future__ import annotations

import torch

from repro_torch.core import tree as tu


def entropy_proxy(scores) -> torch.Tensor:
    """(1/n) * sum_j sigmoid(s_j) over every masked leaf — eq. (12)'s
    regularization term without lambda."""
    tot, n = None, 0
    for s in tu.leaves(scores):
        if s is None:
            continue
        part = torch.sigmoid(s.float()).sum()
        tot = part if tot is None else tot + part
        n += s.numel()
    if n == 0:
        return torch.tensor(0.0)
    return tot / torch.tensor(float(n), dtype=torch.float32,
                              device=tot.device)


def entropy_proxy_grad_(g: torch.Tensor, s: torch.Tensor, coef) -> None:
    """g += coef * sigmoid'(s): the proxy's gradient for one score block,
    with coef = lam / n, added in place (the train step's memory-light
    form of differentiating lam * entropy_proxy)."""
    sig = torch.sigmoid(s.float())
    g.add_(coef * sig * (1.0 - sig))


def binary_entropy(p: torch.Tensor, eps: float = 1e-7) -> torch.Tensor:
    """H(p) in bits, in float32."""
    p = torch.clamp(torch.as_tensor(p, dtype=torch.float32), eps, 1.0 - eps)
    return -(p * torch.log2(p) + (1 - p) * torch.log2(1 - p))


def _ones_and_n(mask):
    ones, n = None, 0
    for m in tu.leaves(mask):
        if m is None:
            continue
        part = m.float().sum()
        ones = part if ones is None else ones + part
        n += m.numel()
    return ones, n


def empirical_entropy(mask) -> torch.Tensor:
    """H of one client's transmitted binary mask, the fraction of ones
    over every masked leaf (eq. 13's inner term): the bits per parameter
    an ideal entropy coder reaches, the paper's reported metric."""
    ones, n = _ones_and_n(mask)
    if n == 0:
        return torch.tensor(0.0)
    return binary_entropy(ones / torch.tensor(float(n), device=ones.device))


def sparsity(mask) -> torch.Tensor:
    """Fraction of zeros in the transmitted mask."""
    ones, n = _ones_and_n(mask)
    if n == 0:
        return torch.tensor(0.0)
    return 1.0 - ones / torch.tensor(float(n), device=ones.device)


def theta_entropy(scores) -> torch.Tensor:
    """Expected transmitted entropy mean_j H(sigmoid(s_j)), reported in
    logs beside eq. 13."""
    tot, n = None, 0
    for s in tu.leaves(scores):
        if s is None:
            continue
        part = binary_entropy(torch.sigmoid(s.float())).sum()
        tot = part if tot is None else tot + part
        n += s.numel()
    if n == 0:
        return torch.tensor(0.0)
    return tot / torch.tensor(float(n), device=tot.device)
