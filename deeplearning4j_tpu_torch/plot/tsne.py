"""t-SNE embeddings (counterpart of `deeplearning4j_tpu/plot/tsne.py`).

Reference: `plot/Tsne.java` (423 LoC, exact O(N^2)) and
`plot/BarnesHutTsne.java` (868 LoC, O(N log N) with SpTree).

The exact variant's gradient steps run on `device` (CUDA by default):
the [N, N] affinity and gradient blocks are dense matmul and elementwise
torch ops, float32 as the JAX package's are with x64 off; y, its
velocity and its gains are updated in place. The input affinities P are
host float64 numpy (the same binary search as JAX's, so bit-equal),
rounded to float32 once on their way to the device. Barnes-Hut stays a
host numpy + SpTree algorithm above 512 points, as in the JAX package
(adaptive tree traversal is host work there too); at or below 512
points, or with theta <= 0, it takes the exact path on `device`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from deeplearning4j_tpu_torch.clustering.sptree import SpTree
from deeplearning4j_tpu_torch.device import resolve_device


def _binary_search_perplexity(d2_row: np.ndarray, perplexity: float,
                              tol: float = 1e-5, max_iter: int = 50):
    """Find beta (1/2sigma^2) giving the target perplexity (reference
    Tsne.hBeta / d2p binary search)."""
    beta, beta_min, beta_max = 1.0, -np.inf, np.inf
    target = np.log(perplexity)
    p = np.zeros_like(d2_row)
    for _ in range(max_iter):
        p = np.exp(-d2_row * beta)
        s = p.sum()
        if s <= 0:
            s = 1e-12
        h = np.log(s) + beta * np.sum(d2_row * p) / s
        p = p / s
        diff = h - target
        if abs(diff) < tol:
            break
        if diff > 0:
            beta_min = beta
            beta = beta * 2 if beta_max == np.inf else (beta + beta_max) / 2
        else:
            beta_max = beta
            beta = beta / 2 if beta_min == -np.inf else (beta + beta_min) / 2
    return p


def _compute_p(x: np.ndarray, perplexity: float) -> np.ndarray:
    n = len(x)
    sum_x = np.sum(x * x, axis=1)
    d2 = np.maximum(sum_x[:, None] - 2 * x @ x.T + sum_x[None, :], 0.0)
    p = np.zeros((n, n))
    for i in range(n):
        row = np.delete(d2[i], i)
        pi = _binary_search_perplexity(row, perplexity)
        p[i, np.arange(n) != i] = pi
    p = (p + p.T) / (2 * n)
    return np.maximum(p, 1e-12)


@torch.no_grad()
def _tsne_step(p, y, velocity, gains, momentum: float, lr: float):
    """One exact t-SNE gradient step on p's device; updates y, velocity
    and gains in place and returns the KL divergence (a 0-d tensor, not
    read back). The gradient 4 (diag(rowsum(pq)) - pq) @ y is computed
    as 4 (rowsum(pq)[:, None] * y - pq @ y): the same sum without the
    two [N, N] temporaries."""
    sum_y = torch.sum(y * y, dim=1)
    num = 1.0 / (1.0 + sum_y[:, None] - 2.0 * y @ y.T + sum_y[None, :])
    num.fill_diagonal_(0.0)
    q = torch.clamp(num / torch.sum(num), min=1e-12)
    pq = (p - q).mul_(num)
    grad = 4.0 * (torch.sum(pq, dim=1)[:, None] * y - pq @ y)
    flip = torch.sign(grad) != torch.sign(velocity)
    torch.where(flip, gains + 0.2, gains * 0.8, out=gains)
    gains.clamp_(min=0.01)
    velocity.mul_(momentum).sub_(lr * gains * grad)
    y.add_(velocity)
    y.sub_(torch.mean(y, dim=0, keepdim=True))
    return torch.sum(p * torch.log(p / q))


class Tsne:
    """Exact t-SNE (reference `Tsne.java`), a gradient step at a time on
    `device`."""

    def __init__(self, n_components: int = 2, perplexity: float = 30.0,
                 learning_rate: float = 200.0, n_iter: int = 500,
                 momentum: float = 0.5, final_momentum: float = 0.8,
                 early_exaggeration: float = 12.0, seed: int = 0,
                 device="cuda"):
        self.n_components = n_components
        self.perplexity = perplexity
        self.learning_rate = learning_rate
        self.n_iter = n_iter
        self.momentum = momentum
        self.final_momentum = final_momentum
        self.early_exaggeration = early_exaggeration
        self.seed = seed
        self.device = resolve_device(device)
        self.kl_divergence_: Optional[float] = None

    def input_affinities(self, x: np.ndarray) -> np.ndarray:
        """P of `x` [N, D] (host float64, the JAX package's search at
        the perplexity it would use for N points)."""
        x = np.asarray(x, np.float64)
        perp = min(self.perplexity, max((len(x) - 1) / 3.0, 1.0))
        return _compute_p(x, perp)

    def initial_map(self, n: int) -> np.ndarray:
        """The starting map [n, n_components] (float64 numpy), the JAX
        package's draw from `default_rng(seed)`."""
        rng = np.random.default_rng(self.seed)
        return rng.standard_normal((n, self.n_components)) * 1e-4

    def descend(self, p: np.ndarray, y0: np.ndarray, steps: int,
                kl_steps=()):
        """The first `steps` of `n_iter`'s schedule (exaggeration to
        min(100, n_iter // 4), momentum switch at 250) from P and y0
        (numpy; float32 on the device). Returns y (float32 numpy), the
        last step's KL and {step: KL} for the steps in `kl_steps` (read
        back once, at the end)."""
        dev = self.device
        p_dev = torch.from_numpy(np.asarray(p)).to(dev, torch.float32)
        p_exag = p_dev * self.early_exaggeration
        y = torch.tensor(np.asarray(y0), dtype=torch.float32, device=dev)
        velocity = torch.zeros_like(y)
        gains = torch.ones_like(y)
        exag_end = min(100, self.n_iter // 4)
        kl, kept = None, {}
        for it in range(steps):
            mom = self.momentum if it < 250 else self.final_momentum
            kl = _tsne_step(p_exag if it < exag_end else p_dev, y, velocity,
                            gains, mom, self.learning_rate)
            if it in kl_steps:
                kept[it] = kl
        return (y.cpu().numpy(), None if kl is None else float(kl),
                {it: float(k) for it, k in kept.items()})

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        p = self.input_affinities(x)
        y, self.kl_divergence_, _ = self.descend(p, self.initial_map(len(x)),
                                                 self.n_iter)
        return y


class BarnesHutTsne(Tsne):
    """Barnes-Hut t-SNE (reference `BarnesHutTsne.java`): sparse input
    affinities from a kNN graph, SpTree-approximated repulsive forces."""

    def __init__(self, theta: float = 0.5, **kw):
        super().__init__(**kw)
        self.theta = theta

    def fit_transform(self, x: np.ndarray) -> np.ndarray:
        x = np.asarray(x, np.float64)
        n = len(x)
        if n <= 512 or self.theta <= 0:
            return super().fit_transform(x)  # exact, on the device
        perp = min(self.perplexity, (n - 1) / 3.0)
        k = int(min(n - 1, 3 * perp))
        # kNN graph via brute-force blocked distances (vectorised)
        sum_x = np.sum(x * x, axis=1)
        d2 = np.maximum(sum_x[:, None] - 2 * x @ x.T + sum_x[None, :], 0.0)
        np.fill_diagonal(d2, np.inf)
        nn_idx = np.argpartition(d2, k, axis=1)[:, :k]
        rows = np.repeat(np.arange(n), k)
        cols = nn_idx.ravel()
        p_vals = np.zeros(n * k)
        for i in range(n):
            p_vals[i * k:(i + 1) * k] = _binary_search_perplexity(
                d2[i, nn_idx[i]], perp)
        # symmetrize the sparse P
        pmat = {}
        for r, c, v in zip(rows, cols, p_vals):
            pmat[(r, c)] = pmat.get((r, c), 0.0) + v
            pmat[(c, r)] = pmat.get((c, r), 0.0) + v
        total = sum(pmat.values())
        sp_rows = np.array([rc[0] for rc in pmat])
        sp_cols = np.array([rc[1] for rc in pmat])
        sp_vals = np.array(list(pmat.values())) / total

        rng = np.random.default_rng(self.seed)
        y = rng.standard_normal((n, self.n_components)) * 1e-4
        velocity = np.zeros_like(y)
        gains = np.ones_like(y)
        exag_end = min(100, self.n_iter // 4)
        for it in range(self.n_iter):
            mom = self.momentum if it < 250 else self.final_momentum
            exag = self.early_exaggeration if it < exag_end else 1.0
            tree = SpTree.build(y)
            neg = np.zeros_like(y)
            z = 0.0
            for i in range(n):
                f = np.zeros(self.n_components)
                z += tree.compute_non_edge_forces(y[i], self.theta, f)
                neg[i] = f
            diff = y[sp_rows] - y[sp_cols]
            q_num = 1.0 / (1.0 + np.sum(diff * diff, axis=1))
            attr = np.zeros_like(y)
            np.add.at(attr, sp_rows, (exag * sp_vals * q_num)[:, None] * diff)
            grad = attr - neg / max(z, 1e-12)
            gains = np.where(np.sign(grad) != np.sign(velocity),
                             gains + 0.2, gains * 0.8)
            gains = np.maximum(gains, 0.01)
            velocity = mom * velocity - self.learning_rate * gains * grad
            y = y + velocity
            y = y - y.mean(axis=0, keepdims=True)
        return y
