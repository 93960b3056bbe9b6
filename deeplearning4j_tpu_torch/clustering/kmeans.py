"""K-means clustering (counterpart of
`deeplearning4j_tpu/clustering/kmeans.py`).

Reference: `clustering/kmeans/KMeansClustering.java` + the generic
clustering framework (`algorithm/BaseClusteringAlgorithm`, strategies,
iteration conditions). Each Lloyd iteration runs on `device` (CUDA by
default) as a handful of torch ops: the [N, K] squared distances are
``x2 - 2 x·cᵀ + c2`` with one [N, D] x [D, K] matmul, the centroid sums
a one-hot [K, N] x [N, D] matmul as JAX's (no `index_add_`: its atomics
on the card make the sums depend on the run). The k-means++ init stays
numpy, draw for draw the JAX package's; points and centroids are float32
on the device, as JAX's are with x64 off.
"""

from __future__ import annotations

from typing import List, Optional

import numpy as np
import torch
import torch.nn.functional as F

from deeplearning4j_tpu_torch.device import resolve_device


@torch.no_grad()
def _lloyd_step(points, centroids):
    # squared euclidean via (x-c)^2 = x^2 - 2xc + c^2; the cross term is
    # a single [N,D]x[D,K] matmul
    x2 = torch.sum(points * points, dim=1, keepdim=True)
    c2 = torch.sum(centroids * centroids, dim=1)[None, :]
    d2 = x2 - 2.0 * points @ centroids.T + c2
    assign = torch.argmin(d2, dim=1)
    K = centroids.shape[0]
    one_hot = F.one_hot(assign, K).to(points.dtype)              # [N,K]
    counts = torch.sum(one_hot, dim=0)                           # [K]
    sums = one_hot.T @ points                                    # [K,D]
    new_centroids = torch.where(counts[:, None] > 0,
                                sums / torch.clamp(counts[:, None], min=1.0),
                                centroids)
    cost = torch.sum(torch.amin(d2, dim=1))
    return new_centroids, assign, cost


def kmeans_pp_init(points: np.ndarray, k: int, seed: int) -> np.ndarray:
    """The k-means++ style starting centroids [k, D] (float32 numpy):
    the JAX package's draws from `default_rng(seed)`, in its order."""
    rng = np.random.default_rng(seed)
    centroids = [points[rng.integers(len(points))]]
    for _ in range(1, k):
        d2 = np.min(
            [np.sum((points - c[None, :]) ** 2, axis=1) for c in centroids],
            axis=0)
        probs = d2 / max(d2.sum(), 1e-12)
        centroids.append(points[rng.choice(len(points), p=probs)])
    return np.stack(centroids)


class Cluster:
    def __init__(self, center: np.ndarray, points: List[int]):
        self.center = center
        self.points = points


class ClusterSet:
    """Centroids [K, D], assignments [N] (int32) and the last cost, as
    numpy; `iterations` is the number of Lloyd steps taken."""

    def __init__(self, centroids: np.ndarray, assignments: np.ndarray,
                 cost: float, iterations: Optional[int] = None):
        self.centroids = centroids
        self.assignments = assignments
        self.cost = cost
        self.iterations = iterations

    def get_clusters(self) -> List[Cluster]:
        return [Cluster(self.centroids[k],
                        list(np.nonzero(self.assignments == k)[0]))
                for k in range(len(self.centroids))]

    def nearest_cluster(self, point) -> int:
        d = np.sum((self.centroids - np.asarray(point)[None, :]) ** 2, axis=1)
        return int(np.argmin(d))


class KMeansClustering:
    """`KMeansClustering.setup(k, maxIterations, distance)` equivalent."""

    def __init__(self, k: int, max_iterations: int = 100,
                 min_delta: float = 1e-6, seed: int = 0, device="cuda"):
        self.k = k
        self.max_iterations = max_iterations
        self.min_delta = min_delta
        self.seed = seed
        self.device = resolve_device(device)

    def apply_to(self, points) -> ClusterSet:
        points = np.asarray(points, np.float32)
        centroids = torch.from_numpy(
            kmeans_pp_init(points, self.k, self.seed)).to(self.device)
        pts = torch.from_numpy(points).to(self.device)
        prev_cost = np.inf
        assign = None
        cost = np.inf
        it = 0
        for it in range(1, self.max_iterations + 1):
            centroids, assign, cost = _lloyd_step(pts, centroids)
            cost = float(cost)
            if abs(prev_cost - cost) < self.min_delta:
                break
            prev_cost = cost
        return ClusterSet(
            centroids.cpu().numpy(),
            None if assign is None else assign.to(torch.int32).cpu().numpy(),
            cost, it)
