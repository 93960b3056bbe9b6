"""Viterbi sequence decoder (counterpart of
`deeplearning4j_tpu/util/viterbi.py`).

Reference: `deeplearning4j-nn/.../util/Viterbi.java` — smooths a
sequence of (possibly noisy) label observations with an HMM whose
emission model is "observed label is correct with pCorrect" and whose
transition model is metastable (stay in the current state with
probability `meta_stability`, hop uniformly otherwise). decode()
returns the most likely hidden label sequence. `viterbi_decode` takes a
full emission log-prob matrix for general HMM decoding.

The max-product recursion and its backtrace run on `device` (CUDA by
default) as one launch of the hand-written scan kernel
(`kernels/viterbi.py`); on the CPU its plain version. The tables are
float32 on the device, as the JAX package's are with x64 off: the log
tables are built in float64 numpy and rounded once.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from deeplearning4j_tpu_torch.device import resolve_device
from deeplearning4j_tpu_torch.kernels.viterbi import viterbi


def _table(a, device) -> torch.Tensor:
    """`a` (numpy of any float dtype, or a tensor) as float32 on
    `device`, rounded once as `jnp.asarray` rounds with x64 off."""
    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(np.asarray(a))
    return t.to(device=device, dtype=torch.float32)


class Viterbi:
    """Noisy-label smoothing decoder (reference `Viterbi.java`
    parameterization)."""

    def __init__(self, num_states: int, p_correct: float = 0.99,
                 meta_stability: float = 0.9, device="cuda"):
        if num_states < 2:
            raise ValueError("need at least 2 states")
        self.device = resolve_device(device)
        self.num_states = int(num_states)
        self.p_correct = float(p_correct)
        self.meta_stability = float(meta_stability)
        S = self.num_states
        # emission: observed == hidden with p_correct, else uniform leak
        emit = np.full((S, S), (1.0 - self.p_correct) / (S - 1))
        np.fill_diagonal(emit, self.p_correct)
        self._log_emit = np.log(emit)                    # [hidden, observed]
        # transition: metastable diagonal
        trans = np.full((S, S), (1.0 - self.meta_stability) / (S - 1))
        np.fill_diagonal(trans, self.meta_stability)
        self._log_trans = np.log(trans)
        self._log_prior = np.full((S,), -np.log(S))

    def decode(self, labels) -> Tuple[float, np.ndarray]:
        """`labels`: [T] int observations or [T, S] one-hot/prob matrix
        (reference's binary label matrix form). Returns
        (best_path_log_prob, smoothed labels [T])."""
        labels = np.asarray(labels)
        if labels.ndim == 2:                             # binary label matrix
            labels = labels.argmax(axis=-1)
        obs = labels.astype(np.int32)
        log_em = self._log_emit[:, obs].T                # [T, S]
        score, path = viterbi(_table(log_em, self.device),
                              _table(self._log_trans, self.device),
                              _table(self._log_prior, self.device))
        return float(score), path.cpu().numpy()


def viterbi_decode(log_emissions, log_transitions,
                   log_prior: Optional[np.ndarray] = None, device="cuda"):
    """General HMM max-product decoding: log_emissions [T,S],
    log_transitions [S,S], optional log_prior [S] (numpy or tensors,
    taken as float32 on `device`). The default prior is -log(S) rounded
    to float32 (JAX computes a float32 log, one ulp off at a few S).
    Returns (best_log_prob, path)."""
    device = resolve_device(device)
    em = _table(log_emissions, device)
    S = em.shape[-1]
    if log_prior is None:
        log_prior = np.full((S,), -np.log(S), np.float32)
    score, path = viterbi(em, _table(log_transitions, device),
                          _table(log_prior, device))
    return float(score), path.cpu().numpy()
