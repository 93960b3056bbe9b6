"""Loss functions (counterpart of `deeplearning4j_tpu/common/losses.py`:
`LossFunction` :46, `LossMCXENT` :135, `LossNegativeLogLikelihood` :153,
`get_loss`). Only the multi-class cross-entropy the LM trains with is
ported; the rest of the catalog is a later slice.

A loss's `score_array(labels, preout, activation, mask, weights)` gives
per-example scores ([batch] or [batch, time]); `__call__` reduces them:
the mean over examples, or with a mask the masked sum over
`max(Σmask, 1)`.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common.activations import get_activation

_EPS = 1e-7


def _finish(per_elem, mask, weights):
    """Per-output weights and the mask; sum over the feature axis."""
    if weights is not None:
        per_elem = per_elem * torch.as_tensor(weights, dtype=per_elem.dtype,
                                              device=per_elem.device)
    score = per_elem.sum(dim=-1)
    if mask is not None:
        score = score * mask
    return score


class LossFunction:
    name: str = "base"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        raise NotImplementedError

    def __call__(self, labels, preout, activation, mask=None, weights=None):
        """Mean score over examples (and masked timesteps)."""
        sa = self.score_array(labels, preout, activation, mask, weights)
        if mask is not None:
            return sa.sum() / torch.clamp(mask.sum(), min=1.0)
        return sa.mean()


class LossMCXENT(LossFunction):
    """Multi-class cross-entropy; the fused `log_softmax(preout)` path
    when the activation is softmax."""

    name = "mcxent"

    def __init__(self, soft_label_clip: float = _EPS):
        self.soft_label_clip = soft_label_clip

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        if get_activation(activation) is get_activation("softmax"):
            per = -labels * torch.log_softmax(preout, dim=-1)
        else:
            out = get_activation(activation)(preout)
            per = -labels * torch.log(torch.clamp(out, self.soft_label_clip,
                                                  1.0))
        return _finish(per, mask, weights)


class LossNegativeLogLikelihood(LossMCXENT):
    """Alias of MCXENT (as in the reference)."""

    name = "negativeloglikelihood"


_LOSSES = {"mcxent": LossMCXENT,
           "negativeloglikelihood": LossNegativeLogLikelihood}


def get_loss(name) -> LossFunction:
    if isinstance(name, LossFunction):
        return name
    cls = _LOSSES.get(str(name).lower())
    if cls is None:
        raise ValueError(f"loss {name!r} is not ported yet; known: "
                         f"{sorted(_LOSSES)}")
    return cls()
