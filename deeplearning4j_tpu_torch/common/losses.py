"""Loss functions (counterpart of `deeplearning4j_tpu/common/losses.py`:
`_finish` :36, `LossFunction` :46, `LossMSE` :70 through
`LossCosineProximity` :195, `get_loss` :216, `loss_from_dict` :227).

A loss's `score_array(labels, preout, activation, mask, weights)` gives
per-example scores ([batch] or [batch, time]): the per-output terms,
times the optional per-output `weights`, summed over the feature axis,
times the optional `mask`. `__call__` reduces them: the mean over
examples, or with a mask the masked sum over `max(Σmask, 1)`. Gradients
come from autograd, as they come from JAX's. The fused paths are the
JAX package's: log-softmax for mcxent under softmax, the logits form
for xent under sigmoid.
"""

from __future__ import annotations

import torch

from deeplearning4j_tpu_torch.common.activations import clip, get_activation

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
        sa = self.score_array(labels, preout, get_activation(activation),
                              mask, weights)
        if mask is not None:
            return sa.sum() / torch.clamp(mask.sum(), min=1.0)
        return sa.mean()

    def to_dict(self):
        return {"loss": self.name}

    def __eq__(self, other):
        return type(self) is type(other) and self.__dict__ == other.__dict__

    def __repr__(self):
        return f"{type(self).__name__}()"


class LossMSE(LossFunction):
    name = "mse"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        out = activation(preout)
        per = (out - labels) ** 2 / labels.shape[-1]
        return _finish(per, mask, weights)


class LossL2(LossFunction):
    """Sum of squared errors (MSE without the 1/n)."""

    name = "l2"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        return _finish((activation(preout) - labels) ** 2, mask, weights)


class LossMAE(LossFunction):
    name = "mae"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        per = (activation(preout) - labels).abs() / labels.shape[-1]
        return _finish(per, mask, weights)


class LossL1(LossFunction):
    name = "l1"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        return _finish((activation(preout) - labels).abs(), mask, weights)


class LossMSLE(LossFunction):
    name = "msle"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        out = activation(preout)
        per = (torch.log1p(clip(out, -1 + _EPS))
               - torch.log1p(labels)) ** 2 / labels.shape[-1]
        return _finish(per, mask, weights)


class LossBinaryXENT(LossFunction):
    """Binary cross-entropy; the logits form under sigmoid."""

    name = "xent"

    def __init__(self, clip_eps: float = _EPS):
        self.clip_eps = clip_eps

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        if activation.name == "sigmoid":
            # max(x, 0) - x*z + log1p(exp(-|x|))
            x, z = preout, labels
            per = (clip(x, 0.0) - x * z
                   + torch.log1p(torch.exp(-x.abs())))
        else:
            out = clip(activation(preout), self.clip_eps,
                       1.0 - self.clip_eps)
            per = -(labels * torch.log(out)
                    + (1 - labels) * torch.log(1 - out))
        return _finish(per, mask, weights)


class LossMCXENT(LossFunction):
    """Multi-class cross-entropy; the fused `log_softmax(preout)` path
    when the activation is softmax."""

    name = "mcxent"

    def __init__(self, soft_label_clip: float = _EPS):
        self.soft_label_clip = soft_label_clip

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        if activation.name == "softmax":
            per = -labels * torch.log_softmax(preout, dim=-1)
        else:
            out = activation(preout)
            per = -labels * torch.log(clip(out, self.soft_label_clip, 1.0))
        return _finish(per, mask, weights)


class LossNegativeLogLikelihood(LossMCXENT):
    """Alias of MCXENT (as in the reference)."""

    name = "negativeloglikelihood"


class LossHinge(LossFunction):
    name = "hinge"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        y = 2.0 * labels - 1.0                     # {0, 1} -> {-1, 1}
        per = clip(1.0 - y * activation(preout), 0.0)
        return _finish(per, mask, weights)


class LossSquaredHinge(LossFunction):
    name = "squaredhinge"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        y = 2.0 * labels - 1.0
        per = clip(1.0 - y * activation(preout), 0.0) ** 2
        return _finish(per, mask, weights)


class LossKLD(LossFunction):
    name = "kl_divergence"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        out = clip(activation(preout), _EPS, 1.0)
        lab = clip(labels, _EPS, 1.0)
        return _finish(lab * (torch.log(lab) - torch.log(out)), mask,
                       weights)


class LossPoisson(LossFunction):
    name = "poisson"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        out = activation(preout)
        per = out - labels * torch.log(clip(out, _EPS))
        return _finish(per, mask, weights)


class LossCosineProximity(LossFunction):
    name = "cosine_proximity"

    def score_array(self, labels, preout, activation, mask=None,
                    weights=None):
        out = activation(preout)
        ln = torch.linalg.vector_norm(labels, dim=-1, keepdim=True)
        on = torch.linalg.vector_norm(out, dim=-1, keepdim=True)
        cos = ((labels * out).sum(dim=-1, keepdim=True)
               / clip(ln * on, _EPS))
        return _finish(-cos, mask, weights)


_LOSSES = {cls.name: cls for cls in (
    LossMSE, LossL2, LossMAE, LossL1, LossMSLE, LossBinaryXENT, LossMCXENT,
    LossNegativeLogLikelihood, LossHinge, LossSquaredHinge, LossKLD,
    LossPoisson, LossCosineProximity)}


def get_loss(loss) -> LossFunction:
    if isinstance(loss, LossFunction):
        return loss
    if isinstance(loss, str):
        key = loss.lower()
        if key not in _LOSSES:
            raise ValueError(f"Unknown loss {loss!r}. Known: "
                             f"{sorted(_LOSSES)}")
        return _LOSSES[key]()
    raise TypeError(f"Cannot interpret {loss!r} as a loss function")


def loss_from_dict(d: dict) -> LossFunction:
    return get_loss(d["loss"])
