"""Next-token cross-entropy with z-loss: the port's copy of ``repro.train.loss``.

Over a mesh the logits arrive as a DTensor split over the batch axes and
the vocabulary.  The loss runs as one region on the logits gathered over
the vocabulary (the log-sum-exp, the label's logit and the argmax each
need a row whole) and split over the batch as they lie: each rank's means
over its equal share of the batch, summed over the batch axes.
"""

from __future__ import annotations

import math

import torch

from repro_torch.models.common import Spec, axes_of, is_dtensor, region, replicated, spec_axes


def _lm_loss(logits: torch.Tensor, labels: torch.Tensor, z_loss: float):
    lf = logits.to(torch.float32)
    lse = torch.logsumexp(lf, dim=-1)
    ll = torch.gather(lf, -1, labels[..., None].long())[..., 0]
    nll = lse - ll
    z = z_loss * torch.square(lse)
    loss = torch.mean(nll + z)
    return loss, {
        "ce": torch.mean(nll),
        "z_loss": torch.mean(z),
        "accuracy": torch.mean((torch.argmax(lf, -1) == labels).to(torch.float32)),
    }


def lm_loss(logits: torch.Tensor, labels: torch.Tensor, *, z_loss: float = 1e-4):
    """logits (B,S,V) vs labels (B,S).  Returns (loss, metrics), in float32;
    replicated DTensors when the logits are a DTensor."""
    if not is_dtensor(logits):
        return _lm_loss(logits, labels, z_loss)
    mesh = logits.device_mesh
    rows = axes_of(logits, mesh)[:2]
    axes = spec_axes(rows)
    sizes = dict(zip(mesh.mesh_dim_names, mesh.mesh.shape))
    nb = math.prod(sizes[a] for a in axes)

    def body(lg, lb):
        loss, m = _lm_loss(lg, lb, z_loss)
        return (loss / nb, *(m[k] / nb for k in ("ce", "z_loss", "accuracy")))

    outs = region(body, (logits, labels), (Spec(*rows, None), Spec(*rows)), (Spec(),) * 4, partial=tuple(axes),
                  mesh=mesh)
    loss, ce, zl, acc = (replicated(o, mesh) for o in outs)
    return loss, {"ce": ce, "z_loss": zl, "accuracy": acc}
