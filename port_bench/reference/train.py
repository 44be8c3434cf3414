"""Training steps of the reference: the loss and its gradients by
autograd, the global-norm clip and Adam, written from the configuration
(``TRAIN.OPTIMIZER: adam``, ``LR``, ``GRAD_CLIP``, ``WD``).

Clip: a gradient whose global norm ``n`` is at least the limit is scaled
by ``limit / n``.  Adam: ``b1 = 0.9``, ``b2 = 0.999``, ``eps = 1e-8``,
bias-corrected moments, ``p -= lr * (m_hat / (sqrt(v_hat) + eps) + wd *
p)``.
"""

from __future__ import annotations

import torch

from port_bench.reference import model as M

B1, B2, EPS = 0.9, 0.999, 1e-8


def leaf_norms(tensors: dict) -> dict:
    return {k: float(torch.linalg.vector_norm(v.double())) for k, v in
            tensors.items()}


def follow(spec: M.ModelSpec, g: M.Graph, train_edges, ratings_of_edges,
           params0: dict, steps, lr, clip, wd=0.0):
    """Run ``len(steps)`` training steps from ``params0``.  Each step is a
    dict of the batch the benchmark recorded: ``pu``, ``pi`` (the pairs),
    ``noise_u``, ``noise_i``, ``recon_u``, ``recon_i`` and ``masks``.  The
    pairs' ratings, the batch edges taken out of the graph, the degrees
    and the normalisation are worked out here from the graph.

    Returns ``{'losses': [...], 'grad1': {leaf: norm of the clipped first
    gradient}, 'delta': {leaf: norm of the change after the steps}}``."""
    dev = g.user.device
    train_ratings = ratings_of_edges[train_edges]
    mean = float(train_ratings.double().mean())
    std = float(train_ratings.double().std(unbiased=False))
    p = {k: v.detach().clone().to(dev).requires_grad_(True)
         for k, v in params0.items()}
    mu = {k: torch.zeros_like(v) for k, v in p.items()}
    nu = {k: torch.zeros_like(v) for k, v in p.items()}
    train_keep = torch.zeros(g.user.numel(), dtype=torch.bool, device=dev)
    train_keep[train_edges] = True
    losses, grad1 = [], None
    for t, st in enumerate(steps, start=1):
        pu, pi = st["pu"].to(dev).long(), st["pi"].to(dev).long()
        edge, hit = g.find(train_edges, pu, pi)
        if not bool(hit.all()):
            raise ValueError("a batch pair is not a training edge")
        keep = train_keep.clone()
        keep[edge] = False
        pred, recon = M.forward(p, spec, g, keep, st["noise_u"].to(dev),
                                st["noise_i"].to(dev), pu, pi, st["masks"],
                                static=train_keep)
        loss = M.loss(p, spec, pred, recon, ratings_of_edges[edge], mean,
                      std, st["recon_u"].to(dev).float(),
                      st["recon_i"].to(dev).float())
        names = list(p)
        grads = dict(zip(names, torch.autograd.grad(
            loss, [p[k] for k in names])))
        losses.append(float(loss.detach()))
        with torch.no_grad():
            gnorm = torch.sqrt(sum((v.double() ** 2).sum()
                                   for v in grads.values()))
            scale = 1.0 if float(gnorm) < clip else clip / float(gnorm)
            grads = {k: v * scale for k, v in grads.items()}
            if grad1 is None:
                grad1 = leaf_norms(grads)
            c1, c2 = 1 - B1 ** t, 1 - B2 ** t
            for k, v in p.items():
                mu[k].mul_(B1).add_(grads[k], alpha=1 - B1)
                nu[k].mul_(B2).addcmul_(grads[k], grads[k], value=1 - B2)
                upd = (mu[k] / c1) / (torch.sqrt(nu[k] / c2) + EPS)
                if wd:
                    upd = upd + wd * v
                v.sub_(lr * upd)
    delta = leaf_norms({k: (p[k].detach() - params0[k].to(dev))
                        for k in p})
    return {"losses": losses, "grad1": grad1, "delta": delta}

