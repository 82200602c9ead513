"""Mini-batch SGD with the gradient reduced over the mesh (B10).

Port of ``dampr_tpu/parallel/sgd.py``: logistic regression, the batch
sharded over the mesh, the parameters replicated.  Each shard computes
the mean loss of its rows and its gradient with ``torch.autograd``; the
global loss is the mean of the shards' losses, so its gradient is the
psum of the shards' gradients over D (what the reference's transpose
rules insert around its ``shard_map``).  ``X @ w`` is ``torch.matmul``,
as the reference's product is outside any Pallas kernel.

Parameters arrive and leave as numpy (``{"w": float32 [F], "b":
float32}``), so :func:`init_params` (the reference's, value for value)
carries either package's parameters into the other.
"""

import numpy as np

from . import mesh as _mesh


def init_params(n_features, seed=0):
    rng = np.random.RandomState(seed)
    return {"w": (rng.randn(n_features) * 0.01).astype(np.float32),
            "b": np.float32(0.0)}


def _loss(w, b, X, y):
    import torch

    logits = torch.matmul(X, w) + b
    # the numerically stable logistic loss, mean over the local shard
    return torch.mean(torch.clamp(logits, min=0) - logits * y
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def _shards(mesh, a):
    """Rows of ``a`` in D equal contiguous shards on the shards' devices."""
    import torch

    t = a if isinstance(a, torch.Tensor) else torch.from_numpy(
        np.ascontiguousarray(a, dtype=np.float32))
    D = _mesh.mesh_size(mesh)
    assert t.shape[0] % D == 0, (
        "batch {} must divide across {} devices".format(t.shape[0], D))
    return _mesh.shard(mesh, t)


#: Steps since import.
steps = 0


def _step(mesh, w, b, Xs, ys, lr):
    """One step over sharded rows: ``w``/``b`` on the first shard's
    device.  Returns the new ``(w, b)`` there and the global loss."""
    import torch

    global steps
    steps += 1
    D = _mesh.mesh_size(mesh)
    losses, gw, gb = [], [], []
    for d, dev in enumerate(mesh.devices):
        wd = w.detach().to(dev).requires_grad_(True)
        bd = b.detach().to(dev).requires_grad_(True)
        loss = _loss(wd, bd, Xs[d], ys[d])
        dw, db = torch.autograd.grad(loss, (wd, bd))
        losses.append(loss.detach())
        gw.append(dw / D)
        gb.append(db / D)
    grad_w = _mesh.psum(mesh, gw)[0]
    grad_b = _mesh.psum(mesh, gb)[0]
    loss = _mesh.psum(mesh, losses)[0] / D
    return (w.detach() - lr * grad_w.to(w.device),
            b.detach() - lr * grad_b.to(b.device), loss)


def _params_in(mesh, params):
    import torch

    dev = mesh.devices[0]
    w = torch.as_tensor(np.asarray(params["w"], dtype=np.float32)).to(dev)
    b = torch.as_tensor(np.float32(params["b"])).to(dev)
    return w, b


def _params_out(w, b):
    return {"w": w.cpu().numpy(), "b": np.float32(b.cpu().item())}


def train_step(mesh, params, X, y, lr=0.1):
    """One data-parallel SGD step: X ``[B, F]`` and y ``[B]`` sharded on
    the batch (B divides into D shards), the parameters replicated.
    Returns ``(params, loss)``, numpy and a float."""
    w, b = _params_in(mesh, params)
    w, b, loss = _step(mesh, w, b, _shards(mesh, X), _shards(mesh, y),
                       float(lr))
    return _params_out(w, b), float(loss)


def train(mesh, X, y, n_steps=50, lr=0.5, seed=0):
    """The training loop (the rows sharded once, equal shards, the tail
    dropped); returns ``(params, final_loss)``.  ``X``/``y`` are numpy
    arrays or float32 tensors (on any device)."""
    import torch

    D = _mesh.mesh_size(mesh)
    n = (len(X) // D) * D

    def rows(a):
        if isinstance(a, torch.Tensor):
            return a[:n]
        return np.asarray(a, dtype=np.float32)[:n]

    Xs = _shards(mesh, rows(X))
    ys = _shards(mesh, rows(y))
    w, b = _params_in(mesh, init_params(Xs[0].shape[1], seed))
    loss = None
    for _ in range(n_steps):
        w, b, loss = _step(mesh, w, b, Xs, ys, float(lr))
    return _params_out(w, b), float(loss)
