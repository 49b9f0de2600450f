"""FL client runtime for the paper's use case: every client trains the
shared GRU on its own sensor's windows.  Counterpart of
``repro/fl/client.py``, with its semantics.

Client parameter trees are stacked on a leading axis of every leaf, as
in the JAX package, and local training is minibatch SGD on each
client's ``mse_loss``.  The JAX package ``vmap``s one program over the
clients; here the clients are trained one after another, which computes
the same thing because they are independent.  Every forward runs
through :func:`repro_torch.models.gru.forward`, so on the card each
layer's recurrence is one ``gru_seq`` kernel launch (its gradient the
plain version's, ``kernels/_grad.py``).

The JAX package draws each epoch's permutation inside ``jit`` from a
key; here the permutations are an explicit argument
(:func:`draw_permutations` draws them from a ``torch.Generator``)."""
from __future__ import annotations

from typing import Any, NamedTuple, Sequence, Tuple

import torch

from repro_torch.configs.base import ArchConfig, ModelConfig
from repro_torch.models import gru
from repro_torch.params import flatten_with_path, tree_map, unflatten

Tree = Any


class ClientBatch(NamedTuple):
    """Stacked per-client data on one device: X (C, N, H, 1), y (C, N, 1)."""
    X: torch.Tensor
    y: torch.Tensor


def stack_clients(params_list: Sequence[Tree]) -> Tree:
    """Trees of one structure -> one tree whose leaves gain a leading
    client axis."""
    flats = [flatten_with_path(p) for p in params_list]
    paths = [path for path, _ in flats[0]]
    return unflatten(paths, [torch.stack([f[i][1] for f in flats])
                             for i in range(len(paths))])


def unstack_client(stacked: Tree, i: int) -> Tree:
    return tree_map(lambda x: x[i], stacked)


def draw_permutations(generator: torch.Generator, C: int, epochs: int,
                      N: int) -> torch.Tensor:
    """One permutation of range(N) per client and epoch: (C, epochs, N)
    int64 on the generator's device."""
    keys = torch.rand((C, epochs, N), generator=generator,
                      device=generator.device)
    return torch.argsort(keys, dim=-1)


def sgd_step(params: Tree, m: ModelConfig, X: torch.Tensor,
             y: torch.Tensor, lr: float) -> torch.Tensor:
    """One step ``w <- w - lr * g`` on the minibatch's ``mse_loss``, in
    place on the leaves of ``params`` (which require grad).  Returns the
    loss before the step, still on the device."""
    leaves = [x for _, x in flatten_with_path(params)]
    loss = gru.mse_loss(params, m, X, y)
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for w, g in zip(leaves, grads):
            w.sub_(lr * g)
    return loss.detach()


def train_clients_locally(stacked: Tree, data: ClientBatch,
                          perms: torch.Tensor, *, cfg: ArchConfig,
                          epochs: int, batch_size: int, lr: float,
                          max_batches: int = 0) -> Tuple[Tree, torch.Tensor]:
    """Run ``epochs`` of minibatch SGD on every client.

    Epoch ``e`` of client ``c`` takes its minibatches, in order, from the
    first ``n_batches * batch_size`` entries of ``perms[c, e]``, where
    ``n_batches = N // batch_size`` (at most ``max_batches`` when that is
    nonzero).  ``perms`` is (C, epochs, N).

    Returns (new stacked params, per client the mean of the last
    epoch's minibatch losses (C,))."""
    m = cfg.model
    C, N = data.X.shape[0], data.X.shape[1]
    if tuple(perms.shape) != (C, epochs, N):
        raise ValueError(f"perms must be (C, epochs, N) = "
                         f"{(C, epochs, N)}, got {tuple(perms.shape)}")
    n_batches = N // batch_size
    if max_batches:
        n_batches = min(n_batches, max_batches)
    take = perms[:, :, :n_batches * batch_size].to(data.X.device)
    clients, last_losses = [], []
    for c in range(C):
        params = tree_map(lambda x: x[c].detach().clone().requires_grad_(),
                          stacked)
        last = data.X.new_zeros(())
        for e in range(epochs):
            X = data.X[c].index_select(0, take[c, e]).view(
                n_batches, batch_size, *data.X.shape[2:])
            y = data.y[c].index_select(0, take[c, e]).view(
                n_batches, batch_size, *data.y.shape[2:])
            losses = [sgd_step(params, m, X[b], y[b], lr)
                      for b in range(n_batches)]
            last = torch.stack(losses).mean()
        clients.append(tree_map(lambda x: x.detach(), params))
        last_losses.append(last)
    return stack_clients(clients), torch.stack(last_losses)


@torch.no_grad()
def eval_clients(stacked: Tree, data: ClientBatch, *,
                 cfg: ArchConfig) -> torch.Tensor:
    """Validation MSE per client (C,): one forward per client."""
    return torch.stack([gru.mse_loss(unstack_client(stacked, c), cfg.model,
                                     data.X[c], data.y[c])
                        for c in range(data.X.shape[0])])
