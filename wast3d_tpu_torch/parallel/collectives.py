"""Every collective of `parallel/`, with autograd where a gradient crosses ranks.

The JAX package lets XLA insert its collectives (`ppermute`, `all_to_all`,
`psum`, the all-gathers of a sharded operand). Here they are explicit
`torch.distributed` calls, all made through this module:

  all_to_all       rows to other ranks, in uneven counts (the duplicate
                   routing of `render_sharded`, the halo exchange of
                   `losses`, the ring hop of `ring`); its backward is the
                   reverse all_to_all;
  all_gather_rows  every rank's rows, in uneven counts, concatenated in rank
                   order; its backward is a reduce-scatter (the sum over the
                   group of each rank's gradient, then this rank's rows);
  all_reduce_sum   a sum over the group; its backward is the identity, since
                   every rank differentiates the same global sum with
                   respect to its own summand;
  gather_object    pickled host objects to rank 0 (results of the sweep).

Backends: `nccl` takes CUDA tensors only; `gloo` takes CPU tensors, and
moves CUDA tensors through host memory itself for some collectives and not
at all for others (point-to-point). So for a CUDA tensor on a gloo group
every call here copies it to the host, runs the collective there and copies
the result back: one path, whatever gloo's own CUDA support. Nothing
switches backend or device on its own.
"""

from __future__ import annotations

from typing import List, Optional, Sequence

import torch
import torch.distributed as dist


def _staged(t: torch.Tensor, group) -> bool:
    """Whether `t` goes through host memory: a CUDA tensor on a gloo group."""
    return t.is_cuda and dist.get_backend(group) == "gloo"


def _comm_device(group) -> torch.device:
    """Where the group's small host-made tensors (counts, sizes) live: the
    rank's current card for nccl, the host for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


def _all_to_all_rows(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
                     group) -> torch.Tensor:
    """Rows x[sum(send[:p]) : sum(send[:p+1])] go to rank p; the result holds
    recv[p] rows from each rank p, in rank order."""
    x = x.contiguous()
    out = x.new_empty((int(sum(recv)),) + tuple(x.shape[1:]))
    if _staged(x, group):
        host = out.cpu()
        dist.all_to_all_single(host, x.cpu(), list(recv), list(send), group=group)
        return host.to(x.device)
    dist.all_to_all_single(out, x, list(recv), list(send), group=group)
    return out


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, send, recv, group):
        ctx.send, ctx.recv, ctx.group = send, recv, group
        return _all_to_all_rows(x, send, recv, group)

    @staticmethod
    def backward(ctx, grad):
        return _all_to_all_rows(grad, ctx.recv, ctx.send, ctx.group), None, None, None


def all_to_all(x: torch.Tensor, send: Sequence[int], recv: Sequence[int],
               group) -> torch.Tensor:
    """Differentiable uneven all_to_all along dim 0 (module docstring);
    `recv` is what `exchange_counts(send)` returns on this rank."""
    send, recv = tuple(int(s) for s in send), tuple(int(r) for r in recv)
    if x.requires_grad:
        return _AllToAll.apply(x, send, recv, group)
    return _all_to_all_rows(x, send, recv, group)


def exchange_counts(send: Sequence[int], group) -> List[int]:
    """Each rank's send counts to every rank -> the counts this rank receives."""
    dev = _comm_device(group)
    s = torch.tensor([int(c) for c in send], dtype=torch.int64, device=dev)
    r = torch.empty_like(s)
    dist.all_to_all_single(r, s, group=group)
    return [int(c) for c in r.tolist()]


def gather_sizes(n: int, group) -> List[int]:
    """Every rank's `n`, in rank order."""
    world = dist.get_world_size(group)
    dev = _comm_device(group)
    out = [torch.zeros(1, dtype=torch.int64, device=dev) for _ in range(world)]
    dist.all_gather(out, torch.tensor([int(n)], dtype=torch.int64, device=dev), group=group)
    return [int(t.item()) for t in out]


def _gather_rows(x: torch.Tensor, sizes: Sequence[int], group) -> torch.Tensor:
    world = dist.get_world_size(group)
    width = max(sizes)
    src = x.contiguous()
    if _staged(src, group):
        src = src.cpu()
    pad = src.new_zeros((width,) + tuple(src.shape[1:]))
    pad[:src.shape[0]] = src
    parts = [torch.empty_like(pad) for _ in range(world)]
    dist.all_gather(parts, pad, group=group)
    out = torch.cat([p[:s] for p, s in zip(parts, sizes)])
    return out.to(x.device)


def _all_reduce(x: torch.Tensor, group) -> torch.Tensor:
    out = x.detach().clone().contiguous()
    if _staged(out, group):
        host = out.cpu()
        dist.all_reduce(host, group=group)
        return host.to(x.device)
    dist.all_reduce(out, group=group)
    return out


class _AllGatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, sizes, group):
        ctx.sizes, ctx.group = sizes, group
        ctx.rank = dist.get_rank(group)
        return _gather_rows(x, sizes, group)

    @staticmethod
    def backward(ctx, grad):
        total = _all_reduce(grad, ctx.group)
        start = sum(ctx.sizes[:ctx.rank])
        return total[start:start + ctx.sizes[ctx.rank]], None, None


def all_gather_rows(x: torch.Tensor, group, sizes: Optional[Sequence[int]] = None
                    ) -> torch.Tensor:
    """Every rank's rows of `x` (uneven counts; `sizes` as `gather_sizes`
    gives them, exchanged here when not given), concatenated in rank order.
    Differentiable: the backward reduce-scatters (module docstring)."""
    if sizes is None:
        sizes = gather_sizes(x.shape[0], group)
    sizes = tuple(int(s) for s in sizes)
    if x.requires_grad:
        return _AllGatherRows.apply(x, sizes, group)
    return _gather_rows(x, sizes, group)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        return _all_reduce(x, group)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """The sum of `x` over the group, on every rank; differentiable with the
    identity as its backward (module docstring)."""
    if x.requires_grad:
        return _AllReduceSum.apply(x, group)
    return _all_reduce(x, group)


def gather_object(obj):
    """Rank 0 gets every rank's picklable `obj` in rank order; the other
    ranks get None."""
    out = [None] * dist.get_world_size() if dist.get_rank() == 0 else None
    dist.gather_object(obj, out, dst=0)
    return out
