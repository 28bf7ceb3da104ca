"""Collectives over one axis of the mesh, with the gradients JAX gives them
(counterparts of `lax.all_gather(tiled=True)`, `lax.ppermute` and the
transposes that shard_map inserts at the edges of a region).

Each is a `torch.autograd.Function` whose backward is written down here,
not taken from `torch.distributed.nn.functional`, whose backward differs
by backend:

  all_gather_tiled(x, axis, dim)  forward: the peers' shards concatenated
      along `dim`; backward: the cotangent summed over the group, then
      this rank's slice (a reduce-scatter), as JAX transposes it;
  ppermute(x, axis, perm)         forward: x sent along `perm`, a list of
      (source, destination) axis indices; backward: the cotangent sent
      along the inverse permutation;
  split_entry(x, axis, dim)       the entry of a region sharded along
      `dim` from a value every peer holds whole: forward this rank's
      slice, backward the peers' cotangent slices gathered, so the whole
      cotangent is the same on every peer;
  gather_exit(x, axis, dim)       the exit of such a region: forward the
      shards gathered, backward this rank's slice of the (replicated)
      cotangent;
  all_reduce_sum(x, axis)         forward the sum over the group; backward
      the sum of the cotangents (the peers' losses all read the sum);
  sum_entry(x, axis)              the entry of a region whose peers each
      take a part of the work on a value they all hold (tensor and expert
      parallelism): forward the identity, backward the peers' partial
      cotangents summed;
  sum_exit(x, axis)               the exit of such a region: forward the
      peers' partial results summed, backward the identity (the peers'
      cotangents of the sum are the same);
  broadcast_from(x, axis, src)    forward the value of the axis's rank
      `src` on every peer; backward the cotangent to `src` alone, once
      (every peer's cotangent is the same).

Without autograd: `all_reduce_mean_` and `broadcast_` over lists of
tensors in place (the gradients, the metrics), and `mean_over`,
`sum_over` and `gather_over`.

`axis` is an `AxisGroup` (parallel/mesh.py). Under gloo a tensor on a card
is staged through the host (`_HOST_STAGED`: gloo has no CUDA form of
point-to-point sends or of reduce-scatter, and on a card its collectives
are for tests on one device only); NCCL takes the tensors where they lie.
No collective error is caught here.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from lunaris_orion_tpu_torch.parallel.mesh import AxisGroup

# The collectives gloo runs on host copies of CUDA tensors, by name.
_HOST_STAGED = ("all_gather", "all_reduce", "reduce_scatter", "ppermute",
                "broadcast")


def _staged(name: str, x: torch.Tensor, axis: AxisGroup) -> bool:
    return (x.is_cuda and name in _HOST_STAGED
            and dist.get_backend(axis.group) == "gloo")


def _raw_all_gather(x: torch.Tensor, axis: AxisGroup, dim: int
                    ) -> torch.Tensor:
    dev = x.device
    src = x.contiguous()
    if _staged("all_gather", x, axis):
        src = src.cpu()
    parts = [torch.empty_like(src) for _ in range(axis.size)]
    dist.all_gather(parts, src, group=axis.group)
    return torch.cat(parts, dim=dim).to(dev)


def _raw_all_reduce(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    """The sum over the group, in a new tensor."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if _staged("all_reduce", x, axis):
        host = out.cpu()
        dist.all_reduce(host, group=axis.group)
        return host.to(x.device)
    dist.all_reduce(out, group=axis.group)
    return out


def _raw_reduce_scatter(x: torch.Tensor, axis: AxisGroup, dim: int
                        ) -> torch.Tensor:
    """The sum over the group, then this rank's slice along `dim`."""
    if _staged("reduce_scatter", x, axis):
        return _own(_raw_all_reduce(x, axis), axis, dim).contiguous()
    parts = [c.contiguous() for c in x.chunk(axis.size, dim=dim)]
    out = torch.empty_like(parts[axis.index])
    dist.reduce_scatter(out, parts, group=axis.group)
    return out


def _raw_ppermute(x: torch.Tensor, axis: AxisGroup,
                  perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    """x sent along perm [(source, destination)] in axis indices; a rank
    that receives nothing gets zeros (as lax.ppermute)."""
    me = axis.index
    send = [d for s, d in perm if s == me]
    recv = [s for s, d in perm if d == me]
    dev = x.device
    src = x.contiguous()
    if _staged("ppermute", x, axis):
        src = src.cpu()
    out = torch.zeros_like(src)
    if send == [me] and recv == [me]:
        return src.clone().to(dev)
    ops = [dist.P2POp(dist.isend, src, axis.ranks[d], axis.group)
           for d in send]
    ops += [dist.P2POp(dist.irecv, out, axis.ranks[s], axis.group)
            for s in recv]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return out.to(dev)


def _own(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    n = x.shape[dim]
    if n % axis.size:
        raise ValueError(f"dim {dim} of size {n} does not split over "
                         f"{axis.size} ranks")
    per = n // axis.size
    return x.narrow(dim, axis.index * per, per)


class _AllGatherTiled(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _raw_all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _raw_reduce_scatter(g, ctx.axis, ctx.dim), None, None


class _Ppermute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, perm):
        ctx.axis, ctx.perm = axis, perm
        return _raw_ppermute(x, axis, perm)

    @staticmethod
    def backward(ctx, g):
        inverse = [(d, s) for s, d in ctx.perm]
        return _raw_ppermute(g, ctx.axis, inverse), None, None


class _SplitEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _own(x, axis, dim).contiguous()

    @staticmethod
    def backward(ctx, g):
        return _raw_all_gather(g, ctx.axis, ctx.dim), None, None


class _GatherExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, dim):
        ctx.axis, ctx.dim = axis, dim
        return _raw_all_gather(x, axis, dim)

    @staticmethod
    def backward(ctx, g):
        return _own(g, ctx.axis, ctx.dim).contiguous(), None, None


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return _raw_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.axis), None


class _SumEntry(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        ctx.axis = axis
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return _raw_all_reduce(g, ctx.axis), None


class _SumExit(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis):
        return _raw_all_reduce(x, axis)

    @staticmethod
    def backward(ctx, g):
        return g, None


def _raw_broadcast(x: torch.Tensor, axis: AxisGroup, src: int
                   ) -> torch.Tensor:
    """The axis rank `src`'s x on every rank, in a new tensor."""
    out = x.detach().clone(memory_format=torch.contiguous_format)
    if _staged("broadcast", x, axis):
        host = out.cpu()
        dist.broadcast(host, axis.ranks[src], group=axis.group)
        return host.to(x.device)
    dist.broadcast(out, axis.ranks[src], group=axis.group)
    return out


class _BroadcastFrom(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, axis, src):
        ctx.mine = axis.index == src
        return _raw_broadcast(x, axis, src)

    @staticmethod
    def backward(ctx, g):
        return (g if ctx.mine else torch.zeros_like(g)), None, None


def all_gather_tiled(x: torch.Tensor, axis: AxisGroup, dim: int
                     ) -> torch.Tensor:
    return _AllGatherTiled.apply(x, axis, dim)


def ppermute(x: torch.Tensor, axis: AxisGroup,
             perm: Sequence[Tuple[int, int]]) -> torch.Tensor:
    return _Ppermute.apply(x, axis, [tuple(p) for p in perm])


def split_entry(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    return _SplitEntry.apply(x, axis, dim)


def gather_exit(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    return _GatherExit.apply(x, axis, dim)


def all_reduce_sum(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    return _AllReduceSum.apply(x, axis)


def sum_entry(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    return _SumEntry.apply(x, axis)


def sum_exit(x: torch.Tensor, axis: AxisGroup) -> torch.Tensor:
    return _SumExit.apply(x, axis)


def broadcast_from(x: torch.Tensor, axis: AxisGroup, src: int
                   ) -> torch.Tensor:
    """`src` is an index on the axis; the other ranks' x is a placeholder
    of the same shape and dtype."""
    return _BroadcastFrom.apply(x, axis, src)


def mean_over(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """The mean of x over the group, without a gradient (x itself when
    `axis` is None)."""
    if axis is None:
        return x
    total = _raw_all_reduce(x, axis)
    return total if axis.size == 1 else total / axis.size


def sum_over(x: torch.Tensor, axis: Optional[AxisGroup]) -> torch.Tensor:
    """The sum of x over the group, without a gradient (x itself when
    `axis` is None)."""
    return x if axis is None else _raw_all_reduce(x, axis)


def gather_over(x: torch.Tensor, axis: AxisGroup, dim: int) -> torch.Tensor:
    """The peers' x concatenated along `dim`, without a gradient."""
    return _raw_all_gather(x.detach(), axis, dim)


def _flat_(tensors: Sequence[torch.Tensor], reduce) -> None:
    """Apply `reduce` to the tensors concatenated in f32, in place."""
    if not tensors:
        return
    flat = reduce(torch.cat([t.reshape(-1).float() for t in tensors]))
    i = 0
    for t in tensors:
        n = t.numel()
        t.copy_(flat[i:i + n].view_as(t))
        i += n


def broadcast_(tensors: Sequence[torch.Tensor], axis: AxisGroup,
               src: int = 0) -> None:
    """Overwrite the tensors in place with the axis rank `src`'s (default
    the first), in one flat collective (no autograd): what the ranks of a
    model row hold alike, made bit-equal where a kernel of their
    replicated work is not deterministic (cuDNN's, on a card); or what one
    rank alone holds (an expert's tensors, gathered for a checkpoint). The
    flat collective runs in f32, exact for bf16 and for integers below
    2**24."""
    _flat_(tensors, lambda flat: _raw_broadcast(flat, axis, src))


def all_reduce_mean_(tensors: Sequence[torch.Tensor], axis: AxisGroup
                     ) -> None:
    """Average tensors in place over the group (no autograd), in one
    flat collective: the gradients' and the metrics' all-reduce."""
    def reduce(flat):
        flat = _raw_all_reduce(flat, axis)
        return flat if axis.size == 1 else flat / axis.size
    _flat_(tensors, reduce)
