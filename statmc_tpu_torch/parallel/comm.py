"""The mesh's collectives on torch.distributed, the port's counterparts of
the JAX package's shard_map collectives: ``psum`` and ``pmax`` are
``all_reduce`` SUM and MAX, ``all_gather`` is ``all_gather``, and
``ppermute`` up and down the "px" axis is ``batch_isend_irecv``
(``halo_rows``).  NCCL takes CUDA tensors; gloo, which a mesh of several
ranks on one card or on the CPU uses, takes host tensors, so a CUDA
tensor on a gloo group travels through a host copy.  A group of one rank
moves nothing.  Each collective adds the bytes that this rank hands to it
to the host counter mesh.bytes (spans.py).
"""
from __future__ import annotations

import torch
import torch.distributed as dist

from .. import spans


def size(group=None) -> int:
    """Ranks in `group` (the world when None)."""
    return dist.get_world_size(group)


def _host(group, x) -> bool:
    return x.is_cuda and dist.get_backend(group) == "gloo"


def all_gather(x, group=None) -> list:
    """Every member's `x`, in the group's rank order."""
    if size(group) == 1:
        return [x]
    host = _host(group, x)
    src = x.detach().contiguous()
    src = src.cpu() if host else src
    spans.count("mesh.bytes", src.numel() * src.element_size())
    out = [torch.empty_like(src) for _ in range(size(group))]
    dist.all_gather(out, src, group=group)
    return [o.to(x.device) for o in out] if host else out


def all_reduce(x, op: str = "sum", group=None):
    """The members' `x` summed ("sum") or their maximum ("max"), as a new
    tensor."""
    if size(group) == 1:
        return x
    y = (x.detach().cpu() if _host(group, x)
         else x.detach().clone()).contiguous()
    spans.count("mesh.bytes", y.numel() * y.element_size())
    dist.all_reduce(y, op={"sum": dist.ReduceOp.SUM,
                           "max": dist.ReduceOp.MAX}[op], group=group)
    return y.to(x.device)


def halo_rows(x, r: int, group, prev: int | None, nxt: int | None):
    """x [h, ...] -> [h + 2r, ...]: the last r rows of the rank `prev`
    (a global rank, None at the image's top edge) above x and the first r
    rows of `nxt` below it, zeros past the image's edges; x's first and
    last r rows go the other way."""
    if r == 0:
        return x
    if x[:1].numel() == 0:  # no channels: nothing to send
        return x.new_zeros((x.shape[0] + 2 * r, *x.shape[1:]))
    host = _host(group, x)
    top = torch.zeros_like(x[:r], device="cpu" if host else x.device)
    bot = torch.zeros_like(top)
    ops = []
    for peer, send, recv in ((prev, x[:r], top), (nxt, x[-r:], bot)):
        if peer is not None:
            send = send.contiguous()
            spans.count("mesh.bytes", send.numel() * send.element_size())
            ops += [dist.P2POp(dist.isend, send.cpu() if host else send,
                               peer, group),
                    dist.P2POp(dist.irecv, recv, peer, group)]
    if ops:
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    return torch.cat([top.to(x.device), x, bot.to(x.device)])
