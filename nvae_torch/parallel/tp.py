"""The collectives of the tensor-parallel layout (``parallel.mesh.
shard_state_tp``), as autograd Functions over the model axis (a
``parallel.mesh.DataMesh``).  JAX's GSPMD inserts them where a sharded
kernel meets a replicated activation; here the modules that read a TP block
call them (``nn/spectral.py``, ``nn/blocks.py``):

- :func:`copy_to_model`: the identity, whose backward sums the gradient over
  the model axis (a replicated input read by each rank's slice of a
  column-parallel conv: each rank's gradient is its share);
- :func:`sum_over_model`: the sum over the model axis, whose backward is
  the identity (a row-parallel conv's partial outputs);
- :func:`gather_channels`: every rank's channels of an NCHW tensor in rank
  order, whose backward takes this rank's slice of the gradient (a
  column-parallel conv whose output is read whole).

Every rank of the axis calls each of them, forward and backward, in the
same order.  :func:`channel_block` is the slice a rank holds, and
:func:`once_over_model` keeps a term that every rank computes whole from
reaching a summed gradient more than once.
"""

from __future__ import annotations

import torch


def channel_block(n: int, mesh) -> slice:
    """The model rank's block of ``n`` channels: ``n / size`` of them,
    block ``rank``."""
    b = n // mesh.size
    return slice(mesh.rank * b, (mesh.rank + 1) * b)


def block_of(t: torch.Tensor, mesh, dim: int = 0) -> torch.Tensor:
    """The model rank's block of ``t`` along ``dim`` (differentiable), a
    tensor of its own in contiguous memory, not a view of ``t``."""
    s = channel_block(t.shape[dim], mesh)
    return t.narrow(dim, s.start, s.stop - s.start).clone(
        memory_format=torch.contiguous_format)


def _sum(t: torch.Tensor, mesh) -> torch.Tensor:
    """The sum of ``t`` over the axis, a new tensor (an NCHW one summed as
    NHWC memory, which channels_last is); a bf16 ``t`` is summed in fp32
    and rounded once."""
    wide = torch.promote_types(t.dtype, torch.float32)
    nhwc = t.dim() == 4
    acc = (t.permute(0, 2, 3, 1) if nhwc else t).to(wide, copy=True)
    acc = mesh.all_reduce_(acc.contiguous())
    return (acc.permute(0, 3, 1, 2) if nhwc else acc).to(t.dtype)


class _CopyToModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return _sum(grad, ctx.mesh), None


class _SumOverModel(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        return _sum(x, mesh)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class _GatherChannels(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        # NCHW in channels_last memory is NHWC-contiguous once permuted.
        part = x.permute(0, 2, 3, 1).contiguous()
        parts = [torch.empty_like(part) for _ in range(mesh.size)]
        torch.distributed.all_gather(parts, part, group=mesh.group)
        return torch.cat(parts, dim=3).permute(0, 3, 1, 2)

    @staticmethod
    def backward(ctx, grad):
        s = channel_block(grad.shape[1], ctx.mesh)
        return grad[:, s].contiguous(memory_format=torch.channels_last), None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _CopyToModel.apply(x, mesh)


def sum_over_model(x: torch.Tensor, mesh) -> torch.Tensor:
    return _SumOverModel.apply(x, mesh)


def gather_channels(x: torch.Tensor, mesh) -> torch.Tensor:
    return _GatherChannels.apply(x, mesh)


def once_over_model(t: torch.Tensor, mesh) -> torch.Tensor:
    """``t``, whose gradient is divided by the model axis's rank count: a
    term that every rank computes whole (a penalty over a whole kernel or
    BatchNorm scale) and whose gradient reaches a parameter that the step
    sums over the axis (a block, or a whole tensor read in slices) then
    counts once.  The value keeps its bits: ``t + (t - t) / n``."""
    d = t.detach()
    return d + (t - d) / mesh.size
