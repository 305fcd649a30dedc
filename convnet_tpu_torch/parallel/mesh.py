"""The data-parallel mesh and its collectives (counterpart of
convnet_tpu/parallel/mesh.py).

The JAX package's 1-D ``Mesh(('data',))`` over the devices is here a
``torch.distributed`` process group of one process per card, wrapped in a
1-D ``DeviceMesh`` named ``'data'``: NCCL on ``cuda``, gloo where the caller
asks for the CPU. Every rank runs the same program on its own part of the
batch; what the JAX step does with ``lax.pmean`` / ``lax.psum`` over the
axis is an all-reduce over the mesh's group.

Multi-host: each host runs one process per local card. ``init_distributed``
takes the address of the rendezvous (``--dist-init tcp://host:port``), the
host's index and the number of hosts (``--dist-rank``, ``--dist-world-size``,
as in the JAX CLI), and the number of local cards; the global rank is
``host · local_world + local_rank`` and the world size ``hosts ·
local_world``, so the ranks of one host are contiguous.

No fallback: a backend that fails to initialise raises, and nothing here
catches a failed collective.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.distributed as dist

DATA_AXIS = "data"


def backend_for(device_type: str) -> str:
    """NCCL on the card, gloo on the CPU."""
    return "nccl" if device_type == "cuda" else "gloo"


def init_distributed(init_method: str, *, device_type: str = "cuda",
                     host: int = 0, hosts: int = 1, local_rank: int = 0,
                     local_world: int = 1, backend: Optional[str] = None):
    """Joins this process to the default process group: global rank
    ``host · local_world + local_rank`` of ``hosts · local_world``.
    ``init_method``: ``tcp://host:port`` or ``file://path``. On ``cuda`` the
    process's card is ``local_rank`` (set before the group, so NCCL binds to
    it). ``backend`` defaults to :func:`backend_for`. Returns (rank,
    world)."""
    rank = host * local_world + local_rank
    world = hosts * local_world
    if device_type == "cuda":
        torch.cuda.set_device(local_rank % torch.cuda.device_count())
    dist.init_process_group(backend or backend_for(device_type),
                            init_method=init_method, rank=rank,
                            world_size=world)
    return rank, world


def make_mesh(num_devices: Optional[int] = None, device_type: str = "cuda"):
    """The 1-D data-parallel mesh over every rank of the default process
    group (:func:`init_distributed` first). ``num_devices``, where given,
    must be the group's size: a process cannot leave the group."""
    world = dist.get_world_size()
    if num_devices is not None and num_devices != world:
        raise ValueError(f"a mesh of {num_devices} devices over a process "
                         f"group of {world}")
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, (world,),
                            mesh_dim_names=(DATA_AXIS,))


def local_batch_size(global_batch: int, mesh) -> int:
    """A rank's part of ``global_batch``."""
    n = mesh.size()
    if global_batch % n != 0:
        raise ValueError(
            f"global batch {global_batch} not divisible by data-parallel "
            f"degree {n}")
    return global_batch // n


def process_batch_slice(global_batch: int, group=None) -> slice:
    """The rows of the global batch this rank holds where the batch is split
    in contiguous parts, as a single-host JAX mesh shards it."""
    n = dist.get_world_size(group)
    idx = dist.get_rank(group)
    per = global_batch // n
    return slice(idx * per, (idx + 1) * per)


@torch.no_grad()
def replicate(module, group=None):
    """Broadcasts ``module``'s parameters and buffers from rank 0 of
    ``group`` in place, so every rank starts from the same weights and
    BatchNorm statistics."""
    src = dist.get_global_rank(group, 0) if group is not None else 0
    for t in list(module.parameters()) + list(module.buffers()):
        dist.broadcast(t.data, src=src, group=group)
    return module


def all_mean_(tensors, group=None):
    """Replaces each tensor of the list by its mean over ``group``: one
    all-reduce of their concatenation (float32), the sum divided by the
    group's size (``lax.pmean``)."""
    if not tensors:
        return tensors
    flat = torch.cat([t.reshape(-1).float() for t in tensors])
    dist.all_reduce(flat, group=group)
    flat /= dist.get_world_size(group)
    offset = 0
    for t in tensors:
        t.copy_(flat[offset:offset + t.numel()].view_as(t))
        offset += t.numel()
    return tensors


class _GroupMean(torch.autograd.Function):
    """y = mean over the group of x, and the cotangent's mean over the group
    in the backward: the transpose of ``lax.pmean`` (a sum of every rank's
    cotangent, as torch's ``SyncBatchNorm`` backward sums it, over the
    group's size)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y / dist.get_world_size(group)

    @staticmethod
    def backward(ctx, dy):
        g = dy.contiguous().clone()
        dist.all_reduce(g, group=ctx.group)
        return g / dist.get_world_size(ctx.group), None


def group_mean(x, group):
    """``lax.pmean(x, axis)``, differentiable; the identity where ``group``
    is None."""
    if group is None:
        return x
    return _GroupMean.apply(x, group)


def group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def set_bn_group(model, group):
    """Sets the group of every ``BatchNorm2d`` of ``model`` in place:
    ``group`` for cross-replica statistics (sync-BN, the JAX package's
    ``ctx.axis_name``), None for per-replica ones. The fused MobileNet-V2
    blocks read their BatchNorms' group. Returns the groups it replaced, in
    module order, for :func:`restore_bn_groups`."""
    from convnet_tpu_torch.nn.layers import BatchNorm2d
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    old = [m.group for m in bns]
    for m in bns:
        m.group = group
    return old


def restore_bn_groups(model, groups):
    from convnet_tpu_torch.nn.layers import BatchNorm2d
    bns = [m for m in model.modules() if isinstance(m, BatchNorm2d)]
    for m, g in zip(bns, groups, strict=True):
        m.group = g
