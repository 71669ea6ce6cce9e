"""The device mesh and its collectives (counterpart of ``parallel/mesh.py``).

Data parallelism is PyTorch's own: one process per GPU, started by
``torchrun`` (``python -m torch.distributed.run --nproc_per_node N``),
NCCL between GPUs and gloo between CPU processes.  Every process holds
the whole state and sees the whole global batch; a mesh path takes its
rows of the batch (:func:`shard_batch`), runs them, and meets the other
processes in collectives: gradients and metrics averaged
(:func:`all_reduce_mean_`), maxima taken (:func:`all_reduce_max_`),
batch-norm moments summed with a gradient (:func:`all_reduce_sum`),
sums taken (:func:`all_reduce_sum_`), outputs gathered
(:func:`all_gather_rows`), rank 0's state broadcast
(:func:`broadcast_`).  Each mesh path computes the function of the
single-device path on the global batch, as the JAX package's sharded
``jit`` does.

The mesh is a ``torch.distributed.device_mesh.DeviceMesh`` of shape
(world, 1) named ("data", "model"), the JAX package's layout; only the
data axis (dimension 0) shards anything.  The JAX package's
``batch_sharding`` and ``replicated_sharding`` have no counterpart: they
place global arrays for XLA to partition, and a tensor here is whole in
each process, so a path takes its rows and calls its collectives itself.

Importing this module touches no process group.
"""

from __future__ import annotations

import os

import torch
from torch._utils import _flatten_dense_tensors, _unflatten_dense_tensors


def launcher_world_size() -> int:
    """The number of processes the launcher started (``WORLD_SIZE``; 1
    outside ``torchrun``)."""
    return int(os.environ.get("WORLD_SIZE", "1"))


def make_mesh(num_devices: int = 0, data_axis: str = "data",
              model_axis: str = "model", device="cuda"):
    """The (world, 1) mesh over every process of the default group.

    Without a default group, one is started from the launcher's
    environment (``env://``): NCCL for a CUDA ``device``, after
    ``torch.cuda.set_device(LOCAL_RANK)``, gloo for the CPU.
    ``num_devices`` is 0 (all) or the world size; anything else raises,
    since a process cannot leave the group it is in.
    """
    import torch.distributed as dist
    from torch.distributed.device_mesh import init_device_mesh

    kind = torch.device(device).type
    if not dist.is_initialized():
        if kind == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", "0")))
        dist.init_process_group("nccl" if kind == "cuda" else "gloo",
                                init_method="env://")
    world = dist.get_world_size()
    if num_devices not in (0, world):
        raise ValueError(f"num_devices={num_devices}: a mesh spans every "
                         f"process of the group, {world} here (or pass 0)")
    return init_device_mesh(kind, (world, 1),
                            mesh_dim_names=(data_axis, model_axis))


def data_size(mesh) -> int:
    """Processes along the data axis."""
    return mesh.size(0)


def data_rank(mesh) -> int:
    """This process's place along the data axis."""
    return mesh.get_local_rank(0)


def is_writer(mesh) -> bool:
    """Whether this process writes a run's files: without a mesh always,
    with one only at data rank 0."""
    return mesh is None or data_rank(mesh) == 0


def local_rows(mesh, n: int) -> slice:
    """This process's rows of an ``n``-row global batch; a batch that the
    data axis does not divide raises ``ValueError``, as the JAX package's
    ``device_put`` refuses it."""
    w = data_size(mesh)
    if n % w:
        raise ValueError(f"a batch of {n} rows does not divide over the "
                         f"data axis ({w} processes)")
    per = n // w
    r = data_rank(mesh)
    return slice(r * per, (r + 1) * per)


def shard_batch(mesh, *tensors):
    """This process's rows of each global-batch tensor (one tensor comes
    back alone, as in the JAX package)."""
    out = tuple(t[local_rows(mesh, t.shape[0])] for t in tensors)
    return out if len(out) > 1 else out[0]


def _group(mesh):
    return mesh.get_group(0)


def _coalesced_(tensors, collective):
    """Run ``collective`` on one flat buffer of each dtype among
    ``tensors`` and copy the result back into them (a multi-tensor copy:
    a copy a tensor would cost a launch each); a lone contiguous tensor
    takes the collective in place."""
    if len(tensors) == 1 and tensors[0].is_contiguous():
        collective(tensors[0])
        return tensors
    by_dtype = {}
    for t in tensors:
        by_dtype.setdefault(t.dtype, []).append(t)
    for same in by_dtype.values():
        # the flatten and the views back in C++, as DDP's buckets do: a
        # Python loop over a model's ~200 tensors costs ~3 µs of host
        # time each
        flat = _flatten_dense_tensors(same)
        collective(flat)
        torch._foreach_copy_(same, _unflatten_dense_tensors(flat, same))
    return tensors


@torch.no_grad()
def all_reduce_sum_(tensors, mesh):
    """Sum each tensor over the data axis, in place, in one all-reduce."""
    import torch.distributed as dist

    return _coalesced_(list(tensors), lambda flat: dist.all_reduce(
        flat, group=_group(mesh)))


@torch.no_grad()
def all_reduce_mean_(tensors, mesh):
    """Average each tensor over the data axis, in place, in one all-reduce
    (a sum, then a division by the axis size)."""
    import torch.distributed as dist

    w = data_size(mesh)

    def mean(flat):
        dist.all_reduce(flat, group=_group(mesh))
        flat.div_(w)

    return _coalesced_(list(tensors), mean)


@torch.no_grad()
def all_reduce_max_(tensors, mesh):
    """Each tensor's elementwise maximum over the data axis, in place."""
    import torch.distributed as dist

    return _coalesced_(list(tensors), lambda flat: dist.all_reduce(
        flat, op=dist.ReduceOp.MAX, group=_group(mesh)))


@torch.no_grad()
def broadcast_(tensors, mesh, src: int = 0):
    """Data rank ``src``'s values of ``tensors`` into every process's."""
    import torch.distributed as dist

    group = _group(mesh)
    root = dist.get_global_rank(group, src)
    return _coalesced_(list(tensors), lambda flat: dist.broadcast(
        flat, src=root, group=group))


def all_gather_rows(t: torch.Tensor, mesh) -> torch.Tensor:
    """Every process's ``t`` stacked along a new leading axis, in data
    rank order: (W, *t.shape), without a gradient.

    The functional collective itself (``_c10d_functional``'s
    ``all_gather_into_tensor`` and ``wait_tensor``, which the
    ``_functional_collectives`` wrappers of every torch release lower to),
    so that ``torch.export`` carries it into a program as two nodes that
    name the data axis's group; run eagerly it moves the same bytes as
    ``dist.all_gather``."""
    group = _group(mesh)
    out = torch.ops._c10d_functional.all_gather_into_tensor(
        t.detach().contiguous().unsqueeze(0), group.size(),
        group.group_name)
    return torch.ops._c10d_functional.wait_tensor(out)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the data axis; its gradient is the sum over the axis
    of each process's gradient, so each process's input receives every
    process's loss's gradient."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        ctx.group = group
        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone()
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def all_reduce_sum(x: torch.Tensor, mesh) -> torch.Tensor:
    """The differentiable sum of ``x`` over the data axis (a small
    ``autograd.Function`` around ``dist.all_reduce``)."""
    return _AllReduceSum.apply(x, _group(mesh))
