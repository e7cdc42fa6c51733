"""The ('data', 'bank') mesh on ``torch.distributed`` (port of
``dsp_tpu/parallel/mesh.py``).

The framework scales along two axes, as in the JAX package:

* ``data``: the utterance batch (pure data parallelism; no collectives
  until the results are assembled);
* ``bank``: the template bank (each rank holds a vocabulary shard and
  classification ends in a small cross-shard top-k).

JAX's mesh is one controller over many devices; here every rank is its own
process (one a GPU, SPMD), and the mesh is a ``DeviceMesh`` over the
process group with ``mesh_dim_names=("data", "bank")``.  Rank ``r`` of the
mesh sits at coordinate ``(r // bank, r % bank)``, and the sub-group of each
axis lists its ranks in coordinate order, so a gather over an axis
concatenates shards in coordinate order, as JAX's tiled ``all_gather``.

Placement is explicit: :func:`shard_queries`, :func:`shard_bank` and
:func:`replicate` return THIS rank's slice (or the whole array) on the
mesh's device.  The sharded functions (``parallel/sharding.py``,
``parallel/em.py``) take the global arrays on every rank, slice their
block, compute it with the single-device functions and end with the global
result on every rank.
"""

from __future__ import annotations

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dsp_tpu_torch.parallel import multihost

DATA_AXIS = "data"
BANK_AXIS = "bank"


def make_mesh(data: int | None = None, bank: int | None = None,
              device: str | torch.device = "cuda") -> DeviceMesh:
    """Build a ('data', 'bank') mesh over the process group.

    With no arguments every rank goes on the bank axis (vocabulary
    sharding reduces each rank's share of the dominant DTW cost).  A CUDA
    mesh runs NCCL on card ``LOCAL_RANK`` and a CPU mesh gloo; a CUDA mesh
    without a card raises.  Where no process group exists the group comes
    from torchrun's environment (:func:`multihost.initialize`), and in a
    plain single process from a one-rank group on a local store.  The mesh
    takes the first ``data * bank`` ranks; more than the group holds is an
    error.
    """
    dev = torch.device(device)
    backend = multihost.backend_for(dev)
    if not dist.is_initialized():
        multihost.initialize(device=dev)
    if not dist.is_initialized():
        if backend == "nccl":
            torch.cuda.set_device(dev.index if dev.index is not None
                                  else multihost.local_rank())
        dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                world_size=1)
    if dist.get_backend() != backend:
        raise ValueError(f"a {dev.type} mesh needs the {backend} backend, "
                         f"and this process group runs {dist.get_backend()}")
    n = dist.get_world_size()
    if data is None and bank is None:
        data, bank = 1, n
    elif data is None:
        data = n // bank
    elif bank is None:
        bank = n // data
    # data/bank can round to 0 when one axis exceeds the rank count:
    # require both >= 1 so a misconfiguration fails here
    if data < 1 or bank < 1 or data * bank > n:
        raise ValueError(f"mesh {data}x{bank} invalid for {n} ranks")
    mesh = DeviceMesh(dev.type, torch.arange(data * bank).reshape(data, bank),
                      mesh_dim_names=(DATA_AXIS, BANK_AXIS))
    coord = mesh.get_coordinate()
    if coord is not None:
        # gathers rely on each axis group listing its ranks in coordinate order
        rows = mesh.mesh.tolist()
        assert dist.get_process_group_ranks(mesh.get_group(BANK_AXIS)) == \
            rows[coord[0]]
        assert dist.get_process_group_ranks(mesh.get_group(DATA_AXIS)) == \
            [r[coord[1]] for r in rows]
    return mesh


def as_mesh(mesh):
    """``mesh`` itself if it is None or a ('data', 'bank') ``DeviceMesh``;
    anything else is a ``TypeError``."""
    if mesh is None:
        return None
    if not isinstance(mesh, DeviceMesh) or \
            tuple(mesh.mesh_dim_names or ()) != (DATA_AXIS, BANK_AXIS):
        raise TypeError(
            f"mesh must be a ('data', 'bank') DeviceMesh from "
            f"dsp_tpu_torch.parallel.make_mesh, not {type(mesh).__name__}")
    return mesh


def mesh_shape(mesh: DeviceMesh) -> tuple[int, int]:
    """(data, bank) sizes."""
    return mesh.size(0), mesh.size(1)


def coordinate(mesh: DeviceMesh) -> tuple[int, int]:
    """This rank's (data, bank) coordinate; a rank outside the mesh raises."""
    c = mesh.get_coordinate()
    if c is None:
        raise ValueError(f"rank {dist.get_rank()} is not in this mesh")
    return int(c[0]), int(c[1])


def flat_index(mesh: DeviceMesh) -> int:
    """This rank's place in the mesh's row-major order (data, then bank)."""
    d, b = coordinate(mesh)
    return d * mesh.size(1) + b


def mesh_device(mesh: DeviceMesh) -> torch.device:
    """The device this rank's shards and collectives live on."""
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def _on(mesh: DeviceMesh, a) -> torch.Tensor:
    dev = mesh_device(mesh)
    if isinstance(a, torch.Tensor):
        return a.to(dev)
    return torch.as_tensor(np.asarray(a), device=dev)


def _rows(mesh: DeviceMesh, a, parts: int, index: int, axis: str):
    n = a.shape[0]
    if n % parts:
        raise ValueError(f"{n} rows do not split over the {axis} axis "
                         f"of {parts} (pad_axis_to_multiple)")
    step = n // parts
    return _on(mesh, a[index * step:(index + 1) * step])


def _placed(out):
    return out if len(out) > 1 else out[0]


def shard_queries(mesh: DeviceMesh, *arrays):
    """This rank's data-axis slice of query-batch arrays (leading dim split
    over 'data'), on the mesh's device."""
    d, _ = coordinate(mesh)
    nd = mesh.size(0)
    return _placed(tuple(_rows(mesh, a, nd, d, DATA_AXIS) for a in arrays))


def shard_bank(mesh: DeviceMesh, *arrays):
    """This rank's bank-axis slice of template-bank arrays (leading dim
    split over 'bank'), on the mesh's device."""
    _, b = coordinate(mesh)
    nb = mesh.size(1)
    return _placed(tuple(_rows(mesh, a, nb, b, BANK_AXIS) for a in arrays))


def shard_flat(mesh: DeviceMesh, *arrays):
    """This rank's slice of arrays split over every rank of the mesh in
    row-major order (the data-parallel decodes: ``gather_flat`` undoes it)."""
    nd, nb = mesh_shape(mesh)
    i = flat_index(mesh)
    return _placed(tuple(_rows(mesh, a, nd * nb, i, "data x bank")
                         for a in arrays))


def replicate(mesh: DeviceMesh, *arrays):
    """Whole arrays on the mesh's device."""
    return _placed(tuple(_on(mesh, a) for a in arrays))


def pad_axis_to_multiple(x: np.ndarray, multiple: int, axis: int = 0):
    """Pad ``x`` with zeros along ``axis`` to a multiple (returns padded,
    orig_size)."""
    n = x.shape[axis]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = [(0, 0)] * x.ndim
    pad[axis] = (0, target - n)
    return np.pad(x, pad), n


def pad_rows_to_multiple(x: torch.Tensor, multiple: int):
    """:func:`pad_axis_to_multiple` of a tensor's leading axis, on its
    device (returns padded, orig_size)."""
    n = x.shape[0]
    target = -(-n // multiple) * multiple
    if target == n:
        return x, n
    pad = torch.zeros((target - n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return torch.cat([x, pad]), n


# ------------------------------------------------------------ collectives
def gather(x: torch.Tensor, mesh: DeviceMesh, axis: str, dim: int = 0):
    """All-gather ``x`` over one mesh axis, concatenated along ``dim`` in
    coordinate order (JAX's ``all_gather(..., tiled=True)``)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.cat(parts, dim=dim)


def gather_stack(x: torch.Tensor, mesh: DeviceMesh, axis: str):
    """All-gather ``x`` over one mesh axis, stacked on a new leading dim in
    coordinate order (JAX's untiled ``all_gather``)."""
    group = mesh.get_group(axis)
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, x, group=group)
    return torch.stack(parts)


def gather_flat(x: torch.Tensor, mesh: DeviceMesh, dim: int = 0):
    """Undo :func:`shard_flat`: gather over 'bank', then over 'data'."""
    return gather(gather(x, mesh, BANK_AXIS, dim), mesh, DATA_AXIS, dim)


def psum(x: torch.Tensor, mesh: DeviceMesh, axis: str) -> torch.Tensor:
    """Sum of ``x`` over one mesh axis, on every rank of it (JAX's ``psum``)."""
    x = x.contiguous().clone()
    dist.all_reduce(x, op=dist.ReduceOp.SUM, group=mesh.get_group(axis))
    return x
