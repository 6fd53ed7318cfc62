"""Data and width parallelism over processes, one per card: the
counterpart of ``rangedet_tpu/parallel/mesh.py``.

JAX runs one program over a mesh of devices; the port runs one process per
card, joined in a ``torch.distributed`` process group (``nccl`` on CUDA,
``gloo`` on the CPU). The mesh is {"data": D, "model": M} with D*M ranks,
data-major as ``mesh_utils.create_device_mesh((D, M))`` lays it out: rank
r = d*M + m holds rows ``[d*B, (d+1)*B)`` of a global batch of ``D*B``
frames and, of its 4-D (B, H, W, C) arrays, columns ``[m*W/M, (m+1)*W/M)``
of the range image (``batch_spec``'s P("data", None, "model", None);
``local_rows``). The M ranks of data index d form its width group
(``with_mesh``), over which the convs exchange their halos
(``parallel/halo.py``) and the targets sum their per-box point counts.
Parameters and buffers are replicated: rank 0's are broadcast after init
and after ``--resume`` (``replicate_state``).

``AllReduceSum`` is psum as ``shard_map`` differentiates it: its forward
sums a copy over the group, its backward sums the incoming gradient. The
BatchNorms (``models/layers.py``) sum their statistics through it, so the
cotangent of each rank's sums is the whole group's.

Every collective issued here adds one to ``COLLECTIVES``, as the kernel
wrappers count their launches.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Optional, Tuple

import torch
import torch.distributed as dist

COLLECTIVES = 0


def reset_counts() -> None:
    global COLLECTIVES
    COLLECTIVES = 0


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the mesh: its rank, the world size, its card
    (or the CPU), the group (None: one process, no group joined); its data
    index d of D and width index m of M (r = d*M + m), and the width group
    of the M ranks of data index d (None where M = 1)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None
    data_index: int = 0
    n_data: int = 1
    width_index: int = 0
    n_width: int = 1
    width_group: Optional[dist.ProcessGroup] = None


def join(device: str = "cuda", backend: Optional[str] = None,
         rank: Optional[int] = None, world_size: Optional[int] = None,
         local_rank: Optional[int] = None,
         init_method: Optional[str] = None, always: bool = False) -> Ranks:
    """Join the process group: from explicit arguments, else from the
    launcher's environment (``torchrun`` / ``python -m
    torch.distributed.run`` set RANK, WORLD_SIZE, LOCAL_RANK, MASTER_ADDR
    and MASTER_PORT; ``init_method`` defaults to ``env://``). The card is
    ``cuda:LOCAL_RANK`` unless ``device`` names one, and is made current
    before anything touches it. ``backend`` defaults to nccl on CUDA and
    gloo on the CPU, and to gloo where the launcher starts more ranks on
    the node (LOCAL_WORLD_SIZE) than it has cards: NCCL refuses two ranks
    on one card. A world of one joins no group unless ``always``."""
    env = os.environ
    world = int(world_size if world_size is not None
                else env.get("WORLD_SIZE", 1))
    rank = int(rank if rank is not None else env.get("RANK", 0))
    local = int(local_rank if local_rank is not None
                else env.get("LOCAL_RANK", 0))
    dev = torch.device(device)
    if dev.type == "cuda":
        if dev.index is None:
            dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
    if world == 1 and not always:
        return Ranks(0, 1, dev)
    if not 0 <= rank < world:
        raise ValueError(f"rank {rank} outside a world of {world}")
    if backend is None:
        shared = (int(env.get("LOCAL_WORLD_SIZE", 1))
                  > torch.cuda.device_count())
        backend = "nccl" if dev.type == "cuda" and not shared else "gloo"
    if not dist.is_initialized():
        dist.init_process_group(
            backend,
            init_method=init_method or "env://", rank=rank,
            world_size=world)
    return Ranks(rank, world, dev, dist.group.WORLD, data_index=rank,
                 n_data=world)


def leave(ranks: Ranks) -> None:
    """Leave the group ``join`` joined, if any."""
    if ranks.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def parse_mesh(spec: str) -> Dict[str, int]:
    """``"data=4,model=2"`` -> {"data": 4, "model": 2}, as ``tools/train.py``
    reads --mesh."""
    try:
        return {k.strip(): int(v) for k, v in
                (kv.split("=") for kv in spec.split(","))}
    except ValueError:
        raise ValueError(f"--mesh takes axis=size[,axis=size], got "
                         f"{spec!r}") from None


def check_mesh(mesh: Optional[Dict[str, int]], world: int
               ) -> Tuple[int, int]:
    """-> (D, M) of a mesh over ``world`` processes: axes "data" and
    "model" (width), D*M = world. No mesh: all ranks on "data". A mesh
    without a "data" axis has D = 1, unless it has no "model" axis
    either."""
    if not mesh:
        return world, 1
    other = sorted(set(mesh) - {"data", "model"})
    if other:
        raise ValueError(f"mesh {mesh}: the axes are 'data' and 'model', "
                         f"not {other[0]!r}")
    M = int(mesh.get("model", 1))
    D = int(mesh.get("data", world if M == 1 else 1))
    if D < 1 or M < 1:
        raise ValueError(f"mesh {mesh}: sizes must be >= 1")
    if D * M != world:
        raise ValueError(f"mesh {mesh}: data x model = {D * M} must equal "
                         f"the world size, {world} processes")
    return D, M


def check_width_split(width: int, n_width: int, fpn_strides,
                      backbone_stride: int, halo: int) -> int:
    """The shard width of a range image ``width`` columns wide over
    ``n_width`` ranks, or ValueError where the shards would not stay
    phase-aligned: the shard width must be a multiple of the largest FPN
    stride (``tools/train.py:178-181``), so ``stride_slice`` of the targets
    and the strided 1x1 shortcuts start on the global phase, and of the
    backbone's width stride (16: four stride-2 stages), so every stride-2
    conv reads an even shard; and at that stride a shard must still hold
    the ``halo`` columns its neighbours' deconv takes from it. Equal shards
    also keep the BatchNorms' per-rank counts equal, which their means over
    the ranks assume."""
    shard, rest = divmod(width, n_width)
    need = max(max(fpn_strides), backbone_stride)
    if rest or shard % need:
        raise ValueError(
            f"width {width} over model={n_width}: shards of "
            f"{width / n_width:g} columns are not phase-aligned; each must "
            f"be a multiple of {need} (the largest FPN stride "
            f"{max(fpn_strides)} and the backbone's width stride "
            f"{backbone_stride})")
    if n_width > 1 and shard // backbone_stride < halo:
        raise ValueError(
            f"width {width} over model={n_width}: a shard is "
            f"{shard // backbone_stride} columns wide at stride "
            f"{backbone_stride}, less than the deconv's {halo}-column halo")
    return shard


def mesh_place(rank: int, n_width: int) -> Tuple[int, int]:
    """(d, m) of rank r on a data-major mesh: r = d*M + m."""
    return divmod(rank, n_width)


def width_members(d: int, n_width: int):
    """The ranks of data index d's width group, in the order of m."""
    return list(range(d * n_width, (d + 1) * n_width))


def with_mesh(ranks: Ranks, n_data: int, n_width: int) -> Ranks:
    """``ranks`` placed on the mesh (D, M) = (n_data, n_width), and with
    M > 1 given the width group of its data index. ``dist.new_group`` is
    collective: every rank creates every width group, in the order of d."""
    if n_data * n_width != ranks.world:
        raise ValueError(f"mesh ({n_data}, {n_width}) over {ranks.world} "
                         f"ranks")
    d, m = mesh_place(ranks.rank, n_width)
    group = None
    if n_width > 1:
        for dd in range(n_data):
            g = dist.new_group(width_members(dd, n_width))
            if dd == d:
                group = g
    return dataclasses.replace(ranks, data_index=d, n_data=n_data,
                               width_index=m, n_width=n_width,
                               width_group=group)


def local_rows(batch: Dict, d: int, n_data: int, m: int = 0,
               n_width: int = 1) -> Dict:
    """Rank (d, m)'s part of a global host batch (``mesh.py:batch_spec``):
    rows ``[d*B, (d+1)*B)`` with B = rows / n_data, and of every 4-D
    (B, H, W, C) array the columns ``[m*Wl, (m+1)*Wl)``, Wl = W / n_width."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % n_data:
            raise ValueError(f"{k}: {n} rows do not split over {n_data} "
                             f"ranks")
        b = n // n_data
        v = v[d * b:(d + 1) * b]
        if n_width > 1 and v.ndim == 4:
            if v.shape[2] % n_width:
                raise ValueError(f"{k}: {v.shape[2]} columns do not split "
                                 f"over {n_width} ranks")
            w = v.shape[2] // n_width
            v = v[:, :, m * w:(m + 1) * w]
        out[k] = v
    return out


def share_batch(batch, ranks: Ranks):
    """The host batch of the width group's first rank (m = 0) on every rank
    of the group (``broadcast_object_list``): the M ranks of data index d
    train on the same frames, loaded and augmented once. Without a width
    group, ``batch`` itself."""
    global COLLECTIVES
    if ranks.width_group is None:
        return batch
    box = [batch if ranks.width_index == 0 else None]
    COLLECTIVES += 1
    dist.broadcast_object_list(box, src=ranks.data_index * ranks.n_width,
                               group=ranks.width_group)
    return box[0]


def _all_reduce(t: torch.Tensor, group) -> None:
    global COLLECTIVES
    COLLECTIVES += 1
    dist.all_reduce(t, op=dist.ReduceOp.SUM, group=group)


class AllReduceSum(torch.autograd.Function):
    """psum with its shard_map transpose: the forward sums a copy of x over
    the group, the backward sums the incoming gradient."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        _all_reduce(y, group)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.clone(memory_format=torch.contiguous_format)
        _all_reduce(g, ctx.group)
        return g, None


def all_reduce_sum(x: torch.Tensor, group) -> torch.Tensor:
    """x summed over the group, differentiable where x needs a gradient."""
    if torch.is_grad_enabled() and x.requires_grad:
        return AllReduceSum.apply(x, group)
    y = x.detach().clone(memory_format=torch.contiguous_format)
    _all_reduce(y, group)
    return y


def _flat(tensors: Iterable[torch.Tensor], collective) -> None:
    """``collective(flat)`` on one flat buffer for each (device, dtype) of
    the tensors, whose values are then copied back in place."""
    groups: Dict = {}
    for t in tensors:
        groups.setdefault((t.device, t.dtype), []).append(t)
    for group in groups.values():
        flat = torch.cat([t.reshape(-1) for t in group])
        collective(flat)
        offset = 0
        for t in group:
            t.copy_(flat[offset:offset + t.numel()].view_as(t))
            offset += t.numel()


def all_reduce_(tensors: Iterable[torch.Tensor], group,
                mean: bool = False) -> None:
    """Sum (or average) each tensor over the group in place."""
    world = dist.get_world_size(group)

    def reduce(flat):
        _all_reduce(flat, group)
        if mean:
            flat /= world

    _flat(tensors, reduce)


@torch.no_grad()
def replicate_state(model: torch.nn.Module, group, src: int = 0) -> None:
    """Rank ``src``'s parameters and buffers on every rank
    (``mesh.py:replicate_state``)."""
    def broadcast(flat):
        global COLLECTIVES
        COLLECTIVES += 1
        dist.broadcast(flat, src, group=group)

    _flat([t.data for t in model.parameters()] + list(model.buffers()),
              broadcast)


def barrier(ranks: Ranks) -> None:
    """Wait for every rank (nothing to wait for without a group)."""
    if ranks.group is not None:
        dist.barrier(group=ranks.group)
