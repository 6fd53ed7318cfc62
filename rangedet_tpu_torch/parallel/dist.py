"""Data parallelism over processes, one per card: the counterpart of
``rangedet_tpu/parallel/mesh.py`` for data-only meshes.

JAX runs one program over a mesh of devices; the port runs one process per
card, joined in a ``torch.distributed`` process group (``nccl`` on CUDA,
``gloo`` on the CPU). Rank r owns rows ``[r*B, (r+1)*B)`` of a global batch
of ``world*B`` frames, as ``batch_spec`` / ``shard_batch`` give JAX's data
shards. Parameters and buffers are replicated: rank 0's are broadcast after
init and after ``--resume`` (``replicate_state``).

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
from typing import Dict, Iterable, Optional

import torch
import torch.distributed as dist

COLLECTIVES = 0


def reset_counts() -> None:
    global COLLECTIVES
    COLLECTIVES = 0


@dataclasses.dataclass(frozen=True)
class Ranks:
    """This process's place in the data-parallel group: its rank, the
    world size, its card (or the CPU) and the group (None: one process,
    no group joined)."""

    rank: int
    world: int
    device: torch.device
    group: Optional[dist.ProcessGroup] = None


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
    gloo on the CPU. A world of one joins no group unless ``always``."""
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
    if not dist.is_initialized():
        dist.init_process_group(
            backend or ("nccl" if dev.type == "cuda" else "gloo"),
            init_method=init_method or "env://", rank=rank,
            world_size=world)
    return Ranks(rank, world, dev, dist.group.WORLD)


def leave(ranks: Ranks) -> None:
    """Leave the group ``join`` joined, if any."""
    if ranks.group is not None and dist.is_initialized():
        dist.destroy_process_group()


def parse_mesh(spec: str) -> Dict[str, int]:
    """``"data=4"`` -> {"data": 4}, as ``tools/train.py`` reads --mesh."""
    try:
        return {k.strip(): int(v) for k, v in
                (kv.split("=") for kv in spec.split(","))}
    except ValueError:
        raise ValueError(f"--mesh takes axis=size[,axis=size], got "
                         f"{spec!r}") from None


def check_mesh(mesh: Optional[Dict[str, int]], world: int) -> None:
    """A data-only mesh whose data axis is the world size. Width sharding
    (a "model" axis) is not ported."""
    if not mesh:
        return
    other = sorted(a for a, n in mesh.items() if a != "data" and n != 1)
    if other:
        raise ValueError(
            f"mesh {mesh}: width sharding (a {other[0]!r} axis) is not "
            f"ported; ROADMAP #16 part 2")
    if mesh.get("data", world) != world:
        raise ValueError(f"mesh {mesh}: the data axis must equal the "
                         f"world size, {world} processes")


def local_rows(batch: Dict, rank: int, world: int) -> Dict:
    """Rank ``rank``'s rows of a global host batch: ``[r*B, (r+1)*B)``
    with B = rows / world (``mesh.py:batch_spec``'s data shard)."""
    out = {}
    for k, v in batch.items():
        n = v.shape[0]
        if n % world:
            raise ValueError(f"{k}: {n} rows do not split over {world} "
                             f"ranks")
        b = n // world
        out[k] = v[rank * b:(rank + 1) * b]
    return out


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
