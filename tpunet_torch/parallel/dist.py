"""Process group bootstrap and the collectives of data parallelism, port
of ``tpunet/parallel/dist.py``.

The reference boots with mpirun, then a TCP rendezvous at a hardcoded
localhost:29500, then an NCCL process group, and binds rank ``r`` to
card ``r % device_count`` (cifar10_mpi_mobilenet_224.py:24-40). Here
:func:`initialize_distributed` reads the launcher's standard variables
(``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``,
``MASTER_PORT``, as ``torchrun`` sets them); explicit arguments override
them. The backend follows the device: NCCL for CUDA, gloo for the CPU.

    torchrun --standalone --nproc-per-node 2 -m tpunet_torch.train \\
        --preset distributed --device cpu ...

Every collective of the port goes through :func:`all_reduce`,
:func:`all_gather`, :func:`reduce_scatter`, :func:`all_reduce_max`,
:func:`fetch_rows` (mixup's partner rows), :func:`ppermute` (the ring's
neighbour hop), :func:`all_to_all` (Ulysses' re-sharding),
:func:`pipe_hop` (a pipeline tick's stage-to-stage hops) or
:func:`broadcast` (the tensor-parallel engine's op stream and the
generation loop's chosen tokens, from the group's first rank), which
count their calls
(``all_reduce.calls``, ...) and the host seconds spent inside them
(``all_reduce.seconds``, ...; NCCL returns once the collective is
queued, gloo when it is done), as the kernel wrappers count their
launches. Each takes a ``group`` (``None``: every rank; the mesh's axis
groups come from ``tpunet_torch.parallel.mesh``); on a group of one
rank it is the identity and counts nothing. Without a process group
every helper here is the identity (one rank, index 0), so
single-process code runs unchanged.

Tensor parallelism's two Megatron operators are here too:
:func:`copy_to_group` (the identity forward, an all-reduce of the
gradient backward: a replicated activation entering a column-parallel
layer) and :func:`reduce_from_group` (an all-reduce forward, the
identity backward: a row-parallel layer's partial sums).

Sequence parallelism's differentiable collectives (tpunet's
``lax.ppermute`` and ``lax.all_to_all`` under ``shard_map``):
:func:`ring_pass` (every block of a ring of neighbour hops, the
gradients sent back the other way) and :func:`all_to_all` (split one
dim, concatenate another; its backward is the inverse all-to-all). Both
move data with ``all_to_all_single``, which NCCL runs card to card and
gloo runs on CPU and CUDA tensors alike; gloo stages a CUDA tensor
through pinned host memory inside the collective, so on gloo their
counted host seconds include those copies.

:func:`agree_any` is the preemption path's stop agreement without a
device collective: a cross-process OR of a host flag through the
process group's key-value store. tpunet's ``kv_live_processes`` (the
liveness count through the store) is ``_live_processes`` in
``tpunet_torch/obs/memory.py``; the checkpointer's commit handshake
(``tpunet_torch/ckpt.py``) uses the same store.
"""

from __future__ import annotations

import datetime
import os
import time
from typing import Optional, Sequence, Tuple

import torch
import torch.distributed as dist

# How long a rank waits at a rendezvous or a collective before it fails.
TIMEOUT = datetime.timedelta(minutes=10)


def is_initialized() -> bool:
    """True when this process belongs to a process group."""
    return dist.is_available() and dist.is_initialized()


def initialize_distributed(init_method: Optional[str] = None,
                           world_size: Optional[int] = None,
                           rank: Optional[int] = None,
                           backend: Optional[str] = None,
                           device: str = "cuda",
                           timeout: Optional[datetime.timedelta] = None
                           ) -> None:
    """Join the process group of this run; a no-op when one exists.

    ``world_size`` and ``rank`` default to ``WORLD_SIZE`` (1) and
    ``RANK`` (0); ``init_method`` to ``env://`` (``MASTER_ADDR`` and
    ``MASTER_PORT``) when ``MASTER_ADDR`` is set. A one-process world
    without an address takes an in-memory store. ``backend`` defaults to
    NCCL when ``device`` is a CUDA device and gloo otherwise; two ranks
    that share one card pass ``backend="gloo"``, since NCCL refuses
    them. ``timeout`` bounds every rendezvous and collective (``TIMEOUT``
    by default): the tensor-parallel server sets its own, so that a dead
    rank fails the others' collectives in that time."""
    if is_initialized():
        return
    env = os.environ
    world_size = int(env.get("WORLD_SIZE", 1)) if world_size is None \
        else world_size
    rank = int(env.get("RANK", 0)) if rank is None else rank
    if not 0 <= rank < world_size:
        raise ValueError(f"rank {rank} outside a world of {world_size}")
    kind = torch.device(device).type
    backend = backend or ("nccl" if kind == "cuda" else "gloo")
    kw = {"backend": backend, "world_size": world_size, "rank": rank,
          "timeout": TIMEOUT if timeout is None else timeout}
    if init_method is None and env.get("MASTER_ADDR"):
        init_method = "env://"
    if init_method is not None:
        kw["init_method"] = init_method
    elif world_size == 1:
        kw["store"] = dist.HashStore()
    else:
        raise ValueError(f"a world of {world_size} processes needs "
                         "MASTER_ADDR and MASTER_PORT or an init_method")
    if backend == "nccl":
        # Binds the communicator to this rank's card up front.
        kw["device_id"] = local_device(kind, rank)
    dist.init_process_group(**kw)


def destroy() -> None:
    """Leave the process group, if this process is in one."""
    if is_initialized():
        dist.destroy_process_group()


def process_index() -> int:
    """This process's rank (the reference's ``rank``)."""
    return dist.get_rank() if is_initialized() else 0


def process_count() -> int:
    """The number of processes (the reference's ``world_size``)."""
    return dist.get_world_size() if is_initialized() else 1


def backend_name() -> Optional[str]:
    """The process group's backend (``nccl``, ``gloo``), or None."""
    return dist.get_backend() if is_initialized() else None


def local_device(kind: str = "cuda",
                 rank: Optional[int] = None) -> torch.device:
    """This rank's device: ``cuda:{LOCAL_RANK % device_count}``, the
    reference's ``rank % device_count`` binding (``LOCAL_RANK`` defaults
    to the rank), or the CPU."""
    if kind == "cpu":
        return torch.device("cpu")
    rank = process_index() if rank is None else rank
    local = int(os.environ.get("LOCAL_RANK", rank))
    return torch.device("cuda", local % torch.cuda.device_count())


def sync_hosts(name: str = "barrier") -> None:
    """A barrier across the ranks (the reference's ``dist.barrier()``);
    ``name`` says what it waits for. Nothing to wait for in a world of
    one."""
    del name
    if process_count() > 1:
        dist.barrier()


class _Self:
    """The group of this rank alone (a mesh axis of size 1): every
    collective over it is the identity, and no process group is made."""

    def __repr__(self) -> str:
        return "SELF"


SELF = _Self()


def group_size(group=None) -> int:
    """The number of ranks in ``group`` (None: all of them)."""
    if group is SELF or not is_initialized():
        return 1
    return dist.get_world_size(group)


def _counted(fn, t0: float) -> None:
    fn.calls += 1
    fn.seconds += time.perf_counter() - t0


def all_reduce(t: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``t`` over the ranks of ``group`` (None: all) in place and
    return it; counts the call in ``all_reduce.calls``. The identity
    without a process group. A group of one rank is the identity too,
    except the default group, which reduces even alone (a world of one
    over NCCL still runs its collectives, as the data-parallel path has
    always done)."""
    if not is_initialized() or (group is not None
                                and group_size(group) == 1):
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, group=group)
    _counted(all_reduce, t0)
    return t


all_reduce.calls = 0
all_reduce.seconds = 0.0


def all_reduce_max(t: torch.Tensor, group=None) -> torch.Tensor:
    """Elementwise max of ``t`` over the ranks of ``group``, in place;
    counted in ``all_reduce_max.calls``."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.all_reduce(t, op=dist.ReduceOp.MAX, group=group)
    _counted(all_reduce_max, t0)
    return t


all_reduce_max.calls = 0
all_reduce_max.seconds = 0.0

# torch 2.13 renames the tensor forms of all-gather and reduce-scatter;
# the older names (torch 2.11) take the same arguments.
_all_gather_single = getattr(dist, "all_gather_single", None) or \
    getattr(dist, "all_gather_into_tensor", None)
_reduce_scatter_single = getattr(dist, "reduce_scatter_single", None) or \
    getattr(dist, "reduce_scatter_tensor", None)


def all_gather(t: torch.Tensor, group=None) -> torch.Tensor:
    """The ``t`` of every rank of ``group``, stacked in rank order on a
    new dim 0 ([ranks, *t.shape]); counted in ``all_gather.calls``. One
    rank: ``t[None]``. NCCL and gloo (CPU and CUDA tensors) both run the
    tensor form of the collective."""
    n = group_size(group)
    if n == 1:
        return t[None]
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(n * flat.numel())
    t0 = time.perf_counter()
    _all_gather_single(out, flat, group=group)
    _counted(all_gather, t0)
    return out.view((n,) + tuple(t.shape))


all_gather.calls = 0
all_gather.seconds = 0.0


def reduce_scatter(t: torch.Tensor, group=None) -> torch.Tensor:
    """Rank r of ``group`` gets ``t[r]`` summed over the ranks: ``t`` is
    [ranks, *shape], the result [*shape]; counted in
    ``reduce_scatter.calls``. One rank: ``t[0]``. NCCL and torch's gloo
    (2.11 and later, CPU and CUDA tensors) both run the tensor form of
    the collective; no all-reduce-and-slice stands in for it."""
    n = group_size(group)
    if n == 1:
        return t[0]
    if t.shape[0] != n:
        raise ValueError(f"reduce_scatter of {t.shape[0]} pieces over "
                         f"{n} ranks")
    flat = t.contiguous().reshape(-1)
    out = flat.new_empty(flat.numel() // n)
    t0 = time.perf_counter()
    _reduce_scatter_single(out, flat, group=group)
    _counted(reduce_scatter, t0)
    return out.view(t.shape[1:])


reduce_scatter.calls = 0
reduce_scatter.seconds = 0.0


def broadcast(t: torch.Tensor, group=None) -> torch.Tensor:
    """``t`` of the first rank of ``group`` (None: all ranks) written
    into ``t`` on every rank, in place, and returned; counted in
    ``broadcast.calls``. The identity on a group of one rank. Every rank
    passes a tensor of the same size and dtype."""
    if group_size(group) == 1:
        return t
    t0 = time.perf_counter()
    dist.broadcast(t, group=group, group_src=0)
    _counted(broadcast, t0)
    return t


broadcast.calls = 0
broadcast.seconds = 0.0


def collective_counts() -> dict:
    """{wrapper name: (calls, host seconds)} of every counted collective."""
    return {f.__name__: (f.calls, f.seconds) for f in _COUNTED}


def reset_collective_counts() -> None:
    for f in _COUNTED:
        f.calls, f.seconds = 0, 0.0


def fetch_rows(tensors: Sequence[torch.Tensor], perm: torch.Tensor,
               group=None) -> Tuple[torch.Tensor, ...]:
    """Rows of the global batch, by global index, for this rank: each of
    ``tensors`` holds this rank's ``n`` rows of a global batch that the
    ranks split evenly in rank order, ``perm`` (int64 [n * ranks], the
    same on every rank) names for each global row the row it wants, and
    this rank gets rows ``perm[n*rank:n*(rank+1)]`` of each tensor, in
    that order. One ``all_to_all_single`` over the tensors' bytes moves
    only the wanted rows, in their own dtypes; counts the call in
    ``fetch_rows.calls``. ``group``: the ranks that split the batch
    (None: all). Without a process group, ``t[perm]``."""
    if not is_initialized() or (group is not None
                                and group_size(group) == 1):
        return tuple(t[perm.to(t.device)] for t in tensors)
    ranks, n = dist.get_world_size(group), tensors[0].shape[0]
    me = dist.get_rank(group)
    want = perm.cpu().view(ranks, n)
    owner = want // n
    mine = owner == me
    # Mine that rank r wants, in r's order; from rank s, what I want of
    # its rows, in my order: ``order`` puts each back at its place.
    send = torch.cat([want[r][mine[r]] for r in range(ranks)]) - me * n
    order = torch.argsort(owner[me], stable=True)
    flat = [t.reshape(n, -1).contiguous().view(torch.uint8) for t in tensors]
    packed = torch.cat(flat, dim=1)
    dev = packed.device
    recv = packed.new_empty(packed.shape)
    t0 = time.perf_counter()
    dist.all_to_all_single(
        recv, packed[send.to(dev)],
        output_split_sizes=torch.bincount(owner[me], minlength=ranks).tolist(),
        input_split_sizes=mine.sum(dim=1).tolist(), group=group)
    rows = torch.empty_like(recv)
    rows[order.to(dev)] = recv
    _counted(fetch_rows, t0)
    out, col = [], 0
    for t, f in zip(tensors, flat):
        part = rows[:, col:col + f.shape[1]].contiguous()
        out.append(part.view(t.dtype).view(t.shape))
        col += f.shape[1]
    return tuple(out)


fetch_rows.calls = 0
fetch_rows.seconds = 0.0


def ppermute(t: torch.Tensor, group=None, shift: int = 1) -> torch.Tensor:
    """What the rank ``shift`` places before this one in ``group`` holds:
    every rank sends ``t`` to its neighbour ``shift`` ranks on (around
    the ring) and receives its other neighbour's; counted in
    ``ppermute.calls``. One ``all_to_all_single`` with one nonzero
    split each way, so gloo and NCCL run the same call and no unbatched
    send can deadlock the ring. Not differentiable (:func:`ring_pass`
    is). One rank: ``t``."""
    n = group_size(group)
    if n == 1:
        return t
    me = dist.get_rank(group)
    flat = t.contiguous().reshape(-1)
    out = torch.empty_like(flat)
    send, recv = [0] * n, [0] * n
    send[(me + shift) % n] = recv[(me - shift) % n] = flat.numel()
    t0 = time.perf_counter()
    dist.all_to_all_single(out, flat, output_split_sizes=recv,
                           input_split_sizes=send, group=group)
    _counted(ppermute, t0)
    return out.view(t.shape)


ppermute.calls = 0
ppermute.seconds = 0.0


def pipe_hop(send: Optional[Tuple[int, torch.Tensor]],
             recv_from: Sequence[int], shape: Sequence[int],
             dtype: torch.dtype, device, group=None) -> dict:
    """One tick of a pipeline's hops over ``group`` (the mesh's 'pipe'
    group): this rank sends ``send[1]`` to the rank of index ``send[0]``
    in the group (or nothing: ``send`` None) and receives one tensor of
    ``shape`` and ``dtype`` from each index in ``recv_from``; returns
    {source index: tensor}. Every rank of the group calls it at the same
    tick with sizes that agree (each rank reads them from the same
    schedule table), so it is one ``all_to_all_single`` with one split
    of ``numel`` or 0 each way: gloo (CPU and CUDA tensors) and NCCL run
    the same call, a rank that neither sends nor receives still takes
    part, and no unpaired send can deadlock. Counted in
    ``pipe_hop.calls``."""
    n = group_size(group)
    numel = 1
    for d in shape:
        numel *= int(d)
    send_split, recv_split = [0] * n, [0] * n
    if send is not None:
        send_split[send[0]] = numel
        flat = send[1].contiguous().reshape(-1)
        if flat.numel() != numel or flat.dtype != dtype:
            raise ValueError(f"pipe_hop: sending {tuple(send[1].shape)} "
                             f"{send[1].dtype}, the hop carries "
                             f"{tuple(shape)} {dtype}")
    else:
        flat = torch.empty(0, dtype=dtype, device=device)
    for r in recv_from:
        recv_split[r] = numel
    out = torch.empty(numel * len(recv_from), dtype=dtype, device=device)
    t0 = time.perf_counter()
    dist.all_to_all_single(out, flat, output_split_sizes=recv_split,
                           input_split_sizes=send_split, group=group)
    _counted(pipe_hop, t0)
    got = out.split(numel)
    return {r: got[i].view(tuple(shape))
            for i, r in enumerate(sorted(recv_from))}


pipe_hop.calls = 0
pipe_hop.seconds = 0.0


class _RingPass(torch.autograd.Function):
    """All n blocks of a ring: block s is what the rank s places before
    this one holds, after s hops of ``ppermute(shift=1)``. The backward
    sends the gradients back the other way: n - 1 hops of
    ``ppermute(shift=-1)``, each adding the block one step nearer home.
    One node for the whole ring, so every rank runs all n - 1 backward
    hops even when it used only some blocks (a causal ring skips the
    blocks from later ranks); a hop per node would leave such a rank out
    of the others' backward hops."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        blocks = [t.view_as(t)]
        for _ in range(group_size(group) - 1):
            blocks.append(ppermute(blocks[-1], group, 1))
        return tuple(blocks)

    @staticmethod
    def backward(ctx, *grads):
        acc = grads[-1]
        for g in reversed(grads[:-1]):
            acc = ppermute(acc, ctx.group, -1) + g
        return acc, None


def ring_pass(t: torch.Tensor, group=None) -> Tuple[torch.Tensor, ...]:
    """The ``group_size(group)`` blocks a ring of neighbour hops brings
    to this rank, its own first: block s came from the rank s before it
    (index ``(me - s) % n``). Differentiable: each block's gradient goes
    back to the rank it came from (tpunet's ``ppermute`` under
    ``shard_map``). ``n - 1`` hops forward and ``n - 1`` backward, none
    after the last block. ``(t,)`` on a group of one."""
    if group_size(group) == 1:
        return (t,)
    return _RingPass.apply(t, group)


def _all_to_all(t: torch.Tensor, group, split_dim: int,
                concat_dim: int) -> torch.Tensor:
    n = group_size(group)
    if t.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} of {tuple(t.shape)} "
                         f"does not split over {n} ranks")
    # [n (destination), ...]: piece j of the split dim goes to rank j.
    send = t.unflatten(split_dim, (n, -1)).movedim(split_dim, 0).contiguous()
    recv = torch.empty_like(send)
    t0 = time.perf_counter()
    dist.all_to_all_single(recv, send, group=group)
    _counted(all_to_all, t0)
    # recv[j] is rank j's piece: concatenated in rank order.
    return recv.movedim(0, concat_dim).flatten(concat_dim, concat_dim + 1)


class _AllToAll(torch.autograd.Function):
    @staticmethod
    def forward(ctx, t, group, split_dim, concat_dim):
        ctx.args = (group, split_dim, concat_dim)
        return _all_to_all(t, group, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, g):
        group, split_dim, concat_dim = ctx.args
        return _all_to_all(g, group, concat_dim, split_dim), None, None, None


def all_to_all(t: torch.Tensor, group, split_dim: int,
               concat_dim: int) -> torch.Tensor:
    """tpunet's tiled ``lax.all_to_all``: ``t``'s dim ``split_dim`` cut
    into ``n`` equal pieces, piece j sent to rank j of ``group``, and
    the pieces received concatenated along ``concat_dim`` in rank order
    (that dim grows n-fold, ``split_dim`` shrinks as much). One
    ``all_to_all_single``, counted in ``all_to_all.calls``;
    differentiable, the backward being the inverse all-to-all. ``t`` on
    a group of one."""
    if group_size(group) == 1:
        return t
    return _AllToAll.apply(t, group, split_dim, concat_dim)


all_to_all.calls = 0
all_to_all.seconds = 0.0


class _AllReduceSum(torch.autograd.Function):
    """Sum over the ranks, forward and backward. The gradient of a rank's
    local summand is the sum over the ranks of the gradients of the
    global sum, so the backward is a sum too."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


def all_reduce_sum(t: torch.Tensor, group=None) -> torch.Tensor:
    """Differentiable sum of ``t`` over the ranks of ``group``, where
    each rank's ``t`` is its own summand of a loss that every rank of
    the group sums (BN's batch sums); the identity (``t`` itself)
    without a process group."""
    if not is_initialized():
        return t
    return _AllReduceSum.apply(t, group)


class _CopyToGroup(torch.autograd.Function):
    """Megatron's ``f``: the identity forward, the gradient summed over
    the group backward."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.group = group
        return t.view_as(t)

    @staticmethod
    def backward(ctx, g):
        return all_reduce(g.clone(), ctx.group), None


class _ReduceFromGroup(torch.autograd.Function):
    """Megatron's ``g``: the partial sums summed over the group forward,
    the identity backward (every rank holds the same loss, so each
    summand's gradient is the sum's)."""

    @staticmethod
    def forward(ctx, t, group):
        return all_reduce(t.clone(), group)

    @staticmethod
    def backward(ctx, g):
        return g, None


class _GatherFromGroup(torch.autograd.Function):
    """Every rank's piece concatenated on dim 0 forward (each rank then
    holds the same whole), this rank's piece of the gradient backward
    (every rank holds the same loss)."""

    @staticmethod
    def forward(ctx, t, group):
        ctx.piece = (axis_rank(group), t.shape[0])
        return all_gather(t, group).flatten(0, 1)

    @staticmethod
    def backward(ctx, g):
        r, n = ctx.piece
        return g[r * n:(r + 1) * n], None


def axis_rank(group) -> int:
    """This rank's index in ``group`` (0 alone)."""
    if group is SELF or not is_initialized():
        return 0
    return dist.get_group_rank(group, dist.get_rank()) \
        if group is not None else dist.get_rank()


def gather_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """Rank-specific pieces [n, ...] becoming one replicated whole
    [ranks * n, ...] in rank order (an all-gather), the gradient of this
    rank's piece backward; ``t`` itself on a group of one."""
    if group_size(group) == 1:
        return t
    return _GatherFromGroup.apply(t, group)


def copy_to_group(t: torch.Tensor, group) -> torch.Tensor:
    """A replicated activation entering rank-specific work (a
    column-parallel layer): ``t`` forward, the gradient all-reduced over
    ``group`` backward; ``t`` itself on a group of one."""
    if group_size(group) == 1:
        return t
    return _CopyToGroup.apply(t, group)


def reduce_from_group(t: torch.Tensor, group) -> torch.Tensor:
    """Rank-specific partial sums becoming one replicated value (a
    row-parallel layer's output): all-reduced over ``group`` forward,
    the gradient passed through backward; ``t`` itself on a group of
    one."""
    if group_size(group) == 1:
        return t
    return _ReduceFromGroup.apply(t, group)


_COUNTED = (all_reduce, all_reduce_max, all_gather, reduce_scatter, fetch_rows,
            ppermute, all_to_all, pipe_hop, broadcast)


def agree_any(tag: str, flag: bool,
              timeout: datetime.timedelta = TIMEOUT) -> bool:
    """Cross-process OR of a host-side flag (the preemption stop
    agreement, tpunet's ``agree_any``) through the default group's c10d
    store: each rank sets ``<tag>/<rank>``, waits until every rank's key
    is there (the store's barrier) and reads them all. No device
    collective: no device sync per poll, and nothing that could
    interleave with the step's collectives. ``tag`` must be unique per
    agreement round and the same on every rank (the global step). The
    local flag in a world of one."""
    world = process_count()
    if world == 1:
        return bool(flag)
    store = dist.distributed_c10d._get_default_store()
    base = f"tpunet_agree/{tag}"
    store.set(f"{base}/{process_index()}", "1" if flag else "0")
    keys = [f"{base}/{i}" for i in range(world)]
    store.wait(keys, timeout)
    return any(store.get(k) == b"1" for k in keys)
