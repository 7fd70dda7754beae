"""Data-parallel training over ``torch.distributed``: the mesh, the
ranks' start, the batch split and the two data-parallel train steps.

Port of ``ugaitnet_tpu/parallel/sharding.py``.  The JAX package drives a
device mesh from one process (GSPMD or ``shard_map``); the port runs one
process per rank, each with its own device, joined by a process group:

  * ``make_mesh`` (and ``build_mesh`` for the 2-D meshes of
    ``parallel/sequence.py`` and ``parallel/expert.py``) returns a ``Mesh``:
    the world, this rank, its device and one process group per named axis.
    Rank ``r`` of a (n0, n1) mesh sits at ``(r // n1, r % n1)``, the
    row-major layout of the JAX package's ``np.reshape(devices, shape)``.
  * ``spawn`` starts the ranks (``torch.multiprocessing``, ``spawn`` method:
    CUDA cannot fork); ``init_rank`` joins one to the group, under
    ``spawn`` or under ``torchrun`` (its ``RANK`` / ``WORLD_SIZE`` /
    ``LOCAL_RANK`` environment).  NCCL when every rank has a card of its
    own; gloo for CPU ranks and for several ranks on one card, which only an
    explicit device list asks for.
  * the differentiable collectives and ``average_gradients`` are in
    ``ops/collectives.py``, which the ops, the models and the train step
    use without depending on this module.

The two data-parallel steps (both ``train/train_step.py:make_train_step``
with a mesh):

  * ``make_sharded_train_step``, the global form (the JAX GSPMD step, which
    the JAX ``Trainer`` uses for a plain mesh): it equals the one-process
    step on the global batch.  The signature's batch-axis L2 sums over the
    data ranks, triplets are mined over the gathered signatures and labels,
    the id losses are averaged over the global batch, MoE routing sees the
    global token set, and every dropout mask is the global batch's, of
    which each rank takes its rows (``models/branches.py:ShardKey``).
  * ``make_shardmap_train_step``, the per-shard form (the JAX ``shard_map``
    step): the signature normalizes over the local batch, as the
    reference's MirroredStrategy replicas did, MoE routes the local tokens,
    the dropout key is folded with the rank, and the id and MoE terms are
    mean-reduced.  Under ``l2_mode="feature"`` with dropout off it equals
    the global form.

The triplet kernel runs unchanged on the gathered batch of every rank; the
JAX steps swap in the XLA formulation only because the GSPMD partitioner
cannot shard a Mosaic call.
"""

from __future__ import annotations

import dataclasses
import os
import tempfile
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

import torch
import torch.distributed as dist

from ugaitnet_tpu_torch.ops.collectives import DATA_AXIS, gather_rows_nograd
from ugaitnet_tpu_torch.train.train_step import make_train_step


# ---------------------------------------------------------------- devices

def device_list(n: int, device=None) -> List[torch.device]:
    """The devices of ``n`` ranks: ``n`` CPU ranks for a CPU device, else
    cards 0..n-1, one per rank.  Raises when fewer cards exist than asked:
    a silent fallback would train with another batch per device than the
    run was sized for."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        return [torch.device("cpu")] * n
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if n > have:
        raise ValueError(
            f"requested a {n}-device mesh but only {have} CUDA device(s) "
            "are available; a silent fallback would train with a different "
            "effective batch than sized for (several ranks on one card "
            "only with an explicit device list)")
    return [torch.device("cuda", i) for i in range(n)]


def rank_devices(device=None) -> List[torch.device]:
    """The device list ``build_mesh`` takes, from inside a started world:
    this rank's own device in every entry (the CPU for a CPU ``device``,
    else the current card, which ``init_rank`` set), since a rank reads
    only its own entry."""
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        dev = torch.device("cuda", torch.cuda.current_device())
    return [dev] * dist.get_world_size()


def backend_for(devices: Sequence[torch.device]) -> str:
    """NCCL when every rank has a card of its own, else gloo."""
    devs = [torch.device(d) for d in devices]
    if all(d.type == "cuda" for d in devs) and \
            len({d.index for d in devs}) == len(devs):
        return "nccl"
    return "gloo"


def init_rank(rank: int, world: int, devices: Sequence,
              init_method: str = "env://") -> torch.device:
    """Join this process to the default group as ``rank`` of ``world`` on
    ``devices[rank]``, and make that card the current one (the kernels'
    launcher uses the current stream, which must be the card's)."""
    devices = [torch.device(d) for d in devices]
    if len(devices) != world:
        raise ValueError(f"{len(devices)} devices for a world of {world}")
    dev = devices[rank]
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    dist.init_process_group(backend_for(devices), init_method=init_method,
                            rank=rank, world_size=world)
    return dev


def init_from_env(device=None) -> torch.device:
    """``init_rank`` under ``torchrun``: rank and world from ``RANK`` and
    ``WORLD_SIZE``.  On cards (the default) every rank takes card
    ``LOCAL_RANK`` of its host and NCCL; with ``device="cpu"``, CPU ranks
    and gloo."""
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cpu":
        dist.init_process_group("gloo", init_method="env://", rank=rank,
                                world_size=world)
        return dev
    local = int(os.environ.get("LOCAL_RANK", rank))
    n_cards = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if local >= n_cards:
        raise ValueError(f"LOCAL_RANK {local} but only {n_cards} CUDA "
                         "device(s) on this host")
    dev = torch.device("cuda", local)
    torch.cuda.set_device(dev)
    dist.init_process_group("nccl", init_method="env://", rank=rank,
                            world_size=world)
    return dev


def under_torchrun() -> bool:
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def _rank_entry(rank: int, fn: Callable, world: int, devices, init_method,
                threads: Optional[int], args: Tuple) -> None:
    if threads:
        torch.set_num_threads(threads)
    init_rank(rank, world, devices, init_method)
    try:
        fn(rank, *args)
    finally:
        dist.destroy_process_group()


def spawn(fn: Callable, world: int, args: Tuple = (),
          devices: Optional[Sequence] = None,
          init_file: Optional[str] = None,
          threads: Optional[int] = None) -> None:
    """Run ``fn(rank, *args)`` in ``world`` fresh processes joined by a
    process group, and wait for all of them.  ``fn`` must be importable
    (a module-level function).  The rendezvous is a file (``init_file``,
    else a new temporary one), so no port is opened and concurrent worlds
    never collide.  A rank that raises fails the call."""
    import torch.multiprocessing as mp
    devices = list(devices) if devices is not None else device_list(world)
    own = init_file is None
    if own:
        fd, init_file = tempfile.mkstemp(prefix="ugait_rdzv_")
        os.close(fd)
        os.unlink(init_file)      # the store creates it
    try:
        mp.start_processes(_rank_entry,
                           args=(fn, world, devices,
                                 f"file://{os.path.abspath(init_file)}",
                                 threads, tuple(args)),
                           nprocs=world, join=True, start_method="spawn")
    finally:
        if own and os.path.exists(init_file):
            os.unlink(init_file)


def spawn_command(fn: Callable, world: int, argv, device=None) -> None:
    """Start ``world`` ranks of a command: ``fn(rank, argv)`` in each, on
    ``device_list(world, device)``; CPU ranks share the host's cores."""
    devices = device_list(world, device)
    threads = (max(1, (os.cpu_count() or 1) // world)
               if devices[0].type == "cpu" else None)
    spawn(fn, world, args=(argv,), devices=devices, threads=threads)


# ------------------------------------------------------------------- mesh

@dataclasses.dataclass
class Mesh:
    """This rank's view of a mesh of ``world`` ranks.

    ``shape``: axis name -> size, in mesh order; ``coords``: this rank's
    index along each axis; ``groups``: axis name -> the process group of
    the ranks that differ from this one along that axis only."""
    shape: Dict[str, int]
    coords: Dict[str, int]
    groups: Dict[str, Any]
    rank: int
    world: int
    device: torch.device
    backend: str

    @property
    def axis_names(self) -> Tuple[str, ...]:
        return tuple(self.shape)

    def size(self, axis: str) -> int:
        return self.shape[axis]

    def index(self, axis: str) -> int:
        return self.coords[axis]

    def group(self, axis: str):
        return self.groups[axis]

    @property
    def is_main(self) -> bool:
        return self.rank == 0


def build_mesh(axes: Sequence[Tuple[str, int]],
               devices: Optional[Sequence] = None) -> Mesh:
    """A mesh of the given (name, size) axes over the default process
    group, whose world must be their product.  ``devices``: one per rank
    (default: the current card in an NCCL world, else the CPU; a gloo world
    on cards passes its devices).
    Every rank makes every axis group, in the same order, as
    ``torch.distributed.new_group`` requires."""
    if not dist.is_initialized():
        raise RuntimeError(
            "no process group: start the ranks with parallel.sharding.spawn "
            "or under torchrun, and call init_rank / init_from_env first")
    names = [a for a, _ in axes]
    sizes = [int(n) for _, n in axes]
    world, rank = dist.get_world_size(), dist.get_rank()
    need = 1
    for n in sizes:
        need *= n
    if need != world:
        raise ValueError(f"a {dict(axes)} mesh needs {need} ranks; the "
                         f"process group has {world}")
    if devices is not None:
        devices = [torch.device(d) for d in devices]
        if len(devices) < world:
            raise ValueError(f"need {world} devices for a {dict(axes)} "
                             f"mesh, have {len(devices)}")
        device = devices[rank]
    elif torch.cuda.is_available() and dist.get_backend() == "nccl":
        device = torch.device("cuda", torch.cuda.current_device())
    else:
        device = torch.device("cpu")
    # row-major coordinates of every rank
    coords_of = []
    for r in range(world):
        c, rest = {}, r
        for name, n in zip(reversed(names), reversed(sizes)):
            c[name] = rest % n
            rest //= n
        coords_of.append({k: c[k] for k in names})
    groups = {}
    for axis in names:
        mine = None
        lines = {}
        for r, c in enumerate(coords_of):
            key = tuple(v for k, v in c.items() if k != axis)
            lines.setdefault(key, []).append(r)
        for key in sorted(lines):
            g = dist.new_group(lines[key])
            if rank in lines[key]:
                mine = g
        groups[axis] = mine
    return Mesh(shape=dict(zip(names, sizes)), coords=coords_of[rank],
                groups=groups, rank=rank, world=world, device=device,
                backend=dist.get_backend())


def make_mesh(n_devices: int = 0, devices: Optional[Sequence] = None
              ) -> Mesh:
    """1-D ("data",) mesh over the process group's ranks; ``n_devices`` (0:
    the whole world) must equal the world size.  How many cards a world may
    have is checked where its ranks start (``device_list``)."""
    n = n_devices or (dist.get_world_size() if dist.is_initialized() else 1)
    return build_mesh([(DATA_AXIS, n)], devices)


# ------------------------------------------------------------ values

def broadcast_values(values: Sequence[float], mesh: Optional[Mesh]
                     ) -> List[float]:
    """Rank 0's float values on every rank (unchanged without a mesh)."""
    if mesh is None:
        return list(values)
    t = torch.tensor(list(values), dtype=torch.float64, device=mesh.device)
    dist.broadcast(t, src=0)
    return t.cpu().tolist()


# ------------------------------------------------------------ batches

def _row_slice(x: torch.Tensor, n: int, i: int, what: str) -> torch.Tensor:
    if x.shape[0] % n != 0:
        raise ValueError(
            f"global batch {x.shape[0]} not divisible by the {n}-device "
            f"data axis ({what}); pick batch_size*expand_level divisible by "
            "the device count")
    b = x.shape[0] // n
    return x[i * b:(i + 1) * b]


def shard_batch(batch, mesh: Mesh):
    """This rank's rows of a global ``Batch``: the ``data``-axis index's
    contiguous block of every leaf (every rank of another axis gets the same
    rows)."""
    n, i = mesh.size(DATA_AXIS), mesh.index(DATA_AXIS)
    return type(batch)(
        volumes=tuple(_row_slice(v, n, i, "volumes") for v in batch.volumes),
        use_flags=tuple(_row_slice(f, n, i, "use_flags")
                        for f in batch.use_flags),
        labels=_row_slice(batch.labels, n, i, "labels"))


def shard_batch_multihost(batch, mesh: Mesh):
    """Multi-host form: every process passes its own rows (the local shard
    its host loaded), which is what this rank trains on.  Checks that every
    data rank holds as many rows, which the gathers and means assume."""
    b = batch.labels.shape[0]
    for leaf in (*batch.volumes, *batch.use_flags):
        if leaf.shape[0] != b:
            raise ValueError("the local shard's leaves differ in rows")
    sizes = gather_rows_nograd(
        torch.tensor([b], device=mesh.device), mesh.group(DATA_AXIS))
    if len(set(sizes.tolist())) != 1:
        raise ValueError(f"local shards differ in rows across the data "
                         f"ranks: {sizes.tolist()}")
    return batch


def replicate(model: torch.nn.Module, mesh: Mesh) -> torch.nn.Module:
    """Broadcast rank 0's parameters and buffers to every rank, in place
    (expert shards, which differ by rank, are left as they are)."""
    with torch.no_grad():
        for t in list(model.parameters()) + list(model.buffers()):
            if getattr(t, "expert_shard", False):
                continue
            dist.broadcast(t.data, src=0)
    return model


# ------------------------------------------------------------ train steps

def make_sharded_train_step(mcfg, tcfg, mesh: Mesh):
    """The global form: step(state, local batch) -> (state, metrics), in
    place, on this rank's rows (``shard_batch``).  The same numerics as the
    one-process step on the global batch, with the same dropout masks."""
    return make_train_step(mcfg, tcfg, mesh, global_batch=True)


def make_shardmap_train_step(mcfg, tcfg, mesh: Mesh):
    """The per-shard form (the JAX ``shard_map`` step): local L2 and MoE
    routing, the dropout key folded with the data index, the id and MoE
    terms mean-reduced over the data ranks, triplets mined over the
    gathered signatures."""
    return make_train_step(mcfg, tcfg, mesh, global_batch=False)
