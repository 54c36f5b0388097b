"""Device meshes of the sharded live tick.

A mesh is an ordered tuple of torch.devices along one axis, the edge
axis: shard s of the edge-state structure of arrays lives on mesh[s].
The same card may appear more than once: those are VIRTUAL SHARDS, each
its own block of the state on one card, running the very same sharded
program (its ring steps then copy within the card). They are the
counterpart of the JAX tests' 8-device CPU mesh under
--xla_force_host_platform_device_count, and what lets one H100 run the
sharded tick at all.

The what-if twin's replica axis has a mesh of its own
(`make_replica_mesh`): replicas of the whole edge state are
embarrassingly parallel, so `replica_sharding` splits the lanes into one
contiguous block per mesh entry, each block runs on its device with no
communication, and the sweep joins the blocks' results on the host.

A mesh may span OS processes (`MultihostMesh`, the counterpart of the JAX
package's `init_distributed` / `make_multihost_mesh`): every process joins
one torch.distributed group (`init_distributed`), and
`make_multihost_mesh` exchanges each process's shard list once, so every
rank holds the same host-major layout (rank 0's shards first). A process
holds, passes and gets back only its own shards (`local_shards`); what
crosses processes rides two collectives, `gather_shards` (the node
counters' psum) and `all_to_all_shards` (the router's all_to_all). On a
one-process mesh (a tuple of devices) both are local.
"""

from __future__ import annotations

import dataclasses
import datetime
import socket

import torch
import torch.distributed as dist

from kubedtn_tpu_torch.ops.edge_state import EdgeState
from kubedtn_tpu_torch.parallel.partition import shard_ranges

EDGE_AXIS = "edge"
# the what-if twin's scaling axis (kubedtn_tpu_torch.twin.engine)
REPLICA_AXIS = "replica"


def _normalise(d) -> torch.device:
    d = torch.device(d)
    if d.type == "cuda" and d.index is None:
        return torch.device("cuda", torch.cuda.current_device())
    return d


def make_mesh(devices) -> tuple:
    """A 1-D mesh over `devices` (a list of torch.devices or names, in
    shard order; repeats make virtual shards). A CUDA device without an
    index means the current card."""
    mesh = tuple(_normalise(d) for d in devices)
    if not mesh:
        raise ValueError("a mesh needs at least one device")
    return mesh


def shard_edge_state(state: EdgeState, mesh) -> list[EdgeState]:
    """Split every EdgeState field into len(mesh) contiguous blocks along
    the edge axis, block s on shard s's device: a list of per-shard
    EdgeStates of capacity / len(mesh) rows each (new tensors), one for
    each shard this process holds (`local_shards`)."""
    ranges = shard_ranges(state.capacity, len(mesh))
    return [EdgeState(**{
        f.name: getattr(state, f.name)[ranges[s][0]:ranges[s][1]].to(
            dev, copy=True)
        for f in dataclasses.fields(EdgeState)})
        for s, dev in local_shards(mesh)]


def make_replica_mesh(n_devices: int | None = None,
                      devices=None) -> tuple:
    """A 1-D mesh over the what-if REPLICA axis: `devices` (default: every
    visible CUDA card), the first `n_devices` of them when given. With
    one card every lane stays on it."""
    if devices is None:
        devices = [torch.device("cuda", i)
                   for i in range(torch.cuda.device_count())]
    if n_devices is not None:
        devices = list(devices)[:n_devices]
    return make_mesh(devices)


def replica_sharding(mesh, n_replicas: int) -> list[tuple]:
    """(device, lo, hi) per mesh entry: lanes [lo, hi) of a sweep of
    `n_replicas` run on `device`. `n_replicas` must be a multiple of the
    mesh size (twin.spec pads with unperturbed replicas)."""
    size = len(mesh)
    if n_replicas % size:
        raise ValueError(f"{n_replicas} replicas do not split evenly over "
                         f"a mesh of {size}")
    per = n_replicas // size
    return [(dev, i * per, (i + 1) * per) for i, dev in enumerate(mesh)]


# -- meshes across processes -----------------------------------------

RENDEZVOUS_TIMEOUT_S = 120.0
STAGED = "pinned-host"   # MultihostMesh.staging where gloo carries cards


@dataclasses.dataclass(frozen=True)
class MeshEntry:
    """One shard of a multi-process mesh: the rank that holds it, its
    device as that rank names it, and, for a card, the card's identity
    across processes (host name and UUID; None on the CPU)."""

    rank: int
    device: str
    card: str | None


@dataclasses.dataclass(frozen=True, eq=False)
class MultihostMesh:
    """A 1-D edge mesh over every process's shards, host-major: entry s
    is shard s of the edge axis, rank 0's shards first. Every rank holds
    the same entries; `rank` is this process's. `backend` is the
    transport of the mesh's collectives (`choose_backend`), `group` its
    process group (None: the default group). Where gloo carries this
    process's card tensors, `staging` is STAGED: each collective copies
    them through pinned host memory (gloo's own CUDA paths are not
    used)."""

    entries: tuple
    rank: int
    world_size: int
    backend: str
    staging: str | None = None
    group: object = None

    def __len__(self) -> int:
        return len(self.entries)

    @property
    def per_rank(self) -> int:
        return len(self.entries) // self.world_size

    @property
    def home(self) -> torch.device:
        """This process's first shard's device: where it sums the
        cross-shard counters and draws a step's uniforms."""
        return local_shards(self)[0][1]


def choose_backend(entries) -> str:
    """The transport a layout takes, decided once from the layout alone:
    "nccl" when every entry is a card that no other rank uses, "gloo"
    otherwise (on the CPU, and for ranks that share a card)."""
    ranks_of: dict = {}
    for e in entries:
        if e.card is None:
            return "gloo"
        ranks_of.setdefault(e.card, set()).add(e.rank)
    return "nccl" if all(len(r) == 1 for r in ranks_of.values()) else "gloo"


def host_major(per_rank) -> tuple:
    """The mesh entries of the layouts the ranks sent: per_rank[r] is rank
    r's list of (device, card) in its shard order. Rank 0's shards come
    first, then rank 1's, and so on; every rank must hold the same number
    of shards (the all-to-all's equal splits)."""
    counts = {len(x) for x in per_rank}
    if len(counts) != 1 or 0 in counts:
        raise ValueError(f"every process must contribute the same number "
                         f"of shards, got {[len(x) for x in per_rank]}")
    return tuple(MeshEntry(rank=r, device=dev, card=card)
                 for r, layout in enumerate(per_rank)
                 for dev, card in layout)


def as_mesh(mesh):
    """A MultihostMesh as it is, any other mesh as a tuple of devices."""
    return mesh if isinstance(mesh, MultihostMesh) else tuple(mesh)


def local_shards(mesh) -> list[tuple[int, torch.device]]:
    """(global shard index, device) of every shard this process holds: all
    of a one-process mesh, this rank's entries of a MultihostMesh."""
    if isinstance(mesh, MultihostMesh):
        return [(s, torch.device(e.device))
                for s, e in enumerate(mesh.entries) if e.rank == mesh.rank]
    return list(enumerate(mesh))


def check_local(mesh, n: int, what: str) -> None:
    """Raise unless `n` blocks of `what` are one per shard this process
    holds."""
    want = len(local_shards(mesh))
    if n == want:
        return
    if isinstance(mesh, MultihostMesh):
        raise ValueError(f"{n} {what} for the {want} shards process "
                         f"{mesh.rank} holds of a mesh of {len(mesh)}")
    raise ValueError(f"{n} {what} for a mesh of {len(mesh)}")


def edge_sharding(mesh, capacity: int) -> list[tuple]:
    """(entry, lo, hi) per shard of the edge axis: rows [lo, hi) of a
    `capacity`-row array are shard s's, held by mesh entry s (a device,
    or a MeshEntry of a multi-process mesh)."""
    entries = mesh.entries if isinstance(mesh, MultihostMesh) else mesh
    return [(e, lo, hi)
            for e, (lo, hi) in zip(entries, shard_ranges(capacity,
                                                          len(mesh)))]


def replicated(mesh) -> tuple:
    """The distinct devices of this process that hold the replicated
    leaves (one copy each, shared by its shards on that device)."""
    return tuple(dict.fromkeys(d for _, d in local_shards(mesh)))


def _card_id(dev: torch.device) -> str | None:
    if dev.type != "cuda":
        return None
    return f"{socket.gethostname()}/{torch.cuda.get_device_properties(dev).uuid}"


def init_distributed(coordinator_address: str | None = None,
                     num_processes: int | None = None,
                     process_id: int | None = None, *,
                     timeout_s: float = RENDEZVOUS_TIMEOUT_S) -> None:
    """Join a multi-process run: the counterpart of the JAX package's
    jax.distributed.initialize, after which make_multihost_mesh spans
    every process.

    Joins a torch.distributed default process group over gloo (it
    carries the layout exchange, and the mesh's collectives unless the
    layout picks NCCL). `coordinator_address` "host:port" meets at
    tcp://host:port (process 0 serves it), a URL ("tcp://...",
    "file://...") is taken as given, and None meets at env:// (MASTER_ADDR
    and MASTER_PORT, WORLD_SIZE and RANK unless `num_processes` and
    `process_id` are given). The rendezvous waits at most `timeout_s`.
    A no-op when a default group is already up, the one failure JAX
    tolerates; any connect or configuration failure raises, so a run
    never goes on as a silent single process."""
    if dist.is_initialized():
        return
    if not (dist.is_available() and dist.is_gloo_available()):
        raise RuntimeError("torch.distributed with gloo is not available")
    if coordinator_address is None:
        url = "env://"
    elif "://" in coordinator_address:
        url = coordinator_address
    else:
        url = f"tcp://{coordinator_address}"
    if url != "env://" and (num_processes is None or process_id is None):
        raise ValueError(f"a rendezvous at {url} needs num_processes and "
                         f"process_id")
    dist.init_process_group(
        "gloo", init_method=url,
        world_size=-1 if num_processes is None else num_processes,
        rank=-1 if process_id is None else process_id,
        timeout=datetime.timedelta(seconds=timeout_s))


def make_multihost_mesh(devices=None) -> MultihostMesh:
    """1-D edge mesh over EVERY process's shards, host-major.

    `devices` are this process's shards in order (torch.devices or
    names; a repeated device makes virtual shards, as in make_mesh; on
    one card, or on the CPU, a process contributes its own virtual
    shards of one device); default every visible card once. The layout
    is exchanged once over the default group, so every rank builds the
    same mesh; then the transport is chosen from it (`choose_backend`)
    before any collective of the mesh, and an NCCL mesh gets a group of
    its own. A collective: every process calls it, after
    init_distributed."""
    if not dist.is_initialized():
        raise RuntimeError("make_multihost_mesh needs init_distributed "
                           "first")
    if devices is None:
        n = torch.cuda.device_count()
        if n == 0:
            raise ValueError("no CUDA card: pass this process's devices "
                             "(e.g. ['cpu', 'cpu'])")
        devices = [torch.device("cuda", i) for i in range(n)]
    local = make_mesh(devices)
    per_rank = [None] * dist.get_world_size()
    dist.all_gather_object(per_rank, [(str(d), _card_id(d)) for d in local])
    entries = host_major(per_rank)
    backend = choose_backend(entries)
    group = None
    if backend == "nccl":
        torch.cuda.set_device(local[0])
        group = dist.new_group(backend="nccl")
    cards_here = any(d.type == "cuda" for d in local)
    return MultihostMesh(
        entries=entries, rank=dist.get_rank(),
        world_size=dist.get_world_size(), backend=backend,
        staging=STAGED if backend == "gloo" and cards_here else None,
        group=group)


def _to_wire(mesh: MultihostMesh, x: torch.Tensor) -> torch.Tensor:
    """x as the mesh's backend carries it: a pinned host copy where gloo
    carries this process's card tensors."""
    if mesh.staging is None:
        return x.contiguous()
    buf = torch.empty(x.shape, dtype=x.dtype, pin_memory=True)
    buf.copy_(x)
    return buf


def gather_shards(mesh, xs) -> list:
    """Every shard's tensor in global shard order, from `xs`, one tensor
    of one shape and dtype per shard this process holds. On a one-process
    mesh that is `xs`; across processes one all_gather, after which every
    rank holds the same list, on its home device (a collective: every
    rank calls it)."""
    if not isinstance(mesh, MultihostMesh):
        return list(xs)
    check_local(mesh, len(xs), "tensors")
    home = mesh.home
    wire = _to_wire(mesh, torch.stack([x.to(home) for x in xs]))
    blocks = [torch.empty_like(wire) for _ in range(mesh.world_size)]
    dist.all_gather(blocks, wire, group=mesh.group)
    # host-major: rank q's block holds shards q * per_rank ... in order
    return [b.to(home) for blk in blocks for b in blk.unbind(0)]


def all_to_all_shards(mesh: MultihostMesh, sends) -> list:
    """The all-to-all of a multi-process mesh: sends[j] is [S, ...], the
    block of this process's j-th shard bound for each shard d; returns
    recv[j], [S, ...], the blocks bound for it from every shard s, in
    global shard order (not arrival order), on its device. One
    all_to_all_single with equal splits, since every rank holds
    per_rank shards (a collective: every rank calls it)."""
    local = local_shards(mesh)
    check_local(mesh, len(sends), "send buffers")
    n, S, home = mesh.per_rank, len(mesh), mesh.home
    blk = tuple(sends[0].shape[1:])
    # [S destinations, n sources, ...]: rank q's destinations are rows
    # [q n, (q + 1) n), the chunk all_to_all_single sends to rank q
    x = torch.stack([t.to(home) for t in sends]).transpose(0, 1)
    wire = _to_wire(mesh, x.contiguous())
    out = torch.empty_like(wire)
    dist.all_to_all_single(out, wire, group=mesh.group)
    # chunk q of the output came from rank q: [n dest, n src, ...]
    out = out.to(home).view(mesh.world_size, n, n, *blk)
    return [out[:, j].reshape(S, *blk).to(dev)
            for j, (_, dev) in enumerate(local)]
