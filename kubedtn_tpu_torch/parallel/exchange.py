"""Cross-shard mailbox exchange of the sharded live tick, and kernel K4.

Port of kubedtn_tpu/parallel/exchange.py. The sharded tick keeps the
edge-state structure of arrays block-sharded along the edge axis; each
tick's busy rows are spread over the shards, but every shard runs the
SAME row core over the SAME gathered rows, so that the results are bit
for bit those of the unsharded tick. The rows' state moves between
shards as a bounded per-tick MAILBOX:

- each shard packs the rows it OWNS into a `[R, Wf]` float32 payload and
  a `[R, Wi]` int32 payload whose column OWNER_COL is the ownership flag,
  and zeroes the rest;
- the mailbox travels the ring in S-1 steps, shard s -> shard s+1 mod S;
- after each step the combine is a SELECT, `where(own, incoming, acc)`:
  exactly one shard owns each row, so the owner's bits move verbatim and
  no arithmetic ever touches the payload.

One ring step is kernel K4 (`ring_right_shift`, csrc/exchange.cu), the
counterpart of the Pallas remote-DMA kernel `_right_permute_kernel`. The
two payloads travel as ONE buffer of 32-bit words per shard,
`[R, Wf + Wi]`, the float payload a view of the same words, and a step
is one launch per card (`ring_plan`): all the shards whose blocks lie on
one card copy in one kernel. For CPU tensors the wrapper runs the plain
version, the list rotation; for CUDA tensors it launches the kernel or
raises. `LAUNCHES["ring_step"]` counts launches (plain runs do not).
"""

from __future__ import annotations

import ctypes
import dataclasses

import torch

from kubedtn_tpu_torch import _build

# Column of the int payload that carries the ownership flag (1 on the
# owning shard, 0 elsewhere); the combine selects on it.
OWNER_COL = 0

# Kernel launches since the last reset_launches().
LAUNCHES = {"ring_step": 0}

# Most shards of one card that one K4 launch takes (MAX_PLAN in
# csrc/exchange.cu); a card with more makes several launches per step.
PLAN_MAX = 32

# (card, peer) pairs with peer access enabled in this process
_PEERS: set = set()


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def ring_right_shift_plain(blocks: list) -> list:
    """The plain version of a ring step: a copy of block s at position
    s+1 mod S (the list rotated right by one, into new buffers, as the
    kernel writes them)."""
    return [blocks[s - 1].clone() for s in range(len(blocks))]


def _enable_peer(src: torch.device, dst: torch.device) -> None:
    pair = (src.index, dst.index)
    if pair in _PEERS:
        return
    _build.check(_build.library("exchange").kdt_enable_peer(*pair),
                 f"kdt_enable_peer{pair}: peer access from {src} to {dst}")
    _PEERS.add(pair)


def _check_blocks(blocks: list, mesh) -> None:
    if len(blocks) != len(mesh):
        raise ValueError(f"{len(blocks)} blocks for a mesh of {len(mesh)}")
    first = blocks[0]
    for s, (b, dev) in enumerate(zip(blocks, mesh)):
        if b.device != dev or dev.type != "cuda":
            raise ValueError(f"block {s} is on {b.device}, expected the "
                             f"CUDA device {dev}")
        if b.dtype not in (torch.int32, torch.float32):
            raise ValueError(f"block {s} has dtype {b.dtype}, expected "
                             "32-bit words (int32 or float32)")
        if b.shape != first.shape or b.dtype != first.dtype:
            raise ValueError(f"block {s} is {b.dtype}{tuple(b.shape)}, "
                             f"block 0 {first.dtype}{tuple(first.shape)}")
        if not b.is_contiguous():
            raise ValueError(f"block {s} must be contiguous")


@dataclasses.dataclass(frozen=True)
class RingLaunch:
    """One K4 launch of a ring step, on `device`'s current stream: each
    shard s of `shards` (all lying on `device`) copies its block into a
    fresh buffer of shard (s + 1) mod S. `peers` are the other cards
    those buffers lie on, in order of first use: the launch's stream
    waits on each one's current stream before the launch, and each one's
    current stream waits on an event recorded after it."""

    device: torch.device
    shards: tuple
    peers: tuple


def ring_plan(mesh) -> tuple:
    """The launches of one ring step over `mesh`, a pure function of it:
    the shards grouped by the card their block lies on, cards in order of
    first appearance, at most PLAN_MAX shards per launch. Virtual shards
    of one card make one launch with no peers."""
    mesh = tuple(mesh)
    S = len(mesh)
    by_card: dict = {}
    for s, dev in enumerate(mesh):
        by_card.setdefault(dev, []).append(s)
    plan = []
    for dev, shards in by_card.items():
        for i in range(0, len(shards), PLAN_MAX):
            chunk = tuple(shards[i:i + PLAN_MAX])
            peers = tuple(dict.fromkeys(
                mesh[(s + 1) % S] for s in chunk
                if mesh[(s + 1) % S] != dev))
            plan.append(RingLaunch(dev, chunk, peers))
    return tuple(plan)


def ring_right_shift(blocks: list, mesh) -> list:
    """One mailbox ring step, K4: returns the list whose block s+1 mod S
    is a copy of blocks[s]; blocks[s] lies on mesh[s] and so does the
    result's block s. CPU blocks take the plain rotation.

    On the card every destination buffer is first allocated fresh on its
    card; then each launch of `ring_plan(mesh)` copies all the blocks of
    one card in one kernel on that card's current stream. Where a
    destination lies on another card, the copy stores over NVLink (peer
    access enabled once per pair) and is ordered both ways, as torch's
    own cross-device copy is, once per pair of cards: the writer's stream
    first waits on the receiving card's current stream, since the
    allocator may hand back a block that work queued there still reads
    or writes; the buffers are then marked used by the writer's stream,
    and the receiving card's stream waits on an event recorded after the
    launch."""
    if all(b.device.type == "cpu" for b in blocks):
        return ring_right_shift_plain(blocks)
    mesh = tuple(mesh)
    _check_blocks(blocks, mesh)
    S = len(blocks)
    n = blocks[0].numel()
    if n > 2 ** 31 - 1:
        raise ValueError(f"{n} words per block: K4 takes at most 2^31 - 1")
    plan = ring_plan(mesh)
    for launch in plan:
        for peer in launch.peers:
            _enable_peer(launch.device, peer)
    out = [torch.empty_like(blocks[s - 1], device=mesh[s]) for s in range(S)]
    # every wait before any launch, so that no card's launch waits on
    # another card's copy
    for launch in plan:
        with torch.cuda.device(launch.device):
            stream = torch.cuda.current_stream(launch.device)
            for peer in launch.peers:
                stream.wait_stream(torch.cuda.current_stream(peer))
    lib = _build.library("exchange")
    for launch in plan:
        with torch.cuda.device(launch.device):
            stream = torch.cuda.current_stream(launch.device)
            if n:
                k = len(launch.shards)
                srcs = (ctypes.c_void_p * k)(
                    *(blocks[s].data_ptr() for s in launch.shards))
                dsts = (ctypes.c_void_p * k)(
                    *(out[(s + 1) % S].data_ptr() for s in launch.shards))
                _build.check(lib.kdt_ring_step(srcs, dsts, k, n,
                                               stream.cuda_stream),
                             "ring_step")
                LAUNCHES["ring_step"] += 1
            for s in launch.shards:
                d = (s + 1) % S
                if mesh[d] != launch.device:
                    out[d].record_stream(stream)
            for peer in launch.peers:
                done = torch.cuda.Event()
                done.record(stream)
                torch.cuda.current_stream(peer).wait_event(done)
    return out


def pack_words(fmail: torch.Tensor, imail: torch.Tensor) -> torch.Tensor:
    """[R, Wf] float32 and [R, Wi] int32 payloads as one [R, Wf + Wi]
    int32 word buffer (the float bits unchanged)."""
    return torch.cat([fmail.view(torch.int32), imail], dim=1)


def unpack_words(words: torch.Tensor, wf: int):
    """(fmail float32 [R, wf], imail int32 [R, Wi]) views of a word
    buffer."""
    return words[:, :wf].view(torch.float32), words[:, wf:]


def make_ring_exchange(n_shards: int):
    """The per-tick mailbox exchange of an `n_shards` ring:
    `exch(fmails, imails) -> (fmails', imails')` over per-shard lists
    (block s on shard s's device). After the call every shard holds each
    row's owner payload: S-1 ring steps (K4), each followed by the
    select-combine `where(own, incoming, acc)` on the receiving shard."""
    def exch(fmails: list, imails: list):
        if len(fmails) != n_shards or len(imails) != n_shards:
            raise ValueError(f"expected {n_shards} mailboxes per payload")
        if n_shards <= 1:
            return list(fmails), list(imails)
        wf = fmails[0].shape[1]
        mesh = [f.device for f in fmails]
        acc = [pack_words(f, i) for f, i in zip(fmails, imails)]
        ring = acc
        for _ in range(n_shards - 1):
            ring = ring_right_shift(ring, mesh)
            acc = [torch.where(r[:, wf + OWNER_COL:wf + OWNER_COL + 1] > 0,
                               r, a) for r, a in zip(ring, acc)]
        out = [unpack_words(a, wf) for a in acc]
        return [f for f, _ in out], [i for _, i in out]

    return exch
