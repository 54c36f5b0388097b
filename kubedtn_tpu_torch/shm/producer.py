"""Real producer subprocess for bench soaks and chaos scenarios:

    python -m kubedtn_tpu_torch.shm.producer RING_PATH WIRE_ID N_FRAMES \
        [--frame-size B] [--batch K] [--pace-s S] [--namespace NS] \
        [--sample-period P] [--torn T] [--hold-s S]

Pushes N deterministic frames (frame i carries its index in the first
8 bytes — consumers audit exact delivery sets against it) through a
ShmSender, so ring-full takes the outage-buffer path, then optionally
reserves T torn slots (crash-frozen image) and holds the process alive
— the chaos scenario SIGKILLs it mid-burst or mid-hold. Progress
(frames pushed into the ring) is reported on stdout as `pushed=N`
lines; the final line is `done pushed=N`.

Port of kubedtn_tpu/shm/producer.py: the same arguments and stdout
protocol. The producer uses the ring and its sender only: it creates no
tensor and never initialises CUDA.
"""

from __future__ import annotations

import argparse
import struct
import sys
import time


_FILL_CACHE: dict = {}


def make_frame(i: int, size: int) -> bytes:
    """Deterministic payload: u64 index + a fixed fill body (cached per
    size — the index prefix is what the audits key on, and a per-frame
    fill would make the PRODUCER the soak's bottleneck)."""
    head = struct.pack("<Q", i)
    if size <= 8:
        return head[:size]
    body = _FILL_CACHE.get(size)
    if body is None:
        body = bytes((37 * j + 11) & 0xFF for j in range(size - 8))
        _FILL_CACHE[size] = body
    return head + body


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="kubedtn_tpu_torch.shm.producer")
    ap.add_argument("ring_path")
    ap.add_argument("wire_id", type=int)
    ap.add_argument("n_frames", type=int)
    ap.add_argument("--frame-size", type=int, default=256)
    ap.add_argument("--batch", type=int, default=256)
    ap.add_argument("--pace-s", type=float, default=0.0)
    ap.add_argument("--namespace", default="")
    ap.add_argument("--sample-period", type=int, default=0)
    ap.add_argument("--slots", type=int, default=8192)
    ap.add_argument("--slot-size", type=int, default=2048)
    ap.add_argument("--torn", type=int, default=0)
    ap.add_argument("--hold-s", type=float, default=0.0)
    args = ap.parse_args(argv)

    from kubedtn_tpu_torch.shm.sender import ShmSender

    sender = ShmSender(args.ring_path, slots=args.slots,
                       slot_size=args.slot_size,
                       namespace=args.namespace,
                       sample_period=args.sample_period)
    sent = 0
    while sent < args.n_frames:
        k = min(args.batch, args.n_frames - sent)
        frames = [make_frame(sent + j, args.frame_size)
                  for j in range(k)]
        sender.send(args.wire_id, frames)
        sent += k
        print(f"pushed={sender.pushed}", flush=True)
        if args.pace_s > 0:
            time.sleep(args.pace_s)
    sender.flush(timeout_s=30.0)
    if args.torn > 0:
        sender.ring.push_torn(args.torn)
        print(f"torn={args.torn}", flush=True)
    print(f"done pushed={sender.pushed}", flush=True)
    if args.hold_s > 0:
        time.sleep(args.hold_s)
    # leave the segment in place: the daemon (consumer) owns teardown
    return 0


if __name__ == "__main__":
    sys.exit(main())
