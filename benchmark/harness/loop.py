"""The closed loop: one request in flight, each an encode and then the
decode of the codestreams it made, over the image pool in turn. A request
codes the mix's `frames_per_request` pool images (one when the mix does
not say; `images.of_request`).

Every request ends in a device synchronisation, so its latencies are the
device's too. The loop runs until a request ends past the window's length;
the window is then the time from the first request's start to the last
one's end, and every request in it counts. A reservoir, drawn from the
seed, keeps a uniform sample of the frames the window coded, over every
frame of every request, for the comparison after the window: it copies
each kept frame's outputs into buffers made at set-up, on the outputs' own
device, so that keeping one never changes what the program's next request
allocates, and the check holds `keep` frames whatever a request codes.

An entry hands a request's outputs over frame by frame, each with the pool
image it coded (`frames`), or, when it codes one frame a request, as one
list (`parts`). A request whose frames are not its images fails.
"""

from __future__ import annotations

import random
import sys
import time
import traceback
from dataclasses import dataclass, field

import numpy as np
import torch
from torch.profiler import record_function

from .images import of_request
from .system import sync


@dataclass
class Window:
    seconds: float = 0.0
    encode_s: list[float] = field(default_factory=list)
    decode_s: list[float] = field(default_factory=list)
    frames: int = 0          # frames coded by the requests completed
    failed: int = 0

    @property
    def attempted(self) -> int:
        return len(self.encode_s) + self.failed


class Reservoir:
    """A uniform sample of `keep` frames (algorithm R over the frames'
    positions, request * frames + j, drawn from the seed), each a list of
    output arrays or tensors, copied flat into buffers sized at warm-up.
    With one frame a request the position is the request's index."""

    def __init__(self, keep: int, seed: int):
        self.keep, self.rng = keep, random.Random(seed)
        self.cap: list[int] = []
        self.slots: list[list] = []
        self.items: list[tuple] = []     # (position, request, image, shapes)

    def size(self, parts: list) -> None:
        sizes = [p.size if isinstance(p, np.ndarray) else p.numel()
                 for p in parts]
        self.cap = [max(a, b) for a, b in zip(self.cap, sizes)] or sizes

    def allocate(self, like: list) -> None:
        self.slots = [[np.empty(n, p.dtype) if isinstance(p, np.ndarray)
                       else torch.empty(n, dtype=p.dtype, device=p.device)
                       for p, n in zip(like, self.cap)]
                      for _ in range(self.keep)]

    def offer(self, position: int, request: int, image: int,
              parts: list) -> None:
        if len(self.items) < self.keep:
            j = len(self.items)
            self.items.append(None)
        else:
            j = self.rng.randrange(position + 1)
            if j >= self.keep:
                return
        while len(self.slots) <= j:
            self.slots.append([])
        slot = self.slots[j]
        for k, p in enumerate(parts):
            flat = p.reshape(-1)
            if k < len(slot) and len(flat) <= len(slot[k]):
                slot[k][:len(flat)] = flat
                continue
            # larger than any warm-up's output
            copy = flat.copy() if isinstance(p, np.ndarray) else flat.clone()
            if k < len(slot):
                slot[k] = copy
            else:
                slot.append(copy)
        self.items[j] = (position, request, image,
                         [tuple(p.shape) for p in parts])

    def outputs(self) -> list[tuple]:
        """(request, image, parts) of every frame kept."""
        return [(r, image, [buf[:int(np.prod(shape))].reshape(shape)
                            for buf, shape in zip(slot, shapes)])
                for (_, r, image, shapes), slot in zip(self.items,
                                                       self.slots)]


def frames_of(entry, images: list[int], encoded, decoded) -> list[tuple]:
    """A request's outputs a frame: (pool image, parts), in the order of
    `images`; an entry without `frames` codes one frame a request."""
    if hasattr(entry, "frames"):
        out = entry.frames(images, encoded, decoded)
    else:
        (image,) = images
        out = [(image, entry.parts(encoded, decoded))]
    if [image for image, _ in out] != images:
        raise ValueError(f"a request of pool images {images} handed back "
                         f"frames of {[image for image, _ in out]}")
    return out


def warm_up(entry, n_images: int, frames: int, reservoir: Reservoir,
            device) -> int:
    """Requests until every image of the pool is coded twice; the
    reservoir's buffers fit the largest frame's outputs seen. Returns the
    requests that failed."""
    failed, like = 0, None
    for i in range(-(-2 * n_images // frames)):
        images = of_request(i, frames, n_images)
        try:
            encoded = entry.encode(images)
            sync(device)
            got = frames_of(entry, images, encoded,
                            entry.decode(images, encoded))
            sync(device)
        except Exception:  # counted like the window's
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
            continue
        for _, like in got:
            reservoir.size(like)
    if like is not None:
        reservoir.allocate(like)
    sync(device)
    return failed


def run(entry, n_images: int, frames: int, seconds: float,
        reservoir: Reservoir, device) -> Window:
    out = Window()
    clock = time.perf_counter
    with record_function("bench/window"):
        start = clock()
        deadline = start + seconds
        i = 0
        while True:
            images = of_request(i, frames, n_images)
            t0 = clock()
            try:
                with record_function("bench/encode"):
                    encoded = entry.encode(images)
                    sync(device)
                t1 = clock()
                with record_function("bench/decode"):
                    decoded = entry.decode(images, encoded)
                    sync(device)
                t2 = clock()
                got = frames_of(entry, images, encoded, decoded)
            except Exception:  # a request that fails is counted, not fatal
                if not out.failed:
                    traceback.print_exc(file=sys.stderr)
                out.failed += 1
                t2 = clock()
            else:
                out.encode_s.append(t1 - t0)
                out.decode_s.append(t2 - t1)
                out.frames += len(got)
                for j, (image, parts) in enumerate(got):
                    reservoir.offer(i * frames + j, i, image, parts)
                del encoded, decoded, got
            i += 1
            if t2 >= deadline:
                break
        out.seconds = t2 - start
    return out
