"""The closed loop: one request in flight, each an encode and then the
decode of the codestreams it made, over the image pool in turn.

Every request ends in a device synchronisation, so its latencies are the
device's too. The loop runs until a request ends past the window's length;
the window is then the time from the first request's start to the last
one's end, and every request in it counts. A reservoir, drawn from the
seed, keeps a uniform sample of the requests' outputs for the comparison
after the window: it copies them into buffers made at set-up, on the
outputs' own device, so that keeping one never changes what the
program's next request allocates.
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

from .system import sync


@dataclass
class Window:
    seconds: float = 0.0
    encode_s: list[float] = field(default_factory=list)
    decode_s: list[float] = field(default_factory=list)
    failed: int = 0

    @property
    def attempted(self) -> int:
        return len(self.encode_s) + self.failed


class Reservoir:
    """A uniform sample of `keep` requests (algorithm R, drawn from the
    seed), each a list of output arrays or tensors, copied flat into
    buffers sized at warm-up."""

    def __init__(self, keep: int, seed: int):
        self.keep, self.rng = keep, random.Random(seed)
        self.cap: list[int] = []
        self.slots: list[list] = []
        self.items: list[tuple] = []     # (request, image, shapes)

    def size(self, parts: list) -> None:
        sizes = [p.size if isinstance(p, np.ndarray) else p.numel()
                 for p in parts]
        self.cap = [max(a, b) for a, b in zip(self.cap, sizes)] or sizes

    def allocate(self, like: list) -> None:
        self.slots = [[np.empty(n, p.dtype) if isinstance(p, np.ndarray)
                       else torch.empty(n, dtype=p.dtype, device=p.device)
                       for p, n in zip(like, self.cap)]
                      for _ in range(self.keep)]

    def offer(self, request: int, image: int, parts: list) -> None:
        if len(self.items) < self.keep:
            j = len(self.items)
            self.items.append(None)
        else:
            j = self.rng.randrange(request + 1)
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
        self.items[j] = (request, image, [tuple(p.shape) for p in parts])

    def outputs(self) -> list[tuple]:
        """(request, image, parts) of every request kept."""
        return [(r, image, [buf[:int(np.prod(shape))].reshape(shape)
                            for buf, shape in zip(slot, shapes)])
                for (r, image, shapes), slot in zip(self.items, self.slots)]


def warm_up(entry, n_images: int, reservoir: Reservoir, device) -> int:
    """Every image of the pool twice; the reservoir's buffers fit the
    largest outputs seen. Returns the requests that failed."""
    failed, like = 0, None
    for i in range(2 * n_images):
        try:
            encoded = entry.encode(i % n_images)
            sync(device)
            like = entry.parts(encoded, entry.decode(i % n_images, encoded))
            sync(device)
        except Exception:  # counted like the window's
            if not failed:
                traceback.print_exc(file=sys.stderr)
            failed += 1
            continue
        reservoir.size(like)
    if like is not None:
        reservoir.allocate(like)
    sync(device)
    return failed


def run(entry, n_images: int, seconds: float, reservoir: Reservoir,
        device) -> Window:
    out = Window()
    clock = time.perf_counter
    with record_function("bench/window"):
        start = clock()
        deadline = start + seconds
        i = 0
        while True:
            image = i % n_images
            t0 = clock()
            try:
                with record_function("bench/encode"):
                    encoded = entry.encode(image)
                    sync(device)
                t1 = clock()
                with record_function("bench/decode"):
                    decoded = entry.decode(image, encoded)
                    sync(device)
                t2 = clock()
            except Exception:  # a request that fails is counted, not fatal
                if not out.failed:
                    traceback.print_exc(file=sys.stderr)
                out.failed += 1
                t2 = clock()
            else:
                out.encode_s.append(t1 - t0)
                out.decode_s.append(t2 - t1)
                reservoir.offer(i, image, entry.parts(encoded, decoded))
                del encoded, decoded
            i += 1
            if t2 >= deadline:
                break
        out.seconds = t2 - start
    return out
