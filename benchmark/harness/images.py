"""The benchmark's input images, made from the seed on the run's device.

The pattern of the port's test images, in integer arithmetic: base +
amplitude * tri(x + dx) * tri(y + dy) / (px * py), with triangle waves of
periods px and py in [-p, p], plus uniform noise in [-noise, noise], clipped
to the sample range. A traffic mix sets base, amplitude, periods and
noise. Each plane of the pool has shifts (dx, dy) of its own, the same for
every seed, since the shifts move the coding work; the seed draws the
noise, by one `torch.Generator` on the device in one call a plane, and the
order of the pool's images. So every seed gives the same work in another
order. A request codes one image of the pool, or a mix's
`frames_per_request` of them in turn (`of_request`).
"""

from __future__ import annotations

import torch


def _tri(t: torch.Tensor, period: int) -> torch.Tensor:
    """A triangle wave in [-period, period]."""
    return ((t % period) * 4 - 2 * period).abs() - period


def pool_size(plane_bytes: int, planes: int, pool: dict) -> int:
    """Images in the pool: at least `min_images`, and enough that their
    samples hold at least `min_bytes` (more than the card's L2 cache)."""
    per_image = plane_bytes * planes
    return max(pool["min_images"], -(-pool["min_bytes"] // per_image))


def of_request(request: int, frames: int, n_images: int) -> list[int]:
    """The pool images request `request` codes, its frames in order: a
    mix's `frames_per_request` of them, (request * frames + j) mod the
    pool, so the requests walk the pool frame by frame."""
    return [(request * frames + j) % n_images for j in range(frames)]


def make_pool(seed: int, n_images: int, planes: int, height: int, width: int,
              peak: int, content: dict, device) -> list[list[torch.Tensor]]:
    """`n_images` images of `planes` (height, width) planes, uint8 for a
    peak of 255 or less, else int16 holding the unsigned values."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed % (1 << 63))
    px, py = content["periods"]
    base, amp, noise = content["base"], content["amplitude"], content["noise"]
    dtype = torch.uint8 if peak <= 255 else torch.int16
    x = torch.arange(width, dtype=torch.int64, device=device)
    y = torch.arange(height, dtype=torch.int64, device=device)
    out = []
    for i in torch.randperm(n_images, generator=gen, device=device).tolist():
        image = []
        for c in range(planes):
            k = i * planes + c
            dx, dy = 37 * k % px, 53 * k % py
            tx, ty = _tri(x + dx, px), _tri(y + dy, py)
            plane = torch.randint(-noise, noise + 1, (height, width),
                                  generator=gen, device=device,
                                  dtype=torch.int64)
            plane += (base * px * py + amp * ty[:, None] * tx[None, :]) \
                // (px * py)
            image.append(plane.clamp_(0, peak).to(dtype))
        out.append(image)
    return out
