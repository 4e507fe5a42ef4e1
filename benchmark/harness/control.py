"""The control: the plain reference computed one step coarser than the
configuration states (`ReferenceCodec(control=True)`), put in the
program's place. Its answers must come out not correct; the limits of
`judge.py` sit between what the program reads and what this reads.

It codes the whole pool at set-up; each request then hands out the
answers for its frames' images, so a short window compares as many frames
as a run does. The benchmark's own runs never use it: `run.py --system
control` does.
"""

from __future__ import annotations

from benchmark.reference.codec import ReferenceCodec


class ControlEntry:
    def __init__(self, cfg, luts, params, device, padded, out_dtype):
        self.coded = ReferenceCodec(cfg, luts, params, device,
                                    control=True).run(padded, out_dtype)

    def encode(self, images: list[int]):
        return [self.coded[i].codestreams for i in images]

    def decode(self, images: list[int], codestreams):
        return [self.coded[i].decoded for i in images]

    @staticmethod
    def frames(images, codestreams, planes) -> list:
        return [(image, [*c, *p])
                for image, c, p in zip(images, codestreams, planes)]

    @staticmethod
    def to_host(parts):
        return parts[:len(parts) // 2], parts[len(parts) // 2:]
