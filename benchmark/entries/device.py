"""The `device` entry: padded sample planes already on the card in,
codestreams left on the card, and back. A frame of the request at a time,
`TorchCodec.encode_planes`, then `assembly.pack.pack_streams` a component
(the header on the first); back through `assembly.pack.unpack_streams` a
component and `TorchCodec.decode_planes`, the samples left on the card.
Each frame's decode takes the bitplane count its encode returned. The
benchmark's `bench/...` labels name the host's activity in a trace."""

import numpy as np
from torch.profiler import record_function

from benchmark.harness.system import HEADER_SHORTS, codec
from picsong_tpu_torch.assembly import pack


class Entry:
    def __init__(self, config, luts, params, device, inputs):
        self.codec = codec(config, luts, params, device)
        self.pool = inputs.padded
        self.header = inputs.header
        self.height, self.width = config["height"], config["width"]

    def encode(self, images: list[int]):
        out = []
        for index in images:
            with record_function("bench/encode_planes"):
                coded, n_planes = self.codec.encode_planes(self.pool[index])
            with record_function("bench/pack"):
                packed = [pack.pack_streams(streams, sizes,
                                            self.header if c == 0 else None)
                          for c, (streams, sizes) in enumerate(coded)]
            out.append((packed, n_planes))
        return out

    def decode(self, images: list[int], encoded):
        ncb = self.codec.ncb
        out = []
        for packed, n_planes in encoded:
            with record_function("bench/unpack"):
                coded = []
                for code in packed:
                    payload = code.numel() - HEADER_SHORTS - 2 * ncb - 1
                    streams, sizes = pack.unpack_streams(code, ncb, payload)
                    coded.append((streams, sizes, n_planes))
            with record_function("bench/decode_planes"):
                out.append(self.codec.decode_planes(coded))
        return out

    @staticmethod
    def frames(images, encoded, decoded) -> list:
        return [(image, [*packed, *planes]) for image, (packed, _), planes
                in zip(images, encoded, decoded)]

    def to_host(self, parts):
        nc = len(parts) // 2
        return ([c.cpu().numpy().view(np.uint16) for c in parts[:nc]],
                [p[:self.height, :self.width].cpu().numpy()
                 for p in parts[nc:]])
