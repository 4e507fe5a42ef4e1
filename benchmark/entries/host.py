"""The `host` entry: images in host memory in, codestreams in host memory
out, and back, through `TorchCodec.encode` (sample planes as NumPy -> one
packed uint16 codestream a component, the header on the first) and
`TorchCodec.decode` (the codestreams -> the samples as NumPy), the codec
built once. One frame a request."""

from benchmark.harness.system import codec


class Entry:
    def __init__(self, config, luts, params, device, inputs):
        self.codec = codec(config, luts, params, device)
        self.rgb = config["is_rgb"]
        self.pool = [[p.cpu().numpy() for p in image]
                     for image in inputs.pool]

    def encode(self, images: list[int]):
        (index,) = images
        image = self.pool[index]
        return self.codec.encode(image if self.rgb else image[0])

    def decode(self, images: list[int], codestreams):
        planes = self.codec.decode(codestreams)
        return planes if self.rgb else [planes]

    @staticmethod
    def parts(codestreams, planes) -> list:
        """A request's outputs as one list: the codestreams, the planes."""
        return [*codestreams, *planes]

    def to_host(self, parts):
        """`parts` -> (codestreams, planes) as NumPy arrays."""
        nc = 3 if self.rgb else 1
        return parts[:nc], parts[nc:]
