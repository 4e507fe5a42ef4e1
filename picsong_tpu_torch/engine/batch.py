"""Frame-batched codec on torch: `BatchCodec`.

Counterpart of `picsong_tpu.engine.batch.BatchCodec`. BPC-PaCo codeblocks
are independent, so a batch of B frames is B x ncb codeblocks, frame-major
(frame f's blocks are rows [f * ncb, (f + 1) * ncb)), coded by ONE kernel
launch per component. The transforms are `TorchCodec`'s own, X2 and X4
(`transform/dwt_cuda.py`), over a leading frame axis: one launch a level
for the whole batch, and a frame of a video takes the arithmetic of the
same frame coded as an image, so its codestream has the same bytes.
"""

from __future__ import annotations

import numpy as np
import torch

from ..core import spec
from ..core.geometry import codeblock_bands
from ..core.header import CodecConfig
from ..core.lut import LUTParams
from ..entropy import bpc, bpc_cuda
from ..transform import dwt_cuda
from .pipeline import TorchCodec, meta_to_torch

_CH, _CW = spec.CBLOCK_LENGTH, spec.CBLOCK_WIDTH


class BatchCodec:
    """Encode and decode batches of B padded frames: (B, ah, aw) gray or
    (B, 3, ah, aw) planar RGB samples on the codec's device."""

    def __init__(self, cfg: CodecConfig, luts, params: LUTParams, batch: int,
                 device="cuda"):
        self.codec = TorchCodec(cfg, luts, params, device)
        self.cfg = cfg
        self.batch = batch
        self.device = self.codec.device
        self.aw, self.ah = self.codec.aw, self.codec.ah
        self.ncb = self.codec.ncb
        levels, subbands = codeblock_bands(self.aw, self.ah,
                                           cfg.wavelet_levels)
        self._meta = meta_to_torch(
            bpc._meta_args(np.tile(levels, batch), np.tile(subbands, batch),
                           params, cfg.wavelet_levels, cfg.coding_passes,
                           cfg.k_factor), self.device)

    def _bpc_args(self, component: int) -> tuple:
        luts = self.codec.luts
        return (luts[min(component, len(luts) - 1)], *self._meta)

    def prep_batch(self, frames: torch.Tensor):
        """Samples -> (per component the (B * ncb, 64, 64) int32
        codeblocks, the coefficient maximum over all of them as a 0-dim
        device tensor). Reads nothing back from the device."""
        samples = list(frames.unbind(1)) if self.cfg.is_rgb else [frames]
        blocks, top = dwt_cuda.forward(samples, self.cfg)
        return [b.reshape(-1, _CH, _CW) for b in blocks], top

    def encode_blocks(self, blocks: list[torch.Tensor], n_planes: int):
        """One BPC encode launch per component -> [(streams (B * ncb,
        4096), sizes (B * ncb,))], on the device."""
        return [bpc_cuda.encode_blocks(b, *self._bpc_args(i),
                                       **self.codec._bpc_kw,
                                       n_planes=n_planes)
                for i, b in enumerate(blocks)]

    def decode_batch(self, coded, n_planes: int) -> torch.Tensor:
        """[(streams (B * ncb, 4096), int32 sizes)] per component, on the
        device -> the decoded (B, ah, aw) or (B, 3, ah, aw) samples, one
        BPC decode launch per component."""
        blocks = [bpc_cuda.decode_blocks(
            streams, sizes, *self._bpc_args(i), **self.codec._bpc_kw,
            n_planes=n_planes).reshape(self.batch, self.ncb, _CH, _CW)
            for i, (streams, sizes) in enumerate(coded)]
        planes = dwt_cuda.reverse(blocks, self.cfg)
        return torch.stack(planes, dim=1) if self.cfg.is_rgb else planes[0]
