"""File formats: PGM P5, planar RAW frames, codestreams and _SIZE sidecars.

Host NumPy, after the reference's IOManager (IO/IOManager.ipp): PGM P5
(loadImageChar :36-65, writeImage :267-344), planar RAW frames and the
mirror padding up to the codeblock-multiple size (loadFrameCAdaptedSizes
:72-112), and the codestream file with its ASCII comma-separated
"<out>_SIZE" sidecar of per-component (or per-frame) short counts
(writeCodedFrame :176-190, readBulkSizes :196-208).
"""

from __future__ import annotations

import os

import numpy as np


def sample_dtype(bps: int = 8, endianess: int = 0,
                 is_signed: bool = False) -> np.dtype:
    """The sample type of the header's bps / endianess / signed fields
    (BitStreamBuilder.cpp:70-84): bps <= 8 -> (u)int8; 9..16 -> (u)int16,
    endianess 0 little, 1 big."""
    if bps <= 8:
        return np.dtype(np.int8 if is_signed else np.uint8)
    if bps <= 16:
        return np.dtype(("<" if endianess == 0 else ">")
                        + ("i2" if is_signed else "u2"))
    raise ValueError(f"unsupported bits per sample: {bps}")


def read_pgm(path: str) -> np.ndarray:
    """A binary PGM (P5): uint8 (maxval <= 255) or uint16 (16-bit samples
    are big-endian in the file, as Netpbm specifies)."""
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(b"P5"):
        raise ValueError(f"{path}: not a P5 PGM")
    # width, height, maxval; '#' starts a comment
    tokens: list[bytes] = []
    pos = 2
    while len(tokens) < 3:
        while pos < len(data) and data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            while pos < len(data) and data[pos] != 0x0A:
                pos += 1
            continue
        start = pos
        while pos < len(data) and not data[pos:pos + 1].isspace():
            pos += 1
        tokens.append(data[start:pos])
    pos += 1  # the single whitespace after maxval
    width, height, maxval = int(tokens[0]), int(tokens[1]), int(tokens[2])
    dtype = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    pixels = np.frombuffer(data, dtype=dtype, count=width * height, offset=pos)
    out = pixels.reshape(height, width)
    return out.astype(np.uint16) if maxval > 255 else out.copy()


def write_pgm(path: str, image: np.ndarray, bit_depth: int = 8) -> None:
    """A binary PGM (P5) with maxval 2**bit_depth - 1; 16-bit samples are
    written big-endian."""
    image = np.asarray(image)
    image = image.astype(">u2") if bit_depth > 8 else image.astype(np.uint8)
    height, width = image.shape
    header = f"P5\n{width} {height}\n{(1 << bit_depth) - 1}\n".encode()
    with open(path, "wb") as f:
        f.write(header)
        f.write(image.tobytes())


def mirror_pad(plane: np.ndarray, adapted_width: int,
               adapted_height: int) -> np.ndarray:
    """Right and bottom padding by symmetric reflection, edge repeated:
    x[W + j] = x[W - 1 - j], then row[H + r] = row[H - 1 - r]
    (IOManager.ipp:95-110), NumPy's 'symmetric' mode."""
    height, width = plane.shape
    return np.pad(plane, ((0, adapted_height - height),
                          (0, adapted_width - width)), mode="symmetric")


def read_raw_frame(path: str, width: int, height: int, frame_index: int,
                   dtype=np.uint8) -> np.ndarray:
    """Plane `frame_index` of a planar RAW file, at byte offset
    frame_index * width * height * itemsize (loadFrameC,
    IOManager.ipp:118-138); the R, G, B planes of an image are planes 0-2.
    Samples come back in native byte order."""
    dtype = np.dtype(dtype)
    size = width * height * dtype.itemsize
    with open(path, "rb") as f:
        f.seek(size * frame_index)
        data = f.read(size)
    if len(data) != size:
        raise ValueError(f"{path}: frame {frame_index} truncated")
    out = np.frombuffer(data, dtype=dtype).reshape(height, width)
    return out.astype(dtype.newbyteorder("="), copy=True)


def append_raw_frame(path: str, plane: np.ndarray, dtype=np.uint8) -> None:
    """Append one plane to a planar RAW file in the sample type. The
    conversion always copies: astype(copy=False) would skip a change of
    byte order alone."""
    with open(path, "ab") as f:
        f.write(np.asarray(plane).astype(np.dtype(dtype)).tobytes())


def write_codestream(path: str, stream: np.ndarray, first: bool) -> None:
    """Append one codestream (uint16 shorts) and its short count to the
    "<path>_SIZE" sidecar; `first` starts both files anew."""
    stream = np.asarray(stream, dtype=np.uint16)
    if first:
        for p in (path, path + "_SIZE"):
            if os.path.exists(p):
                os.remove(p)
    with open(path, "ab") as f:
        f.write(stream.tobytes())
    with open(path + "_SIZE", "a") as f:
        f.write(("%d" if first else ",%d") % stream.size)


def read_sizes(path: str) -> list[int]:
    """The _SIZE sidecar's short counts (readBulkSizes,
    IOManager.ipp:196-208)."""
    with open(path + "_SIZE", "r") as f:
        return [int(tok) for tok in f.read().split(",") if tok.strip()]


def read_codestream(path: str, offset_shorts: int, n_shorts: int) -> np.ndarray:
    """One codestream as uint16 shorts, at a short offset."""
    with open(path, "rb") as f:
        f.seek(offset_shorts * 2)
        data = f.read(n_shorts * 2)
    return np.frombuffer(data, dtype=np.uint16).copy()


def read_header_shorts(path: str, count: int = 9) -> np.ndarray:
    """The leading header shorts (loadBasicInfo, IOManager.ipp:21-32)."""
    with open(path, "rb") as f:
        data = f.read(count * 2)
    return np.frombuffer(data, dtype=np.uint16).copy()
