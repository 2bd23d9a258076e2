"""Image assembly, tone mapping, PNG/EXR/PPM output and the EXR reader.

Counterpart of :mod:`spira_tpu.io.image`.  Assembly and tone mapping are
tensor ops on the render's device; file encoding and decoding are host-side
numpy (PIL is used for PNG when it is installed).  :func:`load_exr` returns
a NumPy array, as the JAX package's does.
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch

from ..utils.profiling import annotate


# ----------------------------------------------------------------------------
# Assembly
# ----------------------------------------------------------------------------

def assemble_image(flat_radiance, width: int, height: int):
    """(H*W, 3) bottom-up buffer → (H, W, 3) top-down image (y-flip)."""
    return torch.flip(flat_radiance.reshape(height, width, 3), dims=(0,))


# ----------------------------------------------------------------------------
# Tone mapping
# ----------------------------------------------------------------------------

def tonemap_gamma(hdr):
    """clamp to [0,1] then sqrt gamma."""
    return torch.sqrt(torch.clamp(hdr, 0.0, 1.0))


def aces_fit(x):
    """ACES filmic fit (constants a..e of the reference)."""
    a, b, c, d, e = 2.51, 0.03, 2.43, 0.59, 0.14
    return torch.clamp((x * (a * x + b)) / (x * (c * x + d) + e), 0.0, 1.0)


def tonemap_aces(hdr):
    """ACES fit then sqrt gamma."""
    return torch.sqrt(aces_fit(hdr))


TONEMAPS = {"gamma": tonemap_gamma, "aces": tonemap_aces, "none": lambda x: x}


def _numpy(x) -> np.ndarray:
    if torch.is_tensor(x):
        with annotate("spira.image.to_host"):
            return x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(ldr) -> np.ndarray:
    """[0, 1] image (tensor or array) → host uint8 array."""
    # one expression, so that the host copy is freed once it is scaled: a
    # copy held by a name keeps a third frame-sized buffer live, which
    # made this a fifth slower on an H100 machine's host (PERF.md)
    with annotate("spira.image.quantize"):
        return np.asarray(
            np.clip(_numpy(ldr) * 255.0 + 0.5, 0.0, 255.0), dtype=np.uint8
        )


# ----------------------------------------------------------------------------
# PNG (pure-Python fallback; PIL when available)
# ----------------------------------------------------------------------------

def save_png(path: str, image_uint8: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 array as PNG."""
    image_uint8 = np.ascontiguousarray(image_uint8)
    try:
        from PIL import Image
    except ImportError:
        _save_png_pure(path, image_uint8)
        return
    Image.fromarray(image_uint8, mode="RGB").save(path)


def load_png(path: str) -> np.ndarray:
    """An 8-bit RGB PNG as an (H, W, 3) uint8 array: through PIL when it
    is installed (:func:`save_png` writes with it then), else the
    unfiltered rows :func:`save_png` writes without it."""
    try:
        from PIL import Image
    except ImportError:
        with open(path, "rb") as f:
            data = f.read()
        pos, idat, size = 8, b"", None
        while pos < len(data):
            n, tag = struct.unpack(">I4s", data[pos:pos + 8])
            body = data[pos + 8:pos + 8 + n]
            if tag == b"IHDR":
                size = struct.unpack(">II", body[:8])
            elif tag == b"IDAT":
                idat += body
            pos += 12 + n
        w, h = size
        rows = np.frombuffer(zlib.decompress(idat), np.uint8).reshape(
            h, 1 + 3 * w)
        if rows[:, 0].any():
            raise ValueError(f"{path}: filtered rows (no PIL to read them)")
        return rows[:, 1:].reshape(h, w, 3).copy()
    with Image.open(path) as img:
        return np.asarray(img.convert("RGB"))


def _save_png_pure(path: str, img: np.ndarray) -> None:
    h, w, _ = img.shape

    def chunk(tag: bytes, data: bytes) -> bytes:
        return (
            struct.pack(">I", len(data))
            + tag
            + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF)
        )

    raw = b"".join(b"\x00" + img[row].tobytes() for row in range(h))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(raw, 6)))
        f.write(chunk(b"IEND", b""))


# ----------------------------------------------------------------------------
# EXR (minimal OpenEXR 2.0 writer: scanline, uncompressed, float32 RGB; a
# scanline reader for NONE/RLE/ZIPS/ZIP files)
# ----------------------------------------------------------------------------

def save_exr(path: str, hdr) -> None:
    """Write an (H, W, 3) float32 HDR image (tensor or array) as an
    uncompressed EXR."""
    hdr = np.asarray(_numpy(hdr), np.float32)
    h, w, _ = hdr.shape

    def attr(name: bytes, typ: bytes, data: bytes) -> bytes:
        return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data

    def channel(name: bytes) -> bytes:
        # name, pixel_type=2 (FLOAT), pLinear=0 + 3 reserved, xSampling, ySampling
        return name + b"\x00" + struct.pack("<iBBBBii", 2, 0, 0, 0, 0, 1, 1)

    channels = channel(b"B") + channel(b"G") + channel(b"R") + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join(
        [
            attr(b"channels", b"chlist", channels),
            attr(b"compression", b"compression", b"\x00"),  # NO_COMPRESSION
            attr(b"dataWindow", b"box2i", box),
            attr(b"displayWindow", b"box2i", box),
            attr(b"lineOrder", b"lineOrder", b"\x00"),  # INCREASING_Y
            attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
            attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0.0, 0.0)),
            attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
            b"\x00",
        ]
    )
    magic = struct.pack("<I", 20000630) + struct.pack("<I", 2)
    offset_table_pos = len(magic) + len(header)
    scanline_bytes = 8 + 3 * 4 * w  # y + size prefix + BGR float rows
    first_scanline = offset_table_pos + 8 * h
    offsets = [
        struct.pack("<Q", first_scanline + y * scanline_bytes) for y in range(h)
    ]
    with open(path, "wb") as f:
        f.write(magic)
        f.write(header)
        f.write(b"".join(offsets))
        for y in range(h):
            row = hdr[y]
            f.write(struct.pack("<ii", y, 3 * 4 * w))
            # channels are stored alphabetically: B, G, R
            f.write(np.ascontiguousarray(row[:, 2]).tobytes())
            f.write(np.ascontiguousarray(row[:, 1]).tobytes())
            f.write(np.ascontiguousarray(row[:, 0]).tobytes())


def _exr_predictor_interleave(raw: bytes) -> np.ndarray:
    """OpenEXR ZIP/RLE post-pass: delta-decode then de-interleave halves."""
    arr = np.frombuffer(raw, np.uint8).astype(np.int64)
    if arr.size:
        arr[1:] -= 128
    arr = (np.cumsum(arr) % 256).astype(np.uint8)
    out = np.empty_like(arr)
    half = (arr.size + 1) // 2
    out[0::2] = arr[:half]
    out[1::2] = arr[half:]
    return out


def _exr_rle_decode(raw: bytes) -> bytes:
    """OpenEXR RLE: a signed count byte ``c``, then ``-c`` literal bytes
    (``c < 0``) or one byte repeated ``c + 1`` times."""
    out = bytearray()
    i = 0
    n = len(raw)
    while i < n:
        count = struct.unpack_from("<b", raw, i)[0]
        i += 1
        if count < 0:
            out += raw[i : i - count]
            i -= count
        else:
            out += raw[i : i + 1] * (count + 1)
            i += 1
    return bytes(out)


_EXR_PIXEL_DTYPES = {0: np.uint32, 1: np.float16, 2: np.float32}
#: scanlines per chunk by compression id
_EXR_BLOCK_LINES = {0: 1, 1: 1, 2: 1, 3: 16}


def load_exr(path: str) -> np.ndarray:
    """Read a scanline EXR into an (H, W, 3) float32 RGB array.

    Handles externally produced files, not just :func:`save_exr`'s output:
    HALF/FLOAT/UINT channels, NONE/RLE/ZIPS/ZIP compression, any channel
    set containing R, G, B (extras such as A are ignored), and both line
    orders.  Tiled images and PIZ/B44/DWA compression raise ``ValueError``.
    """
    with open(path, "rb") as f:
        data = f.read()
    if struct.unpack("<I", data[:4])[0] != 20000630:
        raise ValueError(f"{path}: not an EXR file")
    version = struct.unpack("<I", data[4:8])[0]
    if version & 0x200:
        raise ValueError(f"{path}: tiled EXR images are not supported")
    pos = 8
    width = height = y0 = None
    compression = 0
    line_order = 0
    channels = []  # (name, dtype) in file (alphabetical) order
    while data[pos] != 0:
        name_end = data.index(b"\x00", pos)
        name = data[pos:name_end]
        pos = name_end + 1
        typ_end = data.index(b"\x00", pos)
        pos = typ_end + 1
        (size,) = struct.unpack_from("<I", data, pos)
        pos += 4
        if name == b"dataWindow":
            x0, y0, x1, y1 = struct.unpack_from("<iiii", data, pos)
            width, height = x1 - x0 + 1, y1 - y0 + 1
        elif name == b"compression":
            compression = data[pos]
        elif name == b"lineOrder":
            line_order = data[pos]
        elif name == b"channels":
            cpos = pos
            while data[cpos] != 0:
                cname_end = data.index(b"\x00", cpos)
                cname = data[cpos:cname_end].decode("latin-1")
                cpos = cname_end + 1
                # int pixelType, pLinear+3 reserved, int xSampling, ySampling
                ptype = struct.unpack_from("<i", data, cpos)[0]
                xs, ys = struct.unpack_from("<ii", data, cpos + 8)
                if (xs, ys) != (1, 1):
                    raise ValueError(
                        f"{path}: subsampled channel {cname!r} unsupported"
                    )
                if ptype not in _EXR_PIXEL_DTYPES:
                    raise ValueError(
                        f"{path}: unknown pixel type {ptype} for {cname!r}"
                    )
                channels.append((cname, _EXR_PIXEL_DTYPES[ptype]))
                cpos += 16
        pos += size
    pos += 1  # header terminator
    if width is None or not channels:
        raise ValueError(f"{path}: missing dataWindow/channels header")
    if compression not in _EXR_BLOCK_LINES:
        raise ValueError(
            f"{path}: compression id {compression} unsupported "
            "(only NONE/RLE/ZIPS/ZIP)"
        )
    lines_per_block = _EXR_BLOCK_LINES[compression]
    n_blocks = (height + lines_per_block - 1) // lines_per_block
    pos += 8 * n_blocks  # offset table (blocks follow sequentially)

    bytes_per_line = width * sum(np.dtype(d).itemsize for _, d in channels)
    planes = {
        name: np.empty((height, width), np.float32) for name, _ in channels
    }
    for _ in range(n_blocks):
        y_block, nbytes = struct.unpack_from("<ii", data, pos)
        pos += 8
        raw = data[pos : pos + nbytes]
        pos += nbytes
        n_lines = min(lines_per_block, height - (y_block - y0))
        expected = bytes_per_line * n_lines
        # OpenEXR stores a block raw whenever compression fails to shrink
        # it — a full-size block is uncompressed regardless of the header.
        if compression in (2, 3) and len(raw) < expected:  # ZIPS / ZIP
            raw = zlib.decompress(raw)
            if len(raw) != expected:
                raise ValueError(f"{path}: corrupt ZIP scanline block")
            raw = _exr_predictor_interleave(raw).tobytes()
        elif compression == 1 and len(raw) < expected:  # RLE
            raw = _exr_rle_decode(raw)
            if len(raw) != expected:
                raise ValueError(f"{path}: corrupt RLE scanline block")
            raw = _exr_predictor_interleave(raw).tobytes()
        off = 0
        for line in range(n_lines):
            # chunk headers carry ABSOLUTE y coordinates; lineOrder only
            # affects the order chunks appear in the file, not placement
            y = y_block - y0 + line
            for cname, dtype in channels:
                nb = width * np.dtype(dtype).itemsize
                vals = np.frombuffer(raw, dtype, count=width, offset=off)
                planes[cname][y] = vals.astype(np.float32)
                off += nb
    missing = [c for c in "RGB" if c not in planes]
    if missing:
        raise ValueError(f"{path}: missing color channels {missing}")
    return np.stack([planes["R"], planes["G"], planes["B"]], axis=-1)


def save_ppm(path: str, image_uint8: np.ndarray) -> None:
    h, w, _ = image_uint8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image_uint8).tobytes())
