"""Image assembly, tone mapping, and PNG/EXR/PPM output.

Counterpart of :mod:`spira_tpu.io.image`.  Assembly and tone mapping are
tensor ops on the render's device; file encoding is host-side numpy (PIL is
used for PNG when it is installed).
"""

from __future__ import annotations

import struct
import zlib

import numpy as np
import torch


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
        return x.detach().cpu().numpy()
    return np.asarray(x)


def to_uint8(ldr) -> np.ndarray:
    """[0, 1] image (tensor or array) → host uint8 array."""
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
# EXR (minimal OpenEXR 2.0 writer: scanline, uncompressed, float32 RGB)
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


def save_ppm(path: str, image_uint8: np.ndarray) -> None:
    h, w, _ = image_uint8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(np.ascontiguousarray(image_uint8).tobytes())
