"""The port's EXR reader (``spira_tpu_torch.io.image.load_exr``) against
the JAX package's on the same bytes, in every form the JAX image tests
build and a few more: NONE, RLE, ZIPS and ZIP compression, half, float and
uint channels, an extra alpha channel, decreasing-y chunk order, blocks
stored raw because compression did not shrink them, and the same
``ValueError`` for what neither reads.  Both return float32 NumPy arrays,
and they must be equal to the bit.
"""

import struct
import zlib

import numpy as np
import pytest

from spira_tpu.io import image as jimg
from spira_tpu_torch.io import image as timg

_PTYPE = {np.uint32: 0, np.float16: 1, np.float32: 2}
_LINES = {0: 1, 1: 1, 2: 1, 3: 16}


def _attr(name, typ, data):
    return name + b"\x00" + typ + b"\x00" + struct.pack("<I", len(data)) + data


def _predict(raw: bytes) -> bytes:
    """OpenEXR's ZIP/RLE pre-pass: interleave the halves, then deltas."""
    arr = np.frombuffer(raw, np.uint8)
    d = np.concatenate([arr[0::2], arr[1::2]]).astype(np.int64)
    d[1:] = (d[1:] - d[:-1] + 128) % 256
    return d.astype(np.uint8).tobytes()


def _rle(data: bytes) -> bytes:
    """OpenEXR RLE: runs of 3 to 128 equal bytes as (count - 1, byte),
    everything else as (-length, literal bytes) spans of up to 128."""
    out = bytearray()
    i, n = 0, len(data)
    while i < n:
        j = i
        while j < n and data[j] == data[i] and j - i < 128:
            j += 1
        if j - i >= 3:
            out += struct.pack("<b", j - i - 1) + data[i:i + 1]
            i = j
            continue
        j = i
        while j < n and j - i < 128 and not (
                j + 2 < n and data[j] == data[j + 1] == data[j + 2]):
            j += 1
        out += struct.pack("<b", -(j - i)) + data[i:j]
        i = j
    return bytes(out)


def _write_exr(path, hdr, *, dtype=np.float16, compression=3,
               channels="BGR", line_order=0, tiled=False):
    """Hand-encode a scanline EXR the way external tools write one."""
    h, w, _ = hdr.shape
    names = sorted(channels)  # stored alphabetically
    chl = b"".join(n.encode() + b"\x00" + struct.pack(
        "<iBBBBii", _PTYPE[dtype], 0, 0, 0, 0, 1, 1) for n in names) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join([
        _attr(b"channels", b"chlist", chl),
        _attr(b"compression", b"compression", bytes([compression])),
        _attr(b"dataWindow", b"box2i", box),
        _attr(b"displayWindow", b"box2i", box),
        _attr(b"lineOrder", b"lineOrder", bytes([line_order])),
        _attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0)),
        _attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\x00",
    ])

    def plane(name, y):
        vals = (np.full(w, 1.0) if name == "A"
                else hdr[y, :, "RGB".index(name)])
        return vals.astype(dtype).tobytes()

    blocks = []
    for y0 in range(0, h, _LINES[compression]):
        n_lines = min(_LINES[compression], h - y0)
        raw = b"".join(plane(n, y0 + ln) for ln in range(n_lines)
                       for n in names)
        if compression in (2, 3):
            packed = zlib.compress(_predict(raw))
        elif compression == 1:
            packed = _rle(_predict(raw))
        else:
            packed = raw
        # stored raw whenever compression does not shrink the block
        blocks.append((y0, packed if len(packed) < len(raw) else raw))
    if line_order == 1:
        blocks.reverse()

    version = 2 | (0x200 if tiled else 0)
    magic = struct.pack("<II", 20000630, version)
    pos = len(magic) + len(header) + 8 * len(blocks)
    offsets = []
    for _, raw in blocks:
        offsets.append(struct.pack("<Q", pos))
        pos += 8 + len(raw)
    with open(path, "wb") as f:
        f.write(magic + header + b"".join(offsets))
        for y0, raw in blocks:
            f.write(struct.pack("<ii", y0, len(raw)) + raw)


def _image(seed, h, w, flat_rows=0):
    """Random HDR values, the first ``flat_rows`` rows zero (runs that
    RLE and ZIP shrink)."""
    hdr = np.random.default_rng(seed).uniform(0, 4, (h, w, 3)).astype(
        np.float32)
    hdr[:flat_rows] = 0.0
    return hdr


def _both(path):
    got, want = timg.load_exr(path), jimg.load_exr(path)
    assert isinstance(got, np.ndarray) and got.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    return got


@pytest.mark.parametrize("compression", [0, 1, 2, 3],
                         ids=["none", "rle", "zips", "zip"])
@pytest.mark.parametrize("dtype", [np.float16, np.float32, np.uint32],
                         ids=["half", "float", "uint"])
def test_load_exr_matches_jax(tmp_path, compression, dtype):
    """37x21 (ZIP's 16-line blocks end ragged), the first 9 rows flat so
    RLE shrinks them and stores the noisy rows raw."""
    hdr = _image(compression, 37, 21, flat_rows=9)
    if dtype is np.uint32:
        hdr = np.floor(hdr * 1000)
    p = str(tmp_path / "x.exr")
    _write_exr(p, hdr, dtype=dtype, compression=compression)
    got = _both(p)
    np.testing.assert_array_equal(got, hdr.astype(dtype).astype(np.float32))


def test_load_exr_alpha_and_decreasing_y(tmp_path):
    """An alpha channel is skipped; chunks in decreasing-y order land at
    their own rows."""
    hdr = _image(6, 6, 10, flat_rows=2)
    for kw in (dict(compression=2, channels="ABGR"),
               dict(compression=1, channels="ABGR", line_order=1),
               dict(compression=3, dtype=np.float32, line_order=1)):
        p = str(tmp_path / "y.exr")
        _write_exr(p, hdr, **kw)
        got = _both(p)
        np.testing.assert_array_equal(
            got, hdr.astype(kw.get("dtype", np.float16)).astype(np.float32))


def test_load_exr_reads_save_exr(tmp_path):
    hdr = _image(2, 5, 9)
    p = str(tmp_path / "z.exr")
    timg.save_exr(p, hdr)
    np.testing.assert_array_equal(_both(p), hdr)


def test_load_exr_refusals(tmp_path):
    """PIZ compression, a tiled file, a file that is not an EXR and one
    without R, G and B raise ``ValueError`` in both readers."""
    hdr = _image(8, 4, 4)
    cases = {}
    p = str(tmp_path / "piz.exr")
    _write_exr(p, hdr, compression=1)
    data = bytearray(open(p, "rb").read())
    tag = b"compression\x00compression\x00"
    data[data.index(tag) + len(tag) + 4] = 4  # PIZ
    open(p, "wb").write(bytes(data))
    cases["piz"] = p
    cases["tiled"] = str(tmp_path / "tiled.exr")
    _write_exr(cases["tiled"], hdr, compression=0, tiled=True)
    cases["not_exr"] = str(tmp_path / "not.exr")
    open(cases["not_exr"], "wb").write(b"\x00" * 64)
    cases["no_rgb"] = str(tmp_path / "a.exr")
    _write_exr(cases["no_rgb"], hdr, compression=0, channels="A")
    for name, path in cases.items():
        for reader in (timg.load_exr, jimg.load_exr):
            with pytest.raises(ValueError):
                reader(path)
