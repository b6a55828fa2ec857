"""Scanline OpenEXR reading and writing, PFM and PNG reading (the EXR,
PFM and PNG parts of pbrt_tpu/utils/image.py).

The port imports no module of the JAX package, so it carries its own EXR
codec; tests/test_torch_render.py holds it to the reference's (each reads
the other's files). Writes float32 RGB with ZIPS compression; reads
uncompressed, ZIPS and ZIP files with HALF or FLOAT channels, which covers
the reference renderer's goldens. The PNG reader takes 8- and 16-bit
truecolor (zlib only, no imaging library), as the reference's does.
"""
from __future__ import annotations

import struct
import zlib
from pathlib import Path

import numpy as np

_MAGIC = b"\x76\x2f\x31\x01"
_ZIPS, _ZIP = 2, 3


def _predictor_encode(raw: bytes) -> bytes:
    """OpenEXR zip pre-pass: split even/odd bytes, then delta-encode."""
    d = np.frombuffer(raw, np.uint8)
    t = np.concatenate([d[0::2], d[1::2]]).astype(np.int32)
    t[1:] = (np.diff(t) + 384) % 256
    return t.astype(np.uint8).tobytes()


def _predictor_decode(raw: bytes) -> bytes:
    d = np.frombuffer(raw, np.uint8).astype(np.int64)
    t = d.copy()
    t[1:] -= 128
    t = np.cumsum(t) % 256
    half = (len(d) + 1) // 2
    out = np.empty(len(d), np.uint8)
    out[0::2] = t[:half]
    out[1::2] = t[half:]
    return out.tobytes()


def write_exr(path, img: np.ndarray) -> None:
    """(H, W, 3) -> single-part scanline float32 EXR, ZIPS compressed."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    chans = [img[..., 2], img[..., 1], img[..., 0]]   # B, G, R: sorted

    def attr(name, typ, data):
        return (name.encode() + b"\x00" + typ.encode() + b"\x00"
                + struct.pack("<I", len(data)) + data)

    chlist = b"".join(c + b"\x00" + struct.pack("<iiii", 2, 0, 1, 1)
                      for c in (b"B", b"G", b"R")) + b"\x00"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    hdr = (_MAGIC + struct.pack("<I", 2) + attr("channels", "chlist", chlist)
           + attr("compression", "compression", bytes([_ZIPS]))
           + attr("dataWindow", "box2i", box)
           + attr("displayWindow", "box2i", box)
           + attr("lineOrder", "lineOrder", bytes([0]))
           + attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
           + attr("screenWindowCenter", "v2f", struct.pack("<ff", 0, 0))
           + attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
           + b"\x00")
    blocks = []
    for y in range(h):
        raw = np.concatenate([c[y] for c in chans]).astype("<f4").tobytes()
        comp = zlib.compress(_predictor_encode(raw))
        if len(comp) >= len(raw):
            comp = raw
        blocks.append(struct.pack("<iI", y, len(comp)) + comp)
    pos = len(hdr) + 8 * h
    offsets = []
    for b in blocks:
        offsets.append(pos)
        pos += len(b)
    Path(path).write_bytes(hdr + struct.pack(f"<{h}Q", *offsets)
                           + b"".join(blocks))


def read_exr(path) -> np.ndarray:
    """Scanline EXR -> (H, W, 3) float32 RGB."""
    data = Path(path).read_bytes()
    if data[:4] != _MAGIC:
        raise ValueError(f"{path}: not an OpenEXR file")
    pos = 8
    attrs = {}
    while data[pos] != 0:
        e = data.index(b"\x00", pos)
        name = data[pos:e].decode()
        e2 = data.index(b"\x00", e + 1)
        ln = struct.unpack("<I", data[e2 + 1:e2 + 5])[0]
        attrs[name] = data[e2 + 5:e2 + 5 + ln]
        pos = e2 + 5 + ln
    pos += 1
    x0, y0, x1, y1 = struct.unpack("<iiii", attrs["dataWindow"])
    w, h = x1 - x0 + 1, y1 - y0 + 1
    comp = attrs["compression"][0]
    names, types = [], []
    cd, cp = attrs["channels"], 0
    while cd[cp] != 0:
        e = cd.index(b"\x00", cp)
        names.append(cd[cp:e].decode())
        types.append(struct.unpack("<i", cd[e + 1:e + 5])[0])
        cp = e + 17
    dtypes = [np.float16 if t == 1 else np.float32 for t in types]
    sizes = [np.dtype(t).itemsize for t in dtypes]
    lines = 16 if comp == _ZIP else 1
    n_blocks = -(-h // lines)
    offsets = struct.unpack(f"<{n_blocks}Q", data[pos:pos + 8 * n_blocks])
    img = np.zeros((h, w, len(names)), np.float32)
    line_bytes = w * sum(sizes)
    for off in offsets:
        y, ln = struct.unpack("<iI", data[off:off + 8])
        raw = data[off + 8:off + 8 + ln]
        n_lines = min(lines, y1 - y + 1)
        if comp in (_ZIPS, _ZIP, 4) and ln != line_bytes * n_lines:
            # 4: files from the reference writer's old ZIPS label
            raw = _predictor_decode(zlib.decompress(raw))
        for li in range(n_lines):
            cp = li * line_bytes
            for ci, (dt, sz) in enumerate(zip(dtypes, sizes)):
                img[y - y0 + li, :, ci] = np.frombuffer(
                    raw[cp:cp + w * sz], dt).astype(np.float32)
                cp += w * sz
    order = [names.index(c) for c in "RGB"]
    return img[:, :, order]


def read_pfm(path) -> np.ndarray:
    """Portable float map -> (H, W, 3) (color) or (H, W) float32, top row
    first."""
    with open(path, "rb") as f:
        color = f.readline().strip() == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).astype(np.float32)


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if (pa <= pb and pa <= pc) else (b if pb <= pc else c)


def read_png(path) -> np.ndarray:
    """Truecolor PNG -> (H, W, 3) uint8 (uint16 at 16 bits), the scanline
    filters undone."""
    data = Path(path).read_bytes()
    if data[:8] != b"\x89PNG\r\n\x1a\n":
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = b""
    w = h = depth = ctype = None
    while pos < len(data):
        ln = struct.unpack(">I", data[pos:pos + 4])[0]
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + ln]
        if tag == b"IHDR":
            w, h, depth, ctype = struct.unpack(">IIBB", body[:10])
        elif tag == b"IDAT":
            idat += body
        pos += 12 + ln
    if ctype != 2:
        raise ValueError(f"{path}: only truecolor PNG files are read")
    raw = zlib.decompress(idat)
    bpp = 3 * (depth // 8)
    stride = w * bpp
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.int64)
    pos = 0
    for y in range(h):
        ft = raw[pos]
        line = np.frombuffer(raw[pos + 1:pos + 1 + stride], np.uint8) \
            .astype(np.int64)
        pos += 1 + stride
        if ft == 1:     # sub: a running sum along each byte of a pixel
            line = np.cumsum(line.reshape(-1, bpp), axis=0).reshape(-1) \
                % 256
        elif ft == 2:   # up
            line = (line + prev) % 256
        elif ft in (3, 4):   # average, paeth: left to right
            line = line.tolist()
            up = prev.tolist()
            for i in range(stride):
                a = line[i - bpp] if i >= bpp else 0
                if ft == 3:
                    pred = (a + up[i]) >> 1
                else:
                    pred = _paeth(a, up[i], up[i - bpp] if i >= bpp else 0)
                line[i] = (line[i] + pred) & 0xFF
            line = np.asarray(line, np.int64)
        out[y] = line
        prev = line
    if depth == 16:
        img = out.reshape(h, w, 3, 2)
        return (img[..., 0].astype(np.uint16) << 8) | img[..., 1]
    return out.reshape(h, w, 3)
