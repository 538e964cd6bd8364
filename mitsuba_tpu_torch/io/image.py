"""Image output and the HDR readers (a copy of the subset of
``mitsuba_tpu/io/image.py`` that needs only numpy and struct): NumPy
``.npy`` (mfilm.cpp), PFM, uncompressed scanline OpenEXR (hdrfilm.cpp's
format, written and read back without an EXR library), Radiance RGBE, binary
PPM and a MATLAB ``.m`` dump.

PNG, JPEG, TGA and BMP need an image library that the card's host lacks:
``write_image`` raises ``NotImplementedError`` for them (ROADMAP.md, Queue 1
item 3.13).
"""
from __future__ import annotations

import struct

import numpy as np

_LDR_LIBRARY_FORMATS = (".png", ".jpg", ".jpeg", ".tga", ".bmp")


def write_npy(path: str, img: np.ndarray) -> None:
    np.save(path, np.asarray(img, np.float32))


def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    color = img.ndim == 3 and img.shape[2] == 3
    with open(path, "wb") as f:
        f.write(b"PF\n" if color else b"Pf\n")
        f.write(f"{w} {h}\n".encode())
        f.write(b"-1.0\n")  # little-endian
        f.write(np.flipud(img).astype("<f4").tobytes())


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        header = f.readline().strip()
        color = header == b"PF"
        w, h = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    img = data.reshape(h, w, 3) if color else data.reshape(h, w)
    return np.flipud(img).copy()


# --- minimal OpenEXR (uncompressed, float32, scanline) ---------------------

def _exr_attr(name: bytes, typ: bytes, data: bytes) -> bytes:
    return name + b"\0" + typ + b"\0" + struct.pack("<i", len(data)) + data


def write_exr(path: str, img: np.ndarray) -> None:
    """Write (H, W, 3) float32 as an uncompressed scanline EXR."""
    img = np.asarray(img, np.float32)
    h, w = img.shape[:2]
    if img.ndim == 2:
        img = img[..., None].repeat(3, -1)
    chans = b""
    for name in (b"B", b"G", b"R"):  # alphabetical
        chans += name + b"\0" + struct.pack("<iiii", 2, 0, 1, 1)  # FLOAT
    chans += b"\0"
    box = struct.pack("<iiii", 0, 0, w - 1, h - 1)
    header = b"".join((
        _exr_attr(b"channels", b"chlist", chans),
        _exr_attr(b"compression", b"compression", b"\0"),  # NONE
        _exr_attr(b"dataWindow", b"box2i", box),
        _exr_attr(b"displayWindow", b"box2i", box),
        _exr_attr(b"lineOrder", b"lineOrder", b"\0"),  # INCREASING_Y
        _exr_attr(b"pixelAspectRatio", b"float", struct.pack("<f", 1.0)),
        _exr_attr(b"screenWindowCenter", b"v2f", struct.pack("<ff", 0, 0)),
        _exr_attr(b"screenWindowWidth", b"float", struct.pack("<f", 1.0)),
        b"\0",
    ))

    with open(path, "wb") as f:
        f.write(struct.pack("<I", 20000630))  # magic
        f.write(struct.pack("<I", 2))         # version 2, no flags
        f.write(header)
        # scanline offset table
        data_start = f.tell() + 8 * h
        line_bytes = 4 + 4 + 3 * 4 * w
        for y in range(h):
            f.write(struct.pack("<Q", data_start + y * line_bytes))
        for y in range(h):
            f.write(struct.pack("<i", y))
            f.write(struct.pack("<i", 3 * 4 * w))
            # channel-planar per scanline, alphabetical: B, G, R
            f.write(img[y, :, 2].astype("<f4").tobytes())
            f.write(img[y, :, 1].astype("<f4").tobytes())
            f.write(img[y, :, 0].astype("<f4").tobytes())


def read_exr(path: str) -> np.ndarray:
    """Read an uncompressed RGB float32 scanline EXR (as ``write_exr``
    writes them)."""
    with open(path, "rb") as f:
        magic, _version = struct.unpack("<II", f.read(8))
        if magic != 20000630:
            raise ValueError(f"{path} is not an EXR file")
        attrs = {}
        while True:
            name = b""
            c = f.read(1)
            if c == b"\0":
                break
            while c != b"\0":
                name += c
                c = f.read(1)
            typ = b""
            c = f.read(1)
            while c != b"\0":
                typ += c
                c = f.read(1)
            (size,) = struct.unpack("<i", f.read(4))
            attrs[name] = (typ, f.read(size))
        x0, y0, x1, y1 = struct.unpack("<iiii", attrs[b"dataWindow"][1])
        w, h = x1 - x0 + 1, y1 - y0 + 1
        if attrs[b"compression"][1][0] != 0:
            raise ValueError(f"{path}: only uncompressed EXR is supported")
        f.read(8 * h)  # offset table
        img = np.zeros((h, w, 3), np.float32)
        for _ in range(h):
            (y,) = struct.unpack("<i", f.read(4))
            (nb,) = struct.unpack("<i", f.read(4))
            row = np.frombuffer(f.read(nb), "<f4").reshape(3, w)
            img[y - y0, :, 2] = row[0]  # B
            img[y - y0, :, 1] = row[1]  # G
            img[y - y0, :, 0] = row[2]  # R
    return img


def write_rgbe(path: str, img: np.ndarray) -> None:
    """Radiance RGBE (.hdr): shared-exponent 8-bit mantissas, flat
    (uncompressed) scanlines."""
    img = np.asarray(img, np.float32)
    h, w, _ = img.shape
    mx = img.max(axis=-1)
    e = np.zeros((h, w), np.int32)
    nz = mx > 1e-32
    e[nz] = np.ceil(np.log2(mx[nz])).astype(np.int32) + 1
    scale = np.where(nz, 256.0 / np.exp2(e.astype(np.float32)), 0.0)
    rgbe = np.zeros((h, w, 4), np.uint8)
    rgbe[..., :3] = np.clip(img * scale[..., None], 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {h} +X {w}\n".encode())
        f.write(rgbe.tobytes())


def write_ppm(path: str, img: np.ndarray, gamma: bool = True) -> None:
    """Binary PPM (P6) with sRGB gamma."""
    img = np.asarray(img, np.float32)
    if gamma:
        img = np.where(img <= 0.0031308, 12.92 * img,
                       1.055 * np.maximum(img, 1e-12) ** (1 / 2.4) - 0.055)
    u8 = np.clip(img * 255.0 + 0.5, 0, 255).astype(np.uint8)
    h, w, _ = u8.shape
    with open(path, "wb") as f:
        f.write(f"P6\n{w} {h}\n255\n".encode())
        f.write(u8.tobytes())


def write_m(path: str, img: np.ndarray, variable: str = "data") -> None:
    """MATLAB/Mathematica-readable matrix dump (mfilm.cpp EMATLAB mode)."""
    img = np.asarray(img)
    if img.ndim == 2:
        img = img[..., None]
    h, w, c = img.shape
    with open(path, "w") as f:
        f.write(f"{variable} = [\n")
        for y in range(h):
            row = ", ".join(" ".join(f"{img[y, x, k]:.9g}" for k in range(c))
                            for x in range(w))
            f.write("  " + row + (";\n" if y + 1 < h else "\n"))
        f.write("];\n")


_WRITERS = {".pfm": write_pfm, ".npy": write_npy, ".exr": write_exr,
            ".hdr": write_rgbe, ".rgbe": write_rgbe, ".ppm": write_ppm,
            ".m": write_m}


def write_image(path: str, img: np.ndarray) -> None:
    """Dispatch by extension (Bitmap::write)."""
    p = path.lower()
    if p.endswith(_LDR_LIBRARY_FORMATS):
        raise NotImplementedError(
            f"{path}: PNG, JPEG, TGA and BMP output needs an image library "
            "and lands in a later slice of the port (ROADMAP.md, Queue 1 "
            "item 3.13); write .exr, .pfm, .hdr, .ppm or .npy")
    for ext, writer in _WRITERS.items():
        if p.endswith(ext):
            writer(path, img)
            return
    raise ValueError(f"unsupported image format: {path}")
