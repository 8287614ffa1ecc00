"""Image reading of the dataset loader (port of plvio_tpu/io/euroc.py's
`load_image_gray`, :99-106) and of the prior keyframe sets' 16-bit depth
images (`read_pgm`, what plvio_tpu/models/relocalization.py:117 reads
with PIL).  The rest of the EuRoC loader is not ported yet.

`load_image_gray` reads with OpenCV and converts colour to grey with
PIL's "L" rule, `L = (R * 19595 + G * 38470 + B * 7471 + 0x8000) >> 16`
(the 299 / 587 / 114 weights in 16-bit fixed point), so that its values
equal the reference's PIL read bit for bit; OpenCV's own BGR2GRAY rounds
otherwise.
"""
from __future__ import annotations

import numpy as np


def load_image_gray(path: str) -> np.ndarray:
    """Load one image as grayscale float32 [H,W] in [0,255] (8-bit grey,
    RGB or RGBA)."""
    import cv2

    img = cv2.imread(path, cv2.IMREAD_UNCHANGED)
    if img is None:
        raise FileNotFoundError(f"cannot read image {path!r}")
    if img.dtype != np.uint8:
        raise ValueError(f"{path!r}: {img.dtype} pixels, 8-bit expected")
    if img.ndim == 3:
        bgr = img[..., :3].astype(np.uint32)
        img = ((bgr[..., 2] * 19595 + bgr[..., 1] * 38470
                + bgr[..., 0] * 7471 + 0x8000) >> 16).astype(np.uint8)
    return np.asarray(img, np.float32)


def read_pgm(path: str) -> np.ndarray:
    """A binary PGM (P5, 8- or 16-bit big-endian) as its integer values,
    [H,W] uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    fields, pos = [], 0
    while len(fields) < 4:
        while data[pos:pos + 1].isspace():
            pos += 1
        if data[pos:pos + 1] == b"#":
            pos = data.index(b"\n", pos) + 1
            continue
        end = pos
        while not data[end:end + 1].isspace():
            end += 1
        fields.append(data[pos:end])
        pos = end
    if fields[0] != b"P5":
        raise ValueError(f"{path!r}: not a binary PGM")
    w, h, maxval = (int(x) for x in fields[1:])
    dt = np.dtype(">u2") if maxval > 255 else np.dtype(np.uint8)
    body = data[pos + 1:pos + 1 + w * h * dt.itemsize]
    return np.frombuffer(body, dt).reshape(h, w).astype(dt.newbyteorder("="))
