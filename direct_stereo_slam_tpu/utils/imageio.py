"""Compressed-image (PNG, JPEG) I/O through OpenCV or Pillow, whichever is
installed. The synthetic, PNM, native and rosbag paths need neither."""

from __future__ import annotations

import io

import numpy as np


def image_backend():
    """("cv2", cv2) or ("pil", PIL.Image); raises one ImportError naming
    both packages when neither is installed."""
    try:
        import cv2
        return "cv2", cv2
    except ImportError:
        pass
    try:
        from PIL import Image
        return "pil", Image
    except ImportError:
        raise ImportError(
            "reading or writing PNG/JPEG images needs OpenCV (cv2) or "
            "Pillow (PIL); neither is installed") from None


def read_gray(path: str) -> np.ndarray:
    """Grayscale image as float32 [H, W]."""
    kind, lib = image_backend()
    if kind == "cv2":
        img = lib.imread(path, lib.IMREAD_GRAYSCALE)
        if img is None:
            raise IOError(path)
        return img.astype(np.float32)
    return np.asarray(lib.open(path).convert("L"), dtype=np.float32)


def encode_png(rgb: np.ndarray) -> bytes:
    """PNG bytes of a uint8 [H, W, 3] RGB image."""
    kind, lib = image_backend()
    rgb = np.asarray(rgb)
    if kind == "cv2":
        ok, buf = lib.imencode(".png", rgb[..., ::-1])
        if not ok:
            raise IOError("PNG encoding failed")
        return bytes(buf)
    bio = io.BytesIO()
    lib.fromarray(rgb).save(bio, format="PNG")
    return bio.getvalue()


def write_rgb(path: str, rgb: np.ndarray) -> None:
    """Write a uint8 [H, W, 3] RGB image; the format follows the suffix."""
    kind, lib = image_backend()
    if kind == "cv2":
        lib.imwrite(path, np.asarray(rgb)[..., ::-1])
    else:
        lib.fromarray(np.asarray(rgb)).save(path)
