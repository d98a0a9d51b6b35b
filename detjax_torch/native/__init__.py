"""Host-side native layer (``detjax/native``): g++ at first use, ctypes.

A copy of detjax's in-repo C++, not a device kernel:

* ``iou_xyxy`` / ``match_image``: the per-image COCOeval IoU and greedy
  matching, the fast path of ``evaluation/coco_map.py`` (same results as
  its numpy loops);
* ``resize_bilinear``: the uint8 resize of the data loader, bit for bit
  PIL's ``BILINEAR``;
* ``decode_jpeg``: libjpeg decode to RGB (a library of its own, linked
  with ``-ljpeg``, so that a host without libjpeg keeps the rest).

Each library builds at first use with detjax's flags into
``detjax_torch/_build/native-<hash>/``, where the hash covers the source
and the flags, and is published there by an atomic rename, so that
threads and processes building at once never load a half-written file.
Builds run under one lock. Where g++ or libjpeg is missing, the callers
keep detjax's host fallbacks: numpy for the COCO core, PIL for resize and
decode; ``DETJAX_NATIVE=0`` forces the numpy COCO core. Nothing here runs
when the module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import io
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional

import numpy as np

_DIR = Path(__file__).resolve().parent
BUILD_ROOT = _DIR.parent / "_build"
GXX_FLAGS = ("-O3", "-std=c++17", "-shared", "-fPIC")  # detjax's, exactly

_lock = threading.Lock()  # guards the builds and the module state below
_lib: Optional[ctypes.CDLL] = None
_build_failed = False
_jpeg_lib: Optional[ctypes.CDLL] = None
_jpeg_failed = False
# library name -> why its build or load failed
build_errors: Dict[str, str] = {}
# images decoded by :func:`decode_image`, by route
decode_routes: Dict[str, int] = {"native": 0, "pil": 0}


def _compile(source: str, link: tuple = ()) -> ctypes.CDLL:
    """Build ``source`` (a file in this directory) unless that exact build
    exists, then load it."""
    src = _DIR / source
    digest = hashlib.sha256(" ".join(("g++", *GXX_FLAGS, *link)).encode())
    digest.update(src.read_bytes())
    out_dir = BUILD_ROOT / f"native-{digest.hexdigest()[:16]}"
    lib_path = out_dir / f"{src.stem}.so"
    if not lib_path.is_file():
        out_dir.mkdir(parents=True, exist_ok=True)
        tmp = out_dir / f".{src.stem}.{os.getpid()}.{threading.get_ident()}.so"
        cmd = ["g++", *GXX_FLAGS, "-o", str(tmp), str(src), *link]
        try:
            subprocess.run(cmd, check=True, capture_output=True, text=True)
        except subprocess.CalledProcessError as exc:
            raise OSError(f"{' '.join(cmd)}: {exc.stderr}") from exc
        os.replace(tmp, lib_path)  # atomic against concurrent builds
    return ctypes.CDLL(str(lib_path))


def _build() -> ctypes.CDLL:
    lib = _compile("detjax_native.cpp")
    i64, f64 = ctypes.c_int64, ctypes.c_double
    pd = np.ctypeslib.ndpointer(np.float64, flags="C_CONTIGUOUS")
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.detjax_iou_xyxy.argtypes = [pd, i64, pd, i64, pu8, pd]
    lib.detjax_iou_xyxy.restype = None
    lib.detjax_match_image.argtypes = [
        pd, pu8, pu8, pd, f64, f64, pd, i64, i64, i64, pi64, pu8]
    lib.detjax_match_image.restype = None
    lib.detjax_resize_bilinear_u8.argtypes = [pu8, i64, i64, i64, pu8, i64,
                                              i64]
    lib.detjax_resize_bilinear_u8.restype = None
    return lib


def _build_jpeg() -> ctypes.CDLL:
    lib = _compile("detjax_jpeg.cpp", ("-ljpeg",))
    i64 = ctypes.c_int64
    pu8 = np.ctypeslib.ndpointer(np.uint8, flags="C_CONTIGUOUS")
    pi64 = np.ctypeslib.ndpointer(np.int64, flags="C_CONTIGUOUS")
    lib.detjax_jpeg_info.argtypes = [pu8, i64, pi64, pi64]
    lib.detjax_jpeg_info.restype = i64
    lib.detjax_jpeg_decode.argtypes = [pu8, i64, pu8, i64]
    lib.detjax_jpeg_decode.restype = i64
    return lib


def _get() -> Optional[ctypes.CDLL]:
    global _lib, _build_failed
    if _lib is not None or _build_failed:
        return _lib
    with _lock:
        if _lib is None and not _build_failed:
            try:
                _lib = _build()
            except OSError as exc:  # no g++, a failed build or load
                _build_failed = True
                build_errors["detjax_native"] = str(exc)
    return _lib


def _get_jpeg() -> Optional[ctypes.CDLL]:
    global _jpeg_lib, _jpeg_failed
    if _jpeg_lib is not None or _jpeg_failed:
        return _jpeg_lib
    with _lock:
        if _jpeg_lib is None and not _jpeg_failed:
            try:
                _jpeg_lib = _build_jpeg()
            except OSError as exc:  # no g++ or no libjpeg
                _jpeg_failed = True
                build_errors["detjax_jpeg"] = str(exc)
    return _jpeg_lib


def available() -> bool:
    return _get() is not None


def jpeg_available() -> bool:
    return _get_jpeg() is not None


def decode_jpeg(data: bytes) -> Optional[np.ndarray]:
    """JPEG bytes -> [H, W, 3] uint8 RGB through libjpeg; None when the
    library is unavailable or the payload is not a decodable JPEG. The C
    call releases the GIL."""
    lib = _get_jpeg()
    if lib is None:
        return None
    buf = np.frombuffer(data, np.uint8)
    h = np.zeros(1, np.int64)
    w = np.zeros(1, np.int64)
    if lib.detjax_jpeg_info(buf, len(buf), h, w):
        return None
    out = np.empty((int(h[0]), int(w[0]), 3), np.uint8)
    if lib.detjax_jpeg_decode(buf, len(buf), out.reshape(-1), out.size):
        return None
    return out


def decode_image(data: bytes) -> np.ndarray:
    """Image bytes -> [H, W, 3] uint8 RGB: :func:`decode_jpeg` first, then
    PIL (any format PIL reads), as detjax's loader and server decode.
    Counts each image's route in ``decode_routes``."""
    img = decode_jpeg(data)
    route = "native"
    if img is None:
        from PIL import Image

        route = "pil"
        with Image.open(io.BytesIO(data)) as im:
            img = np.asarray(im.convert("RGB"), np.uint8)
    with _lock:
        decode_routes[route] += 1
    return img


def iou_xyxy(det: np.ndarray, gt: np.ndarray, iscrowd: np.ndarray
             ) -> np.ndarray:
    """[D,4] x [G,4] xyxy -> [D,G] IoU (crowd: inter / det area)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("the native library is not available")
    det = np.ascontiguousarray(det, np.float64).reshape(-1, 4)
    gt = np.ascontiguousarray(gt, np.float64).reshape(-1, 4)
    crowd = np.ascontiguousarray(iscrowd, np.uint8).reshape(-1)
    if len(crowd) != len(gt):
        raise ValueError(f"{len(gt)} GT boxes but {len(crowd)} crowd flags")
    out = np.empty((len(det), len(gt)), np.float64)
    if out.size:
        lib.detjax_iou_xyxy(det, len(det), gt, len(gt), crowd, out)
    return out


def match_image(ious: np.ndarray, gt_ig: np.ndarray, g_crowd: np.ndarray,
                det_areas: np.ndarray, area_rng, iou_thrs: np.ndarray):
    """COCOeval's greedy matching of one image and category; returns
    ``(dtm [T,D] int64, dt_ig [T,D] bool)``."""
    lib = _get()
    if lib is None:
        raise RuntimeError("the native library is not available")
    d_n, g_n = ious.shape if ious.size else (len(det_areas), 0)
    t_n = len(iou_thrs)
    ious = np.ascontiguousarray(ious, np.float64)
    gt_ig = np.ascontiguousarray(gt_ig, np.uint8)
    g_crowd = np.ascontiguousarray(g_crowd, np.uint8)
    det_areas = np.ascontiguousarray(det_areas, np.float64)
    if len(det_areas) != d_n or (g_n and (len(gt_ig) != g_n
                                          or len(g_crowd) != g_n)):
        raise ValueError("match_image: inconsistent shapes")
    dtm = np.zeros((t_n, d_n), np.int64)
    dt_ig = np.zeros((t_n, d_n), np.uint8)
    lib.detjax_match_image(
        ious, gt_ig, g_crowd, det_areas, float(area_rng[0]),
        float(area_rng[1]), np.ascontiguousarray(iou_thrs, np.float64),
        t_n, d_n, g_n, dtm, dt_ig)
    return dtm, dt_ig.astype(bool)


def resize_bilinear(src: np.ndarray, dh: int, dw: int) -> np.ndarray:
    """uint8 [H,W,C] (or [H,W]) -> [dh,dw,C], bit for bit PIL's
    ``BILINEAR`` (the antialiased triangle filter in Pillow's 8-bit
    fixed-point arithmetic)."""
    lib = _get()
    if lib is None:
        raise RuntimeError("the native library is not available")
    src = np.ascontiguousarray(src, np.uint8)
    if src.ndim == 2:
        src = src[:, :, None]
    h, w, c = src.shape
    if dh < 1 or dw < 1:
        raise ValueError(f"resize to {dh}x{dw}")
    out = np.empty((dh, dw, c), np.uint8)
    lib.detjax_resize_bilinear_u8(src, h, w, c, out, dh, dw)
    return out
