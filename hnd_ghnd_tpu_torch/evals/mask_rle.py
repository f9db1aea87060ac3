"""RLE mask utilities: the native cocomask library, and numpy.

Counterpart of hnd_ghnd_tpu/evals/mask_rle.py (pycocotools' mask surface
that the reference consumes: encode/decode/area/IoU,
src/utils/coco_eval_util.py:107-111, src/utils/coco_util.py:33-47).
``encode``, ``decode``, ``area``, ``iou_matrix`` and ``poly_to_rle`` call
the JAX package's native/cocomask/cocomask.cpp, which the port builds with
g++ (``_build.load_host("cocomask")``; the run-merge IoU never
materialises a mask), and evals/coco_eval.py's matching calls its
``coco_match``.  The numpy functions (``*_np``) are their plain versions:
the path where the library does not build, and what the native results are
held to.
Run-length counts are column-major, uint32, and start with a zero-run.
"""
from __future__ import annotations

import ctypes
from typing import List, Optional, Sequence

import numpy as np

from hnd_ghnd_tpu_torch import _build

_U32P = ctypes.POINTER(ctypes.c_uint32)
_U8P = ctypes.POINTER(ctypes.c_uint8)
_I64P = ctypes.POINTER(ctypes.c_int64)
_I32P = ctypes.POINTER(ctypes.c_int32)
_F64P = ctypes.POINTER(ctypes.c_double)
_I64 = ctypes.c_int64
_bound: Optional[ctypes.CDLL] = None


def get_lib() -> Optional[ctypes.CDLL]:
    """The cocomask library with its signatures; None where it does not
    build."""
    global _bound
    lib = _build.load_host("cocomask")
    if lib is not None and _bound is not lib:
        for name, res, args in (
                ("rle_encode", _I64, [_U8P, _I64, _I64, _U32P]),
                ("rle_decode", None, [_U32P, _I64, _I64, _I64, _U8P]),
                ("rle_area", _I64, [_U32P, _I64]),
                ("rle_iou_matrix", None, [_U32P, _I64P, _I64, _U32P, _I64P,
                                          _I64, _I32P, _F64P]),
                ("poly_to_rle", _I64, [_F64P, _I64, _I64, _I64, _U32P,
                                       _I64]),
                ("coco_match", None, [_F64P, _I64, _I64, _U8P, _F64P, _I64,
                                      _I32P])):
            fn = getattr(lib, name)
            fn.restype, fn.argtypes = res, args
        _bound = lib
    return lib


def _ptr(arr: np.ndarray, ptype):
    return arr.ctypes.data_as(ptype)


def encode(mask: np.ndarray) -> np.ndarray:
    """Binary [h, w] mask -> column-major run lengths (uint32)."""
    lib = get_lib()
    if lib is None:
        return encode_np(mask)
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    h, w = mask.shape
    out = np.empty(h * w + 1, dtype=np.uint32)
    n = lib.rle_encode(_ptr(mask, _U8P), h, w, _ptr(out, _U32P))
    return out[:n].copy()


def encode_np(mask: np.ndarray) -> np.ndarray:
    mask = np.ascontiguousarray(mask, dtype=np.uint8)
    flat = mask.T.reshape(-1)
    changes = np.flatnonzero(np.diff(flat)) + 1
    bounds = np.concatenate([[0], changes, [flat.size]])
    runs = np.diff(bounds).astype(np.uint32)
    if flat[0] != 0:  # runs must start with a zero-run
        runs = np.concatenate([[np.uint32(0)], runs])
    return runs


def _flat(counts: np.ndarray) -> np.ndarray:
    """Column-major flat uint8 mask of an RLE."""
    counts = np.asarray(counts, dtype=np.int64)
    values = np.arange(len(counts)) % 2
    return np.repeat(values.astype(np.uint8), counts)


def decode(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    lib = get_lib()
    if lib is None:
        return decode_np(counts, h, w)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    out = np.zeros((h, w), dtype=np.uint8)
    lib.rle_decode(_ptr(counts, _U32P), len(counts), h, w, _ptr(out, _U8P))
    return out


def decode_np(counts: np.ndarray, h: int, w: int) -> np.ndarray:
    flat = np.zeros(h * w, dtype=np.uint8)
    runs = _flat(counts)[:h * w]
    flat[:len(runs)] = runs
    return flat.reshape(w, h).T


def area(counts: np.ndarray) -> int:
    lib = get_lib()
    if lib is None:
        return area_np(counts)
    counts = np.ascontiguousarray(counts, dtype=np.uint32)
    return int(lib.rle_area(_ptr(counts, _U32P), len(counts)))


def area_np(counts: np.ndarray) -> int:
    return int(np.asarray(counts, dtype=np.int64)[1::2].sum())


def iou_matrix(det_rles: Sequence[np.ndarray], gt_rles: Sequence[np.ndarray],
               iscrowd: np.ndarray) -> np.ndarray:
    """IoU between RLE sets over a shared canvas; crowd gt -> inter/det
    (intersections are exact integer counts, the quotient a float64)."""
    n_det, n_gt = len(det_rles), len(gt_rles)
    lib = get_lib()
    if n_det == 0 or n_gt == 0 or lib is None:
        return iou_matrix_np(det_rles, gt_rles, iscrowd)
    runs, offs = [], []
    for rles in (det_rles, gt_rles):
        runs.append(np.ascontiguousarray(np.concatenate(
            [np.asarray(r, np.uint32) for r in rles])))
        offs.append(np.concatenate(
            [[0], np.cumsum([len(r) for r in rles])]).astype(np.int64))
    iscrowd = np.ascontiguousarray(iscrowd, dtype=np.int32)
    out = np.zeros((n_det, n_gt), dtype=np.float64)
    lib.rle_iou_matrix(_ptr(runs[0], _U32P), _ptr(offs[0], _I64P), n_det,
                       _ptr(runs[1], _U32P), _ptr(offs[1], _I64P), n_gt,
                       _ptr(iscrowd, _I32P), _ptr(out, _F64P))
    return out


def iou_matrix_np(det_rles: Sequence[np.ndarray],
                  gt_rles: Sequence[np.ndarray],
                  iscrowd: np.ndarray) -> np.ndarray:
    n_det, n_gt = len(det_rles), len(gt_rles)
    if n_det == 0 or n_gt == 0:
        return np.zeros((n_det, n_gt))
    iscrowd = np.asarray(iscrowd, dtype=np.int32)
    gts = [_flat(g) for g in gt_rles]
    n = min(len(g) for g in gts)
    gt_stack = np.stack([g[:n] for g in gts]).astype(bool)
    ga = np.asarray([area_np(g) for g in gt_rles], dtype=np.int64)
    out = np.zeros((n_det, n_gt))
    for i, d in enumerate(det_rles):
        dm = _flat(d)[:n].astype(bool)
        inter = np.count_nonzero(gt_stack & dm[None], axis=1).astype(np.int64)
        da = area_np(d)
        denom = np.where(iscrowd != 0, da, da + ga - inter).astype(np.float64)
        np.divide(inter.astype(np.float64), denom, out=out[i],
                  where=denom > 0)
    return out


def poly_to_rle(xy: Sequence[float], h: int, w: int) -> np.ndarray:
    """COCO polygon -> column-major RLE, bit-exact with pycocotools'
    rleFrPoly (5x-upsampled boundary walk -> column-crossing downsample ->
    sorted-diff run encoding).  This is the rasterization COCO ground truth
    was published with."""
    pts = np.ascontiguousarray(xy, dtype=np.float64).reshape(-1)
    k = len(pts) // 2
    lib = get_lib()
    if lib is not None:
        max_counts = int(h * w + 2 + 4 * k * 5)
        out = np.empty(max_counts, dtype=np.uint32)
        n = lib.poly_to_rle(_ptr(pts, _F64P), k, h, w, _ptr(out, _U32P),
                            max_counts)
        if n >= 0:
            return out[:n].copy()
    return poly_to_rle_np(pts, h, w)


def poly_to_rle_np(xy: Sequence[float], h: int, w: int) -> np.ndarray:
    pts = np.ascontiguousarray(xy, dtype=np.float64).reshape(-1)
    k = len(pts) // 2
    if k < 3:
        return np.asarray([h * w], dtype=np.uint32)
    scale = 5.0
    x = (scale * pts[0::2] + 0.5).astype(np.int64)
    y = (scale * pts[1::2] + 0.5).astype(np.int64)
    x = np.append(x, x[0])
    y = np.append(y, y[0])
    us: List[np.ndarray] = []
    vs: List[np.ndarray] = []
    for j in range(k):
        xs, xe, ys, ye = int(x[j]), int(x[j + 1]), int(y[j]), int(y[j + 1])
        dx, dy = abs(xe - xs), abs(ys - ye)
        flip = (dx >= dy and xs > xe) or (dx < dy and ys > ye)
        if flip:
            xs, xe, ys, ye = xe, xs, ye, ys
        if dx >= dy:
            s = (ye - ys) / dx if dx else 0.0
            d = np.arange(dx + 1, dtype=np.int64)
            t = dx - d if flip else d
            us.append(t + xs)
            vs.append((ys + s * t + 0.5).astype(np.int64))
        else:
            s = (xe - xs) / dy if dy else 0.0
            d = np.arange(dy + 1, dtype=np.int64)
            t = dy - d if flip else d
            vs.append(t + ys)
            us.append((xs + s * t + 0.5).astype(np.int64))
    u = np.concatenate(us)
    v = np.concatenate(vs)
    # column-boundary crossings, downsampled
    change = u[1:] != u[:-1]
    uj, up = u[1:][change], u[:-1][change]
    vj, vp = v[1:][change], v[:-1][change]
    xd = np.where(uj < up, uj, uj - 1).astype(np.float64)
    xd = (xd + 0.5) / scale - 0.5
    keep = (np.floor(xd) == xd) & (xd >= 0) & (xd <= w - 1)
    yd = np.minimum(vj, vp).astype(np.float64)
    yd = (yd + 0.5) / scale - 0.5
    yd = np.ceil(np.clip(yd, 0, h))
    cx = xd[keep].astype(np.int64)
    cy = yd[keep].astype(np.int64)
    a = np.sort(cx * h + cy).astype(np.uint32)
    a = np.append(a, np.uint32(h * w))
    a = np.diff(a, prepend=np.uint32(0)).astype(np.uint32)
    # merge zero runs (a zero means two crossings at the same position —
    # they cancel and their neighbors fuse)
    b: List[int] = [int(a[0])]
    j = 1
    n = len(a)
    while j < n:
        if a[j] > 0:
            b.append(int(a[j]))
            j += 1
        else:
            j += 1
            if j < n:
                b[-1] += int(a[j])
                j += 1
    return np.asarray(b, dtype=np.uint32)
