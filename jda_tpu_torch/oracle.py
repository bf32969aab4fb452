"""Golden-reference oracle: the reference C detector through ctypes.

Compiles the reference's dependency-free C inference library (c/jda.c
of the reference checkout, libc and libm only) into a shared object at
first use and drives it through ctypes.  No reference code is vendored
into this repo: the oracle is a test and bench fixture, available only
where the read-only reference checkout is mounted.  It gives ground-truth
detections for parity tests and the single-core CPU baseline of a bench.
Where the reference is not mounted, `native.py` (the repo's own C library
with the same API) fills its role.

The reference hard-codes T=5, K=540, landmark_n=27, depth=4
(c/jda.c:24-32), so models compared with it must have exactly that
geometry.
"""

from __future__ import annotations

import ctypes
import os
import subprocess

import numpy as np

# the read-only mount of the reference checkout (the JAX package's path)
REFERENCE_C = "/root/reference/c/jda.c"
_BUILD_DIR = os.path.join(os.path.dirname(__file__), "..", ".oracle_build")

# geometry baked into the reference C library
T, K, LANDMARK_N, TREE_DEPTH = 5, 540, 27, 4


def available() -> bool:
    return os.path.exists(REFERENCE_C)


_lib = None


def _build() -> str:
    os.makedirs(_BUILD_DIR, exist_ok=True)
    so = os.path.join(_BUILD_DIR, "libjda_ref.so")
    if not os.path.exists(so) or os.path.getmtime(so) < os.path.getmtime(REFERENCE_C):
        subprocess.run(
            ["gcc", "-O2", "-std=c99", "-fPIC", "-shared", REFERENCE_C, "-o", so, "-lm"],
            check=True,
            capture_output=True,
        )
    return so


class _JdaResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("landmark_n", ctypes.c_int),
        ("bboxes", ctypes.POINTER(ctypes.c_int)),
        ("shapes", ctypes.POINTER(ctypes.c_float)),
        ("scores", ctypes.POINTER(ctypes.c_float)),
    ]


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_build())
        lib.jdaCascadorCreateDouble.restype = ctypes.c_void_p
        lib.jdaCascadorCreateDouble.argtypes = [ctypes.c_char_p]
        lib.jdaCascadorCreateFloat.restype = ctypes.c_void_p
        lib.jdaCascadorCreateFloat.argtypes = [ctypes.c_char_p]
        lib.jdaCascadorSerializeTo.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.jdaCascadorRelease.argtypes = [ctypes.c_void_p]
        lib.jdaDetect.restype = _JdaResult
        lib.jdaDetect.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_ubyte),
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
            ctypes.c_float,
            ctypes.c_int,
            ctypes.c_int,
            ctypes.c_float,
        ]
        lib.jdaResultRelease.argtypes = [_JdaResult]
        _lib = lib
    return _lib


class Oracle:
    """ctypes wrapper over the compiled reference C detector."""

    def __init__(self, model_path: str, dtype: str = "double"):
        lib = _load()
        if dtype == "double":
            self._c = lib.jdaCascadorCreateDouble(model_path.encode())
        else:
            self._c = lib.jdaCascadorCreateFloat(model_path.encode())
        if not self._c:
            raise IOError(f"oracle failed to load model {model_path}")
        self._lib = lib

    def detect(
        self,
        gray: np.ndarray,
        scale: float = 1.25,
        step: float = 0.1,
        min_size: int = 24,
        max_size: int = -1,
        th: float = -0.5,
    ):
        """Returns (bboxes [n,3] int32, shapes [n,2L] f32, scores [n] f32)."""
        assert gray.dtype == np.uint8 and gray.ndim == 2
        gray = np.ascontiguousarray(gray)
        h, w = gray.shape
        res = self._lib.jdaDetect(
            self._c,
            gray.ctypes.data_as(ctypes.POINTER(ctypes.c_ubyte)),
            w,
            h,
            scale,
            step,
            min_size,
            max_size,
            th,
        )
        n = res.n
        ld = 2 * res.landmark_n
        bboxes = np.ctypeslib.as_array(res.bboxes, (n, 3)).copy() if n else np.zeros((0, 3), np.int32)
        shapes = np.ctypeslib.as_array(res.shapes, (n, ld)).copy() if n else np.zeros((0, ld), np.float32)
        scores = np.ctypeslib.as_array(res.scores, (n,)).copy() if n else np.zeros((0,), np.float32)
        self._lib.jdaResultRelease(res)
        return bboxes, shapes, scores

    def serialize_float(self, path: str) -> None:
        self._lib.jdaCascadorSerializeTo(self._c, path.encode())

    def __del__(self):
        try:
            if getattr(self, "_c", None):
                self._lib.jdaCascadorRelease(self._c)
                self._c = None
        except Exception:
            pass
