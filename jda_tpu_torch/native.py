"""ctypes binding for the repository's native C inference library
(native/jda_native.c), with the reference C API (c/jda.h).

The port's second oracle: it needs no JAX, so it checks the port on a
machine that has none.  The library is compiled at first use from
native/jda_native.c, with the flags of native/Makefile, into the port's
own build directory; nothing is written into native/.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

import numpy as np

_PKG = os.path.dirname(os.path.abspath(__file__))
_SRC = os.path.join(_PKG, "..", "native", "jda_native.c")
_BUILD_DIR = os.path.join(_PKG, "build")
# CFLAGS and LDFLAGS of native/Makefile
_CFLAGS = ("-O3", "-std=c11", "-fPIC", "-Wall", "-Wextra", "-fopenmp")
_LDFLAGS = ("-shared", "-fopenmp", "-lm")


class _JdaResult(ctypes.Structure):
    _fields_ = [
        ("n", ctypes.c_int),
        ("landmark_n", ctypes.c_int),
        ("bboxes", ctypes.POINTER(ctypes.c_int)),
        ("shapes", ctypes.POINTER(ctypes.c_float)),
        ("scores", ctypes.POINTER(ctypes.c_float)),
    ]


_lib = None


def build() -> str:
    """Compile the library if no build of the current source exists;
    returns the path of the shared object."""
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:12]
    so = os.path.join(_BUILD_DIR, f"libjda_native-{digest}.so")
    if not os.path.exists(so):
        os.makedirs(_BUILD_DIR, exist_ok=True)
        tmp = f"{so}.tmp{os.getpid()}"
        # gcc, the Makefile's default compiler, which builds with OpenMP
        proc = subprocess.run(
            ["gcc", *_CFLAGS, _SRC, "-o", tmp, *_LDFLAGS],
            capture_output=True,
            text=True,
        )
        if proc.returncode != 0:
            raise RuntimeError(f"building the native library failed:\n{proc.stderr}")
        os.replace(tmp, so)
    return so


def _load():
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(build())
        lib.jdaCascadorCreateDouble.restype = ctypes.c_void_p
        lib.jdaCascadorCreateDouble.argtypes = [ctypes.c_char_p]
        lib.jdaCascadorCreateFloat.restype = ctypes.c_void_p
        lib.jdaCascadorCreateFloat.argtypes = [ctypes.c_char_p]
        lib.jdaCascadorSerializeTo.restype = None
        lib.jdaCascadorSerializeTo.argtypes = [ctypes.c_void_p, ctypes.c_char_p]
        lib.jdaCascadorRelease.restype = None
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
        lib.jdaResultRelease.restype = None
        lib.jdaResultRelease.argtypes = [_JdaResult]
        _lib = lib
    return _lib


class NativeDetector:
    """CPU detector over the native shared library."""

    def __init__(self, model_path: str, dtype: str = "double"):
        lib = _load()
        fn = (
            lib.jdaCascadorCreateDouble
            if dtype == "double"
            else lib.jdaCascadorCreateFloat
        )
        self._c = fn(model_path.encode())
        if not self._c:
            raise IOError(f"failed to load model {model_path}")
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
        """Returns (bboxes [n, 3] int32, shapes [n, 2L] float32,
        scores [n] float32)."""
        if gray.dtype != np.uint8 or gray.ndim != 2:
            raise ValueError("detect: gray must be a 2-D uint8 image")
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
        bboxes = (
            np.ctypeslib.as_array(res.bboxes, (n, 3)).copy()
            if n
            else np.zeros((0, 3), np.int32)
        )
        shapes = (
            np.ctypeslib.as_array(res.shapes, (n, ld)).copy()
            if n
            else np.zeros((0, ld), np.float32)
        )
        scores = (
            np.ctypeslib.as_array(res.scores, (n,)).copy()
            if n
            else np.zeros((0,), np.float32)
        )
        self._lib.jdaResultRelease(res)
        return bboxes, shapes, scores

    def serialize_float(self, path: str) -> None:
        self._lib.jdaCascadorSerializeTo(self._c, path.encode())

    def close(self) -> None:
        if getattr(self, "_c", None):
            self._lib.jdaCascadorRelease(self._c)
            self._c = None

    def __del__(self):
        self.close()
