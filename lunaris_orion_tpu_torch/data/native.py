"""The native C++ batch gatherer (`native/gather.cpp`) through ctypes
(counterpart: lunaris_orion_tpu/data/native.py, same C interface).

A host helper, not a device kernel: `SpriteDataset.gather` uses it when it
builds, and the numpy gather otherwise, so the pipeline never depends on a
C++ toolchain. The library is compiled with g++ at first use into
`lunaris_orion_tpu_torch/_build/` (gitignored), under a name that carries a
hash of the source, so an edited source builds anew; the compiler writes to
a temporary name that is renamed into place, so ranks that build at once
never load a half-written file.
"""

from __future__ import annotations

import ctypes
import hashlib
import logging
import os
import subprocess
from pathlib import Path
from typing import List, Optional

import numpy as np

logger = logging.getLogger(__name__)

_PKG = Path(__file__).resolve().parents[1]
SRC = _PKG / "native" / "gather.cpp"
BUILD_ROOT = _PKG / "_build"
CXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17")
_lib: Optional[ctypes.CDLL] = None
_tried = False


def library_path() -> Path:
    tag = hashlib.sha256(SRC.read_bytes() + " ".join(CXX_FLAGS).encode()
                         ).hexdigest()[:16]
    return BUILD_ROOT / f"libgather-{tag}.so"


def _build() -> ctypes.CDLL:
    so = library_path()
    if not so.exists():
        so.parent.mkdir(parents=True, exist_ok=True)
        tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
        cmd = ["g++", *CXX_FLAGS, "-o", str(tmp), str(SRC)]
        logger.info("Building the native gather: %s", " ".join(cmd))
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so)
    lib = ctypes.CDLL(str(so))
    lib.gather_u8.argtypes = [
        ctypes.POINTER(ctypes.c_void_p), ctypes.POINTER(ctypes.c_int64),
        ctypes.c_int64, ctypes.POINTER(ctypes.c_int64), ctypes.c_int64,
        ctypes.c_int64, ctypes.c_void_p, ctypes.c_int64]
    lib.gather_u8.restype = None
    lib.shuffle_indices.argtypes = [ctypes.POINTER(ctypes.c_int64),
                                    ctypes.c_int64, ctypes.c_uint64]
    lib.shuffle_indices.restype = None
    return lib


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built at the first call; None (and a warning,
    once) when it cannot be built."""
    global _lib, _tried
    if _lib is None and not _tried:
        _tried = True
        try:
            _lib = _build()
        except Exception as e:  # no toolchain, or the build failed
            logger.warning("native gather unavailable (%s); using numpy", e)
    return _lib


class NativeGatherer:
    """Holds the shards' base pointers for repeated batch gathers."""

    def __init__(self, shards: List[np.ndarray]):
        lib = get_lib()
        if lib is None:
            raise RuntimeError("native gather library unavailable")
        self._lib = lib
        self._shards = shards                   # keeps the memmaps alive
        self.item_shape = shards[0].shape[1:]
        self.item_bytes = int(np.prod(self.item_shape))
        ptrs = (ctypes.c_void_p * len(shards))()
        for i, s in enumerate(shards):
            if s.dtype != np.uint8 or not s.flags["C_CONTIGUOUS"]:
                raise ValueError("native gather: shards must be C-contiguous "
                                 "uint8 arrays")
            ptrs[i] = s.ctypes.data_as(ctypes.c_void_p).value
        self._ptrs = ptrs
        cum = np.zeros(len(shards) + 1, np.int64)
        np.cumsum([len(s) for s in shards], out=cum[1:])
        self._cum = np.ascontiguousarray(cum)
        self._n_shards = len(shards)

    def gather(self, indices: np.ndarray) -> np.ndarray:
        """Rows `indices` (global, in [0, total)) -> [n, *item_shape] uint8,
        on the calling thread. The C side does not check the indices: out
        of range raises here."""
        idx = np.ascontiguousarray(indices, np.int64)
        if idx.size and (idx.min() < 0 or idx.max() >= self._cum[-1]):
            raise IndexError(f"native gather: indices outside "
                             f"[0, {int(self._cum[-1])})")
        out = np.empty((len(idx),) + self.item_shape, np.uint8)
        self._lib.gather_u8(
            self._ptrs,
            self._cum.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            self._n_shards,
            idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
            len(idx), self.item_bytes,
            out.ctypes.data_as(ctypes.c_void_p), 1)
        return out


def native_shuffle(indices: np.ndarray, seed: int) -> np.ndarray:
    """A Fisher-Yates shuffle of a copy of `indices` with SplitMix64, the
    JAX package's order. Raises RuntimeError when the library cannot be
    built: no other generator draws that order."""
    lib = get_lib()
    if lib is None:
        raise RuntimeError("native gather library unavailable")
    idx = np.array(indices, np.int64)
    lib.shuffle_indices(
        idx.ctypes.data_as(ctypes.POINTER(ctypes.c_int64)),
        len(idx), ctypes.c_uint64(seed & 0xFFFFFFFFFFFFFFFF))
    return idx
