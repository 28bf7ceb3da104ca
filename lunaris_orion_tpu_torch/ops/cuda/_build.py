"""Build the hand-written Hopper kernels and load them with ctypes.

`library()` compiles every `lunaris_orion_tpu_torch/csrc/*.cu` with nvcc,
for sm_90a, into one shared library with a plain C interface, at first use.
The library lands in `lunaris_orion_tpu_torch/_build/<hash>/`, where the
hash covers the sources' content and the compiler flags, so an edited
source builds anew and an unchanged one is reused. The compiler writes to
a temporary name that is renamed into place, so a build cut short never
leaves a library that loads. The compiler's report (`-Xptxas -v`:
registers, shared memory and spills of each kernel) is kept beside it in
`build.log`.

Importing this module builds nothing; only `library()` does, and it raises
`RuntimeError` when nvcc is missing.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
CUDA_ROOTS = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
_U = ctypes.c_uint
# C entry points and their argument types (every pointer and the stream
# as c_void_p, or ctypes would pass them as 32-bit ints).
SIGNATURES = {
    "lunaris_gn_mish": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _F,
                        _I, _P),
    "lunaris_flash_attention_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                    _I, _F, _I, _U, _F, _U, _I, _I, _I, _P),
}


def sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def nvcc() -> str:
    """Path of nvcc: on PATH, else under CUDA_HOME or CUDA_ROOTS."""
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), *CUDA_ROOTS):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError(
        "nvcc not found (PATH, CUDA_HOME, /usr/local/cuda): the CUDA kernels "
        "of lunaris_orion_tpu_torch are built at first use on a machine with "
        "the CUDA toolkit")


def build_dir() -> Path:
    h = hashlib.sha256()
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def build() -> Path:
    """Compile the sources unless this content was built already; returns
    the library's path."""
    out_dir = build_dir()
    lib = out_dir / "liblunaris_kernels.so"
    if lib.is_file():
        return lib
    compiler = nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tmp = out_dir / f".liblunaris_kernels.so.{os.getpid()}"
    cmd = [compiler, *NVCC_FLAGS, "-o", str(tmp), *map(str, sources())]
    proc = subprocess.run(cmd, capture_output=True, text=True)
    (out_dir / "build.log").write_text(
        " ".join(cmd) + "\n" + proc.stdout + proc.stderr)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(
            f"nvcc failed ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, lib)
    return lib


@functools.cache
def library() -> ctypes.CDLL:
    """The kernels' shared library, built at first call and loaded once."""
    lib = ctypes.CDLL(str(build()))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    lib.lunaris_cuda_error_string.argtypes = [ctypes.c_int]
    lib.lunaris_cuda_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, kernel: str) -> None:
    """Raise when a C entry point returned a CUDA error."""
    if err != 0:
        name = library().lunaris_cuda_error_string(err).decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({name}) at launch")
