"""Build the hand-written Hopper kernels and load them with ctypes.

`library()` compiles every `lunaris_orion_tpu_torch/csrc/*.cu` with nvcc,
for sm_90a, into one shared library with a plain C interface, at first use:
one `nvcc -c` per source, all started together, then one link. The
library lands in `lunaris_orion_tpu_torch/_build/<hash>/`, where the hash
covers the content of the sources and of the headers they share
(`csrc/*.cuh`) and the compiler flags, so an edited source or header
builds anew and an unchanged one is reused. The linker writes to a
temporary name that is renamed into place, so a build cut short never
leaves a library that loads. The compiler's report (`-Xptxas -v`:
registers, shared memory and spills of each kernel) and each source's
compile time are kept beside it in `build.log`.

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
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

_PKG = Path(__file__).resolve().parents[2]
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
CUDA_ROOTS = ("/usr/local/cuda",)
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

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
                                    _I, _F, _I, _U, _F, _U, _I, _I, _I, _I,
                                    _P),
    "lunaris_flash_attention_bwd": (_I, _P, _P, _P, _P, _P, _P, _P, _P, _P,
                                    _P, _P, _P, _I, _I, _I, _I, _I, _F, _I,
                                    _U, _F, _U, _I, _I, _I, _I, _P),
    "lunaris_mse_kl": (_P, _P, _P, _P, _P, _P, _I, ctypes.c_longlong, _I, _I,
                       _P),
    "lunaris_gn_stats_pass1": (_P, _P, _I, _I, _I, _I, _I, _I, _P),
    "lunaris_lane_sums_partials": (_P, _P, _P, _I, _I, _I, _I, _I, _P),
    "lunaris_flash_attention_stage": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                      _I, _I, _I, _P),
    "lunaris_gn_mish_conv3": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                              _P),
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
    for src in (*sources(), *sorted(CSRC.glob("*.cuh"))):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_ROOT / h.hexdigest()[:16]


def _run_timed(cmd):
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, stdout=subprocess.PIPE,
                          stderr=subprocess.STDOUT, text=True)
    return proc, time.perf_counter() - t0


def build() -> Path:
    """Compile the sources unless this content was built already; returns
    the library's path."""
    out_dir = build_dir()
    lib = out_dir / "liblunaris_kernels.so"
    if lib.is_file():
        return lib
    compiler = nvcc()
    out_dir.mkdir(parents=True, exist_ok=True)
    tag = os.getpid()
    jobs = []
    for src in sources():
        obj = out_dir / f".{src.stem}.{tag}.o"  # nvcc reads the type from ".o"
        jobs.append(([compiler, *NVCC_FLAGS, "-c", "-o", str(obj), str(src)],
                     obj))
    with ThreadPoolExecutor(len(jobs)) as pool:     # one nvcc per source
        done = list(pool.map(_run_timed, (cmd for cmd, _ in jobs)))
    log, failed = [], []
    for (cmd, _), (proc, seconds) in zip(jobs, done):
        log.append(f"{' '.join(cmd)}\n{proc.stdout}"
                   f"nvcc seconds: {seconds:.1f} {Path(cmd[-1]).name}\n")
        if proc.returncode != 0:
            failed.append(f"{cmd[-1]} ({proc.returncode}):\n{proc.stdout}")
    tmp = out_dir / f".liblunaris_kernels.so.{tag}"
    if not failed:
        cmd = [compiler, "-shared", "-o", str(tmp), *(str(o) for _, o in jobs)]
        proc = subprocess.run(cmd, capture_output=True, text=True)
        log.append(" ".join(cmd) + "\n" + proc.stdout + proc.stderr)
        if proc.returncode != 0:
            failed.append(f"link ({proc.returncode}):\n{proc.stdout}{proc.stderr}")
    (out_dir / "build.log").write_text("".join(log))
    for _, obj in jobs:
        obj.unlink(missing_ok=True)
    if failed:
        tmp.unlink(missing_ok=True)
        raise RuntimeError("nvcc failed: " + "\n".join(failed))
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
