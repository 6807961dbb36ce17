"""Build the CUDA sources in ``csrc/`` with nvcc and bind them with ctypes.

Each ``csrc/<name>.cu`` becomes one shared library with a plain C
interface, ``build/repro_torch/<name>-<hash>.so`` under the repository
root.  The hash covers the source and every header in ``csrc/``, so an
edited source is rebuilt and an unchanged one is loaded as it is.  Nothing
here runs at import time: a library is built on its first use, and
:func:`build_all` builds every library at once, one nvcc process per
source, all started together.  Importing the package therefore needs
neither nvcc nor a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "repro_torch"
SOURCES = ("bitonic", "batched", "partition")

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# C signatures: every entry returns cudaGetLastError() as an int.
_SIGNATURES = {
    "bitonic": {
        "rt_sort_rows": (_I, _P, _P, _LL, _I, _P),
        "rt_merge_pairs": (_I, _P, _LL, _LL, _I, _I, _P),
        "rt_sort_pairs_rows": (_I, _I, _I, _P, _P, _P, _P, _P, _P, _LL, _I, _P),
    },
    "batched": {
        "rt_batched_row_sort": (_I, _I, _P, _P, _P, _LL, _I, _P),
        "rt_batched_row_sort_pairs": (_I, _I, _P, _P, _P, _P, _P, _LL, _I, _P),
    },
    "partition": {
        "rt_bucket_count_rank": (_P, _LL, _I, _P, _P, _P, _P),
        "rt_bcr_tile": (_I,),
    },
}

_lock = threading.Lock()
_libs: dict[str, ctypes.CDLL] = {}


def nvcc_path() -> str:
    for env in ("CUDA_HOME", "CUDA_PATH"):
        root = os.environ.get(env)
        if root and (Path(root) / "bin" / "nvcc").exists():
            return str(Path(root) / "bin" / "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


def _digest(name: str) -> str:
    h = hashlib.sha256()
    for path in [CSRC / f"{name}.cu", *sorted(CSRC.glob("*.cuh"))]:
        h.update(path.name.encode())
        h.update(path.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


def library_path(name: str) -> Path:
    return BUILD_DIR / f"{name}-{_digest(name)}.so"


def _start(name: str) -> "tuple[subprocess.Popen, Path, Path] | None":
    out = library_path(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    log = out.with_suffix(".log")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(
        cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
    )
    return proc, tmp, log


def _finish(name: str, started) -> None:
    if started is None:
        return
    proc, tmp, log = started
    output, _ = proc.communicate()
    log.write_text(output)
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for {name}.cu:\n{output}")
    os.replace(tmp, library_path(name))


def build_all(names=SOURCES) -> None:
    """Build every listed library that is missing, all nvcc runs at once."""
    with _lock:
        started = {name: _start(name) for name in names}
        errors = []
        for name, job in started.items():
            try:
                _finish(name, job)
            except RuntimeError as e:
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def load(name: str) -> ctypes.CDLL:
    """The bound library for ``csrc/<name>.cu``, built on first use."""
    lib = _libs.get(name)
    if lib is not None:
        return lib
    build_all((name,))
    with _lock:
        lib = _libs.get(name)
        if lib is None:
            lib = ctypes.CDLL(str(library_path(name)))
            for fn, argtypes in _SIGNATURES[name].items():
                getattr(lib, fn).argtypes = list(argtypes)
                getattr(lib, fn).restype = ctypes.c_int
            lib.rt_error_string.argtypes = [ctypes.c_int]
            lib.rt_error_string.restype = ctypes.c_char_p
            _libs[name] = lib
    return lib


def check(lib: ctypes.CDLL, code: int, what: str) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = lib.rt_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")


def build_log(name: str) -> str:
    """nvcc's output (``-Xptxas -v`` register and shared-memory report)."""
    log = library_path(name).with_suffix(".log")
    return log.read_text() if log.exists() else ""
