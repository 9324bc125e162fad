"""Build and load the port's CUDA kernels.

Each source under ``kernels/csrc`` is compiled by ``nvcc`` for Hopper
(``sm_90a``) into a shared library with a plain C interface, loaded with
``ctypes``. The library's name carries a hash of its source and of the
headers under ``csrc`` (``*.cuh``), so an edited source or header builds
anew and an unchanged one is built once per checkout. The
output goes to ``kernels/_build/`` (listed in ``.gitignore``). ``build``
starts one ``nvcc`` per missing library, all at once, and raises if any
fails. Nothing here runs at import: the CPU tests import every module of
the package on machines without ``nvcc``.
"""

from __future__ import annotations

import hashlib
import os
import shutil
import threading
from typing import Dict, Iterable, Optional

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC_DIR = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")

# kernel library -> its source under csrc/
SOURCES: Dict[str, str] = {
    "ell_matvec": "ell_matvec.cu",
    "ell_scatter_add": "ell_scatter_add.cu",
    "fused": "fused.cu",
    "colsort": "colsort.cu",
    "lab": "lab.cu",
}

NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
    "-Xptxas", "-v",
)

_lock = threading.Lock()
_loaded: Dict[str, object] = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    path = os.path.join(cuda_home, "bin", "nvcc")
    if os.path.exists(path):
        return path
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels cannot be "
        "built"
    )


def library_path(name: str) -> str:
    """``_build/lib<name>-<hash>.so``, the hash over the library's source,
    every header under ``csrc/`` (any source may include any of them) and
    the compiler flags."""
    digest = hashlib.sha256()
    headers = sorted(f for f in os.listdir(CSRC_DIR) if f.endswith(".cuh"))
    for source in (SOURCES[name], *headers):
        with open(os.path.join(CSRC_DIR, source), "rb") as f:
            digest.update(source.encode() + b"\0" + f.read() + b"\0")
    digest.update(" ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}-{digest.hexdigest()[:16]}.so")


def build(names: Optional[Iterable[str]] = None) -> Dict[str, str]:
    """Build every named library that is not built yet (all by default),
    one ``nvcc`` each, in parallel. Returns {name: library path}; the
    compiler's output (``-Xptxas -v``: registers, spills) is kept beside
    each library as ``.log``."""
    import subprocess

    names = list(SOURCES if names is None else names)
    paths = {name: library_path(name) for name in names}
    missing = [n for n in names if not os.path.exists(paths[n])]
    if not missing:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = _nvcc()
    procs = {}
    for name in missing:
        tmp = f"{paths[name]}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (
            tmp,
            subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True
            ),
        )
    failed = []
    for name, (tmp, proc) in procs.items():
        output, _ = proc.communicate()
        with open(paths[name][: -len(".so")] + ".log", "w") as f:
            f.write(output)
        if proc.returncode != 0:
            failed.append(f"{name} (nvcc exit {proc.returncode}):\n{output}")
            if os.path.exists(tmp):
                os.remove(tmp)
        else:
            os.replace(tmp, paths[name])
    if failed:
        raise RuntimeError("CUDA kernel build failed: " + "\n".join(failed))
    return paths


def build_log(name: str) -> str:
    """The compiler's output from building ``name`` (empty if absent)."""
    log = library_path(name)[: -len(".so")] + ".log"
    if not os.path.exists(log):
        return ""
    with open(log) as f:
        return f.read()


def load(name: str):
    """The ``ctypes.CDLL`` of kernel library ``name``, built at first use."""
    with _lock:
        lib = _loaded.get(name)
        if lib is None:
            import ctypes

            lib = ctypes.CDLL(build([name])[name])
            lib.photon_cuda_error_string.argtypes = [ctypes.c_int]
            lib.photon_cuda_error_string.restype = ctypes.c_char_p
            _loaded[name] = lib
        return lib


def check(lib, code: int, what: str) -> None:
    """Raise if a kernel entry point returned a CUDA error."""
    if code != 0:
        msg = lib.photon_cuda_error_string(code).decode()
        raise RuntimeError(f"{what}: CUDA error {code} ({msg})")
