"""Build the CUDA kernels with nvcc at first use and load them with ctypes.

Each ``csrc/*.cu`` compiles into its own shared library with a plain C
interface (no PyTorch headers), for ``sm_90a``::

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -fmad=false
         -shared -Xcompiler -fPIC -Xptxas -v -o lib<name>.so csrc/<name>.cu

All sources are compiled in parallel (one nvcc process each, started
together) into ``build/repro_torch/<hash>/`` under the repository root,
where the hash covers every file in ``csrc/``: an unchanged checkout reuses
its libraries, an edited one rebuilds. ``-fmad=false`` keeps every multiply
and add separately rounded, as in the plain torch versions. The ptxas
report (registers, shared memory, spills) of each build is kept in
``BuildCache.logs``.

Nothing here runs at import: the build starts inside the CUDA branch of a
wrapper. A missing nvcc is an error, never a fallback.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path

__all__ = ["CSRC", "SOURCES", "BuildCache", "BUILD", "nvcc_path"]

CSRC = Path(__file__).resolve().parent.parent / "csrc"
SOURCES = ("cd_epoch", "fused_ws", "csc_score")
_REPO_ROOT = Path(__file__).resolve().parents[3]
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-fmad=false", "-lineinfo", "-shared", "-Xcompiler", "-fPIC",
              "-Xptxas", "-v"]


def nvcc_path() -> str:
    """The nvcc to build with: on PATH, else the CUDA toolkit's default."""
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("repro_torch: nvcc not found (PATH or "
                       "/usr/local/cuda/bin); the CUDA kernels cannot be "
                       "built")


def _source_hash() -> str:
    h = hashlib.sha256()
    for f in sorted(CSRC.iterdir()):
        if f.suffix in (".cu", ".cuh"):
            h.update(f.name.encode())
            h.update(f.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return h.hexdigest()[:16]


class BuildCache:
    """Builds every source once per process and hands out loaded
    libraries. ``logs`` maps a source name to its nvcc/ptxas output (empty
    when the library came from an earlier build)."""

    def __init__(self, build_root: Path | None = None):
        self.build_root = build_root or (_REPO_ROOT / "build" / "repro_torch")
        self.logs: dict[str, str] = {}
        self._libs: dict[str, ctypes.CDLL] = {}

    def build_all(self) -> dict[str, Path]:
        """Compile every source that has no library yet, all in parallel."""
        out_dir = self.build_root / _source_hash()
        out_dir.mkdir(parents=True, exist_ok=True)
        paths = {name: out_dir / f"lib{name}.so" for name in SOURCES}
        todo = [name for name, path in paths.items() if not path.exists()]
        if todo:
            nvcc = nvcc_path()
            procs = {}
            for name in todo:
                tmp = out_dir / f"lib{name}.{os.getpid()}.tmp.so"
                cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-o", str(tmp),
                       str(CSRC / f"{name}.cu")]
                procs[name] = (tmp, subprocess.Popen(
                    cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                    text=True))
            failed = []
            for name, (tmp, proc) in procs.items():
                log, _ = proc.communicate()
                self.logs[name] = log
                if proc.returncode != 0:
                    failed.append(f"{name}.cu (rc {proc.returncode}):\n{log}")
                else:
                    os.replace(tmp, paths[name])
            if failed:
                raise RuntimeError("repro_torch: nvcc failed for "
                                   + "\n".join(failed))
        return paths

    def lib(self, name: str) -> ctypes.CDLL:
        """The loaded library of ``csrc/<name>.cu`` (built on first use)."""
        if name not in self._libs:
            path = self.build_all()[name]
            self._libs[name] = _declare(name, ctypes.CDLL(str(path)))
        return self._libs[name]


_P, _I, _D, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_double, \
    ctypes.c_longlong

_SIGNATURES = {
    "cd_epoch": {
        "cd_epoch_gram": [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _D, _D, _P],
        "cd_epoch_xb": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                        _I, _D, _D, _P],
    },
    "fused_ws": {
        "fused_ws": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _I, _I, _D, _D, _P],
        "ws_score": [_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _D, _D, _P],
    },
    "csc_score": {
        "csc_score": [_P, _P, _P, _P, _P, _I, _I, _P],
    },
}


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    for fn, argtypes in _SIGNATURES[name].items():
        for suffix in ("f32", "f64"):
            f = getattr(lib, f"{fn}_{suffix}")
            f.argtypes = argtypes
            f.restype = ctypes.c_int
    return lib


# the process's build cache; nothing is built until a CUDA wrapper asks
BUILD = BuildCache()
