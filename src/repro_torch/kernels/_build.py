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
SOURCES = ("cd_epoch", "fused_ws", "csc_score", "graph_ctl")
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


_P, _I, _LL = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong

# the penalty's hyper-parameters reach the kernels as a device pointer to
# the codec vector (the _P after the penalty id), read at kernel entry
_SIGNATURES = {
    "cd_epoch": {
        "cd_epoch_gram": [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                          _P, _I, _I, _I, _P],
        "cd_epoch_xb": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                        _I, _I, _P, _I, _I, _I, _I, _I, _P],
        # the plan's (cluster, use_smem, dyn, threads, per, owners, g_whole)
        "cd_epoch_gram_block": [_P, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I,
                                _I, _I, _P, _I, _I, _I, _I, _I, _I, _I, _P],
        # the lane forms: a lane stride, the lanes' parameter rows, the
        # active-lane mask and the lane count beside the single-lane
        # arguments
        "cd_epoch_xb_lanes": [_P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P,
                              _LL, _I, _I, _I, _I, _I, _P, _I, _P, _I, _I,
                              _I, _I, _I, _I, _P],
    },
    "fused_ws": {
        "score": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P,
                  _P],
        "select": [_P, _P, _I, _I, _I, _P],
        "merge": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        "merge_lanes": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                        _I, _P],
        # the product plan's (config, bn, spans, span) after the scratch
        "fused_ws_block": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                           _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _P],
    },
    "csc_score": {
        "csc_walk": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
        # K5r's matvec: val, col, ptr, coef, base, out, rows, R, C,
        # longer, threads, nt
        "csc_row_matvec": [_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                           _P],
        # K5r's update: val, col, ptr, slot, bits, coef, base, out, rows,
        # R, kmax, longer, threads, nt, K
        "csc_row_update": [_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                           _I, _I, _I, _P],
    },
}


# entry points without an f32/f64 pair
_PLAIN_SIGNATURES = {
    "cd_epoch": {"cluster_barrier_loop": [_I, _I, _I, _P],
                 # K1l: float64 only
                 "cd_epoch_gram_lanes_f64": [_P, _LL, _LL, _LL, _P, _P, _P,
                                             _P, _P, _P, _I, _I, _I, _P, _I,
                                             _P, _I, _I, _I, _I, _P],
                 # K1bl: float64 only
                 "cd_epoch_gram_block_lanes_f64": [
                     _P, _LL, _LL, _LL, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                     _I, _P, _I, _P, _I, _I, _I, _I, _I, _I, _I, _I, _P],
                 "gram_chain_floor": [_I, _I, _I, _P, _P],
                 "gram_block_chain_floor": [_I, _I, _I, _I, _P, _P],
                 "fill_shared_memory": [_P],
                 "cluster_capacity": [_I, _I, _I, _I, _I, _I, _I, _P],
                 # K1's / K1l's attributes
                 "gram_kernel_attrs": [_I, _I, _I, _P, _P]},
    "fused_ws": {"fused_ws_product_info": [_I, _I],
                 "dmma_rate_probe": [_I, _I, _I, _I, _P, _P],
                 # the float64 product alone (the sweep, the tests)
                 "fused_ws_product_f64": [_P, _P, _P, _I, _I, _I, _I, _I, _I,
                                          _I, _P],
                 # K3 over lanes: float64 only (its product runs on DMMA)
                 "fused_ws_lanes_f64": [_P, _P, _P, _P, _I, _P, _P, _P, _P,
                                        _P, _P, _P, _I, _I, _I, _I, _I, _I,
                                        _I, _I, _I, _I, _I, _P, _I, _P],
                 # K3g, K3l's gather of the lanes' rows: float64 only
                 "ws_gather_f64": [_P, _P, _P, _P, _I, _I, _I, _I, _P, _P],
                 # K3b over lanes of blocks: float64 only, as K3l
                 "fused_ws_block_lanes_f64": [
                     _P, _P, _P, _P, _I, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                     _I, _I, _I, _I, _I, _I, _I, _I, _I, _I, _P, _I, _P]},
    "csc_score": {"l2_gather_probe": [_P, _I, _I, _LL, _I, _P, _P],
                  # K5r's update's slot map and its bitmap
                  "csc_slot_map": [_P, _P, _P, _I, _I, _P]},
    "graph_ctl": {"cond_begin": [_P, _P, _I, _P, _P],
                  "cond_end": [_P, ctypes.c_ulonglong, _P],
                  "runtime_version": []},
}


def _declare(name: str, lib: ctypes.CDLL) -> ctypes.CDLL:
    fns = [(f"{fn}_{suffix}", argtypes)
           for fn, argtypes in _SIGNATURES.get(name, {}).items()
           for suffix in ("f32", "f64")]
    fns += list(_PLAIN_SIGNATURES.get(name, {}).items())
    for fn, argtypes in fns:
        f = getattr(lib, fn)
        f.argtypes = argtypes
        f.restype = ctypes.c_int
    return lib


# the process's build cache; nothing is built until a CUDA wrapper asks
BUILD = BuildCache()
