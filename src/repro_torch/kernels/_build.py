"""Build the CUDA sources in ``csrc/`` at first use and load them.

Each ``csrc/<name>.cu`` is compiled on its own by ``nvcc`` for ``sm_90a``
into a shared library with a plain C interface, loaded with ``ctypes``
(seconds per source; a build that includes PyTorch's headers takes
minutes). Libraries go to ``build/kernels/`` at the repository root
(listed in ``.gitignore``) under a name that carries the source's hash, so
an edited source (or header, ``csrc/*.cuh``) is rebuilt and an unchanged
one is loaded as it is. Only
the sources in this package are built. ``build_all`` starts one ``nvcc`` per source at once and waits for
all of them.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC"]

#: ctypes signature of each source's one C entry point: (symbol, argtypes);
#: pointers and the stream are c_void_p, sizes c_int, scales c_float, the
#: result is the launch's cudaError_t.
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
ENTRY_POINTS = {
    # x, w, thr, out, M, N, K, S, block_m, block_n, flags, stream
    "threshold_matmul": ("threshold_matmul_launch",
                         [_P, _P, _P, _P] + [_I] * 7 + [_P]),
    # x, w, thr, out, N, HP, WP, C, F, K, stride, out_h, out_w, block_h, S,
    # block_n, pixel stride, weight chunk, samples per block, flags, stream
    "conv_threshold": ("conv_threshold_launch",
                       [_P, _P, _P, _P] + [_I] * 16 + [_P]),
    # x, out, host arrays of weight and bank pointers, dims, steps,
    # stages, M, cluster, row tile, residency flags, shared memory, stream
    "mlp_megakernel": ("mlp_megakernel_launch",
                       [_P] * 6 + [_I] * 6 + [_P]),
    # q, k, v, out, lse (or null), 11 sizes and flags, host array of 12
    # strides, stream
    "flash_attention": ("flash_attention_launch",
                        [_P] * 5 + [_I] * 11 + [_P, _P]),
    # q, k, v, out, lse, d_out, dq, dk, dv, float32 workspace, 11 sizes
    # and flags, host array of 24 strides, stream
    "flash_attention_bwd": ("flash_attention_bwd_launch",
                            [_P] * 10 + [_I] * 11 + [_P, _P]),
    # acc, thr, out, M, C, S, channels per block (0: linear), stream
    "multi_threshold": ("multi_threshold_launch",
                        [_P, _P, _P] + [_I] * 4 + [_P]),
    # x, w, scale (or null), bias (or null), out, M, N, K, relu, requant,
    # acc_out, 1 / out_scale, tile, stream
    "qmatmul": ("qmatmul_launch",
                [_P] * 5 + [_I] * 6 + [_F, _I, _P]),
    # x, w, b, out, M, N, K, in_scale, stream
    "float_head": ("float_head_launch", [_P] * 4 + [_I] * 3 + [_F, _P]),
}

_LOCK = threading.Lock()
_LOADED: Dict[str, ctypes._CFuncPtr] = {}


def nvcc_path() -> str:
    cuda_home = os.environ.get("CUDA_HOME", "/usr/local/cuda")
    for cand in (os.path.join(cuda_home, "bin", "nvcc"), shutil.which("nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels "
                       "are built on the machine that has the card")


def _lib_path(name: str) -> Path:
    """Where the library of ``csrc/<name>.cu`` goes: its name carries a
    digest of the source, of every header in ``csrc/`` (any source may
    include one) and of the flags, so an edit to any of them rebuilds."""
    h = hashlib.sha256((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.name.encode() + b"\0" + header.read_bytes())
    h.update(" ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"{name}-{h.hexdigest()[:16]}.so"


def _start(name: str) -> Optional[subprocess.Popen]:
    """Start nvcc for one source unless its library is already built."""
    lib = _lib_path(name)
    if lib.exists():
        return None
    lib.parent.mkdir(parents=True, exist_ok=True)
    tmp = lib.with_suffix(f".{os.getpid()}.tmp")
    cmd = [nvcc_path(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    proc.lib, proc.tmp = lib, tmp
    return proc


def _finish(name: str, proc: Optional[subprocess.Popen]) -> None:
    if proc is None:
        return
    out, _ = proc.communicate()
    if proc.returncode != 0:
        if proc.tmp.exists():
            proc.tmp.unlink()
        raise RuntimeError(f"nvcc failed for {name}.cu "
                           f"(exit {proc.returncode}):\n{out}")
    os.replace(proc.tmp, proc.lib)


def build_all(names: Optional[Iterable[str]] = None) -> List[Path]:
    """Build every listed source (default: all), one nvcc each, in
    parallel; returns the library paths."""
    names = list(ENTRY_POINTS if names is None else names)
    with _LOCK:
        procs = [(n, _start(n)) for n in names]
        try:
            for n, p in procs:
                _finish(n, p)
        finally:
            for _, p in procs:
                if p is not None and p.poll() is None:
                    p.kill()
                    p.wait()
    return [_lib_path(n) for n in names]


def entry_point(name: str):
    """The ctypes function of ``csrc/<name>.cu``, built on first use."""
    fn = _LOADED.get(name)
    if fn is not None:
        return fn
    (lib_path,) = build_all([name])
    symbol, argtypes = ENTRY_POINTS[name]
    with _LOCK:
        fn = _LOADED.get(name)
        if fn is None:
            fn = getattr(ctypes.CDLL(str(lib_path)), symbol)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _LOADED[name] = fn
    return fn
