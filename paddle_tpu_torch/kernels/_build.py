"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into a
shared library with a plain C interface, at first use, into
``kernels/_build/`` (ignored by git).  The library name carries a hash of
the source, the shared headers (``csrc/*.cuh``) and the flags, so an
edited source or header rebuilds and a stale build is never loaded.
Libraries are loaded with ``ctypes``; every exported function declares
its ``argtypes`` and ``restype`` here.  ``install`` puts a library built
on another host (the AOT store's copy, serving/aot.py) in place, after
which ``load`` finds it and compiles nothing.

Nothing is compiled or loaded when this module is imported.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
import zlib
from pathlib import Path
from typing import Dict, Iterable, List

__all__ = ["NVCC_FLAGS", "build", "install", "library_key", "load"]

_HERE = Path(__file__).resolve().parent
_CSRC = _HERE / "csrc"
_BUILD = _HERE / "_build"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC")

_P = ctypes.c_void_p
_I = ctypes.c_int
_L = ctypes.c_longlong
_F = ctypes.c_float

# C signatures of the exported entry points, per source
_SIGNATURES = {
    "decode_attention": {
        "decode_attention_launch": (
            [_P, _P, _P, _P, _P,            # q, k, v, seq_lens, out
             _P, _P,                        # split workspace or null
             _I, _I, _I, _I, _I, _I, _I,    # dtype, B, sq, H, KVH, S, D
             _L, _L, _L, _L, _L, _L, _L, _L, _L,   # q/k/v strides b, s, h
             _F, _I, _I, _P],               # scale, causal, split rows,
                                            # stream
            _I),
    },
    "decode_block": {
        "decode_block_row_stats": (
            [_P, _P, _L,                    # in, stats, row stride
             _I, _I, _I, _I, _F, _P],       # rows, K, dtype, rms, eps, stream
            _I),
        # a pointer to GemvArgs / AttnArgs (decode_block.py mirrors them)
        "decode_block_gemv": ([_P, _P], _I),
        "decode_block_attention": ([_P, _P], _I),
    },
    "decode_block_tp": {
        # a pointer to GemvArgs (decode_block.py mirrors it) / TpAttnArgs
        # (decode_block_tp.py mirrors it)
        "decode_block_tp_hop": ([_P, _P], _I),
        "decode_block_tp_attention": ([_P, _P], _I),
        # the dynamic shared memory a TpAttnArgs launch takes
        "decode_block_tp_attention_smem": ([_P], _L),
    },
    "flash_attention": {
        "flash_attention_fwd": (
            [_P, _P, _P, _P, _P,            # q, k, v, out, lse
             _P, _P,                        # q / k segment ids or null
             _I, _I, _I, _I, _I, _I, _I,    # dtype, B, Sq, Sk, H, KVH, D
             _L, _L, _L, _L, _L, _L, _L, _L, _L,   # q/k/v strides b, s, h
             _F, _I, _P],                   # scale, causal, stream
            _I),
        "flash_attention_bwd_dq": (
            [_P, _P, _P, _P, _P, _P, _P,    # q, k, v, dout, lse, delta, dq
             _P, _P,                        # q / k segment ids or null
             _I, _I, _I, _I, _I, _I, _I,    # dtype, B, Sq, Sk, H, KVH, D
             *[_L] * 12,                    # q/k/v/dout strides b, s, h
             _F, _I, _P],                   # scale, causal, stream
            _I),
        "flash_attention_bwd_dkv": (
            [_P, _P, _P, _P, _P, _P, _P, _P,   # q, k, v, dout, lse, delta,
                                               # dk, dv
             _P, _P,                        # q / k segment ids or null
             _I, _I, _I, _I, _I, _I, _I,    # dtype, B, Sq, Sk, H, KVH, D
             *[_L] * 12,                    # q/k/v/dout strides b, s, h
             _F, _I, _P],                   # scale, causal, stream
            _I),
    },
    "fused_norm": {
        "fused_norm_fwd": (
            [_P, _P, _P, _P, _P, _P,        # x, w, b, y, mean, rstd
             _I, _I, _I, _I, _I,            # rms, x/w dtype, rows, h
             _F, _I, _P],                   # eps, vec, stream
            _I),
        "fused_norm_bwd": (
            [_P, _P, _P, _P, _P, _P, _P, _P, _P,   # x, w, mean, rstd, g,
                                                   # dx, dw, db, part
             _I, _I, _I, _I, _I,            # rms, x/w dtype, rows, h
             _I, _I,                        # log2 threads a row, blocks
             _I, _P],                       # vec, stream
            _I),
        "fused_norm_bwd_blocks": (
            [_I, _I, _I, _I, _I],           # rms, x/w dtype, vec, long rows
            _I),
    },
    "fused_adamw": {
        "fused_adamw_launch": (
            [_P, _P, _P, _P, _P,            # p, g, m, v, low
             _I, _I, _I, _L,                # p/g/low dtype, n
             _F, _F, _F, _F, _F, _F, _F,    # lr, b1, b2, eps, wd, bc1, bc2
             _I, _P],                       # vec, stream
            _I),
    },
}

_loaded: Dict[str, ctypes.CDLL] = {}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found (on PATH or under CUDA_HOME/bin); "
                       "the port's CUDA kernels are built at first use")


def library_key(name: str) -> str:
    """The 16 hex digits in the name of ``csrc/<name>.cu``'s library: a
    hash of the source, the shared headers and the flags."""
    src = (_CSRC / f"{name}.cu").read_bytes()
    # the shared headers too: an edited header rebuilds every source
    for header in sorted(_CSRC.glob("*.cuh")):
        src += header.read_bytes()
    key = hashlib.sha256(src + " ".join(NVCC_FLAGS).encode()).hexdigest()
    return key[:16]


def _library_path(name: str) -> Path:
    return _BUILD / f"lib{name}-{library_key(name)}.so"


def install(name: str, payload: bytes, crc: int) -> bool:
    """Put a library built elsewhere (the AOT store's copy) where
    :func:`load` finds it, so that ``load(name)`` runs no ``nvcc``.
    ``payload`` must match its ``crc32``; it is written to a temporary
    file, synced and renamed into place, and only when no library of
    this key is there yet.  Returns True when it wrote the file."""
    if zlib.crc32(payload) != crc:
        raise ValueError(f"library {name}: payload fails its crc32 "
                         f"check; nothing installed")
    out = _library_path(name)
    if out.exists():
        return False
    _BUILD.mkdir(exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp")
    with open(tmp, "wb") as f:
        f.write(payload)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, out)     # atomic: a reader sees all of it or none
    return True


def build(names: Iterable[str]) -> Dict[str, float]:
    """Compile every library in ``names`` that is not built yet, one
    ``nvcc`` per source, all started together.  Returns the wall seconds
    each compile took (absent for libraries already built); raises with
    the compiler's output when one fails."""
    _BUILD.mkdir(exist_ok=True)
    jobs: List[tuple] = []
    for name in names:
        out = _library_path(name)
        if out.exists():
            continue
        tmp = out.with_suffix(f".{os.getpid()}.tmp")
        cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp),
               str(_CSRC / f"{name}.cu")]
        proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                stderr=subprocess.STDOUT, text=True)
        jobs.append((name, out, tmp, proc, time.perf_counter()))
    seconds: Dict[str, float] = {}
    failures = []
    for name, out, tmp, proc, t0 in jobs:
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failures.append(f"nvcc failed for {name}.cu "
                            f"(exit {proc.returncode}):\n{log}")
            tmp.unlink(missing_ok=True)
        else:
            os.replace(tmp, out)     # atomic: concurrent builds agree
    if failures:
        raise RuntimeError("\n".join(failures))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, building it first if
    needed."""
    lib = _loaded.get(name)
    if lib is not None:
        return lib
    build([name])
    lib = ctypes.CDLL(str(_library_path(name)))
    for fn_name, (argtypes, restype) in _SIGNATURES[name].items():
        fn = getattr(lib, fn_name)
        fn.argtypes = argtypes
        fn.restype = restype
    _loaded[name] = lib
    return lib
