"""Build the hand-written CUDA kernels at first use and bind them with ctypes.

Every ``csrc/*.cu`` is compiled by its own ``nvcc`` process (all started
together) for ``sm_90a`` and linked into one shared library with a plain C
interface. The library lands in ``build/repro_torch_kernels/<hash>/`` under
the repository root, keyed by a hash of the sources, the shared headers
(``csrc/*.cuh``) and the flags, so a changed source or header rebuilds and
an unchanged tree loads at once. The build runs only on
a machine with the CUDA toolkit: nothing on the CPU path calls it.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import tempfile
import threading
from pathlib import Path
from typing import List, Optional

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_ROOT = Path(__file__).resolve().parents[3] / "build" / "repro_torch_kernels"
LIB_NAME = "librepro_torch_kernels.so"
GENCODE = ["-gencode", "arch=compute_90a,code=sm_90a"]
CFLAGS = ["-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

_P, _I, _LL, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong, ctypes.c_float
# argtypes of every C entry point; pointers and the stream are c_void_p so
# ctypes does not cut them to 32 bits
SIGNATURES = {
    "repro_rmsnorm_f32": [_P, _P, _P, _LL, _I, _F, _P],
    "repro_rmsnorm_bf16": [_P, _P, _P, _LL, _I, _F, _P],
    "repro_flash_fwd_f32": [_P] * 6 + [_I] * 6 + [_LL] * 9 + [_I, _I, _F, _P],
    "repro_flash_fwd_bf16": [_P] * 6 + [_I] * 6 + [_LL] * 9 + [_I, _I, _F, _P],
    "repro_flash_decode_bf16": [_P] * 6 + [_I] * 6 + [_LL] * 9 + [_I, _I, _F, _P]
                               + [_P, _P, _I, _I],
    "repro_flash_bwd_dq_f32": [_P] * 7 + [_I] * 6 + [_I, _I, _F, _P],
    "repro_flash_bwd_dq_bf16": [_P] * 7 + [_I] * 6 + [_I, _I, _F, _P],
    "repro_flash_bwd_dkv_f32": [_P] * 8 + [_I] * 6 + [_I, _I, _F, _P],
    "repro_flash_bwd_dkv_bf16": [_P] * 8 + [_I] * 6 + [_I, _I, _F, _P],
    "repro_moe_gmm_f32": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bf16": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bf16_tc": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bf16_decode": [_P, _P, _P, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bwd_bf16_tc": [_P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bwd_bf16": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_moe_gmm_bwd_f32": [_P, _P, _P, _I, _I, _I, _I, _I, _P],
    "repro_ssd_scan_f32": [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_P],
    "repro_ssd_scan_bf16": [_P] * 7 + [_I] * 6 + [_LL] * 12 + [_P] + [_P, _I],
    "repro_ssd_scan_bwd_f32": [_P] * 13 + [_I] * 6 + [_LL] * 15 + [_P],
    "repro_ssd_scan_bwd_bf16": [_P] * 17 + [_I] * 6 + [_LL] * 15 + [_P, _I],
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> List[Path]:
    """Everything the library is built from: the ``.cu`` files nvcc compiles
    and the ``.cuh`` headers they include."""
    return sorted([*CSRC.glob("*.cu"), *CSRC.glob("*.cuh")])


def source_hash() -> str:
    h = hashlib.sha256(" ".join(GENCODE + CFLAGS).encode())
    for src in sources():
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels build only where the "
                       "CUDA toolkit is installed")


def build() -> Path:
    """Compile and link the kernels unless this hash is built; → the .so path.

    Concurrent builds each work in their own temporary directory and
    publish with an atomic rename. The compiler's output (``-Xptxas -v``:
    registers, shared memory, spills) is kept in ``build.log`` beside it.
    """
    out_dir = BUILD_ROOT / source_hash()
    lib = out_dir / LIB_NAME
    if lib.exists():
        return lib
    out_dir.mkdir(parents=True, exist_ok=True)
    compiler = nvcc()
    with tempfile.TemporaryDirectory(dir=out_dir) as tmp:
        jobs = []
        for src in (s for s in sources() if s.suffix == ".cu"):
            obj = Path(tmp) / f"{src.stem}.o"
            cmd = [compiler, *GENCODE, *CFLAGS, "-c", str(src), "-o", str(obj)]
            jobs.append((src, obj, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)))
        log, failed = [], []
        for src, _, proc in jobs:
            out, _ = proc.communicate()
            log.append(f"== {src.name} (exit {proc.returncode})\n{out}")
            if proc.returncode != 0:
                failed.append(src.name)
        if failed:
            raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
        tmp_lib = Path(tmp) / LIB_NAME
        link = subprocess.run(
            [compiler, *GENCODE, "-shared", *(str(o) for _, o, _ in jobs),
             "-o", str(tmp_lib)], stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True)
        log.append(f"== link (exit {link.returncode})\n{link.stdout}")
        if link.returncode != 0:
            raise RuntimeError("linking the kernels failed:\n" + "\n".join(log))
        (out_dir / "build.log").write_text("\n".join(log))
        os.replace(tmp_lib, lib)
    return lib


def library() -> ctypes.CDLL:
    """The kernels' shared library, built on first call and loaded once."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.repro_cuda_error_string.argtypes = [ctypes.c_int]
            lib.repro_cuda_error_string.restype = ctypes.c_char_p
            lib.repro_last_error_note.argtypes = []
            lib.repro_last_error_note.restype = ctypes.c_char_p
            _lib = lib
    return _lib


def check(err: int, kernel: str) -> None:
    """Raise if a C entry point returned an error, with the note it left on
    this thread: the check, tensor map (and libcuda's CUresult) or launch
    that failed, or an earlier call's error found pending before the launch."""
    if err != 0:
        lib = library()
        msg = lib.repro_cuda_error_string(err).decode()
        note = lib.repro_last_error_note().decode()
        raise RuntimeError(f"{kernel}: CUDA error {err} ({msg})" + (f": {note}" if note else ""))
