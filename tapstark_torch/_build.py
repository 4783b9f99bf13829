"""Build and load the port's CUDA kernels.

Every `tapstark_torch/csrc/*.cu` is compiled at first use, with `nvcc`, into
one shared library with a plain C interface under `tapstark_torch/_build/`
(named by a hash of the sources and headers, so an edited file rebuilds), and bound
with ctypes. No PyTorch headers are compiled, which keeps the build to
seconds. A failed build raises.
"""

from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import time

from .field.constants import MU, P

_HERE = os.path.dirname(os.path.abspath(__file__))
CSRC = os.path.join(_HERE, "csrc")
BUILD_DIR = os.path.join(_HERE, "_build")
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
]

_lib = None
build_info: dict = {}


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: the CUDA kernels cannot be built")


def sources() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cu")))


def headers() -> list[str]:
    return sorted(glob.glob(os.path.join(CSRC, "*.cuh")))


def _bind(lib: ctypes.CDLL) -> None:
    ptr, i32, u32, i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
    lib.tapstark_lde_constants.argtypes = [ptr]
    lib.tapstark_lde_constants.restype = None
    lib.tapstark_lde_inverse.argtypes = [ptr, ptr, ptr, i32, i32, u32, ptr]
    lib.tapstark_lde_inverse.restype = i32
    lib.tapstark_lde_forward.argtypes = [ptr, ptr, ptr, ptr, ptr, i32, i32, i32, ptr]
    lib.tapstark_lde_forward.restype = i32
    lib.tapstark_sha256_constants.argtypes = [ptr]
    lib.tapstark_sha256_constants.restype = i32
    lib.tapstark_sha256_compress.argtypes = [
        ptr, i64, i64, i64, ptr, i64, ptr, i32, i32, ptr, ptr,
    ]
    lib.tapstark_sha256_compress.restype = i32
    lib.tapstark_tapbranch.argtypes = [ptr, i64, i64, ptr, i64, i64, i64, ptr, ptr]
    lib.tapstark_tapbranch.restype = i32
    lib.tapstark_ntt_cols_max_log_r.argtypes = []
    lib.tapstark_ntt_cols_max_log_r.restype = i32
    lib.tapstark_ntt_cols.argtypes = [ptr, ptr, ptr, i32, i64, i32, ptr]
    lib.tapstark_ntt_cols.restype = i32
    lib.tapstark_matmul_constants.argtypes = [ptr]
    lib.tapstark_matmul_constants.restype = i32
    lib.tapstark_limb_matmul.argtypes = [ptr, ptr, ptr, ptr, i32, i64, ptr]
    lib.tapstark_limb_matmul.restype = i32


def _check_constants(lib: ctypes.CDLL) -> None:
    """The kernels' baked constants against the host's."""
    from .hashes.sha256_device import _K, _tapbranch_block2_round_consts, tag_midstate_words
    from .poly.cols_ntt import MAX_LOG_R
    from .poly.matmul_ntt import shift_consts_mont

    consts = (ctypes.c_uint32 * 2)()
    lib.tapstark_lde_constants(consts)
    if (consts[0], consts[1]) != (P, MU):
        raise RuntimeError(f"kernel field constants {tuple(consts)} != (P, MU)")
    sha = (ctypes.c_uint32 * 136)()
    err = lib.tapstark_sha256_constants(sha)
    if err != 0:
        raise RuntimeError(f"reading the SHA-256 kernel constants: CUDA error {err}")
    want = [*tag_midstate_words(b"TapBranch"), *_tapbranch_block2_round_consts(), *_K]
    if list(sha) != [int(x) for x in want]:
        raise RuntimeError("SHA-256 kernel constants differ from the host's")
    mm = (ctypes.c_uint32 * 11)()
    err = lib.tapstark_matmul_constants(mm)
    if err != 0:
        raise RuntimeError(f"reading the limb-matmul kernel constants: CUDA error {err}")
    if list(mm) != [P, MU, *(int(c) for c in shift_consts_mont())]:
        raise RuntimeError(f"limb-matmul kernel constants {list(mm)} differ from the host's")
    if lib.tapstark_ntt_cols_max_log_r() != MAX_LOG_R:
        raise RuntimeError("column-NTT kernel's largest log R differs from cols_ntt.MAX_LOG_R")


def load_library() -> ctypes.CDLL:
    """Compile (once per source hash) and load the kernel library."""
    global _lib
    if _lib is not None:
        return _lib
    srcs = sources()
    h = hashlib.sha256()
    for path in srcs + headers():
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(NVCC_FLAGS).encode())
    os.makedirs(BUILD_DIR, exist_ok=True)
    so_path = os.path.join(BUILD_DIR, f"libtapstark_torch_{h.hexdigest()[:16]}.so")
    t0 = time.perf_counter()
    built = not os.path.exists(so_path)
    if built:
        tmp = f"{so_path}.{os.getpid()}.tmp"
        proc = subprocess.run(
            [_nvcc(), *NVCC_FLAGS, "-o", tmp, *srcs], capture_output=True, text=True
        )
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed ({proc.returncode}):\n{proc.stderr}")
        os.replace(tmp, so_path)
    lib = ctypes.CDLL(so_path)
    _bind(lib)
    _check_constants(lib)
    build_info.update(
        path=so_path, sources=srcs, built=built, seconds=time.perf_counter() - t0
    )
    _lib = lib
    return lib
