"""Build and load the port's CUDA kernels.

Every `tapstark_torch/csrc/*.cu` is compiled at first use, with `nvcc`, one
process per source, all started together, and linked into one shared
library with a plain C interface under `tapstark_torch/_build/` (named by a
hash of the sources and headers, so an edited file rebuilds), and bound
with ctypes. No PyTorch headers are compiled, which keeps the build to
seconds. ptxas reports each kernel's registers and spills; the report is
kept beside the library and read back with it (`build_info["ptxas"]`).
The quotient's kernels are generated per AIR (`air/codegen.py`) and built
by `compile_library` into libraries of their own, recorded under
`build_info["quotient"]`. A failed build raises.
"""

from __future__ import annotations

import concurrent.futures
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
    "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
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


_ptr, _i32, _u32, _i64 = ctypes.c_void_p, ctypes.c_int, ctypes.c_uint32, ctypes.c_longlong
# the C interface: name -> (argument types, result type)
SIGNATURES = {
    "tapstark_field_constants": ([_ptr], None),
    "tapstark_sha256_constants": ([_ptr], _i32),
    "tapstark_sha256_tiling": ([_ptr], None),
    "tapstark_tapleaf_subtrees": ([_ptr, _ptr, _ptr, _i32, _i32, _i32, _i32, _ptr, _i64, _i64, _ptr], _i32),
    "tapstark_tapbranch_levels": ([_ptr, _i64, _i64, _i32, _i32, _i32, _i32, _ptr, _i64, _i64, _ptr], _i32),
    "tapstark_ntt_cols_max_log_r": ([], _i32),
    "tapstark_dif_cols": ([_ptr, _ptr, _ptr, _i32, _i64, _ptr], _i32),
    "tapstark_dif_last": ([_ptr, _ptr, _i64, _i64, _ptr, _ptr, _ptr, _u32, _i32, _i32, _i32, _i32, _ptr], _i32),
    "tapstark_dit_cols": ([_ptr, _ptr, _ptr, _i32, _i64, _ptr], _i32),
    "tapstark_dit_first": ([_ptr, _i64, _i64, *[_ptr] * 6, _i32, _i32, _i32, _i32, _i32, _ptr], _i32),
    "tapstark_matmul_constants": ([_ptr], _i32),
    "tapstark_mod_matmul": ([_ptr, _ptr, _ptr, _i64, _ptr, _i32, _i64, _i32, _ptr], _i32),
    "tapstark_bitrev_cols": ([_ptr, _i32, _i32, _ptr, _ptr], _i32),
    "tapstark_transcript_constants": ([_ptr], None),
    "tapstark_transcript_step": ([_ptr, _ptr, _i32, _ptr, _i32, _i64, _i64, _i32, _ptr, _ptr], _i32),
}


def _bind(lib: ctypes.CDLL) -> None:
    for name in SIGNATURES:
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = SIGNATURES[name]


def _check_constants(lib: ctypes.CDLL) -> None:
    """The kernels' baked constants against the host's."""
    from .hashes import sha256_device as sd
    from .hashes.sha256_device import _K, _tapbranch_block2_round_consts, tag_midstate_words
    from .poly.cols_ntt import MAX_LOG_R
    from .poly.matmul_ntt import byte_shift_consts_mont

    consts = (ctypes.c_uint32 * 2)()
    lib.tapstark_field_constants(consts)
    if (consts[0], consts[1]) != (P, MU):
        raise RuntimeError(f"kernel field constants {tuple(consts)} != (P, MU)")
    sha = (ctypes.c_uint32 * 136)()
    err = lib.tapstark_sha256_constants(sha)
    if err != 0:
        raise RuntimeError(f"reading the SHA-256 kernel constants: CUDA error {err}")
    want = [*tag_midstate_words(b"TapBranch"), *_tapbranch_block2_round_consts(), *_K]
    if list(sha) != [int(x) for x in want]:
        raise RuntimeError("SHA-256 kernel constants differ from the host's")
    tiling = (ctypes.c_int * 4)()
    lib.tapstark_sha256_tiling(tiling)
    if (tiling[1], tiling[3]) != (sd.LEAF_LEVELS, sd.MAX_TILE_LEVELS) or sd.BRANCH_LEVELS > tiling[3]:
        raise RuntimeError(f"SHA-256 kernel tiling {list(tiling)} differs from sha256_device's")
    mm = (ctypes.c_uint32 * 9)()
    err = lib.tapstark_matmul_constants(mm)
    if err != 0:
        raise RuntimeError(f"reading the limb-matmul kernel constants: CUDA error {err}")
    if list(mm) != [P, MU, *(int(c) for c in byte_shift_consts_mont())]:
        raise RuntimeError(f"limb-matmul kernel constants {list(mm)} differ from the host's")
    if lib.tapstark_ntt_cols_max_log_r() != MAX_LOG_R:
        raise RuntimeError("column-NTT kernel's largest log R differs from cols_ntt.MAX_LOG_R")
    from .field.constants import R2_MOD_P
    from .hashes.blake3 import IV

    tr = (ctypes.c_uint32 * 9)()
    lib.tapstark_transcript_constants(tr)
    if list(tr) != [R2_MOD_P, *IV]:
        raise RuntimeError(f"transcript kernel constants {list(tr)} differ from the host's")


def compile_library(srcs: list[str], so_path: str, flags: list[str] = ()) -> list[float]:
    """nvcc each source (one process each, all at once, with `flags` after
    NVCC_FLAGS), link them into so_path; what ptxas reported goes to
    `so_path`.ptxas.txt. Returns each source's nvcc seconds."""
    objs = [f"{so_path}.{os.getpid()}.{i}.o" for i in range(len(srcs))]

    def nvcc(src: str, obj: str):
        t0 = time.perf_counter()
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, *flags, "-c", "-o", obj, src], capture_output=True, text=True)
        return proc, time.perf_counter() - t0

    with concurrent.futures.ThreadPoolExecutor(max_workers=len(srcs)) as pool:
        runs = list(pool.map(nvcc, srcs, objs))
    ptxas = ""
    for src, (p, _) in zip(srcs, runs):
        if p.returncode != 0:
            raise RuntimeError(f"nvcc failed on {src} ({p.returncode}):\n{p.stderr}")
        ptxas += p.stdout + p.stderr
    tmp = f"{so_path}.{os.getpid()}.tmp"
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS[:2], "-shared", "-o", tmp, *objs], capture_output=True, text=True)
    for o in objs:
        os.remove(o)
    if proc.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({proc.returncode}):\n{proc.stderr}")
    with open(f"{tmp}.ptxas.txt", "w") as f:
        f.write(ptxas)
    os.replace(f"{tmp}.ptxas.txt", f"{so_path}.ptxas.txt")  # before the library: it implies the report
    os.replace(tmp, so_path)
    return [seconds for _, seconds in runs]


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
        compile_library(srcs, so_path)
    with open(f"{so_path}.ptxas.txt") as f:
        ptxas = f.read()
    lib = ctypes.CDLL(so_path)
    _bind(lib)
    _check_constants(lib)
    build_info.update(
        path=so_path, sources=srcs, built=built, seconds=time.perf_counter() - t0, ptxas=ptxas
    )
    _lib = lib
    return lib
