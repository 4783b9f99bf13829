"""The port's public surface against the JAX package's: every public name
of every `tapstark` module has a counterpart in the `tapstark_torch`
module of the same dotted path, and the small helpers among them equal
the JAX package's on seeded inputs.
"""

import importlib
import inspect
import pkgutil

import jax.numpy as jnp
import numpy as np
import torch

import tapstark
from tapstark.challenger import jnp_argwhere_first
from tapstark.fri.proof import get_leaf_index_by_query_index as j_leaf_index
from tapstark.hashes.blake3 import compress_scan as j_compress_scan
from tapstark.utils import reverse_slice_index_bits as j_reverse_slice_index_bits
from tapstark_torch.challenger import argwhere_first, device_tail
from tapstark_torch.fri import get_leaf_index_by_query_index
from tapstark_torch.hashes.blake3 import compress_scan
from tapstark_torch.utils import profiling, reverse_slice_index_bits

# Names of the JAX package that the port holds under another name: (the
# reference module, its name) -> (the port module, the port's name, why).
# Nothing else may stand here: no name is left out for being missing.
_JIT = "the reference's jitted twin; the port's function is eager torch"
_ROUTE = "a Pallas LDE route; the port's twin runs the CUDA kernels of the same split"
MAPPED = {
    ("tapstark.poly", "fold_matrix_jit"): ("tapstark_torch.poly", "fold_matrix", _JIT),
    ("tapstark.poly", "coset_lde_batch_jit"): ("tapstark_torch.poly", "coset_lde_batch", _JIT),
    ("tapstark.poly", "intt_jit"): ("tapstark_torch.poly", "intt", _JIT),
    ("tapstark.poly", "ntt_jit"): ("tapstark_torch.poly", "ntt", _JIT),
    ("tapstark.poly.fold", "fold_matrix_jit"): ("tapstark_torch.poly.fold", "fold_matrix", _JIT),
    ("tapstark.poly.ntt", "coset_lde_batch_jit"): ("tapstark_torch.poly.ntt", "coset_lde_batch", _JIT),
    ("tapstark.poly.ntt", "intt_jit"): ("tapstark_torch.poly.ntt", "intt", _JIT),
    ("tapstark.poly.ntt", "ntt_jit"): ("tapstark_torch.poly.ntt", "ntt", _JIT),
    ("tapstark.poly.pallas_ntt", "ntt_pallas"): ("tapstark_torch.poly.cols_ntt", "ntt_cols_fourstep", _ROUTE),
    ("tapstark.poly.pallas_ntt", "coset_lde_batch_pallas"): ("tapstark_torch.poly.cols_ntt", "coset_lde_padded",
                                                             _ROUTE),
    ("tapstark.poly.pallas_ntt", "coset_lde_batch_pallas_blocks"): ("tapstark_torch.poly.cols_ntt",
                                                                    "coset_lde_blocks", _ROUTE),
    ("tapstark.poly.pallas_ntt", "coset_lde_batch_pallas_fused"): ("tapstark_torch.poly.cuda_ntt",
                                                                   "coset_lde_batch_cuda", _ROUTE),
    ("tapstark.poly.pallas_ntt", "coset_lde_batch_pallas_nogather"): ("tapstark_torch.poly.cols_ntt",
                                                                      "coset_lde_nogather", _ROUTE),
    ("tapstark.poly.pallas_ntt", "intt_to_bitrev_pallas"): ("tapstark_torch.poly.cols_ntt", "intt_to_bitrev",
                                                            _ROUTE),
    ("tapstark.poly.pallas_ntt", "ntt_from_bitrev_pallas"): ("tapstark_torch.poly.cols_ntt", "ntt_from_bitrev",
                                                             _ROUTE),
    ("tapstark.poly.pallas_ntt", "bitrev_indices_np"): ("tapstark_torch.poly.cols_ntt", "bitrev_indices_np",
                                                        "the Pallas routes' module has no port module of its name"),
    ("tapstark.poly.matmul_ntt", "mod_matmul_fused"): ("tapstark_torch.poly.matmul_ntt", "mod_matmul",
                                                       "the Pallas limb matmul; the port's runs its CUDA kernel"),
    ("tapstark.challenger", "jnp_argwhere_first"): ("tapstark_torch.challenger", "argwhere_first",
                                                    "the port's is torch, so its name drops `jnp`"),
}


def _public_names(module) -> set:
    """The names a module defines (obj.__module__ is the module) or lists
    in its `__all__`, private ones left out."""
    names = {
        k for k, v in vars(module).items()
        if not k.startswith("_") and getattr(v, "__module__", None) == module.__name__
    }
    return names | set(getattr(module, "__all__", ()))


def test_every_public_name_has_a_counterpart():
    """Walk every module of `tapstark` and take its public names: each must
    be a name of the port's module of the same dotted path (and not a
    module where the reference's is not), or stand in MAPPED, whose port
    names must exist. MAPPED holds only names that the walk meets."""
    missing, met = [], set()
    for info in pkgutil.walk_packages(tapstark.__path__, "tapstark."):
        module = importlib.import_module(info.name)
        port_name = "tapstark_torch" + info.name[len("tapstark"):]
        try:
            port = importlib.import_module(port_name)
        except ModuleNotFoundError:
            port = None
        for name in sorted(_public_names(module)):
            key = (info.name, name)
            if key in MAPPED:
                met.add(key)
                where, twin, _ = MAPPED[key]
                obj = getattr(importlib.import_module(where), twin, None)
                if obj is None:
                    missing.append(f"{where}.{twin} (for {info.name}.{name})")
                continue
            obj = getattr(port, name, None) if port is not None else None
            if obj is None or (inspect.ismodule(obj) and not inspect.ismodule(getattr(module, name))):
                missing.append(f"{port_name}.{name}")
    assert not missing, f"public names of tapstark without a counterpart in tapstark_torch: {missing}"
    assert met == set(MAPPED), f"MAPPED entries the walk did not meet: {set(MAPPED) - met}"


def test_small_names_match_jax():
    """`compress_scan` (also under `challenger.device_tail`), the challenger's
    `argwhere_first`, `get_leaf_index_by_query_index`,
    `reverse_slice_index_bits` and `profiling.enabled` against the JAX
    package's."""
    rng = np.random.default_rng(70)
    cv = rng.integers(0, 1 << 32, (4, 3, 8), dtype=np.uint64).astype(np.uint32)
    block = rng.integers(0, 1 << 32, (4, 3, 16), dtype=np.uint64).astype(np.uint32)
    for counter, block_len, flags in ((0, 64, 11), ((1 << 32) + 5, 17, 3)):
        want = np.asarray(j_compress_scan(jnp.asarray(cv), jnp.asarray(block), counter, block_len, flags))
        got = compress_scan(torch.from_numpy(cv.view(np.int32)), torch.from_numpy(block.view(np.int32)), counter,
                            block_len, flags)
        np.testing.assert_array_equal(got.numpy().view(np.uint32), want)
    assert device_tail.compress_scan is compress_scan

    for ok in ([False, True, True], [False, False], [True], [False] * 5 + [True]):
        assert int(argwhere_first(torch.tensor(ok))) == int(jnp_argwhere_first(jnp.asarray(ok)))
    assert [get_leaf_index_by_query_index(q) for q in range(64)] == [j_leaf_index(q) for q in range(64)]
    for n in (0, 1, 2, 16):
        assert reverse_slice_index_bits(list(range(n))) == j_reverse_slice_index_bits(list(range(n)))
    was = profiling.enabled()
    try:
        profiling.enable(True)
        assert profiling.enabled()
        profiling.enable(False)
        assert not profiling.enabled()
    finally:
        profiling.enable(was)
