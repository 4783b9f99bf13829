"""tapstark_torch — the PyTorch/CUDA port of tapstark.

A second package beside `tapstark/` (the JAX reference, which stays as it
is). It imports torch, and neither jax nor anything of `tapstark`. Field
arrays are int32 tensors of the same Montgomery words as the reference's
uint32 arrays, so every stage can be held word for word against it.

Copied from `tapstark` (jax-free host layers; each a verbatim copy except
where jax code was dropped or replaced): field/constants.py and scalar.py,
utils, hashes/{sha256,ripemd160,blake3}.py, script/, commit/ (Winternitz,
bit commitments, taptree, TCS, TapTreeMmcs), native/ (the C++ SHA-NI
engine, built into _build/), the host challenger, air/ (AirBuilder,
symbolic degrees) and airs/ (Fibonacci, MulAir).

Carried here as twins of modules whose reference imports jax:
  field/device.py            Montgomery BabyBear / EF4 ops on tensors
  poly/                      NTT, coset LDE routes (CUDA kernels in
                             poly/cuda_ntt.py, poly/cols_ntt.py and
                             poly/matmul_ntt.py), domains, interpolation,
                             FRI fold
  hashes/sha256_device.py    SHA-256 compressions and TapBranch nodes
                             (CUDA kernels)
  commit/device_commit.py    taptree commits where the matrices' tensors live
  air/folders.py             prover (tensor) and verifier (host) constraint folders
  fri/                       config, proof, PCS, FRI prover and verifier
  stark/                     prove, verify, proof containers, serde
  interop.py                 carry-across to and from the JAX package (tests)

Kernel sources are in csrc/, built by nvcc at first use (_build.py).
"""
