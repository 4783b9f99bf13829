"""tapstark_torch — the PyTorch/CUDA port of tapstark.

A second package beside `tapstark/` (the JAX reference, which stays as it
is). It imports torch, and neither jax nor anything of `tapstark`. Field
arrays are int32 tensors of the same Montgomery words as the reference's
uint32 arrays, so every stage can be held word for word against it.

Copied from `tapstark` (jax-free host layers; each a verbatim copy except
where jax code was dropped or replaced): field/constants.py and scalar.py,
utils, hashes/{sha256,ripemd160,blake3}.py, script/, commit/ (Winternitz,
bit commitments, taptree, TCS, TapTreeMmcs), native/ (the C++ SHA-NI
engine, built into _build/), the host challenger (its grind also checks
batches as torch tensor ops on a device), air/ (AirBuilder, symbolic
degrees), airs/ (Fibonacci, MulAir, WideAir, RecursionAir), dsl/ (the
Bitcoin-Script expression DSL, u32 and field gadgets, the in-script
Blake3 and challenger replay, the constraint builders),
fri/script_verifier.py, stark/script_verifier.py, stark/check.py
(`prove(debug=True)`) and stark/config.py (`standard_config`, on the card
unless given a device); TwoAdicFriPcs.generate_verify_expr in fri/pcs.py.

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
  mesh/                      the device mesh: distributed four-step LDE,
                             block exchanges, the sharded prover step
  interop.py                 carry-across to and from the JAX package (tests)

Kernel sources are in csrc/, built by nvcc at first use (_build.py).
"""
