"""The port's Blake3 AIRs (tapstark_torch.airs.blake3_compression,
airs.blake3g) and the quotient's constraint program (tapstark_torch.air.
program, kernel csrc/quotient.cuh) against the JAX package.

Inputs are made from numpy seeds and handed to both packages; exact
equality throughout. No test here proves with the JAX package or runs its
jitted quotient at 1548 columns (minutes of XLA compiles on a CPU): the
JAX side runs its trace generators and its host `VerifierConstraintFolder`
on EF4 scalars, and its verifier on the port's bytes of the small sponge
proof, whose digest is frozen from the JAX package's own proof
(`python tools/freeze_port_references.py blake3_small`). The quotient
kernel's source runs on the host through `tests/cuda_host_shim` (g++), held
word for word against the eager folder, its plain version; `chip_smoke.py`
holds the CUDA build against the same on the card.
"""

import ctypes
import hashlib
import os
import pathlib
import subprocess

import numpy as np
import pytest

import tapstark.airs as jairs
from tapstark.air.folders import VerifierConstraintFolder as JVerifierConstraintFolder
from tapstark.challenger import BfChallenger as JBfChallenger
from tapstark.commit import BcManager as JBcManager
from tapstark.commit import TapTreeMmcs as JTapTreeMmcs
from tapstark.field import EF4 as JEF4
from tapstark.field import F as JF
from tapstark.fri import FriConfig as JFriConfig
from tapstark.fri import TwoAdicFriPcs as JTwoAdicFriPcs
from tapstark.poly.domain import LagrangeSelectors as JLagrangeSelectors
from tapstark.poly.domain import TwoAdicMultiplicativeCoset as JCoset
from tapstark.stark import VerificationError as JVerificationError
from tapstark.stark import verify as j_verify
from tapstark.stark.serde import proof_from_bytes as j_proof_from_bytes
from tapstark_torch.air.folders import VerifierConstraintFolder
from tapstark_torch.air import codegen
from tapstark_torch.air.program import (
    K_CONST,
    K_LOCAL,
    K_NEXT,
    K_PUBLIC,
    K_SEL,
    K_VAL,
    KIND_SHIFT,
    OP_ADD,
    OP_FOLD,
    OP_MUL,
    OP_NEG,
    OP_SUB,
    SEGMENT_INSTRUCTIONS,
    alpha_powers,
    coset_tables,
    program_for,
    quotient_args,
    quotient_eager,
    quotient_window_plain,
)
from tapstark_torch.air.symbolic import get_log_quotient_degree
from tapstark_torch.airs import (
    Blake3CompressionAir,
    Blake3GAir,
    Blake3SpongeChainAir,
    FibonacciAir,
    MulAir,
    RecursionAir,
    WideAir,
    generate_blake3_compression_trace,
    generate_blake3_sponge_trace,
    generate_blake3g_trace,
)
from tapstark_torch.challenger import BfChallenger
from tapstark_torch.field import EF4, F
from tapstark_torch.field.constants import MULT_GENERATOR, P, R_MOD_P
from tapstark_torch.field.device import np_from_mont, np_to_mont
from tapstark_torch.interop import mont_np_from_tensor, pcs_from_reference, tensor_from_mont_np
from tapstark_torch.poly.domain import LagrangeSelectors, TwoAdicMultiplicativeCoset
from tapstark_torch.poly.ntt import coset_lde_batch
from tapstark_torch.stark import VerificationError, prove, quotient_values, verify
from tapstark_torch.stark.serde import proof_from_bytes, proof_to_bytes

# (sha256, bytes, PoW witness) of the JAX package's proof of the sponge over
# 4 compressions (tests/test_blake3_sponge_air.py's shape)
BLAKE3_SMALL = ("bec0ea139d74e8a6d2990e9630259ff39538ecf9574473628eadca39b150ad74", 1497462, 0)

# the three AIRs: (port AIR, JAX AIR, number of public values)
BLAKE3_AIRS = [
    (Blake3GAir(), jairs.Blake3GAir(), 8),
    (Blake3CompressionAir(), jairs.Blake3CompressionAir(), 48),
    (Blake3SpongeChainAir(), jairs.Blake3SpongeChainAir(), 16),
]


def _sponge_blocks(n):
    return [[b * 16 + w for w in range(16)] for b in range(n)]


def _ef(rng):
    return [int(v) for v in rng.integers(0, P, 4)]


def test_trace_generators_match_jax():
    """The sponge over 4 compressions, one compression of a random message
    and 16 rows of Blake3GAir: traces, public values and digests equal."""
    rng = np.random.default_rng(40)
    blocks = _sponge_blocks(4)
    got, want = generate_blake3_sponge_trace(blocks), jairs.generate_blake3_sponge_trace(blocks)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[0].shape == (256, 1548) and got[1:] == want[1:]
    ch = BfChallenger()
    for blk in blocks:
        ch.observe_u32s(blk)
    assert got[2] == ch.cv

    message = rng.integers(0, 256, 64).astype(np.uint8).tobytes()
    got, want = generate_blake3_compression_trace(message), jairs.generate_blake3_compression_trace(message)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1:] == want[1:]

    state = tuple(int(v) for v in rng.integers(0, 1 << 32, 4, dtype=np.uint64))
    got, want = generate_blake3g_trace(state, 16, seed=3), jairs.generate_blake3g_trace(state, 16, seed=3)
    np.testing.assert_array_equal(got[0], want[0])
    assert got[1] == want[1]


def test_verifier_folders_match_jax():
    """Each Blake3 AIR's `VerifierConstraintFolder` at random EF4 rows,
    public values, selectors and alpha: the accumulators are equal."""
    rng = np.random.default_rng(41)
    for air, j_air, num_public in BLAKE3_AIRS:
        w = air.width()
        local, nxt = [_ef(rng) for _ in range(w)], [_ef(rng) for _ in range(w)]
        pis = [int(v) for v in rng.integers(0, P, num_public)]
        sels, alpha = [_ef(rng) for _ in range(4)], _ef(rng)
        folder = VerifierConstraintFolder([EF4(v) for v in local], [EF4(v) for v in nxt], [F(v) for v in pis],
                                          LagrangeSelectors(*(EF4(v) for v in sels)), EF4(alpha))
        air.eval(folder)
        j_folder = JVerifierConstraintFolder([JEF4(v) for v in local], [JEF4(v) for v in nxt],
                                             [JF(v) for v in pis], JLagrangeSelectors(*(JEF4(v) for v in sels)),
                                             JEF4(alpha))
        j_air.eval(j_folder)
        assert folder.accumulator.as_u32_vec() == j_folder.accumulator.as_u32_vec(), type(air).__name__

    # The quotient program's cache: two AIR classes of one name, width and
    # public count (as from two modules) with different constraints, and
    # two instances of one class whose state differs, get programs of
    # their own.
    def twin_class(power: int):
        class TwinAir(FibonacciAir):
            def __init__(self, offset: int = 0):
                self.offset = offset

            def eval(self, builder):
                local = builder.main().row(0)
                term = local[0]
                for _ in range(power - 1):
                    term = term * local[0]
                builder.assert_eq(term + F(self.offset), local[1])

        return TwinAir

    first, second = twin_class(1), twin_class(2)
    assert first.__qualname__ == second.__qualname__
    prog_a, prog_b = program_for(first(), 0), program_for(second(), 0)
    assert prog_a.counts["mul"] != prog_b.counts["mul"]
    prog_c = program_for(first(offset=5), 0)
    assert not np.array_equal(prog_a.consts, prog_c.consts)
    assert program_for(first(), 0) is prog_a


def test_sponge_quotient_rows_match_jax_folder():
    """The port's quotient (on the CPU: the eager folder, the kernel's plain
    version) of the sponge over 4 compressions, its trace extended to the
    quotient coset (512 rows): at sampled rows, the JAX package's host
    folder at that coset point, times its inverse zeroifier."""
    rng = np.random.default_rng(42)
    trace, pis, _ = generate_blake3_sponge_trace(_sponge_blocks(4))
    log_n = 8
    tq = coset_lde_batch(tensor_from_mont_np(np_to_mont(trace), "cpu"), 1, MULT_GENERATOR)
    alpha = _ef(rng)
    td = TwoAdicMultiplicativeCoset(log_n, 1)
    qd = td.create_disjoint_domain(1 << (log_n + 1))
    assert qd.shift == MULT_GENERATOR
    got = np_from_mont(mont_np_from_tensor(quotient_values(
        Blake3SpongeChainAir(), [F(v) for v in pis], td, qd, tq, EF4(alpha))))
    canon = np_from_mont(mont_np_from_tensor(tq))
    jd = JCoset(log_n, 1)
    m = qd.size()
    for i in (0, 1, 255, m - 1):
        point = JEF4.from_base(JF(MULT_GENERATOR) * JF(qd.gen().v).exp(i))
        sels = jd.selectors_at_point(point)
        folder = JVerifierConstraintFolder([JEF4.from_base(JF(int(v))) for v in canon[i]],
                                           [JEF4.from_base(JF(int(v))) for v in canon[(i + 2) % m]],
                                           [JF(v) for v in pis], sels, JEF4(alpha))
        jairs.Blake3SpongeChainAir().eval(folder)
        want = (folder.accumulator * sels.inv_zeroifier).as_u32_vec()
        assert [int(v) for v in got[i]] == want, i


# the host-shim cases: (AIR, number of public values, log_n, launch (grid,
# block) or None for the card's, S or None for SEGMENT_INSTRUCTIONS)
HOST_CASES = [(FibonacciAir(), 3, 3, None, None), (MulAir(), 3, 4, (2, 4), None), (WideAir(8), 8, 3, None, 16),
              (RecursionAir(), 12, 3, (3, 4), 300), (Blake3GAir(), 8, 4, None, None),
              (Blake3CompressionAir(), 48, 3, None, None), (Blake3SpongeChainAir(), 16, 3, (2, 4), None)]
# the cases also run as two windows of the coset, each with its halo (a
# mesh shard's launch): Fibonacci, and RecursionAir cut by a short S
WINDOWED_CASES = (0, 3)


@pytest.fixture(scope="module")
def host_program(tmp_path_factory):
    """The generated segments of every HOST_CASES program, built with g++
    -O0 against tests/cuda_host_shim (one translation unit a segment, all
    at once) and linked with quotient_host.cpp, which runs them one after
    another: (library, {case index: (plan, entry points)})."""
    here = pathlib.Path(__file__).parent
    shim, csrc = here / "cuda_host_shim", here.parent / "tapstark_torch" / "csrc"
    out = tmp_path_factory.mktemp("quotient_host")
    flags = ["g++", "-std=c++20", "-fPIC", f"-I{shim}", f"-I{csrc}"]
    plans, objs = {}, []
    for c, (air, num_public, _, _, s) in enumerate(HOST_CASES):
        prog = program_for(air, num_public)
        pl = codegen.plan(prog, s or SEGMENT_INSTRUCTIONS)
        plans[c] = pl
        for k, text in enumerate(codegen.sources(prog, pl, f"case{c}")):
            (out / f"case{c}_{k}.cu").write_text(text)
            objs.append(out / f"case{c}_{k}.o")
    procs, pending = [], [(o.with_suffix(".cu"), o) for o in objs]
    while pending or procs:  # at most one g++ a CPU
        while pending and len(procs) < (os.cpu_count() or 1):
            src, o = pending.pop()
            procs.append(subprocess.Popen([*flags, "-O0", "-x", "c++", "-include", "cuda_runtime.h", "-c", "-o",
                                           str(o), str(src)], stderr=subprocess.PIPE, text=True))
        p = procs.pop(0)
        assert p.wait() == 0, p.stderr.read()
    so = out / "libquotient_host.so"
    subprocess.run([*flags, "-O1", "-shared", "-o", str(so), str(shim / "quotient_host.cpp"), *map(str, objs)],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    lib.host_run_segments.argtypes = [ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p, ctypes.c_uint, ctypes.c_uint,
                                      ctypes.c_void_p, ctypes.c_longlong]
    entries = {c: [ctypes.cast(getattr(lib, f"case{c}_{k}"), ctypes.c_void_p).value
                   for k in range(len(pl.segments))] for c, pl in plans.items()}
    return lib, {c: (plans[c], entries[c]) for c in plans}


def _program_values(prog, tq, pis, sels, step, alpha, cuts):
    """Every value of the program (instruction i: row i; selector s: row n +
    s) at every coset row, and the accumulator at each of `cuts`, as
    Montgomery words, by numpy: an evaluator independent of the generated
    code."""
    n, m = len(prog.code), tq.shape[0]
    p, rinv, w = np.uint64(P), np.uint64(pow(R_MOD_P, P - 2, P)), np.uint64(11)
    vals = np.zeros((n + 3, m), np.uint64)
    vals[n:] = [mont_np_from_tensor(s) for s in (sels.is_first_row, sels.is_last_row, sels.is_transition)]
    nxt = np.roll(tq, -step, axis=0)
    pub = [np.uint64(v.v * R_MOD_P % P) for v in pis]
    al = [np.uint64(v * R_MOD_P % P) for v in alpha.as_u32_vec()]

    def mul(x, y):
        return (x * y % p) * rinv % p

    def get(x):
        kind, i = x >> KIND_SHIFT, x & ((1 << KIND_SHIFT) - 1)
        return {K_VAL: lambda: vals[i], K_LOCAL: lambda: tq[:, i], K_NEXT: lambda: nxt[:, i],
                K_PUBLIC: lambda: pub[i], K_CONST: lambda: np.uint64(prog.consts[i]),
                K_SEL: lambda: vals[n + i]}[kind]().astype(np.uint64)

    acc, acc_at = [np.zeros(m, np.uint64) for _ in range(4)], {}
    for i, (op, a, b) in enumerate(prog.code.astype(np.int64)):
        if i in cuts:
            acc_at[i] = np.stack(acc)
        x, y = get(a), get(b)
        if op == OP_FOLD:  # acc * alpha + x, x^4 = 11
            prod = [sum((mul(acc[j], al[t - j]) if t >= j else w * mul(acc[j], al[t + 4 - j])) % p
                        for j in range(4)) % p for t in range(4)]
            acc = [(prod[0] + x) % p, *prod[1:]]
            continue
        vals[i] = {OP_ADD: lambda: (x + y) % p, OP_SUB: lambda: (x + p - y) % p, OP_NEG: lambda: (p - x) % p,
                   OP_MUL: lambda: mul(x, y)}[op]()
    return vals, acc_at


def test_program_on_host_shim_matches_eager(host_program):
    """The generated segments of each recorded program, run one after
    another on the host from the coset's parameters (the selectors computed
    by the kernel code) and the coset laid out by columns, against the
    eager folder word for word: Fibonacci, MulAir, WideAir, RecursionAir
    (163 columns), Blake3GAir and both 1548-column AIRs, on random cosets
    of 8-32 rows, with the card's launch shape and with fewer threads
    (each thread then walks several rows), at SEGMENT_INSTRUCTIONS and,
    for WideAir and RecursionAir, a short S that cuts them. At every cut,
    the values carried across it are exactly those read after it: the
    plan's carried set equals the set read after the cut and defined
    before it (liveness recomputed here), each is stored and loaded at one
    row of the live buffer that nothing overwrites in between, and after
    the segments before the cut that row holds the value's words (numpy
    evaluation of the program). The WINDOWED_CASES also run as two windows
    of half the coset (a mesh shard's launch: the window's rows and the
    next_step rows after them, by columns, the selectors at the coset's
    rows): each window equals the eager folder over it, and the two
    joined equal the whole coset's run."""
    lib, built = host_program
    rng = np.random.default_rng(43)
    for c, (air, num_public, log_n, launch, _) in enumerate(HOST_CASES):
        pl, entries = built[c]
        prog = program_for(air, num_public)
        td = TwoAdicMultiplicativeCoset(log_n, 1)
        log_q = get_log_quotient_degree(air, num_public)
        qd = td.create_disjoint_domain(1 << (log_n + log_q))
        m, w, step = qd.size(), air.width(), 1 << log_q
        tq = np_to_mont(rng.integers(0, P, (m, w)).astype(np.uint32))
        pis = [F(int(v)) for v in rng.integers(0, P, num_public)]
        alpha = EF4(_ef(rng))
        sels = td.selectors_on_coset(qd, "cpu")
        want = mont_np_from_tensor(quotient_eager(air, pis, sels, step, tensor_from_mont_np(tq, "cpu"), alpha))

        tq_cols = np.ascontiguousarray(tq.T)
        coset = mont_np_from_tensor(coset_tables(log_n, qd.log_n, qd.shift, "cpu")).copy()
        live = np.full((max(pl.live_rows, 1), m), 0xA5A5A5A5, np.uint32)  # not a field word
        out = np.zeros((m, 4), np.uint32)
        pows = alpha_powers(alpha, pl.alpha_powers)
        args = quotient_args(td, qd, pis, tq_cols.ctypes.data, live.ctypes.data, out.ctypes.data, coset.ctypes.data,
                             pows.ctypes.data)
        snaps = np.zeros((len(entries), *live.shape), np.uint32)
        fns = (ctypes.c_void_p * len(entries))(*entries)
        grid, block = launch or (0, 0)
        lib.host_run_segments(fns, len(entries), ctypes.byref(args), grid, block, snaps.ctypes.data, live.size)
        np.testing.assert_array_equal(out, want, err_msg=type(air).__name__)

        if c in WINDOWED_CASES:
            half, joined = m // 2, []
            for row0 in (0, half):
                rows_at = (row0 + np.arange(half + step)) % m  # the window's rows, then its halo
                win_cols = np.ascontiguousarray(tq[rows_at].T)
                win_live = np.full((max(pl.live_rows, 1), half + step), 0xA5A5A5A5, np.uint32)
                win_out = np.zeros((half, 4), np.uint32)
                win_args = quotient_args(td, qd, pis, win_cols.ctypes.data, win_live.ctypes.data, win_out.ctypes.data,
                                         coset.ctypes.data, pows.ctypes.data, row0, half, half + step)
                win_snaps = np.zeros((len(entries), *win_live.shape), np.uint32)
                lib.host_run_segments(fns, len(entries), ctypes.byref(win_args), grid, block, win_snaps.ctypes.data,
                                      win_live.size)
                plain = quotient_window_plain(air, pis, td, qd, tensor_from_mont_np(tq[rows_at], "cpu"), alpha, row0, half)
                np.testing.assert_array_equal(win_out, mont_np_from_tensor(plain), err_msg=f"{type(air).__name__} {row0}")
                joined.append(win_out)
            np.testing.assert_array_equal(np.concatenate(joined), want, err_msg=type(air).__name__)

        # the cuts
        n, segs = len(prog.code), pl.segments
        reads = [(i, (int(x) & 0xFFFFFF) + (n if x >> KIND_SHIFT == K_SEL else 0))
                 for i, row in enumerate(prog.code[:, 1:].astype(np.int64)) for x in row
                 if x >> KIND_SHIFT in (K_VAL, K_SEL)]
        first = {}
        for i, v in reads:
            first.setdefault(v, i)
        vals, acc_at = _program_values(prog, tq, pis, sels, step, alpha, {sg.stop for sg in segs[:-1]})
        holder = {}  # live-buffer row -> the value it holds
        for k, sg in enumerate(segs):
            for v, r in sg.loads.items():  # stored at this row before, not overwritten since
                assert holder.get(r) == v, (type(air).__name__, k, v)
            # a row a segment loads is not stored in it (loads and stores keep no order)
            assert not set(sg.loads.values()) & set(sg.stores.values()), (type(air).__name__, k)
            holder.update({r: v for v, r in sg.stores.items()})
            if k + 1 == len(segs):
                break
            cut = sg.stop
            read_after = {v for i, v in reads if i >= cut and (v < cut if v < n else first[v] < cut)}
            carried = {v for s in segs[: k + 1] for v in s.stores} & {v for s in segs[k + 1 :] for v in s.loads}
            assert carried == read_after, (type(air).__name__, k)
            rows = {v: r for r, v in holder.items()}
            for v in carried:
                np.testing.assert_array_equal(snaps[k, rows[v]], vals[v], err_msg=f"{type(air).__name__}: {v}")
            folded = bool((prog.code[:cut, 0] == OP_FOLD).any())
            if folded:
                np.testing.assert_array_equal(snaps[k, :4], acc_at[cut], err_msg=f"{type(air).__name__}: acc")
            assert sg.live_out == len(carried) + 4 * folded, (type(air).__name__, k)


def _j_pcs(num_queries, log_blowup, pow_bits):
    fri = JFriConfig(log_blowup=log_blowup, num_queries=num_queries, proof_of_work_bits=pow_bits,
                     mmcs=JTapTreeMmcs(JBcManager(), num_queries, ext=True))
    return JTwoAdicFriPcs(JTapTreeMmcs(JBcManager(), num_queries, ext=False), fri)


def test_blake3_small_proof_matches_frozen_jax():
    """The sponge over 4 compressions (256 x 1548), blowup 2, 1 query, 2 PoW
    bits, proved by the port on the CPU: its bytes equal the JAX package's
    frozen proof; the JAX package's verify and the port's accept them; with
    one public value changed, both reject."""
    ref_pcs = _j_pcs(1, 1, 2)
    pcs = pcs_from_reference(ref_pcs, "cpu")
    trace, pis, _ = generate_blake3_sponge_trace(_sponge_blocks(4))
    pis = [F(v) for v in pis]
    air = Blake3SpongeChainAir()
    proof = prove(pcs, air, BfChallenger(), trace, pis)
    data = proof_to_bytes(proof)
    assert (hashlib.sha256(data).hexdigest(), len(data), proof.opening_proof.pow_witness) == BLAKE3_SMALL
    verify(pcs, air, BfChallenger(), proof_from_bytes(data), pis)
    j_pis = [JF(p.v) for p in pis]
    j_verify(ref_pcs, jairs.Blake3SpongeChainAir(), JBfChallenger(), j_proof_from_bytes(data), j_pis)

    bad = list(pis)
    bad[3] = bad[3] + F(1)
    with pytest.raises(VerificationError):
        verify(pcs, air, BfChallenger(), proof_from_bytes(data), bad)
    j_bad = list(j_pis)
    j_bad[3] = j_bad[3] + JF(1)
    with pytest.raises(JVerificationError):
        j_verify(ref_pcs, jairs.Blake3SpongeChainAir(), JBfChallenger(), j_proof_from_bytes(data), j_bad)
