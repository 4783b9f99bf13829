"""The constraint program: an AIR's quotient as generated CUDA kernels.

The JAX package evaluates the constraint folder over the whole quotient
coset under one jit (`tapstark/stark/prover.py` quotient_values), because
evaluating it eagerly dispatches a device program per field operation: the
1548-column Blake3 AIRs run about 57,000 base operations and 3,500 folds a
row. The port records the AIR's constraints once, as a flat program, and
`air/codegen.py` turns the program into straight-line CUDA C++ kernels,
built at its first use on the card (`csrc/quotient.cuh`).

Recording. `ProgramRecorder` is an `AirBuilder` whose values are `Node`s:
`air.eval` runs on them once. The leaves are the trace's local and next
columns, the public values (kernel arguments, so new public values never
rebuild anything), the three selectors and constants. Interior nodes are
base-field add, sub, mul and neg; `assert_zero(x)` appends a fold step,
acc = acc·alpha + x. Equal nodes are one node (hash-consing), exact
identities are applied (x·1, x+0, x-0, x·0, constant operands folded):
the field ops are exact, so none of this changes a word of the result.

Emission. The nodes the folds reach are linearised in eval order, in SSA
form: instruction i defines value i (a fold defines none). The program is
an (n, 3) int32 array of (opcode, a, b), operands tagged by kind in their
top bits (a value, a local or next column, a public value, a constant of
the table, a selector), and a table of Montgomery constants; it is cached
per (AIR class, width, number of public values).

Plain version. On a CPU tensor `quotient_program` runs the eager
`ProverConstraintFolder`, the kernels' plain version (which the card path
never runs); on a CUDA tensor it launches the generated segments or
raises. An AIR whose constraints hold an extension-field value (none of
the repo's does) raises NotImplementedError: the kernels fold base-field
constraints only.
"""

from __future__ import annotations

import ctypes
import functools
import pickle
from dataclasses import dataclass

import numpy as np
import torch

from ..field.constants import EXT_W, P, R_MOD_P
from ..field.device import ef_mul_base
from ..field.scalar import EF4, F
from . import AirBuilder, TwoRowMatrixView
from .folders import ProverConstraintFolder

# opcodes
OP_ADD, OP_SUB, OP_MUL, OP_NEG, OP_FOLD = range(5)
# operand kinds, in the operand's bits KIND_SHIFT and up
K_VAL, K_LOCAL, K_NEXT, K_PUBLIC, K_CONST, K_SEL = range(6)
KIND_SHIFT = 24
# selector indices of a K_SEL operand
SEL_FIRST, SEL_LAST, SEL_TRANSITION = range(3)
# public values a program may read (csrc/quotient.cuh kMaxPublic)
MAX_PUBLIC = 64

# Instructions of one generated segment at most (S): each segment is its
# own translation unit and kernel. nvcc's time grows faster than linearly
# in a segment's length, and each cut costs the values live across it.
# Chosen on the card by build time against run time (PERF.md).
SEGMENT_INSTRUCTIONS = 1000

# Segment launches since the last reset: each `quotient_program` call on
# the card launches every segment of its program once.
launches = {"quotient_program": 0}


def reset_launch_counts() -> None:
    for k in launches:
        launches[k] = 0


class Node:
    """A base-field value of the recorded program."""

    __slots__ = ("rec", "id")

    def __init__(self, rec: "ProgramRecorder", node_id: int):
        self.rec = rec
        self.id = node_id

    def __add__(self, other):
        return self.rec._binary(OP_ADD, self, other)

    __radd__ = __add__

    def __sub__(self, other):
        return self.rec._binary(OP_SUB, self, other)

    def __rsub__(self, other):
        return self.rec._binary(OP_SUB, other, self)

    def __mul__(self, other):
        return self.rec._binary(OP_MUL, self, other)

    __rmul__ = __mul__

    def __neg__(self):
        return self.rec._neg(self)


class ProgramRecorder(AirBuilder):
    """Records `air.eval` as nodes and fold steps."""

    def __init__(self, air, num_public: int):
        self.name = type(air).__qualname__
        w = air.width()
        # per node: ("leaf", operand) or ("const", canonical value) or (op, a id, b id)
        self.defs: list[tuple] = []
        self._memo: dict = {}
        self.events: list[tuple[str, int]] = []  # ("node", id) | ("fold", id), eval order
        self._main = TwoRowMatrixView(
            [self._leaf(K_LOCAL, j) for j in range(w)], [self._leaf(K_NEXT, j) for j in range(w)]
        )
        self._public = [self._leaf(K_PUBLIC, i) for i in range(num_public)]
        self._sels = [self._leaf(K_SEL, s) for s in (SEL_FIRST, SEL_LAST, SEL_TRANSITION)]

    # -- nodes ----------------------------------------------------------------
    def _new(self, key, definition) -> Node:
        node_id = self._memo.get(key)
        if node_id is None:
            node_id = len(self.defs)
            self.defs.append(definition)
            self._memo[key] = node_id
            if definition[0] not in ("leaf", "const"):
                self.events.append(("node", node_id))
        return Node(self, node_id)

    def _leaf(self, kind: int, index: int) -> Node:
        operand = (kind << KIND_SHIFT) | index
        return self._new(("leaf", operand), ("leaf", operand))

    def _const(self, v: int) -> Node:
        v %= P
        return self._new(("const", v), ("const", v))

    def _coerce(self, x) -> Node:
        if isinstance(x, Node):
            if x.rec is not self:
                raise ValueError("a value of another recording")
            return x
        if isinstance(x, (int, np.integer)):
            return self._const(int(x))
        if isinstance(x, F):
            return self._const(x.v)
        if isinstance(x, EF4):
            raise NotImplementedError(
                f"{self.name}: a constraint holds an extension-field value; the quotient "
                "program folds base-field constraints only"
            )
        raise TypeError(f"{self.name}: cannot record a {type(x).__name__}")

    def _const_value(self, node: Node):
        d = self.defs[node.id]
        return d[1] if d[0] == "const" else None

    def _binary(self, op: int, a, b) -> Node:
        a, b = self._coerce(a), self._coerce(b)
        ca, cb = self._const_value(a), self._const_value(b)
        if ca is not None and cb is not None:
            return self._const({OP_ADD: ca + cb, OP_SUB: ca - cb, OP_MUL: ca * cb}[op])
        if op == OP_ADD:
            if ca == 0:
                return b
            if cb == 0:
                return a
        elif op == OP_SUB:
            if cb == 0:
                return a
            if ca == 0:
                return self._neg(b)
        else:
            if ca == 1:
                return b
            if cb == 1:
                return a
            if ca == 0 or cb == 0:
                return self._const(0)
        ia, ib = a.id, b.id
        if op != OP_SUB and ia > ib:  # add and mul commute: one node for both orders
            ia, ib = ib, ia
        return self._new((op, ia, ib), (op, ia, ib))

    def _neg(self, a: Node) -> Node:
        ca = self._const_value(a)
        if ca is not None:
            return self._const(-ca)
        return self._new((OP_NEG, a.id, a.id), (OP_NEG, a.id, a.id))

    # -- AirBuilder -----------------------------------------------------------
    def main(self):
        return self._main

    def is_first_row(self):
        return self._sels[SEL_FIRST]

    def is_last_row(self):
        return self._sels[SEL_LAST]

    def is_transition_window(self, size: int):
        if size != 2:
            raise ValueError("uni-stark only supports a window size of 2")
        return self._sels[SEL_TRANSITION]

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        self.events.append(("fold", self._coerce(x).id))


@dataclass
class Program:
    """A recorded constraint program (module docstring)."""

    name: str  # the AIR's class
    code: np.ndarray  # (n, 3) int32: opcode, operand a, operand b
    consts: np.ndarray  # (k,) uint32 Montgomery words
    counts: dict  # instructions by opcode name


def emit(rec: ProgramRecorder) -> Program:
    """Linearise the nodes the folds reach, in eval order, as SSA."""
    defs = rec.defs
    live = set()
    for kind, node_id in reversed(rec.events):  # a node's event comes before every use of it
        if kind == "fold":
            live.add(node_id)
        elif node_id in live:
            live.update(defs[node_id][1:])
    steps = [(k, i) for k, i in rec.events if k == "fold" or i in live]
    if len(steps) >= 1 << KIND_SHIFT:
        raise ValueError(f"{rec.name}: {len(steps)} instructions, more than an operand can index")

    consts: dict[int, int] = {}
    value_of: dict[int, int] = {}  # node id -> the instruction that defines it

    def operand(node_id: int) -> int:
        d = defs[node_id]
        if d[0] == "leaf":
            return d[1]
        if d[0] == "const":
            k = consts.setdefault(d[1], len(consts))
            return (K_CONST << KIND_SHIFT) | k
        return (K_VAL << KIND_SHIFT) | value_of[node_id]

    code = np.zeros((len(steps), 3), np.int32)
    names = {OP_ADD: "add", OP_SUB: "sub", OP_MUL: "mul", OP_NEG: "neg", OP_FOLD: "fold"}
    counts = dict.fromkeys(names.values(), 0)
    for pos, (kind, node_id) in enumerate(steps):
        if kind == "fold":
            op, reads = OP_FOLD, (node_id, node_id)
        else:
            op, reads = defs[node_id][0], defs[node_id][1:]
            value_of[node_id] = pos
        code[pos] = (op, operand(reads[0]), operand(reads[1]))
        counts[names[op]] += 1
    table = np.array([v * R_MOD_P % P for v in consts], np.uint32)
    return Program(rec.name, code, table, counts)


_programs: dict = {}


def program_for(air, num_public: int) -> Program:
    """The AIR's program, recorded on first use and cached per (class
    object, the instance's state, width, number of public values): two
    classes of one name, or two instances whose attributes differ, get
    programs of their own."""
    key = (type(air), pickle.dumps(vars(air)), air.width(), num_public)
    prog = _programs.get(key)
    if prog is None:
        rec = ProgramRecorder(air, num_public)
        air.eval(rec)
        prog = _programs[key] = emit(rec)
    return prog


def build(air, num_public: int):
    """The AIR's generated kernels (`codegen.Kernels`) at
    SEGMENT_INSTRUCTIONS, generated and built at their first use (once per
    process; the library is kept in `tapstark_torch/_build/`). Raises if
    nvcc fails."""
    from . import codegen

    return codegen.kernels(program_for(air, num_public), SEGMENT_INSTRUCTIONS)


def quotient_eager(air, public_values, sels, next_step: int, tq: torch.Tensor, alpha: EF4) -> torch.Tensor:
    """The kernels' plain version: the eager `ProverConstraintFolder` over
    the whole coset, divided by the zeroifier."""
    folder = ProverConstraintFolder(tq, next_step, public_values, sels, alpha)
    air.eval(folder)
    return ef_mul_base(folder.accumulator.arr, sels.inv_zeroifier)


def _mont(v: int) -> int:
    return v * R_MOD_P % P


@functools.lru_cache(maxsize=None)
def coset_tables(log_n: int, log_m: int, shift: int, device) -> torch.Tensor:
    """The kernels' coset parameters, Montgomery words on `device`: the
    coset's point x_i = shift·omega^i as hi[i >> log_lo]·lo[i mod
    2^log_lo] (lo: omega^k; hi: shift·omega^(k·2^log_lo)), then the
    2^log_q values of the trace domain's zeroifier x^n - 1 over the coset
    (entry i mod 2^log_q) and their inverses."""
    log_lo, log_q = log_m // 2, log_m - log_n
    omega = F.two_adic_generator(log_m).v
    lo = [pow(omega, k, P) for k in range(1 << log_lo)]
    step = pow(omega, 1 << log_lo, P)
    hi = [shift * pow(step, k, P) % P for k in range(1 << (log_m - log_lo))]
    shift_n, omega_n = pow(shift, 1 << log_n, P), pow(omega, 1 << log_n, P)
    zh = [(shift_n * pow(omega_n, k, P) - 1) % P for k in range(1 << log_q)]
    words = [_mont(v) for v in lo + hi + zh + [pow(z, P - 2, P) for z in zh]]
    return torch.tensor(np.array(words, np.uint32).view(np.int32), device=device)


def _ext_mul(a, b):
    """a * b in the quartic extension (x^4 = W), canonical coordinates: Python
    ints, or numpy uint64 arrays that broadcast."""
    a0, a1, a2, a3 = a
    b0, b1, b2, b3 = b
    w = EXT_W
    return ((a0 * b0 % P + w * ((a1 * b3 % P + a2 * b2 % P + a3 * b1 % P) % P)) % P,
            (a0 * b1 % P + a1 * b0 % P + w * ((a2 * b3 % P + a3 * b2 % P) % P)) % P,
            (a0 * b2 % P + a1 * b1 % P + a2 * b0 % P + w * (a3 * b3 % P)) % P,
            (a0 * b3 % P + a1 * b2 % P + a2 * b1 % P + a3 * b0 % P) % P)


def alpha_powers(alpha: EF4, count: int) -> np.ndarray:
    """alpha^0 .. alpha^(count - 1) as (count, 4) Montgomery words: the
    powers the kernels' folds multiply by (csrc/quotient.cuh fold_pair).
    Baby steps alpha^j (j < 32) and giant steps alpha^(32k) on the host,
    then every product of the two at once."""
    x, baby = (1, 0, 0, 0), []
    for _ in range(min(count, 32)):
        baby.append(x)
        x = _ext_mul(x, alpha.as_u32_vec())
    pows = np.array(baby, np.uint64)
    if count > len(baby):
        giant = [(1, 0, 0, 0)]
        while len(giant) * len(baby) < count:
            giant.append(_ext_mul(giant[-1], x))  # x = alpha^32
        g = np.array(giant, np.uint64)[:, None, :]
        pows = np.stack(_ext_mul([g[..., i] for i in range(4)], [pows[None, :, i] for i in range(4)]), axis=-1)
    return (pows.reshape(-1, 4)[:count] * np.uint64(R_MOD_P) % np.uint64(P)).astype(np.uint32)


@functools.lru_cache(maxsize=None)
def _g_inv(log_n: int) -> int:
    """The inverse of the generator of the 2^log_n trace domain, Montgomery."""
    return _mont(pow(F.two_adic_generator(log_n).v, P - 2, P))


def quotient_args(trace_domain, quotient_domain, public_values, tq: int, live: int, out: int, coset: int,
                  alpha_pows: int, row0: int = 0, rows: int | None = None, ld: int | None = None):
    """The kernels' arguments (`codegen.QuotientArgs`) for the window of
    `rows` coset rows from row `row0` (the whole coset by default) whose
    buffers lie at the given addresses, their leading dimension `ld` (the
    coset's size by default)."""
    from .codegen import QuotientArgs

    log_n, log_m = trace_domain.log_n, quotient_domain.log_n
    if trace_domain.shift != 1 or log_n > log_m:
        raise ValueError("quotient_program expects the natural trace domain and a coset no smaller")
    if len(public_values) > MAX_PUBLIC:
        raise ValueError(f"quotient_program: {len(public_values)} public values, at most {MAX_PUBLIC}")
    m, next_step = 1 << log_m, 1 << (log_m - log_n)
    rows = m if rows is None else rows
    ld = m if ld is None else ld
    whole = row0 == 0 and rows == ld == m  # the next rows wrap around the coset
    if not whole and not (0 <= row0 and rows >= 1 and row0 + rows <= m and rows + next_step <= ld):
        raise ValueError(f"quotient_program: a window of {rows} rows from row {row0} of {m} needs its "
                         f"{next_step} next rows in the buffer (leading dimension {ld})")
    return QuotientArgs(
        tq, live, out, coset, alpha_pows, row0, rows, ld, next_step, log_m // 2, log_m - log_m // 2,
        log_m - log_n, _g_inv(log_n),
        (ctypes.c_uint32 * MAX_PUBLIC)(*(_mont(v.v) for v in public_values)),
    )


def quotient_program(air, public_values, trace_domain, quotient_domain, tq: torch.Tensor, alpha: EF4) -> torch.Tensor:
    """Constraint accumulator over the quotient coset, divided by the
    zeroifier, as an (m, 4) Montgomery tensor: `tq` (m, width) holds the
    trace on the coset in natural order; the next row of row i is row (i +
    next_step) mod m, next_step = m / n. On the card `tq` is laid out by
    columns (strides (1, m), as `TwoAdicFriPcs.get_evaluations_on_domain`
    gives it) and the generated segments run one after another, computing
    the selectors themselves; on a CPU tensor, the plain version over
    `selectors_on_coset`."""
    return quotient_window(air, public_values, trace_domain, quotient_domain, tq, alpha)


def window_selectors(sels, row0: int, ld: int):
    """The coset's selectors at rows row0 .. row0 + ld - 1, mod the coset's size."""
    m = sels.is_first_row.shape[0]
    idx = (torch.arange(ld, dtype=torch.int64, device=sels.is_first_row.device) + row0) % m
    return type(sels)(*(s.index_select(0, idx) for s in (sels.is_first_row, sels.is_last_row, sels.is_transition,
                                                          sels.inv_zeroifier)))


def quotient_window_plain(air, public_values, trace_domain, quotient_domain, tq: torch.Tensor, alpha: EF4,
                          row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """The windowed kernels' plain version: the eager folder over the
    window's buffer (its next rows roll around the buffer, as the kernels'
    do), with the selectors (`selectors_on_coset`) at the buffer's coset
    rows; its first `rows` rows."""
    ld = tq.shape[0]
    rows = ld if rows is None else rows
    next_step = 1 << (quotient_domain.log_n - trace_domain.log_n)
    sels = trace_domain.selectors_on_coset(quotient_domain, tq.device)
    if row0 != 0 or ld != quotient_domain.size():
        sels = window_selectors(sels, row0, ld)
    return quotient_eager(air, public_values, sels, next_step, tq, alpha)[:rows]


def quotient_window(air, public_values, trace_domain, quotient_domain, tq: torch.Tensor, alpha: EF4,
                    row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """`quotient_program` over the coset's rows row0 .. row0 + rows - 1, as
    a (rows, 4) tensor: `tq` (ld, width) holds them and, after them, at
    least the next_step rows that follow them in the coset (ld >= rows +
    next_step), or is the whole coset (row0 0, rows = ld = m). On the card
    `tq` is laid out by columns (strides (1, ld)) and the segments run on
    the window; on a CPU tensor, `quotient_window_plain`."""
    if tq.device.type == "cpu":
        return quotient_window_plain(air, public_values, trace_domain, quotient_domain, tq, alpha, row0, rows)
    if tq.device.type != "cuda":
        raise ValueError(f"quotient_program: no path for device {tq.device}")
    return launch_segments(build(air, len(public_values)), air, public_values, trace_domain, quotient_domain, tq,
                           alpha, row0, rows)


def launch_segments(kernels, air, public_values, trace_domain, quotient_domain, tq: torch.Tensor,
                    alpha: EF4, row0: int = 0, rows: int | None = None) -> torch.Tensor:
    """`quotient_window` on the card through the given built segments
    (`codegen.Kernels` of the AIR's program, at any segment length): each
    launched in turn on the current stream; raises on a launch's error."""
    ld, width = tq.shape
    rows = ld if rows is None else rows
    if tq.dtype != torch.int32 or width != air.width() or tq.stride() != (1, ld):
        raise ValueError(f"quotient_program: expected an int32 (rows, {air.width()}) tensor laid out by columns "
                         "(strides (1, rows))")
    dev = tq.device
    live = torch.empty((max(kernels.plan.live_rows, 1), ld), dtype=torch.int32, device=dev)
    out = torch.empty((rows, 4), dtype=torch.int32, device=dev)
    coset = coset_tables(trace_domain.log_n, quotient_domain.log_n, quotient_domain.shift, dev)
    pows = torch.from_numpy(alpha_powers(alpha, kernels.plan.alpha_powers).view(np.int32)).to(dev)
    args = quotient_args(trace_domain, quotient_domain, public_values, tq.data_ptr(), live.data_ptr(),
                         out.data_ptr(), coset.data_ptr(), pows.data_ptr(), row0, rows, ld)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for k, entry in enumerate(kernels.entries):
            err = entry(ctypes.byref(args), stream)
            if err != 0:
                raise RuntimeError(f"quotient_program: segment {k} of {air.width()}-column "
                                   f"{type(air).__name__}: CUDA error {err}")
            launches["quotient_program"] += 1
    return out
