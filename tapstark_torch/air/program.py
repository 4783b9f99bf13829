"""The constraint program: an AIR's quotient as one kernel launch.

The JAX package evaluates the constraint folder over the whole quotient
coset under one jit (`tapstark/stark/prover.py` quotient_values), because
evaluating it eagerly dispatches a device program per field operation: the
1548-column Blake3 AIRs run about 57,000 base operations and 3,500 folds a
row. The port records the AIR's constraints once, as a flat program, and
one CUDA kernel (`csrc/quotient.cuh` `quotient_program_kernel`) interprets
it for every row of the coset.

Recording. `ProgramRecorder` is an `AirBuilder` whose values are `Node`s:
`air.eval` runs on them once. The leaves are the trace's local and next
columns, the public values (kernel arguments, so new public values never
rebuild anything), the three selectors and constants. Interior nodes are
base-field add, sub, mul and neg; `assert_zero(x)` appends a fold step,
acc = acc·alpha + x. Equal nodes are one node (hash-consing), exact
identities are applied (x·1, x+0, x-0, x·0, constant operands folded):
the field ops are exact, so none of this changes a word of the result.

Emission. The nodes the folds reach are linearised in eval order. A leaf
is not an instruction: it is an operand, read where it is used (the `K_` kinds).
Every interior value gets a slot, allocated by last use (a linear scan),
so the slot count is the live width, not the op count. The program is an
(n, 4) int32 array of (opcode, dst slot, a, b), operands tagged by kind in
their top bits, a table of Montgomery constants, and the slot count; it is
cached per (AIR class, width, number of public values).

Plain version. On a CPU tensor `quotient_program` runs the eager
`ProverConstraintFolder`, the kernel's plain version (which the card path
never runs); on a CUDA tensor it launches the kernel or raises. An AIR
whose constraints hold an extension-field value (none of the repo's does)
raises NotImplementedError: the kernel folds base-field constraints only.
"""

from __future__ import annotations

import heapq
from dataclasses import dataclass, field

import numpy as np
import torch

from ..field.constants import P, R_MOD_P
from ..field.device import ef_mul_base
from ..field.scalar import EF4, F
from . import AirBuilder, TwoRowMatrixView
from .folders import ProverConstraintFolder

# opcodes (csrc/quotient.cuh kOpAdd ...)
OP_ADD, OP_SUB, OP_MUL, OP_NEG, OP_FOLD = range(5)
# operand kinds, in the operand's bits KIND_SHIFT and up (csrc/quotient.cuh)
K_SLOT, K_LOCAL, K_NEXT, K_PUBLIC, K_CONST, K_SEL = range(6)
KIND_SHIFT = 24
# selector indices of a K_SEL operand: the kernel's `sel` rows
SEL_FIRST, SEL_LAST, SEL_TRANSITION = range(3)

# The kernel keeps each thread's slots in a global scratch laid out
# [slot][thread]; a launch runs as many threads as fit this many bytes of
# scratch (a power of two, at most the coset's rows), each walking rows
# t, t + threads, ... . The row chunking of the JAX package's lax.map.
SCRATCH_BUDGET = 256 << 20

# Launches since the last reset: one per `quotient_program` call that
# reached the card.
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

    code: np.ndarray  # (n, 4) int32: opcode, dst slot, operand a, operand b
    consts: np.ndarray  # (k,) uint32 Montgomery words
    slots: int
    counts: dict  # instructions by opcode name
    _on_device: dict = field(default_factory=dict, repr=False)

    def on(self, device) -> tuple[torch.Tensor, torch.Tensor]:
        """(code, consts) as int32 tensors on `device`, copied once."""
        key = str(device)
        if key not in self._on_device:
            consts = self.consts if len(self.consts) else np.zeros(1, np.uint32)
            self._on_device[key] = (
                torch.from_numpy(np.ascontiguousarray(self.code)).to(device),
                torch.from_numpy(consts.view(np.int32)).to(device),
            )
        return self._on_device[key]


def emit(rec: ProgramRecorder) -> Program:
    """Linearise the nodes the folds reach, in eval order, and allocate
    their slots by last use."""
    defs = rec.defs
    live = set()
    for kind, node_id in reversed(rec.events):  # a node's event comes before every use of it
        if kind == "fold":
            live.add(node_id)
        elif node_id in live:
            live.update(defs[node_id][1:])
    steps = [(k, i) for k, i in rec.events if k == "fold" or i in live]
    last_use: dict[int, int] = {}
    for pos, (kind, node_id) in enumerate(steps):
        reads = (node_id,) if kind == "fold" else defs[node_id][1:]
        for r in reads:
            last_use[r] = pos

    consts: dict[int, int] = {}
    slot_of: dict[int, int] = {}
    free: list[int] = []
    n_slots = 0

    def operand(node_id: int) -> int:
        d = defs[node_id]
        if d[0] == "leaf":
            return d[1]
        if d[0] == "const":
            k = consts.setdefault(d[1], len(consts))
            return (K_CONST << KIND_SHIFT) | k
        return (K_SLOT << KIND_SHIFT) | slot_of[node_id]

    code = np.zeros((len(steps), 4), np.int32)
    names = {OP_ADD: "add", OP_SUB: "sub", OP_MUL: "mul", OP_NEG: "neg", OP_FOLD: "fold"}
    counts = dict.fromkeys(names.values(), 0)
    for pos, (kind, node_id) in enumerate(steps):
        if kind == "fold":
            op, reads, dst = OP_FOLD, (node_id, node_id), 0
        else:
            op, reads = defs[node_id][0], defs[node_id][1:]
        a, b = operand(reads[0]), operand(reads[1])
        for r in set(reads):  # read before the write: a dying operand's slot may take the result
            if last_use[r] == pos and r in slot_of:
                heapq.heappush(free, slot_of.pop(r))
        if kind == "node":
            if free:
                dst = heapq.heappop(free)
            else:
                dst, n_slots = n_slots, n_slots + 1
            slot_of[node_id] = dst
        code[pos] = (op, dst, a, b)
        counts[names[op]] += 1
    table = np.array([v * R_MOD_P % P for v in consts], np.uint32)
    return Program(code, table, n_slots, counts)


_programs: dict = {}


def program_for(air, num_public: int) -> Program:
    """The AIR's program, recorded on first use and cached per (class,
    width, number of public values)."""
    key = (type(air).__qualname__, air.width(), num_public)
    prog = _programs.get(key)
    if prog is None:
        rec = ProgramRecorder(air, num_public)
        air.eval(rec)
        prog = _programs[key] = emit(rec)
    return prog


def quotient_eager(air, public_values, sels, next_step: int, tq: torch.Tensor, alpha: EF4) -> torch.Tensor:
    """The kernel's plain version: the eager `ProverConstraintFolder` over
    the whole coset, divided by the zeroifier."""
    folder = ProverConstraintFolder(tq, next_step, public_values, sels, alpha)
    air.eval(folder)
    return ef_mul_base(folder.accumulator.arr, sels.inv_zeroifier)


def chunk_threads(m: int, slots: int) -> int:
    """Threads of one launch: the largest power of two of at most m whose
    [slot][thread] scratch fits SCRATCH_BUDGET."""
    t = m
    while t > 1 and 4 * max(slots, 1) * t > SCRATCH_BUDGET:
        t //= 2
    return t


def quotient_program(air, public_values, sels, next_step: int, tq: torch.Tensor, alpha: EF4) -> torch.Tensor:
    """Constraint accumulator over the coset, divided by the zeroifier, as
    an (m, 4) Montgomery tensor: `tq` (m, width) holds the trace on the
    coset in natural order, the next row of row i is row (i + next_step)
    mod m, `sels` holds (m,) Montgomery selector tensors. On the card, one
    launch of `quotient_program_kernel`; on a CPU tensor, the plain
    version."""
    if tq.device.type == "cpu":
        return quotient_eager(air, public_values, sels, next_step, tq, alpha)
    if tq.device.type != "cuda":
        raise ValueError(f"quotient_program: no path for device {tq.device}")
    from .._build import load_library

    m, width = tq.shape
    if tq.dtype != torch.int32 or not tq.is_contiguous() or width != air.width():
        raise ValueError(f"quotient_program: expected a contiguous int32 (m, {air.width()}) tensor")
    if m & (m - 1) or not 0 < next_step < m or width >= 1 << KIND_SHIFT or m * width >= 1 << 62:
        raise ValueError(f"quotient_program: shape {(m, width)}, next_step {next_step} unsupported")
    prog = program_for(air, len(public_values))
    dev = tq.device
    code, consts = prog.on(dev)
    pub = torch.tensor([v.v * R_MOD_P % P for v in public_values] or [0], dtype=torch.int32, device=dev)
    parts = (sels.is_first_row, sels.is_last_row, sels.is_transition, sels.inv_zeroifier)
    if any(s.shape != (m,) or s.device != dev for s in parts):
        raise ValueError("quotient_program: selectors must be (m,) tensors on the trace's device")
    sel = torch.stack(parts[:3]).to(torch.int32)  # the kernel's (3, m) rows: SEL_FIRST, SEL_LAST, SEL_TRANSITION
    invz = parts[3].to(torch.int32).contiguous()
    threads = chunk_threads(m, prog.slots)
    scratch = torch.empty(max(prog.slots, 1) * threads, dtype=torch.int32, device=dev)
    out = torch.empty((m, 4), dtype=torch.int32, device=dev)
    alpha_w = [v * R_MOD_P % P for v in alpha.as_u32_vec()]
    with torch.cuda.device(dev):
        err = load_library().tapstark_quotient_program(
            code.data_ptr(), len(prog.code), consts.data_ptr(), pub.data_ptr(), tq.data_ptr(), m, width,
            next_step, sel.data_ptr(), invz.data_ptr(), *alpha_w, scratch.data_ptr(), threads, out.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if err != 0:
        raise RuntimeError(f"quotient_program: CUDA error {err}")
    launches["quotient_program"] += 1
    return out
