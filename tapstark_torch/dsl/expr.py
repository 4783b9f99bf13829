"""Bitcoin-Script expression DSL: graph, stack compiler, input manager.

Fills the role of the reference's script_expr crate
(tap-stark's script_expr/src/: Dsl<F> expression DAG in alias.rs, the
two-pass CSE compiler in lib.rs:63-213, InputManager/ManagerAssign in
input_manager.rs): expressions are built by the verifier-emission code, then
compiled to a single Tapscript that takes witness inputs (and prover hints,
verified in-script) from the initial stack.

Design (own, same capabilities):
- every node knows its limb size: 'num' (query indices), base field (1 limb),
  extension field (4 limbs, [c3..c0] with c0 on top);
- shared subexpressions (refcount >= 2) are computed once, retained in place
  on the stack, and later uses copy them with depth-computed OP_PICKs (the
  CSE discipline the reference implements with copy-to-altstack via
  StackTracker);
- inputs live at the bottom of the stack (the witness) and are never
  consumed, only copied; a cleanup epilogue parks the result on the altstack
  and drops inputs + retained values.

Simulation: every node also evaluates on host scalars (F / EF4 / int), the
`run()` path executes the compiled script under the Tapscript interpreter and
cross-checks both.
"""

from __future__ import annotations

import itertools
from dataclasses import dataclass, field

from ..field.constants import P
from ..field.scalar import EF4, F
from ..script import opcodes as op
from ..script.builder import ScriptBuilder, encode_num
from ..script.interpreter import execute_script
from ..utils import reverse_bits_len
from . import gadgets as g

_ids = itertools.count()

NUM = "num"
BASE = "base"
EXT = "ext"

_LIMBS = {NUM: 1, BASE: 1, EXT: 4}


def _size_of(kind: str) -> int:
    return _LIMBS[kind]


class Expr:
    __slots__ = ("id", "kind", "vtype", "children", "meta")

    def __init__(self, kind: str, vtype: str, children: list["Expr"], meta=None):
        self.id = next(_ids)
        self.kind = kind
        self.vtype = vtype  # NUM | BASE | EXT | "void"
        self.children = children
        self.meta = meta

    # -- constructors ------------------------------------------------------
    @staticmethod
    def constant(v) -> "Expr":
        if isinstance(v, int):
            v = F(v)
        if isinstance(v, F):
            return Expr("const", BASE, [], v)
        if isinstance(v, EF4):
            return Expr("const", EXT, [], v)
        raise TypeError(type(v))

    @staticmethod
    def constant_num(n: int) -> "Expr":
        return Expr("const_num", NUM, [], int(n))

    # -- coercion / promotion ----------------------------------------------
    def _coerce(self, other) -> "Expr":
        if isinstance(other, Expr):
            return other
        return Expr.constant(other)

    @staticmethod
    def _arith_type(a: "Expr", b: "Expr") -> str:
        assert a.vtype in (BASE, EXT) and b.vtype in (BASE, EXT), (
            a.vtype,
            b.vtype,
        )
        return EXT if EXT in (a.vtype, b.vtype) else BASE

    # -- operators ---------------------------------------------------------
    # Constant subtrees FOLD at construction (ops on two consts evaluate
    # natively): emission-time values like zeta-derived selector factors and
    # generator-power products become single pushes instead of in-script
    # arithmetic — e.g. the quotient segment's (zeta/a * g^-j)^degree
    # numerators, which would otherwise cost log2(degree) Karatsuba squares.
    @staticmethod
    def _fold2(a: "Expr", b: "Expr", f):
        va, vb = a.meta, b.meta
        if isinstance(va, F) and isinstance(vb, EF4):
            va = EF4.from_base(va)
        if isinstance(vb, F) and isinstance(va, EF4):
            vb = EF4.from_base(vb)
        return Expr.constant(f(va, vb))

    def __add__(self, other):
        other = self._coerce(other)
        if self.kind == "const" and other.kind == "const":
            return self._fold2(self, other, lambda x, y: x + y)
        return Expr("add", self._arith_type(self, other), [self, other])

    __radd__ = __add__

    def __sub__(self, other):
        other = self._coerce(other)
        if self.kind == "const" and other.kind == "const":
            return self._fold2(self, other, lambda x, y: x - y)
        return Expr("sub", self._arith_type(self, other), [self, other])

    def __rsub__(self, other):
        return self._coerce(other).__sub__(self)

    def __mul__(self, other):
        other = self._coerce(other)
        if self.kind == "const" and other.kind == "const":
            return self._fold2(self, other, lambda x, y: x * y)
        return Expr("mul", self._arith_type(self, other), [self, other])

    __rmul__ = __mul__

    def __neg__(self):
        if self.kind == "const":
            return Expr.constant(-self.meta)
        return Expr("neg", self.vtype, [self])

    def square(self):
        if self.kind == "const":
            return Expr.constant(self.meta * self.meta)
        return Expr("square", self.vtype, [self])

    def double(self):
        if self.kind == "const":
            return Expr.constant(self.meta + self.meta)
        return Expr("double", self.vtype, [self])

    def exp_const(self, n: int):
        assert n >= 1
        if self.kind == "const":
            return Expr.constant(self.meta.exp(n))
        return Expr("exp_const", self.vtype, [self], int(n))

    @staticmethod
    def _match_sizes(a: "Expr", b: "Expr"):
        if a.vtype == EXT and b.vtype == BASE:
            b = b.to_ext()
        elif b.vtype == EXT and a.vtype == BASE:
            a = a.to_ext()
        return a, b

    def equal(self, other):
        a, b = self._match_sizes(self, self._coerce(other))
        return Expr("equal", "bool", [a, b])

    def equal_for_f(self, v):
        return self.equal(Expr.constant(v))

    def equal_verify(self, other):
        a, b = self._match_sizes(self, self._coerce(other))
        return Expr("equal_verify", "void", [a, b])

    def equal_verify_for_f(self, v):
        return self.equal_verify(Expr.constant(v))

    def to_ext(self):
        if self.vtype == EXT:
            return self
        if self.kind == "const":
            return Expr.constant(EF4.from_base(self.meta))
        return Expr("to_ext", EXT, [self])

    # -- index (number) operations ----------------------------------------
    def num_to_field(self):
        assert self.vtype == NUM
        return Expr("num_to_field", BASE, [self])

    def index_to_rou(self, log_height: int):
        """g_{log_height} ** reverse_bits(self, log_height) as a base value
        (reference script_helper.rs:292-330 semantics)."""
        assert self.vtype == NUM
        return Expr("index_to_rou", BASE, [self], int(log_height))

    def reverse_bits_len(self, bits: int):
        assert self.vtype == NUM
        return Expr("rev_bits", NUM, [self], int(bits))

    def bit(self, j: int, bits: int):
        """Extract bit j (0 = LSB) of a number known to fit in `bits` bits."""
        assert self.vtype == NUM
        return Expr("bit", NUM, [self], (int(j), int(bits)))

    # -- lookup tables (reference Table/Lookup opcodes,
    #    script_expr/src/script_gen.rs:38-41, alias.rs:249-279) -------------
    @staticmethod
    def from_table(values) -> "Expr":
        """A table of base-field constants materialized once on the stack
        (retained even at refcount 1) and indexed in place by lookup()."""
        vals = tuple(v if isinstance(v, F) else F(int(v)) for v in values)
        assert vals, "empty table"
        return Expr("table", "table", [], vals)

    def lookup(self, index) -> "Expr":
        """table.lookup(index) -> table[index] as a base value; `index` is a
        NUM expr (or int constant). Compiles to a single depth-computed
        OP_PICK against the retained table — the table is never copied."""
        assert self.kind == "table"
        if isinstance(index, int):
            index = Expr.constant_num(index)
        assert index.vtype == NUM
        return Expr("lookup", BASE, [self, index])


@dataclass
class InputVar:
    expr: Expr
    value: object  # int | F | EF4
    is_hint: bool


class InputManager:
    """Witness/hint bookkeeping for one script segment
    (reference input_manager.rs:14-281)."""

    def __init__(self, name: str = "manager"):
        self.name = name
        self.inputs: list[InputVar] = []
        self.hint_verifies: list[Expr] = []
        self.exec_exprs: list[Expr] = []

    def assign_input(self, value) -> Expr:
        return self._assign(value, is_hint=False)

    def assign_input_f(self, value) -> Expr:
        return self._assign(value, is_hint=False)

    def assign_hint_input_f(self, value) -> Expr:
        return self._assign(value, is_hint=True)

    def assign_input_num(self, n: int) -> Expr:
        e = Expr("input", NUM, [], len(self.inputs))
        self.inputs.append(InputVar(e, int(n), False))
        return e

    def _assign(self, value, is_hint: bool) -> Expr:
        if isinstance(value, int):
            value = F(value)
        vt = BASE if isinstance(value, F) else EXT
        e = Expr("input", vt, [], len(self.inputs))
        self.inputs.append(InputVar(e, value, is_hint))
        return e

    def add_hint_verify(self, e: Expr) -> None:
        assert e.kind == "equal_verify"
        self.hint_verifies.append(e)

    def set_exec_dsl(self, e: Expr) -> None:
        self.exec_exprs.append(e)

    # -- compile / run -----------------------------------------------------
    def witness(self) -> list[bytes]:
        """Initial stack: inputs in assignment order (input 0 deepest); ext
        values as [c3 c2 c1 c0] with c0 nearer the top."""
        out: list[bytes] = []
        for iv in self.inputs:
            v = iv.value
            if isinstance(v, int):
                out.append(encode_num(v))
            elif isinstance(v, F):
                out.append(encode_num(v.v))
            else:
                for limb in reversed(v.as_u32_vec()):
                    out.append(encode_num(limb))
        return out

    def compile(self) -> bytes:
        """All hint verifies, then the exec expressions (each must be a
        'void' verify or 'bool'), then cleanup + OP_1."""
        roots = list(self.hint_verifies) + list(self.exec_exprs)
        return compile_program(self.inputs, roots)

    def get_script_len(self) -> int:
        return len(self.compile())

    def run(self, debug: bool = False) -> None:
        """Execute the compiled segment under the Tapscript interpreter.

        With debug=True a source map is recorded during compilation (the
        analog of the reference's injected stack.debug() breakpoints,
        script_expr/src/lib.rs:157-159) and a failure names the DSL node
        whose emitted byte range contains the failing opcode."""
        source_map: list | None = [] if debug else None
        script = compile_program(
            self.inputs,
            list(self.hint_verifies) + list(self.exec_exprs),
            source_map=source_map,
        ) if debug else self.compile()
        res = execute_script(script, self.witness())
        if res.success:
            return
        if debug and res.error_offset >= 0:
            culprit = None
            for start, end, desc in source_map:
                if start <= res.error_offset < end:
                    culprit = desc
                    break
            raise AssertionError(
                f"{self.name}: script failed: {res.error} "
                f"at byte {res.error_offset} in node [{culprit}]"
            )
        assert res.success, f"{self.name}: script failed: {res.error}"


class ManagerAssign:
    """A set of per-segment input managers
    (reference input_manager.rs ManagerAssign)."""

    def __init__(self):
        self.managers: list[InputManager] = []

    def next_manager(self, name: str) -> InputManager:
        m = InputManager(name)
        self.managers.append(m)
        return m

    def run_all(self) -> dict[str, int]:
        sizes = {}
        for m in self.managers:
            m.run()
            sizes[m.name] = m.get_script_len()
        return sizes


# ---------------------------------------------------------------------------
# Simulation (host evaluation)
# ---------------------------------------------------------------------------


def simulate(e: Expr, cache: dict | None = None):
    if cache is None:
        cache = {}
    if e.id in cache:
        return cache[e.id]
    ch = [simulate(c, cache) for c in e.children]

    def as_ext(v):
        if isinstance(v, F):
            return EF4.from_base(v)
        return v

    k = e.kind
    if k == "const":
        r = e.meta
    elif k == "const_num":
        r = e.meta
    elif k == "input":
        raise AssertionError("inputs must be pre-seeded in the cache")
    elif k == "add":
        r = ch[0] + ch[1] if e.vtype == BASE else as_ext(ch[0]) + as_ext(ch[1])
    elif k == "sub":
        r = ch[0] - ch[1] if e.vtype == BASE else as_ext(ch[0]) - as_ext(ch[1])
    elif k == "mul":
        r = ch[0] * ch[1] if e.vtype == BASE else as_ext(ch[0]) * as_ext(ch[1])
    elif k == "neg":
        r = -ch[0]
    elif k == "square":
        r = ch[0] * ch[0]
    elif k == "double":
        r = ch[0] + ch[0]
    elif k == "exp_const":
        v = ch[0]
        r = v.exp(e.meta) if hasattr(v, "exp") else pow(v, e.meta, P)
    elif k == "to_ext":
        r = as_ext(ch[0])
    elif k == "num_to_field":
        r = F(ch[0])
    elif k == "index_to_rou":
        r = F.two_adic_generator(e.meta).exp(reverse_bits_len(ch[0], e.meta))
    elif k == "rev_bits":
        r = reverse_bits_len(ch[0], e.meta)
    elif k == "bit":
        r = (ch[0] >> e.meta[0]) & 1
    elif k == "equal":
        r = ch[0] == ch[1]
    elif k == "equal_verify":
        assert ch[0] == ch[1], f"equal_verify failed: {ch[0]} != {ch[1]}"
        r = None
    elif k == "table":
        r = e.meta
    elif k == "lookup":
        r = ch[0][ch[1]]
    else:
        raise AssertionError(k)
    cache[e.id] = r
    return r


def simulate_with_inputs(roots: list[Expr], inputs: list[InputVar]):
    cache = {iv.expr.id: iv.value for iv in inputs}
    return [simulate(r, cache) for r in roots]


# ---------------------------------------------------------------------------
# Compilation
# ---------------------------------------------------------------------------


def _count_refs(roots: list[Expr]) -> dict[int, int]:
    counts: dict[int, int] = {}

    def walk(e: Expr):
        counts[e.id] = counts.get(e.id, 0) + 1
        if counts[e.id] == 1:
            for c in e.children:
                walk(c)

    for r in roots:
        walk(r)
    return counts


class _Stack:
    """Model of the main stack: entries (tag, node_id, limbs), bottom first."""

    def __init__(self):
        self.entries: list[list] = []

    def push_temp(self, limbs: int):
        self.entries.append(["temp", None, limbs])

    def pop_temp(self, limbs: int):
        e = self.entries.pop()
        assert e[0] == "temp" and e[2] == limbs, e

    def retain_top(self, node_id: int):
        assert self.entries[-1][0] == "temp"
        self.entries[-1][0] = "retained"
        self.entries[-1][1] = node_id

    def depth_of(self, node_id: int) -> int:
        """Depth (0-based from top) of the node's topmost limb."""
        d = 0
        for e in reversed(self.entries):
            if e[1] == node_id and e[0] in ("retained", "input"):
                return d
            d += e[2]
        raise KeyError(node_id)

    def total_limbs(self) -> int:
        return sum(e[2] for e in self.entries)


def _copy_segment(sb: ScriptBuilder, depth: int, limbs: int):
    """Copy a retained segment (top limb at `depth`) to the top of the stack."""
    for _ in range(limbs):
        sb.num(depth + limbs - 1).emit(op.OP_PICK)


def _emit_op(sb: ScriptBuilder, e: Expr, child_types: list[str]):
    """Emit the op script; children values are on top of the stack in order."""
    k = e.kind
    if k == "const":
        v = e.meta
        if isinstance(v, F):
            sb.num(v.v)
        else:
            for limb in reversed(v.as_u32_vec()):
                sb.num(limb)
    elif k == "const_num":
        sb.num(e.meta)
    elif k == "table":
        for v in e.meta:
            sb.num(v.v)
    elif k in ("add", "sub", "mul"):
        lt, rt = child_types
        if e.vtype == BASE:
            sb.extend({"add": g.u31_add, "sub": g.u31_sub, "mul": g.u31_mul}[k]())
        else:
            # promote any base operand in place
            if lt == BASE and rt == BASE:
                raise AssertionError("ext op with two base children")
            if lt == BASE:
                # left (deeper) is 1 limb below the 4-limb right operand:
                # bring it up, extend, then restore order
                if k == "mul":
                    # commutative: bring the base limb to the top
                    sb.num(4).emit(op.OP_ROLL)
                    sb.extend(g.u31ext_mul_u31())
                else:
                    sb.num(4).emit(op.OP_ROLL)
                    sb.extend(g.u31_to_u31ext())
                    # now [b3..b0, a3..a0]: need [a.., b..] for sub
                    for _ in range(4):
                        sb.num(7).emit(op.OP_ROLL)
                    sb.extend(g.u31ext_add() if k == "add" else g.u31ext_sub())
            elif rt == BASE:
                if k == "mul":
                    sb.extend(g.u31ext_mul_u31())
                else:
                    sb.extend(g.u31_to_u31ext())
                    sb.extend(g.u31ext_add() if k == "add" else g.u31ext_sub())
            else:
                sb.extend(
                    {
                        "add": g.u31ext_add,
                        "sub": g.u31ext_sub,
                        "mul": g.u31ext_mul_karatsuba,
                    }[k]()
                )
    elif k == "neg":
        sb.extend(g.u31_neg() if e.vtype == BASE else g.u31ext_neg())
    elif k == "double":
        sb.extend(g.u31_double() if e.vtype == BASE else g.u31ext_double())
    elif k == "square":
        if e.vtype == BASE:
            sb.extend(g.u31_square())
        else:
            for _ in range(4):
                sb.num(3).emit(op.OP_PICK)
            sb.extend(g.u31ext_mul_karatsuba())
    elif k == "exp_const":
        _emit_exp_const(sb, e.vtype, e.meta)
    elif k == "to_ext":
        if child_types[0] != EXT:
            sb.extend(g.u31_to_u31ext())
    elif k == "num_to_field":
        pass  # canonical number < p is already a valid base limb
    elif k == "index_to_rou":
        _emit_index_to_rou(sb, e.meta)
    elif k == "rev_bits":
        _emit_rev_bits(sb, e.meta)
    elif k == "bit":
        j, bits = e.meta
        sb.extend(g.u31_to_bits(bits))
        for i in range(bits):
            sb.emit(op.OP_FROMALTSTACK)
            if i != j:
                sb.emit(op.OP_DROP)
        # keep only bit j on the stack: it was left among pops — handled above
    elif k == "equal":
        lt = child_types[0]
        if _size_of_type(e.children[0].vtype) == 1:
            sb.emit(op.OP_EQUAL)
        else:
            # 4-limb equality -> bool: compare limb pairs, AND together
            for i in range(4):
                sb.num(4 - i).emit(op.OP_ROLL)
                sb.emit(op.OP_EQUAL)
                sb.emit(op.OP_TOALTSTACK)
            sb.emit(op.OP_FROMALTSTACK)
            for _ in range(3):
                sb.emit(op.OP_FROMALTSTACK, op.OP_BOOLAND)
    elif k == "equal_verify":
        if _size_of_type(e.children[0].vtype) == 1:
            sb.emit(op.OP_EQUALVERIFY)
        else:
            sb.extend(g.u31ext_equalverify())
    else:
        raise AssertionError(k)


def _size_of_type(vt: str) -> int:
    if vt == "void":
        return 0
    if vt == "bool":
        return 1
    return _LIMBS[vt]


def _node_size(e: Expr) -> int:
    if e.kind == "table":
        return len(e.meta)
    return _size_of_type(e.vtype)


def _emit_exp_const(sb: ScriptBuilder, vtype: str, n: int):
    limbs = _LIMBS[vtype]
    if n == 1:
        return
    bits = bin(n)[2:]
    # [x] -> [x, acc=x]
    if limbs == 1:
        sb.emit(op.OP_DUP)
    else:
        for _ in range(4):
            sb.num(3).emit(op.OP_PICK)
    for b in bits[1:]:
        # square acc
        if limbs == 1:
            sb.extend(g.u31_square())
        else:
            for _ in range(4):
                sb.num(3).emit(op.OP_PICK)
            sb.extend(g.u31ext_mul_karatsuba())
        if b == "1":
            if limbs == 1:
                sb.emit(op.OP_OVER)
                sb.extend(g.u31_mul())
            else:
                for _ in range(4):
                    sb.num(7).emit(op.OP_PICK)
                sb.extend(g.u31ext_mul_karatsuba())
    # drop the retained base x under acc
    if limbs == 1:
        sb.emit(op.OP_NIP)
    else:
        for _ in range(4):
            sb.num(7).emit(op.OP_ROLL)
        for _ in range(2):
            sb.emit(op.OP_2DROP)


def _emit_rev_bits(sb: ScriptBuilder, bits: int):
    """[idx] -> [reverse_bits_len(idx, bits)]"""
    sb.extend(g.u31_to_bits(bits))  # altstack bits, pops LSB first
    sb.num(0)
    for j in range(bits):
        sb.emit(op.OP_FROMALTSTACK)  # bit j
        sb.emit(op.OP_IF)
        sb.num(1 << (bits - 1 - j)).emit(op.OP_ADD)
        sb.emit(op.OP_ENDIF)
    return sb


def _emit_index_to_rou(sb: ScriptBuilder, log_height: int):
    """[idx] -> [g_{log_height}^{reverse_bits(idx, log_height)}]"""
    if log_height == 0:
        sb.emit(op.OP_DROP).num(1)
        return
    sb.extend(g.u31_to_bits(log_height))  # pops LSB first
    sb.num(1)
    for j in range(log_height):
        # bit j of idx contributes g^(2^(log-1-j)) = two_adic_generator(j+1)
        sb.emit(op.OP_FROMALTSTACK)
        sb.emit(op.OP_IF)
        sb.extend(g.u31_mul_by_constant(F.two_adic_generator(j + 1).v))
        sb.emit(op.OP_ENDIF)


def compile_program(
    inputs: list[InputVar],
    roots: list[Expr],
    source_map: list | None = None,
) -> bytes:
    """Compile roots (void/bool exprs evaluated in order) into one script.
    Inputs occupy the bottom of the stack (the witness). Ends with cleanup
    and OP_1.

    If source_map is a list, appends (start_byte, end_byte, description) per
    emitted node — the debug facility (see InputManager.run(debug=True))."""
    counts = _count_refs(roots)
    stack = _Stack()
    for iv in inputs:
        stack.entries.append(["input", iv.expr.id, _size_of_type(iv.expr.vtype)])
    sb = ScriptBuilder()
    computed: set[int] = set()

    def emit(e: Expr):
        size = _node_size(e)
        start = len(sb) if source_map is not None else 0
        if e.kind == "input" or e.id in computed:
            _copy_segment(sb, stack.depth_of(e.id), size)
            stack.push_temp(size)
            if source_map is not None:
                source_map.append((start, len(sb), f"copy {e.kind}#{e.id}"))
            return
        if e.kind == "lookup":
            # the table is retained in place (phase 1); PICK the entry by a
            # depth computed from the on-stack index — the table is not copied
            tbl, idx = e.children
            emit(idx)
            d = stack.depth_of(tbl.id)  # counts the idx temp
            sb.num(d + len(tbl.meta) - 2).emit(op.OP_SWAP, op.OP_SUB, op.OP_PICK)
            stack.pop_temp(1)
            stack.push_temp(1)
            if source_map is not None:
                source_map.append((start, len(sb), f"lookup:{e.vtype}#{e.id}"))
            return
        if e.kind == "mul" and any(c.kind == "const" for c in e.children):
            # multiply-by-constant: skip pushing the constant operand and use
            # the fixed double-and-add / constant-Karatsuba gadgets (both-
            # const products fold at construction and never reach here)
            ca, cb = e.children
            const_e, dyn = (ca, cb) if ca.kind == "const" else (cb, ca)
            if dyn.kind != "const":
                emit(dyn)
                start = len(sb) if source_map is not None else 0
                v = const_e.meta
                if e.vtype == BASE:
                    sb.extend(g.u31_mul_by_constant(v.v))
                elif dyn.vtype == BASE:
                    assert isinstance(v, EF4)
                    sb.extend(g.u31_mul_by_ext_constant([int(x) for x in v.c]))
                elif isinstance(v, F):
                    sb.extend(g.u31ext_mul_by_constant([v.v, 0, 0, 0]))
                else:
                    sb.extend(g.u31ext_mul_by_constant([int(x) for x in v.c]))
                stack.pop_temp(_size_of_type(dyn.vtype))
                stack.push_temp(size)
                if source_map is not None:
                    source_map.append(
                        (start, len(sb), f"mul_const:{e.vtype}#{e.id}")
                    )
                return
        for c in e.children:
            emit(c)
        start = len(sb) if source_map is not None else 0
        _emit_op(sb, e, [c.vtype for c in e.children])
        for c in reversed(e.children):
            stack.pop_temp(_size_of_type(c.vtype))
        stack.push_temp(size)
        if source_map is not None:
            source_map.append((start, len(sb), f"{e.kind}:{e.vtype}#{e.id}"))

    # Phase 1: materialize every shared subexpression once, child-first, into
    # a retained region just above the inputs. Because descendants are
    # retained before their ancestors, each computation only creates pure
    # temporaries above the retained region (operands stay contiguous).
    shared: list[Expr] = []
    seen: set[int] = set()

    def collect(e: Expr):
        if e.id in seen:
            return
        seen.add(e.id)
        for c in e.children:
            collect(c)
        if e.kind == "table" or (
            counts.get(e.id, 0) > 1
            and e.kind not in ("input", "const", "const_num")
            and _size_of_type(e.vtype) > 0
        ):
            # consts are never retained: re-pushing one costs no more than
            # the OP_PICK copies a retained slot would
            shared.append(e)

    for r in roots:
        collect(r)
    for e in shared:
        emit(e)
        stack.retain_top(e.id)
        computed.add(e.id)

    # Phase 2: evaluate the verification roots.
    for r in roots:
        emit(r)
        sz = _size_of_type(r.vtype)
        if r.vtype == "bool":
            sb.emit(op.OP_VERIFY)
            stack.pop_temp(1)
        elif sz:
            raise AssertionError("program roots must be void or bool")
        else:
            stack.pop_temp(0)

    # cleanup: drop inputs + retained values, leave OP_1
    remaining = stack.total_limbs()
    for _ in range(remaining // 2):
        sb.emit(op.OP_2DROP)
    if remaining % 2:
        sb.emit(op.OP_DROP)
    sb.emit(op.OP_1)
    return sb.build()
