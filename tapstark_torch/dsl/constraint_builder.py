"""ScriptConstraintBuilder — an AirBuilder whose expressions are DSL nodes.

Reference parity: script_expr/src/script_builder.rs:14-196. Evaluates the AIR
once more to build the in-script constraint accumulator
acc = ((c0 * alpha + c1) * alpha + c2) ... from the trace openings at zeta.
Trace openings and public values enter the script as witness inputs.

Wide AIRs (width*2 EF4 openings alone exceed Bitcoin's 1000-element stack)
use emit_sharded_constraints: the AIR is evaluated once against PLACEHOLDER
inputs, the constraint list is partitioned into chunks by distinct-input limb
budget, and each chunk becomes its own script whose running alpha-accumulator
is bit-committed at the chunk boundary (same committed-boundary discipline as
the FRI reduced-opening spill in fri/pcs.py).
"""

from __future__ import annotations

from ..air import AirBuilder, TwoRowMatrixView
from ..field.scalar import EF4, F
from .expr import BASE, EXT, Expr, InputManager, ManagerAssign, simulate


class ScriptConstraintBuilder(AirBuilder):
    def __init__(
        self,
        manager: InputManager | None,
        trace_local: list[EF4],
        trace_next: list[EF4],
        public_values: list[F],
        is_first_row: Expr,
        is_last_row: Expr,
        is_transition: Expr,
        alpha: EF4,
    ):
        self.manager = manager
        if manager is None:
            # recording mode: placeholder inputs, bound to real managers
            # later by emit_sharded_constraints
            self.values: dict[int, object] = {}

            def _assign(v):
                e = Expr("input", EXT if isinstance(v, EF4) else BASE, [], None)
                self.values[e.id] = v
                return e

        else:
            _assign = manager.assign_input_f
        local_in = [_assign(v) for v in trace_local]
        next_in = [_assign(v) for v in trace_next]
        self._main = TwoRowMatrixView(local_in, next_in)
        self._public = [_assign(v) for v in public_values]
        self._first = is_first_row
        self._last = is_last_row
        self._transition = is_transition
        self._alpha = Expr.constant(alpha)
        self.constraints: list[Expr] = []

    def main(self):
        return self._main

    def is_first_row(self):
        return self._first

    def is_last_row(self):
        return self._last

    def is_transition_window(self, size: int):
        assert size == 2
        return self._transition

    def public_values(self):
        return self._public

    def assert_zero(self, x):
        if not isinstance(x, Expr):
            x = Expr.constant(x)
        self.constraints.append(x)

    def accumulator_expr(self) -> Expr:
        """acc = sum_k alpha^{n-1-k} * C_k (same value as the Horner form).
        The absolute alpha-power WEIGHTS fold into each constraint's leading
        constant (constraints are selector_const * expr), so the whole
        accumulator costs one constant-multiply per constraint and no
        alpha-chain multiplies."""
        alpha = self._alpha.meta
        n = len(self.constraints)
        acc = None
        for k, c in enumerate(self.constraints):
            term = _weighted(c, alpha.exp(n - 1 - k))
            acc = term if acc is None else acc + term
        return acc


def _weighted(c: Expr, weight: EF4) -> Expr:
    """weight * c with the constant distributed into c's leading const
    factor when c = const * expr (one folded constant-multiply instead of
    two)."""
    if weight == EF4.one():
        return c
    if c.kind == "mul":
        a, b = c.children
        if a.kind == "const":
            return Expr.constant(weight * _to_ef(a.meta)) * b
        if b.kind == "const":
            return Expr.constant(weight * _to_ef(b.meta)) * a
    return Expr.constant(weight) * c


def _to_ef(v) -> EF4:
    return v if isinstance(v, EF4) else EF4.from_base(v)


def _placeholder_ids(e: Expr, values: dict[int, object], memo: dict) -> set:
    """Distinct placeholder-input ids referenced by e."""
    r = memo.get(e.id)
    if r is not None:
        return r
    if e.id in values:
        r = {e.id}
    else:
        r = set()
        for c in e.children:
            r |= _placeholder_ids(c, values, memo)
    memo[e.id] = r
    return r


def _clone_expr(e: Expr, values: dict, manager: InputManager, cache: dict) -> Expr:
    """Rebuild e for `manager`: placeholders become assigned inputs (each
    distinct placeholder assigned once per chunk via the shared cache)."""
    r = cache.get(e.id)
    if r is not None:
        return r
    if e.id in values:
        r = manager.assign_input_f(values[e.id])
    else:
        r = Expr(
            e.kind,
            e.vtype,
            [_clone_expr(c, values, manager, cache) for c in e.children],
            e.meta,
        )
    cache[e.id] = r
    return r


def emit_sharded_constraints(
    manager_assign: ManagerAssign,
    recording: ScriptConstraintBuilder,
    alpha: EF4,
    folded_constraints: EF4,
    chunk_limb_budget: int = 600,
) -> None:
    """Partition `recording.constraints` (built against placeholders) into
    scripts whose witnesses fit the stack. Chunk k verifies
    acc_k == acc_{k-1} * alpha^{len(chunk)} + sum alpha^j c_j with acc values
    bit-committed at the boundaries; the final chunk checks the full
    accumulator against the emission-time constant `folded_constraints`."""
    values = recording.values
    limb_of = {pid: (4 if isinstance(v, EF4) else 1) for pid, v in values.items()}

    # native constraint values (one shared simulate cache, placeholders seeded)
    sim_cache = dict(values)
    c_natives = [simulate(c, sim_cache) for c in recording.constraints]

    # partition by distinct-input limb budget
    memo: dict = {}
    chunks: list[list[int]] = []
    cur: list[int] = []
    cur_ids: set = set()
    for i, c in enumerate(recording.constraints):
        ids = _placeholder_ids(c, values, memo)
        new_ids = cur_ids | ids
        cost = sum(limb_of[p] for p in new_ids)
        if cur and cost > chunk_limb_budget:
            chunks.append(cur)
            cur, cur_ids = [], set()
            new_ids = set(ids)
        cur.append(i)
        cur_ids = new_ids
    if cur:
        chunks.append(cur)

    def _ef(v):
        return v if isinstance(v, EF4) else EF4.from_base(v)

    # acc = sum_k alpha^{n-1-k} C_k with the weights folded into each
    # constraint's leading constant (see _weighted): chunks partition a
    # plain SUM, so chunk boundaries carry the running partial with no
    # alpha-multiply at the seam.
    n = len(recording.constraints)
    acc_native = None
    for k, chunk in enumerate(chunks):
        last = k == len(chunks) - 1
        name = (
            "trace-constraints"
            if len(chunks) == 1
            else f"trace-constraints part:{k}"
        )
        m = manager_assign.next_manager(name)
        cache: dict = {}
        acc = m.assign_input_f(acc_native) if k > 0 else None
        for i in chunk:
            w = alpha.exp(n - 1 - i)
            ce = _weighted(
                _clone_expr(recording.constraints[i], values, m, cache), w
            )
            acc = ce if acc is None else acc + ce
            cv = w * _ef(c_natives[i])
            acc_native = cv if acc_native is None else acc_native + cv
        if last:
            m.set_exec_dsl(acc.equal_verify_for_f(folded_constraints))
        else:
            m.set_exec_dsl(acc.equal_verify(m.assign_input_f(acc_native)))
    assert acc_native == _ef(folded_constraints), "accumulator drift"
