"""ValueCounter — dedup counter of distinct u32 values requiring
bit commitments (reference script_expr/src/value_manager.rs:3-39; source of
the README table's "total u32 num" column).

Counting policy (matches the reference): only plain witness inputs count.
Hint inputs (assign_hint_input_f) are excluded — the reference's
set_value_count iterates input_var only, never input_hint
(script_expr/src/input_manager.rs:111-120,162-166). This is principled:
hints are verified in-script against committed/constant data, so a wrong
hint makes the script fail — equivocation is impossible and no Winternitz
bit commitment is needed for them."""

from __future__ import annotations

from ..field.scalar import EF4, F


class ValueCounter:
    def __init__(self):
        self._values: set[int] = set()

    def add_u32(self, v: int) -> None:
        self._values.add(int(v) & 0xFFFFFFFF)

    def add_value(self, v) -> None:
        if isinstance(v, (F, EF4)):
            for limb in v.as_u32_vec():
                self.add_u32(limb)
        else:
            self.add_u32(v)

    def add_manager(self, manager) -> None:
        for iv in manager.inputs:
            if not iv.is_hint:
                self.add_value(iv.value)

    def get_value_num(self) -> int:
        return len(self._values)
