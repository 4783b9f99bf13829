from .expr import (
    Expr,
    InputManager,
    ManagerAssign,
    compile_program,
    simulate,
    simulate_with_inputs,
)
from .value_counter import ValueCounter

__all__ = [
    "Expr",
    "InputManager",
    "ManagerAssign",
    "compile_program",
    "simulate",
    "simulate_with_inputs",
    "ValueCounter",
]
