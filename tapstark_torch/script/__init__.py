from . import opcodes
from .builder import ScriptBuilder, decode_num, encode_num, push_bytes, push_int
from .interpreter import ExecutionResult, ScriptError, execute_script

__all__ = [
    "opcodes",
    "ScriptBuilder",
    "decode_num",
    "encode_num",
    "push_bytes",
    "push_int",
    "ExecutionResult",
    "ScriptError",
    "execute_script",
]
