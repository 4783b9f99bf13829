"""CUDA C++ generated from a constraint program (`air/program.py`).

`plan` cuts the program into segments of at most S instructions, each cut
where the fewest values are live, and gives every value that crosses a cut
a row of the live buffer (`[value][row]`): a value's row is its own from
the segment that defines it to the last that reads it, so a segment may
load its inputs at their first use and store its outputs at their
definition in any order. `sources` writes each segment as one translation
unit (csrc/quotient.cuh says what the code does on the card); `kernels`
builds them with nvcc, one process a segment, all at once, into one shared
library under `tapstark_torch/_build/` named by a hash of the program's
code and constants, S, the headers and this generator, at the program's
first use on the card, and loads it with ctypes. A failed build raises.
"""

from __future__ import annotations

import ctypes
import hashlib
import heapq
import os
import re
import time
from dataclasses import dataclass, field

import numpy as np

from .program import (
    K_CONST,
    K_LOCAL,
    K_NEXT,
    K_PUBLIC,
    K_SEL,
    K_VAL,
    KIND_SHIFT,
    MAX_PUBLIC,
    OP_ADD,
    OP_FOLD,
    OP_MUL,
    OP_NEG,
    OP_SUB,
    SEL_FIRST,
    SEL_LAST,
    SEL_TRANSITION,
    Program,
)

_INDEX_MASK = (1 << KIND_SHIFT) - 1
ACC_ROWS = 4  # rows 0-3 of the live buffer: the accumulator, once a program has a cut


class QuotientArgs(ctypes.Structure):
    """csrc/quotient.cuh QuotientArgs."""

    _fields_ = [
        ("tq", ctypes.c_void_p),
        ("live", ctypes.c_void_p),
        ("out", ctypes.c_void_p),
        ("coset", ctypes.c_void_p),
        ("alpha_pows", ctypes.c_void_p),
        ("row0", ctypes.c_longlong),
        ("rows", ctypes.c_longlong),
        ("ld", ctypes.c_longlong),
        ("next_step", ctypes.c_longlong),
        ("log_lo", ctypes.c_int),
        ("log_hi", ctypes.c_int),
        ("log_q", ctypes.c_int),
        ("g_inv", ctypes.c_uint32),
        ("pub", ctypes.c_uint32 * MAX_PUBLIC),
    ]


@dataclass
class Segment:
    start: int  # instructions [start, stop)
    stop: int
    loads: dict  # value -> live-buffer row, read in this segment, defined in an earlier one
    stores: dict  # value -> live-buffer row, defined here, read in a later segment
    live_out: int  # values carried across the cut after this segment (accumulator included)
    folds: int
    acc_in: bool  # loads the accumulator (folded before, and folds here or is the last)
    acc_out: bool  # stores it (folds here, and is not the last)


@dataclass
class Plan:
    """A program cut into segments. Values are instruction indices; the
    selectors are values n + SEL_FIRST, n + SEL_LAST, n + SEL_TRANSITION,
    defined in the segment that first reads them."""

    segments: list[Segment]
    live_rows: int  # rows of the live buffer
    selectors: dict  # selector -> the segment that computes it

    @property
    def alpha_powers(self) -> int:
        """Powers of alpha the segments read: alpha^0 .. alpha^(most folds)."""
        return max(sg.folds for sg in self.segments) + 1


def plan(prog: Program, max_instructions: int) -> Plan:
    n = len(prog.code)
    # every read of a value: (position, value)
    operands = prog.code[:, 1:].astype(np.int64).reshape(-1)
    kinds, idx = operands >> KIND_SHIFT, operands & _INDEX_MASK
    pos = np.repeat(np.arange(n), 2)
    is_val = kinds == K_VAL
    is_sel = kinds == K_SEL
    read_pos = np.concatenate([pos[is_val], pos[is_sel]])
    read_val = np.concatenate([idx[is_val], n + idx[is_sel]])
    last = np.full(n + 3, -1, np.int64)
    np.maximum.at(last, read_val, read_pos)
    first_sel = np.full(3, n, np.int64)
    np.minimum.at(first_sel, idx[is_sel], pos[is_sel])
    defined = np.concatenate([np.arange(n), first_sel])
    used = last >= 0
    # live[c]: values defined before instruction c and read at c or later
    live = np.zeros(n + 2, np.int64)
    np.add.at(live, defined[used] + 1, 1)
    np.add.at(live, last[used] + 1, -1)
    live = np.cumsum(live)[: n + 1]

    cuts, start = [], 0
    while n - start > max_instructions:
        lo, hi = start + max(1, max_instructions // 2), start + max_instructions
        window = live[lo : hi + 1]
        c = hi - int(np.argmin(window[::-1]))  # the latest of the least live
        cuts.append(c)
        start = c
    bounds = [0, *cuts, n]
    nseg = len(bounds) - 1

    def seg(p):
        return np.searchsorted(cuts, p, side="right")

    seg_def, seg_last = seg(defined), seg(last)
    crossing = used & (seg_last > seg_def)
    loads: list[dict] = [{} for _ in range(nseg)]
    stores: list[dict] = [{} for _ in range(nseg)]
    row_of: dict[int, int] = {}
    first_row = ACC_ROWS if nseg > 1 else 0
    free: list[int] = []
    busy: list[tuple[int, int]] = []  # (last segment, row)
    n_rows = first_row
    for v in sorted(np.flatnonzero(crossing), key=lambda v: (seg_def[v], defined[v])):
        while busy and busy[0][0] < seg_def[v]:
            heapq.heappush(free, heapq.heappop(busy)[1])
        if free:
            s = heapq.heappop(free)
        else:
            s, n_rows = n_rows, n_rows + 1
        heapq.heappush(busy, (int(seg_last[v]), s))
        row_of[int(v)] = s
        stores[seg_def[v]][int(v)] = s
    read_seg = seg(read_pos)
    for p_seg, v in zip(read_seg, read_val):
        v = int(v)
        if v in row_of and p_seg != seg_def[v]:
            loads[p_seg][v] = row_of[v]

    fold_pos = np.flatnonzero(prog.code[:, 0] == OP_FOLD)
    folds = [int(((fold_pos >= a) & (fold_pos < b)).sum()) for a, b in zip(bounds, bounds[1:])]
    segments = []
    for k in range(nseg):
        last_seg, before = k + 1 == nseg, any(folds[:k])
        carried = int((crossing & (seg_def <= k) & (seg_last > k)).sum())
        acc_live = not last_seg and (before or folds[k] > 0)  # the accumulator crosses this cut
        segments.append(Segment(bounds[k], bounds[k + 1], loads[k], stores[k], carried + ACC_ROWS * acc_live,
                                folds[k], before and (folds[k] > 0 or last_seg), folds[k] > 0 and not last_seg))
    selectors = {s: int(seg(first_sel[s])) for s in range(3) if first_sel[s] < n}
    return Plan(segments, n_rows, selectors)


_SEL_NAMES = {SEL_FIRST: "is_first_row", SEL_LAST: "is_last_row", SEL_TRANSITION: "is_transition"}
_STATEMENT = {OP_ADD: "add_mod({}, {})", OP_SUB: "sub_mod({}, {})", OP_MUL: "mont_mul({}, {})", OP_NEG: "neg_mod({})"}


def sources(prog: Program, pl: Plan, tag: str) -> list[str]:
    """One translation unit a segment; segment k's C entry point is
    `tag`_k (csrc/quotient.cuh QUOTIENT_SEGMENT_ENTRY)."""
    n, nseg = len(prog.code), len(pl.segments)
    out = []
    for k, sg in enumerate(pl.segments):
        body: list[str] = []
        have: set[str] = set()

        def ref(x: int) -> str:
            kind, i = x >> KIND_SHIFT, x & _INDEX_MASK
            if kind == K_PUBLIC:
                return f"a.pub[{i}]"
            if kind == K_CONST:
                return f"0x{int(prog.consts[i]):08x}u"
            name = {K_VAL: "v", K_LOCAL: "l", K_NEXT: "n", K_SEL: "s"}[kind] + str(i)
            if name not in have:
                if kind == K_LOCAL or kind == K_NEXT:
                    load = f"{'tl' if kind == K_LOCAL else 'tn'}[{i} * ld]"
                else:  # defined in an earlier segment: its row of the live buffer
                    value = i if kind == K_VAL else n + i
                    if value not in sg.loads:
                        raise AssertionError(f"{prog.name}: segment {k} reads {name}, which no earlier one stores")
                    load = f"lv[{sg.loads[value]} * ld]"
                body.append(f"    const uint32_t {name} = {load};")
                have.add(name)
            return name

        here = sorted(s for s, at in pl.selectors.items() if at == k)
        if here:
            body.append("    const uint32_t x = coset_x(a, row);")
        if SEL_FIRST in here or SEL_LAST in here:
            body.append("    const uint32_t zh = coset_zh(a, row, 0);")
        if SEL_FIRST in here and SEL_LAST in here:
            body.append(f"    uint32_t s{SEL_FIRST}, s{SEL_LAST};")
            body.append(f"    first_and_last_row(x, zh, a.g_inv, s{SEL_FIRST}, s{SEL_LAST});")
        elif SEL_FIRST in here:
            body.append(f"    const uint32_t s{SEL_FIRST} = first_row(x, zh);")
        elif SEL_LAST in here:
            body.append(f"    const uint32_t s{SEL_LAST} = last_row(x, zh, a.g_inv);")
        if SEL_TRANSITION in here:
            body.append(f"    const uint32_t s{SEL_TRANSITION} = sub_mod(x, a.g_inv);")
        for s in here:
            have.add(f"s{s}")
            if n + s in sg.stores:
                body.append(f"    lv[{sg.stores[n + s]} * ld] = s{s};  // {_SEL_NAMES[s]}")
        if sg.folds:
            body.append("    uint32_t sum[4] = {0u, 0u, 0u, 0u};")
        pending, e = None, sg.folds  # a fold waiting for its pair; the next fold's power is alpha^(e - 1)
        for p in range(sg.start, sg.stop):
            op, a, b = (int(v) for v in prog.code[p])
            if op == OP_FOLD:
                e -= 1
                if pending is None:
                    pending = ref(a)
                else:
                    body.append(f"    fold_pair(sum, a, {e + 1}, {pending}, {ref(a)});")
                    pending = None
                continue
            args = (ref(a),) if op == OP_NEG else (ref(a), ref(b))
            body.append(f"    const uint32_t v{p} = {_STATEMENT[op].format(*args)};")
            have.add(f"v{p}")
            if p in sg.stores:
                body.append(f"    lv[{sg.stores[p]} * ld] = v{p};")
        if pending is not None:
            body.append(f"    fold_one(sum, a, 0, {pending});")
        if sg.acc_in:
            body.append("    uint32_t acc[4] = {" + ", ".join(f"lv[{j} * ld]" for j in range(4)) + "};")
            if sg.folds:
                body.append(f"    fold_segment(acc, a, {sg.folds}, sum);")
        elif sg.folds:
            body.append("    const uint32_t (&acc)[4] = sum;")
        elif k + 1 == nseg:
            body.append("    const uint32_t acc[4] = {0u, 0u, 0u, 0u};")
        if k + 1 == nseg:
            body.append("    store_quotient(a, r, row, acc);")
        elif sg.acc_out:
            body += [f"    lv[{j} * ld] = acc[{j}];" for j in range(4)]
        out.append(
            f"// Segment {k} of {nseg} of the constraint program of {prog.name}: instructions\n"
            f"// [{sg.start}, {sg.stop}) of {n}, {len(sg.loads)} values loaded from the live buffer, "
            f"{len(sg.stores)} stored,\n// {sg.live_out} carried across the cut after it. Generated by "
            "tapstark_torch/air/codegen.py;\n// the shared code and the design: csrc/quotient.cuh.\n"
            '#include "quotient.cuh"\n\nnamespace {\n\n'
            f"__global__ void __launch_bounds__(kQuotientBlock) quotient_segment_{k}(const __grid_constant__ "
            "QuotientArgs a) {\n"
            "  const long long ld = a.ld;\n"
            "  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;\n"
            "  for (long long r = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; r < a.rows; "
            "r += stride) {\n"
            "    const long long row = a.row0 + r;  // the coset's row: the selectors and 1/zh\n"
            "    const long long rn = r + a.next_step;  // the next row's, in the buffer\n"
            "    const uint32_t* __restrict__ tl = a.tq + r;\n"
            "    const uint32_t* __restrict__ tn = a.tq + (rn < ld ? rn : rn - ld);\n"
            "    uint32_t* __restrict__ lv = a.live + r;\n"
            + "\n".join(body)
            + "\n  }\n}\n\n}  // namespace\n\n"
            f"QUOTIENT_SEGMENT_ENTRY({tag}_{k}, quotient_segment_{k})\n"
        )
    return out


@dataclass
class Kernels:
    """A program's built segments on the card."""

    plan: Plan
    entries: list  # ctypes functions (const QuotientArgs*, stream) -> CUDA error
    path: str
    built: bool
    seconds: float  # generation, build (when built) and load
    # per segment: {"registers", "spill_stores", "spill_loads"} and, when built, "nvcc_seconds"
    ptxas: list = field(default_factory=list)


def ptxas_by_segment(report: str, nseg: int) -> list[dict]:
    """Registers and spill bytes of each segment's kernel, from ptxas -v."""
    found: dict[int, dict] = {}
    k = None
    for line in report.splitlines():
        entry = re.search(r"Compiling entry function '[^']*quotient_segment_(\d+)", line)
        if entry:
            k = int(entry.group(1))
            found.setdefault(k, {})
        elif k is not None and "spill stores" in line:
            st, ld = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line).groups()
            found[k].update(spill_stores=int(st), spill_loads=int(ld))
        elif k is not None and "registers" in line:
            found[k]["registers"] = int(re.search(r"Used (\d+) registers", line).group(1))
    if sorted(found) != list(range(nseg)) or any(len(v) != 3 for v in found.values()):
        raise RuntimeError(f"ptxas's report lacks a segment's registers or spills: {found}")
    return [found[k] for k in range(nseg)]


_kernels: dict = {}


def kernels(prog: Program, max_instructions: int) -> Kernels:
    """The program's segments, generated, built (once per source hash) and
    loaded (once per process)."""
    from .. import _build

    key = (id(prog), max_instructions)
    if key in _kernels:
        return _kernels[key]
    t0 = time.perf_counter()
    pl = plan(prog, max_instructions)
    h = hashlib.sha256(prog.code.tobytes() + prog.consts.tobytes() + str(max_instructions).encode())
    for path in [*_build.headers(), __file__]:  # the generator's own source too
        with open(path, "rb") as f:
            h.update(f.read())
    h.update(" ".join(_build.NVCC_FLAGS).encode())
    tag = f"tq_{h.hexdigest()[:16]}"
    so_path = os.path.join(_build.BUILD_DIR, f"libquotient_{tag[3:]}.so")
    built = not os.path.exists(so_path)
    nvcc_seconds = None
    if built:
        os.makedirs(_build.BUILD_DIR, exist_ok=True)
        srcs = []
        for k, text in enumerate(sources(prog, pl, tag)):
            srcs.append(f"{so_path}.{os.getpid()}.{k}.cu")
            with open(srcs[-1], "w") as f:
                f.write(text)
        try:
            nvcc_seconds = _build.compile_library(srcs, so_path, ["-I", _build.CSRC])
        finally:
            for src in srcs:
                os.remove(src)
    with open(f"{so_path}.ptxas.txt") as f:
        ptxas = ptxas_by_segment(f.read(), len(pl.segments))
    lib = ctypes.CDLL(so_path)
    entries = []
    for k in range(len(pl.segments)):
        fn = getattr(lib, f"{tag}_{k}")
        fn.argtypes, fn.restype = [ctypes.c_void_p, ctypes.c_void_p], ctypes.c_int
        entries.append(fn)
    if nvcc_seconds:
        for px, seconds in zip(ptxas, nvcc_seconds):
            px["nvcc_seconds"] = seconds
    ks = _kernels[key] = Kernels(pl, entries, so_path, built, time.perf_counter() - t0, ptxas)
    _build.build_info.setdefault("quotient", {})[f"{prog.name} S={max_instructions}"] = {
        "path": so_path, "built": built, "seconds": ks.seconds, "segments": len(pl.segments), "ptxas": ptxas,
    }
    return ks
