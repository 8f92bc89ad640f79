"""ctypes bindings for the native C++ MPS parser.

Assembles the same :class:`~relp_tpu_torch.io.mps.MPS` structure as the pure-Python
parser (including the reference's rows-sorted-by-name convention), but with
tokenization, name interning, and exact decimal parsing done in C++
(native/mps_parser.cpp).  Falls back transparently when the shared library
has not been built.
"""

from __future__ import annotations

import ctypes
import os
from fractions import Fraction
from typing import Dict, List, Optional, Tuple

import numpy as np

from relp_tpu_torch.data.elements import ConstraintRelation, Objective, VariableType
from relp_tpu_torch.io.errors import Inconsistency, ParseError
from relp_tpu_torch.io.mps import (
    MPS,
    BoundGroup,
    BoundValue,
    MpsColumn,
    RangeGroup,
    Rhs,
    Row,
)

_LIB_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    "native",
    "libmps_parser.so",
)

_lib = None


class _Record(ctypes.Structure):
    _fields_ = [
        ("kind", ctypes.c_int32),
        ("a", ctypes.c_int64),
        ("b", ctypes.c_int64),
        ("extra", ctypes.c_int64),
        ("mantissa", ctypes.c_int64),
        ("exp10", ctypes.c_int32),
    ]


def _load():
    global _lib
    if _lib is not None:
        return _lib
    if not os.path.exists(_LIB_PATH):
        return None
    lib = ctypes.CDLL(_LIB_PATH)
    lib.mps_parse.restype = ctypes.c_void_p
    lib.mps_parse.argtypes = [ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32]
    lib.mps_num_records.restype = ctypes.c_int64
    lib.mps_num_records.argtypes = [ctypes.c_void_p]
    lib.mps_records.restype = ctypes.POINTER(_Record)
    lib.mps_records.argtypes = [ctypes.c_void_p]
    for fn in (
        "mps_row_names",
        "mps_col_names",
        "mps_program_name",
        "mps_cost_row",
        "mps_error",
    ):
        getattr(lib, fn).restype = ctypes.c_char_p
        getattr(lib, fn).argtypes = [ctypes.c_void_p]
    lib.mps_objective_max.restype = ctypes.c_int32
    lib.mps_objective_max.argtypes = [ctypes.c_void_p]
    lib.mps_free.argtypes = [ctypes.c_void_p]
    _lib = lib
    return lib


def native_available() -> bool:
    return _load() is not None


def _fraction(mantissa: int, exp10: int) -> Fraction:
    if exp10 >= 0:
        return Fraction(mantissa * 10**exp10)
    return Fraction(mantissa, 10 ** (-exp10))


def parse_native(text: str, fixed: bool) -> MPS:
    """Parse via the C++ library; raises on parse errors."""
    lib = _load()
    if lib is None:
        raise RuntimeError("native parser not built (run make in native/)")
    data = text.encode()
    handle = lib.mps_parse(data, len(data), 1 if fixed else 0)
    try:
        error = lib.mps_error(handle).decode()
        if error:
            raise ParseError(error)
        n = lib.mps_num_records(handle)
        records = lib.mps_records(handle)

        row_names = lib.mps_row_names(handle).decode().split("\n")[:-1]
        col_names = lib.mps_col_names(handle).decode().split("\n")[:-1]
        program_name = lib.mps_program_name(handle).decode()
        cost_row = lib.mps_cost_row(handle).decode()
        if not cost_row:
            raise Inconsistency("No cost name read.")
        objective = (
            Objective.MAXIMIZE if lib.mps_objective_max(handle) else Objective.MINIMIZE
        )

        # Rows sorted by name with index remap (reference convention).
        row_types: Dict[int, str] = {}
        for k in range(n):
            r = records[k]
            if r.kind == 0:
                row_types[r.b] = chr(r.a)
        order = sorted(range(len(row_names)), key=lambda i: row_names[i])
        remap = {old: new for new, old in enumerate(order)}
        rows = []
        rel = {
            "E": ConstraintRelation.EQUAL,
            "L": ConstraintRelation.LESS,
            "G": ConstraintRelation.GREATER,
        }
        for old in order:
            rows.append(Row(row_names[old], rel[row_types[old]]))
        for r1, r2 in zip(rows, rows[1:]):
            if r1.name == r2.name:
                raise Inconsistency(f"Duplicate row name {r1.name} found.")
        if any(r.name == cost_row for r in rows):
            raise Inconsistency("Cost row name found in other rows.")

        # Assemble columns / cost / groups.
        col_values: List[List[Tuple[int, Fraction]]] = [[] for _ in col_names]
        col_types: List[VariableType] = [VariableType.CONTINUOUS] * len(col_names)
        col_seen = [False] * len(col_names)
        cost_values: List[Tuple[int, Fraction]] = []
        rhs_groups: Dict[int, List[Tuple[int, Fraction]]] = {}
        rhs_order: List[int] = []
        range_groups: Dict[int, List[Tuple[int, Fraction]]] = {}
        range_order: List[int] = []
        bound_groups: Dict[int, List[Tuple[int, BoundValue]]] = {}
        bound_order: List[int] = []
        group_names: Dict[int, str] = {}
        integer_mode = False
        objective_constant = Fraction(0)
        objective_constant_seen = False

        for k in range(n):
            r = records[k]
            if r.kind == 6:
                integer_mode = bool(r.a)
            elif r.kind == 1:
                j = r.a
                if not col_seen[j]:
                    col_seen[j] = True
                    col_types[j] = (
                        VariableType.INTEGER if integer_mode else VariableType.CONTINUOUS
                    )
                col_values[j].append((remap[r.b], _fraction(r.mantissa, r.exp10)))
            elif r.kind == 2:
                j = r.a
                if not col_seen[j]:
                    col_seen[j] = True
                    col_types[j] = (
                        VariableType.INTEGER if integer_mode else VariableType.CONTINUOUS
                    )
                cost_values.append((j, _fraction(r.mantissa, r.exp10)))
            elif r.kind == 3:
                rhs_groups.setdefault(r.a, [])
                if r.a not in group_names:
                    group_names[r.a] = None  # resolved below by id order
                if r.a not in rhs_order:
                    rhs_order.append(r.a)
                rhs_groups[r.a].append((remap[r.b], _fraction(r.mantissa, r.exp10)))
            elif r.kind == 7:
                # RHS on the objective row: constant = -value, first wins.
                if not objective_constant_seen:
                    objective_constant = -_fraction(r.mantissa, r.exp10)
                    objective_constant_seen = True
            elif r.kind == 4:
                range_groups.setdefault(r.a, [])
                if r.a not in range_order:
                    range_order.append(r.a)
                range_groups[r.a].append((remap[r.b], _fraction(r.mantissa, r.exp10)))
            elif r.kind == 5:
                kind_text = chr((r.a >> 8) & 0xFF) + chr(r.a & 0xFF)
                group = r.b
                if group not in bound_order:
                    bound_order.append(group)
                bound_groups.setdefault(group, [])
                if kind_text in ("FR", "MI", "PL", "BV"):
                    bound = BoundValue(kind_text)
                else:
                    bound = BoundValue(kind_text, _fraction(r.mantissa, r.exp10))
                bound_groups[group].append((int(r.extra), bound))

        columns = []
        for j, name in enumerate(col_names):
            values = sorted(col_values[j], key=lambda t: t[0])
            for (i1, _), (i2, _) in zip(values, values[1:]):
                if i1 == i2:
                    raise Inconsistency(f"Duplicate row for column {name!r}")
            columns.append(MpsColumn(name, col_types[j], values))

        def finish_value_groups(groups, order, cls):
            out = []
            for gid in order:
                values = sorted(groups[gid], key=lambda t: t[0])
                for (i1, _), (i2, _) in zip(values, values[1:]):
                    if i1 == i2:
                        raise Inconsistency(
                            f"Duplicate row id {i1} for group {gid}"
                        )
                out.append(cls(f"g{gid}", values))
            return out

        rhss = finish_value_groups(rhs_groups, rhs_order, Rhs)
        ranges = finish_value_groups(range_groups, range_order, RangeGroup)

        seen_range_rows = set()
        for group in ranges:
            for i, _ in group.values:
                if i in seen_range_rows:
                    raise Inconsistency("Each row can have at most one range value")
                seen_range_rows.add(i)

        bounds = [
            BoundGroup(f"g{gid}", bound_groups[gid]) for gid in bound_order
        ]

        return MPS(
            name=program_name,
            objective=objective,
            cost_row_name=cost_row,
            cost_values=cost_values,
            rows=rows,
            columns=columns,
            rhss=rhss,
            ranges=ranges,
            bounds=bounds,
            objective_constant=objective_constant,
        )
    finally:
        lib.mps_free(handle)
