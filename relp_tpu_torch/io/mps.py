"""MPS reading: structures and the fixed/free parsers.

Behavioral mirror of reference ``src/io/mps``:

* Comments (lines starting ``*``) and blank lines are skipped.
* Sections: NAME, optional OBJSENSE, ROWS, COLUMNS (with INTORG/INTEND
  markers), optional RHS / RANGES / BOUNDS, ENDATA.
* Two column-retrieval strategies (reference: parse/{fixed,free}.rs): *fixed*
  uses the classic MPS character field ranges; *free* splits on whitespace.
* Rows are **sorted by name** after reading (reference:
  check_row_section_consistency) — row indices used everywhere else refer to
  this sorted order.
* Cost coefficients met in COLUMNS are collected per column index; a value
  for an undeclared row errors unless it targets the cost row.
* Numbers parse to exact rationals (``Fraction`` accepts decimal and
  exponent forms).
"""

from __future__ import annotations

from dataclasses import dataclass, field
from fractions import Fraction
from typing import Dict, Iterator, List, Optional, Tuple

from relp_tpu_torch.data.elements import ConstraintRelation, Objective, VariableType
from relp_tpu_torch.io.errors import Inconsistency, ParseError

COMMENT_INDICATOR = "*"
COLUMN_SECTION_MARKER = "'MARKER'"
START_OF_INTEGER = "'INTORG'"
END_OF_INTEGER = "'INTEND'"

# Classic MPS fixed field character ranges (reference: parse/fixed.rs:137-145).
FIELDS = [(0, 1), (1, 3), (4, 12), (14, 22), (24, 36), (39, 47), (49, 61)]


# --- MPS data structures (reference: io/mps/mod.rs:51-110) ---


@dataclass
class Row:
    name: str
    constraint_type: ConstraintRelation


@dataclass
class MpsColumn:
    name: str
    variable_type: VariableType
    values: List[Tuple[int, Fraction]]  # (row index, value), sorted


@dataclass
class Rhs:
    name: str
    values: List[Tuple[int, Fraction]]


@dataclass
class RangeGroup:
    name: str
    values: List[Tuple[int, Fraction]]


class BoundKind:
    LOWER = "LO"
    UPPER = "UP"
    FIXED = "FX"
    FREE = "FR"
    LOWER_MINUS_INF = "MI"
    UPPER_INF = "PL"
    BINARY = "BV"
    LOWER_INT = "LI"
    UPPER_INT = "UI"


@dataclass
class BoundValue:
    kind: str
    value: Optional[Fraction] = None


@dataclass
class BoundGroup:
    name: str
    values: List[Tuple[int, BoundValue]]  # (column index, bound)


@dataclass
class MPS:
    name: str
    objective: Objective
    cost_row_name: str
    cost_values: List[Tuple[int, Fraction]]
    rows: List[Row]
    columns: List[MpsColumn]
    rhss: List[Rhs] = field(default_factory=list)
    ranges: List[RangeGroup] = field(default_factory=list)
    bounds: List[BoundGroup] = field(default_factory=list)
    #: Constant term of the objective, from an RHS entry on the cost row
    #: (standard MPS convention: constant = -rhs value).  BEYOND REFERENCE:
    #: the reference errors on such entries (build_row_index excludes the
    #: cost row, parse/mod.rs:334-351) and ships GROW15/GROW22 untested;
    #: both carry "RHS REVENUE 0." lines.
    objective_constant: Fraction = field(default_factory=lambda: Fraction(0))

    def nr_rows(self) -> int:
        return len(self.rows)

    def nr_columns(self) -> int:
        return len(self.columns)


# --- column retrievers ---


class _Free:
    """Whitespace-splitting retrieval (reference: parse/free.rs)."""

    @staticmethod
    def one_and_two(line: str) -> List[str]:
        parts = line.split()
        if len(parts) < 2:
            raise ParseError("Could not read first two fields")
        return parts[:2]

    @staticmethod
    def data_fields(line: str) -> List[str]:
        return line.split()

    @staticmethod
    def is_marker_line(parts: List[str]) -> Optional[str]:
        if len(parts) >= 3 and parts[1] == COLUMN_SECTION_MARKER:
            return parts[2]
        return None


class _Fixed:
    """Character-field retrieval (reference: parse/fixed.rs)."""

    @staticmethod
    def _field(line: str, k: int) -> str:
        lo, hi = FIELDS[k]
        return line[lo : min(hi, len(line))].strip()

    @staticmethod
    def one_and_two(line: str) -> List[str]:
        if len(line) <= FIELDS[2][0]:
            raise ParseError("Line is too short.")
        type_text = _Fixed._field(line, 1)
        name = _Fixed._field(line, 2)
        if not name:
            raise ParseError("Empty row name.")
        return [type_text, name]

    @staticmethod
    def data_fields(line: str) -> List[str]:
        """Positional fields 2..6.

        Field 2 (the group/column name) may legitimately be empty — netlib
        SIF files (e.g. BLEND) omit the RHS group name, meaning "the current
        group".  Fields 5/6 are an optional second (row, value) pair.
        """
        out = [_Fixed._field(line, 2), _Fixed._field(line, 3), _Fixed._field(line, 4)]
        five = _Fixed._field(line, 5) if len(line) > FIELDS[5][0] else ""
        six = _Fixed._field(line, 6) if len(line) > FIELDS[6][0] else ""
        if five:
            out.append(five)
            out.append(six)
        return out

    @staticmethod
    def is_marker_line(parts_unused, line: str = "") -> Optional[str]:
        return None


def _into_lines(text: str) -> Iterator[Tuple[int, str]]:
    for number, line in enumerate(text.splitlines(), start=1):
        if not line:
            continue
        stripped = line.lstrip()
        if stripped.startswith(COMMENT_INDICATOR):
            continue
        # Some netlib SIF files (CRE-C) carry stray "&"-prefixed comment
        # lines; "&" never starts a valid section keyword or data line
        # (data lines are indented), so skip them like "*" comments.
        if line.startswith("&"):
            continue
        yield (number, line)


_SECTIONS = {"ROWS", "COLUMNS", "RHS", "RANGES", "BOUNDS", "ENDATA", "OBJSENSE"}


def _is_section_header(line: str) -> bool:
    return not line.startswith(" ")


def _section_frame(exc: ParseError, section: str, entry=None) -> ParseError:
    """Chain a section-context frame onto a propagating parse error
    (reference: the nested Parse file-location chain, io/error.rs:70-237).

    The frame carries the failing line only when the inner error did not
    already record one (so stale loop variables never mislabel an
    end-of-section error)."""
    loc = entry if not exc.locations else None
    return exc.wrap(f"while parsing the {section} section", loc)


def _parse(text: str, fixed: bool) -> MPS:
    lines = list(_into_lines(text))
    pos = 0

    def peek() -> Optional[Tuple[int, str]]:
        return lines[pos] if pos < len(lines) else None

    # --- NAME ---
    if pos >= len(lines):
        raise ParseError("Empty program.")
    number, line = lines[pos]
    pos += 1
    if not line.startswith("NAME"):
        raise ParseError("Expected a NAME indicator.", (number, line))
    name_parts = line[len("NAME") :].split()
    program_name = name_parts[0] if name_parts else ""

    # --- OBJSENSE (optional) + ROWS header ---
    objective = Objective.MINIMIZE
    entry = peek()
    if entry is None:
        raise ParseError("No line to read after the program name.")
    if entry[1].rstrip() == "OBJSENSE":
        pos += 1
        entry = peek()
        if entry is None:
            raise ParseError("Program can't end in the OBJSENSE section.")
        direction = entry[1].strip()
        pos += 1
        if direction in ("MINIMIZE", "MIN"):
            objective = Objective.MINIMIZE
        elif direction in ("MAXIMIZE", "MAX"):
            objective = Objective.MAXIMIZE
        else:
            raise ParseError(f"Can't read objective {direction!r}", entry)
        entry = peek()
    if entry is None or not entry[1].startswith("ROWS"):
        raise ParseError("Expected the ROWS section next.")
    pos += 1

    retriever = _Fixed if fixed else _Free

    # --- ROWS ---
    cost_row_name: Optional[str] = None
    rows: List[Row] = []
    while True:
        entry = peek()
        if entry is None:
            raise ParseError("Section ended sooner than expected.").wrap(
                "while parsing the ROWS section"
            )
        number, line = entry
        if _is_section_header(line):
            break
        pos += 1
        try:
            row_type, row_name = retriever.one_and_two(line)
            if row_type == "N":
                if cost_row_name is not None:
                    raise ParseError(
                        "Second cost row detected.", (number, line)
                    )
                cost_row_name = row_name
            elif row_type == "E":
                rows.append(Row(row_name, ConstraintRelation.EQUAL))
            elif row_type == "L":
                rows.append(Row(row_name, ConstraintRelation.LESS))
            elif row_type == "G":
                rows.append(Row(row_name, ConstraintRelation.GREATER))
            else:
                raise ParseError(
                    f"Row type {row_type!r} unknown.", (number, line)
                )
        except ParseError as exc:
            raise _section_frame(exc, "ROWS", (number, line)) from None

    if cost_row_name is None:
        raise Inconsistency("No cost name read.")
    # Rows sorted by name; indices refer to this order (reference:
    # check_row_section_consistency).
    rows.sort(key=lambda r: r.name)
    for r1, r2 in zip(rows, rows[1:]):
        if r1.name == r2.name:
            raise Inconsistency(f"Duplicate row name {r1.name} found.")
    if any(r.name == cost_row_name for r in rows):
        raise Inconsistency("Cost row name found in other rows.")
    row_index: Dict[str, int] = {r.name: i for i, r in enumerate(rows)}

    # --- section header loop ---
    number, line = lines[pos]
    if line.rstrip() != "COLUMNS":
        raise ParseError("Expected the COLUMNS section.", (number, line))
    pos += 1

    # --- COLUMNS ---
    columns: List[MpsColumn] = []
    cost_values: List[Tuple[int, Fraction]] = []
    current_name: Optional[str] = None
    current_values: List[Tuple[int, Fraction]] = []
    active_type = VariableType.CONTINUOUS

    def save_column(new_name: Optional[str]) -> None:
        nonlocal current_name, current_values
        if current_name is not None:
            current_values.sort(key=lambda t: t[0])
            for (i1, _), (i2, _) in zip(current_values, current_values[1:]):
                if i1 == i2:
                    raise Inconsistency(f"Duplicate row for column {current_name!r}")
            columns.append(MpsColumn(current_name, active_type, current_values))
            current_values = []
        current_name = new_name

    def parse_number(text: str, location: Tuple[int, str]) -> Fraction:
        try:
            return Fraction(text)
        except (ValueError, ZeroDivisionError) as exc:
            raise ParseError(f"Couldn't parse value {text!r}: {exc}", location)

    while True:
        entry = peek()
        if entry is None:
            raise ParseError("Section ended sooner than expected.").wrap(
                "while parsing the COLUMNS section"
            )
        number, line = entry
        if _is_section_header(line):
            break
        pos += 1
        try:
            if fixed:
                marker = None
                if len(line) > FIELDS[3][0] and _Fixed._field(line, 3) == COLUMN_SECTION_MARKER:
                    marker = _Fixed._field(line, 5)
                fields = None
            else:
                parts = line.split()
                marker = _Free.is_marker_line(parts)
                fields = parts
            if marker is not None:
                save_column(None)
                if marker == START_OF_INTEGER:
                    active_type = VariableType.INTEGER
                elif marker == END_OF_INTEGER:
                    active_type = VariableType.CONTINUOUS
                else:
                    raise ParseError(f"Marker type {marker!r} unknown.", (number, line))
                continue
            if fixed:
                fields = _Fixed.data_fields(line)
            if fields is None or len(fields) < 3:
                raise ParseError("Line contained too few elements.", (number, line))
            column_name = fields[0]
            if not column_name and current_name is not None:
                column_name = current_name  # empty name continues the column
            if current_name != column_name:
                save_column(column_name)
            pairs = fields[1:]
            if len(pairs) % 2 != 0:
                raise ParseError("Line contained an unexpected number of elements.", (number, line))
            for k in range(0, len(pairs), 2):
                row_name, value_text = pairs[k], pairs[k + 1]
                value = parse_number(value_text, (number, line))
                idx = row_index.get(row_name)
                if idx is None:
                    if row_name == cost_row_name:
                        cost_values.append((len(columns), value))
                    else:
                        raise Inconsistency(f"Row {row_name!r} not known.")
                else:
                    current_values.append((idx, value))
        except ParseError as exc:
            raise _section_frame(exc, "COLUMNS", (number, line)) from None
    save_column(None)

    column_index: Dict[str, int] = {c.name: j for j, c in enumerate(columns)}
    if len(column_index) != len(columns):
        raise Inconsistency("Duplicate column names.")

    # --- RHS / RANGES (same shape), then BOUNDS ---
    objective_constant = [Fraction(0), False]  # value, seen

    def parse_value_groups(section: str) -> List[Tuple[str, List[Tuple[int, Fraction]]]]:
        nonlocal pos
        allow_cost_row = section == "RHS"
        groups: List[Tuple[str, List[Tuple[int, Fraction]]]] = []
        g_name: Optional[str] = None
        g_values: List[Tuple[int, Fraction]] = []

        def save_group(new_name: Optional[str]) -> None:
            nonlocal g_name, g_values
            if g_name is not None:
                g_values.sort(key=lambda t: t[0])
                for (i1, _), (i2, _) in zip(g_values, g_values[1:]):
                    if i1 == i2:
                        raise Inconsistency(
                            f"Duplicate row id {i1} for group {g_name!r}"
                        )
                groups.append((g_name, g_values))
                g_values = []
            g_name = new_name

        while True:
            entry = peek()
            if entry is None:
                raise ParseError(
                    f"Section {section!r} ended sooner than expected."
                ).wrap(f"while parsing the {section} section")
            number, line = entry
            if _is_section_header(line):
                break
            pos += 1
            try:
                fields = retriever.data_fields(line)
                if len(fields) < 3:
                    raise ParseError("Line contained too few elements.", (number, line))
                group_name = fields[0]
                if not group_name and g_name is not None:
                    group_name = g_name  # empty name continues the group
                if g_name != group_name:
                    save_group(group_name)
                pairs = fields[1:]
                if len(pairs) % 2 != 0:
                    raise ParseError(
                        "Line contained an unexpected number of elements.", (number, line)
                    )
                for k in range(0, len(pairs), 2):
                    row_name, value_text = pairs[k], pairs[k + 1]
                    idx = row_index.get(row_name)
                    if idx is None:
                        if allow_cost_row and row_name == cost_row_name:
                            # RHS on the objective row: the constant term is
                            # the NEGATED rhs (first entry wins, like cost
                            # coefficients in COLUMNS).
                            value = parse_number(value_text, (number, line))
                            if not objective_constant[1]:
                                objective_constant[0] = -value
                                objective_constant[1] = True
                            continue
                        raise Inconsistency(f"Row {row_name!r} not known.")
                    g_values.append((idx, parse_number(value_text, (number, line))))
            except ParseError as exc:
                raise _section_frame(exc, section, (number, line)) from None
        save_group(None)
        return groups

    rhss: List[Rhs] = []
    ranges: List[RangeGroup] = []
    bounds: List[BoundGroup] = []

    number, line = lines[pos]
    section = line.split()[0]
    if section == "RHS":
        pos += 1
        rhss = [Rhs(n, v) for n, v in parse_value_groups("RHS")]
        number, line = lines[pos]
        section = line.split()[0]
    if section == "RANGES":
        pos += 1
        ranges = [RangeGroup(n, v) for n, v in parse_value_groups("RANGES")]
        number, line = lines[pos]
        section = line.split()[0]

    # ranges consistency: one range per row (reference: check_ranges_consistency)
    seen_range_rows = set()
    for group in ranges:
        for i, _ in group.values:
            if i in seen_range_rows:
                raise Inconsistency("Each row can have at most one range value")
            seen_range_rows.add(i)

    if section == "BOUNDS":
        pos += 1
        g_name: Optional[str] = None
        g_bvalues: List[Tuple[int, BoundValue]] = []

        def save_bound_group(new_name: Optional[str]) -> None:
            nonlocal g_name, g_bvalues
            if g_name is not None:
                bounds.append(BoundGroup(g_name, g_bvalues))
                g_bvalues = []
            g_name = new_name

        while True:
            entry = peek()
            if entry is None:
                raise ParseError(
                    "Section 'BOUNDS' ended sooner than expected."
                ).wrap("while parsing the BOUNDS section")
            number, line = entry
            if _is_section_header(line):
                break
            pos += 1
            try:
                if fixed:
                    kind = _Fixed._field(line, 1)
                    bound_name = _Fixed._field(line, 2)
                    col_name = _Fixed._field(line, 3)
                    value_text = _Fixed._field(line, 4) if len(line) > FIELDS[4][0] else ""
                else:
                    parts = line.split()
                    if len(parts) < 3:
                        raise ParseError("Line contained too few elements.", (number, line))
                    kind, bound_name, col_name = parts[0], parts[1], parts[2]
                    value_text = parts[3] if len(parts) > 3 else ""
                col = column_index.get(col_name)
                if col is None:
                    raise Inconsistency(f"Column name {col_name!r} unknown")
                if g_name != bound_name:
                    save_bound_group(bound_name)
                if kind in ("FR", "MI", "PL", "BV"):
                    bound = BoundValue(kind)
                elif kind in ("LO", "UP", "FX", "LI", "UI"):
                    if not value_text:
                        raise ParseError("Bound value missing.", (number, line))
                    bound = BoundValue(kind, parse_number(value_text, (number, line)))
                else:
                    raise ParseError(f"Bound type {kind!r} unknown.", (number, line))
                g_bvalues.append((col, bound))
            except ParseError as exc:
                raise _section_frame(exc, "BOUNDS", (number, line)) from None
        save_bound_group(None)
        number, line = lines[pos]
        section = line.split()[0]

    if section != "ENDATA":
        raise ParseError(f"Unexpected section {section!r}.", (number, line))
    pos += 1
    if pos < len(lines):
        raise ParseError("File parsed successfully, but it has nonempty lines at the end.")

    return MPS(
        name=program_name,
        objective=objective,
        cost_row_name=cost_row_name,
        cost_values=cost_values,
        rows=rows,
        columns=columns,
        rhss=rhss,
        ranges=ranges,
        bounds=bounds,
        objective_constant=objective_constant[0],
    )


def parse_fixed(text: str) -> MPS:
    """Parse fixed-field MPS (netlib SIF uses this; reference: parse_fixed)."""
    return _parse(text, fixed=True)


def parse_free(text: str) -> MPS:
    """Parse free-format (whitespace-split) MPS (reference: parse_free)."""
    return _parse(text, fixed=False)
