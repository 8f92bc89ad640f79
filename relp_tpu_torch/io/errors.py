"""Import error hierarchy.

Mirror of reference ``src/io/error.rs``: file-extension / IO / parse /
inconsistency errors.  ``ParseError`` carries a *chain* of
(context, file location) frames — every enclosing section parser wraps the
inner error with its own context on the way up, exactly like the
reference's nested ``Parse`` errors (``io/error.rs:70-237``), so a
malformed file reports the failing line AND the parse path that reached it.
"""

from __future__ import annotations

from typing import List, Optional, Tuple

#: (line number, line text) — where in the file a frame points.
FileLocation = Tuple[int, str]


class ImportError_(Exception):
    """Base of the import error hierarchy (reference: Import)."""


class FileExtensionError(ImportError_):
    pass


class IOError_(ImportError_):
    pass


class ParseError(ImportError_):
    """Syntactic error with a chain of (context, location) frames.

    The innermost frame is the raising site; each section parser that the
    error propagates through appends its own frame via :meth:`wrap`
    (reference: ``ParseError::wrap`` / ``LineLocation``,
    ``io/error.rs:70-237``).
    """

    def __init__(
        self, message: str, location: Optional[FileLocation] = None
    ):
        super().__init__(message)
        self.message = message
        #: innermost-first chain of (context, optional file location).
        self.trace: List[Tuple[str, Optional[FileLocation]]] = [
            ("", location)
        ] if location else []

    def wrap(
        self, context: str, location: Optional[FileLocation] = None
    ) -> "ParseError":
        """Append an enclosing-context frame and return self (for re-raise)."""
        self.trace.append((context, location))
        return self

    @property
    def locations(self) -> List[FileLocation]:
        """All file locations in the chain, innermost first."""
        return [loc for _, loc in self.trace if loc is not None]

    def __str__(self) -> str:
        parts = [self.message]
        for context, loc in self.trace:
            if context:
                parts.append(f"\n  {context}")
            if loc is not None:
                number, text = loc
                parts.append(f"\n    at line {number}: {text!r}")
        return "".join(parts)


class Inconsistency(ImportError_):
    """Logically invalid program (reference: Inconsistency)."""
