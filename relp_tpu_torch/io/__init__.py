"""Problem import.

Mirror of reference ``src/io``: ``import_file(path)`` reads an MPS/SIF file
into an :class:`~relp_tpu_torch.io.mps.MPS` structure; ``mps_to_general_form``
converts it to a :class:`~relp_tpu_torch.data.general_form.GeneralForm`
(reference: io/mod.rs:32-61 + io/mps/convert.rs).
"""

from __future__ import annotations

import os

from relp_tpu_torch.io.convert import mps_to_general_form
from relp_tpu_torch.io.errors import (
    FileExtensionError,
    ImportError_,
    Inconsistency,
    IOError_,
    ParseError,
)
from relp_tpu_torch.io.mps import MPS, parse_fixed, parse_free


def import_file(
    path: str, *, fixed: bool | None = None, native: bool | None = None
) -> MPS:
    """Read an MPS/SIF file (reference: io::import, io/mod.rs:32-61).

    ``fixed=None`` chooses by extension: ``.SIF`` (netlib) uses the
    fixed-field parser, ``.mps`` the free parser.  ``native=None`` uses the
    C++ parser when built (native/libmps_parser.so), falling back to the
    pure-Python one.
    """
    _, ext = os.path.splitext(path)
    ext = ext.lstrip(".")
    if ext not in ("mps", "SIF", "sif"):
        raise FileExtensionError(
            f"Could not recognise file extension {ext!r} of file: {path!r}"
        )
    try:
        with open(path, "r") as f:
            text = f.read()
    except OSError as exc:
        raise IOError_(str(exc))
    if fixed is None:
        fixed = ext.lower() == "sif"

    from relp_tpu_torch.io.native import native_available, parse_native

    if native is None:
        native = native_available()
    try:
        if native:
            return parse_native(text, fixed)
        return parse_fixed(text) if fixed else parse_free(text)
    except ParseError as exc:
        # Outermost frame of the chain: which file failed (reference:
        # Import::Parse wraps the whole location chain, io/error.rs:70-237).
        raise exc.wrap(f"while importing {path!r}") from None


def load_general_form(path: str, *, fixed: bool | None = None):
    """Convenience: import + convert."""
    return mps_to_general_form(import_file(path, fixed=fixed))


__all__ = [
    "MPS",
    "parse_fixed",
    "parse_free",
    "mps_to_general_form",
    "import_file",
    "load_general_form",
    "ImportError_",
    "FileExtensionError",
    "IOError_",
    "ParseError",
    "Inconsistency",
]
