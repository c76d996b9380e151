"""Registry of the ``REPRO_*`` environment knobs the port reads.

Port of ``repro/env.py``, cut to the knobs the resident query path
reads.  Consumers call :func:`get` instead of ``os.environ.get`` so that
a typo like ``REPRO_COMPACT=of`` fails loudly with the list of accepted
values rather than silently selecting a default.

Conventions (as in the reference):

* The empty string is always accepted and means "use the default".
* Values are matched case-insensitively after stripping whitespace.
"""
from __future__ import annotations

import os
from dataclasses import dataclass


@dataclass(frozen=True)
class Knob:
    name: str
    values: tuple[str, ...]
    default: str
    help: str


_KNOBS = (
    Knob("REPRO_COMPACT",
         ("", "on", "off"), "on",
         "Compacted candidate gather on the resident range path: gather "
         "the certified candidate rows once into a dense power-of-two "
         "bucket and filter only those (on, default), or stream the "
         "full padded slot array through the kernels (off)."),
)

KNOBS: dict[str, Knob] = {k.name: k for k in _KNOBS}


def get(name: str) -> str:
    """Validated value of knob ``name`` ("" and unset -> its default).

    Raises ``KeyError`` for an undeclared knob (a programming error) and
    ``ValueError`` for a set-but-invalid value (a user error).
    """
    knob = KNOBS[name]
    raw = os.environ.get(name)
    if raw is None:
        return knob.default
    val = raw.strip().lower()
    if val not in knob.values:
        valid = ", ".join(repr(v) for v in knob.values if v)
        raise ValueError(
            f"{name}={raw!r} is not a valid setting ({knob.help} "
            f"Valid values: {valid}, or empty/unset for the default.)")
    return knob.default if val == "" else val
