"""Keys and Symbols.

A Key is a plain Python/uint64 integer naming one variable. A Symbol packs a
single character and a 56-bit index into a Key, so 'x5' prints nicely while
remaining a dense integer (reference: gtsam/inference/Symbol.h:33-80,
gtsam/inference/Key.h). Host-side only — on device, variables are referred to
by dense slot indices assigned by the planner (inference/symbolic.py).

Copied from gtsam_petercdev_tpu/core/keys.py (pure Python).
"""

from __future__ import annotations

_INDEX_BITS = 56
_INDEX_MASK = (1 << _INDEX_BITS) - 1
_CHR_MASK = 0xFF << _INDEX_BITS


def symbol(c: str, j: int) -> int:
    """Pack character + index into a Key (uint64 range)."""
    if len(c) != 1:
        raise ValueError(f"symbol character must be a single char, got {c!r}")
    if not 0 <= j <= _INDEX_MASK:
        raise ValueError(f"symbol index {j} out of range")
    return (ord(c) << _INDEX_BITS) | j


def symbol_chr(key: int) -> str:
    """Extract the character of a symbol-packed key ('' if not printable)."""
    c = (key & _CHR_MASK) >> _INDEX_BITS
    return chr(c) if 0x20 < c < 0x7F else ""


def symbol_index(key: int) -> int:
    """Extract the index part of a symbol-packed key."""
    return key & _INDEX_MASK


class Symbol:
    """Convenience wrapper mirroring gtsam::Symbol (inference/Symbol.h:33)."""

    __slots__ = ("c", "j")

    def __init__(self, c: str, j: int):
        self.c, self.j = c, j

    @classmethod
    def from_key(cls, key: int) -> "Symbol":
        return cls(symbol_chr(key) or "\0", symbol_index(key))

    def key(self) -> int:
        return symbol(self.c, self.j)

    def __int__(self) -> int:
        return self.key()

    def __index__(self) -> int:
        return self.key()

    def __eq__(self, other) -> bool:
        return int(self) == int(other)

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"{self.c}{self.j}"


class _Shorthand:
    def __init__(self, c: str):
        self._c = c

    def __call__(self, j: int) -> int:
        return symbol(self._c, j)


def shorthand(c: str) -> _Shorthand:
    """symbol_shorthand: X = shorthand('x'); X(3) -> key."""
    return _Shorthand(c)


def key_to_str(key: int) -> str:
    s = symbol_chr(key)
    return f"{s}{symbol_index(key)}" if s else str(key)


# --- LabeledSymbol: robot-id namespacing (inference/LabeledSymbol.h) ---------

_LABEL_BITS = 48
_LABEL_MASK = (1 << _LABEL_BITS) - 1


def labeled_symbol(c: str, label: str, j: int) -> int:
    """Pack type char + robot label char + 48-bit index into a Key.

    The reference's multi-robot key namespacing mechanism
    (gtsam/inference/LabeledSymbol.h): same uint64 key space as Symbol but
    with a second character identifying the robot.
    """
    if len(c) != 1 or len(label) != 1:
        raise ValueError("labeled_symbol needs single characters")
    if not 0 <= j <= _LABEL_MASK:
        raise ValueError(f"labeled symbol index {j} out of range")
    return (ord(c) << 56) | (ord(label) << _LABEL_BITS) | j


def labeled_symbol_chr(key: int) -> str:
    return symbol_chr(key)


def labeled_symbol_label(key: int) -> str:
    c = (key >> _LABEL_BITS) & 0xFF
    return chr(c) if 0x20 < c < 0x7F else ""


def labeled_symbol_index(key: int) -> int:
    return key & _LABEL_MASK


class LabeledSymbol:
    """Mirror of gtsam::LabeledSymbol (multi-robot keys)."""

    __slots__ = ("c", "label", "j")

    def __init__(self, c: str, label: str, j: int):
        self.c, self.label, self.j = c, label, j

    @classmethod
    def from_key(cls, key: int) -> "LabeledSymbol":
        return cls(
            labeled_symbol_chr(key) or "\0",
            labeled_symbol_label(key) or "\0",
            labeled_symbol_index(key),
        )

    def key(self) -> int:
        return labeled_symbol(self.c, self.label, self.j)

    def new_chr(self, c: str) -> "LabeledSymbol":
        return LabeledSymbol(c, self.label, self.j)

    def new_label(self, label: str) -> "LabeledSymbol":
        return LabeledSymbol(self.c, label, self.j)

    def __int__(self) -> int:
        return self.key()

    def __index__(self) -> int:
        return self.key()

    def __eq__(self, other) -> bool:
        return int(self) == int(other)

    def __hash__(self) -> int:
        return hash(self.key())

    def __repr__(self) -> str:
        return f"{self.c}{self.label}{self.j}"
