"""Table — the heterogeneous activity container (counterpart of
``bigdl_tpu.utils.table``; BigDL utils/Table.scala:34).

A Lua-style map used wherever a module takes or returns several tensors.
Keys follow BigDL's convention: ``T(a, b, c)`` builds ``{1: a, 2: b, 3:
c}`` (1-based); string and other keys are allowed. The JAX package also
registers Table as a pytree node; the port has no pytrees, so a Table
here is a plain container.
"""
from __future__ import annotations

__all__ = ["T", "Table"]


class Table:
    """An int/any-keyed container: 1-based ``insert``, ``length``
    counting consecutive integer keys from 1, iteration over the array
    part."""

    __slots__ = ("_state",)

    def __init__(self, state=None):
        object.__setattr__(self, "_state", dict(state) if state else {})

    def __getitem__(self, key):
        return self._state[key]

    def __setitem__(self, key, value):
        self._state[key] = value

    def __contains__(self, key):
        return key in self._state

    def __delitem__(self, key):
        del self._state[key]

    def get(self, key, default=None):
        return self._state.get(key, default)

    def keys(self):
        return self._state.keys()

    def values(self):
        return self._state.values()

    def items(self):
        return self._state.items()

    def __iter__(self):
        for i in range(1, self.length() + 1):
            yield self._state[i]

    def __len__(self):
        return self.length()

    def length(self) -> int:
        """Number of consecutive int keys starting at 1 (Table.scala:120)."""
        n = 0
        while (n + 1) in self._state:
            n += 1
        return n

    def insert(self, value) -> "Table":
        """Append at the end of the array part (Table.scala:151)."""
        self._state[self.length() + 1] = value
        return self

    def remove(self, index=None):
        """Remove and return entry ``index`` (default: the last of the
        array part), shifting the entries above it down by one."""
        if index is None:
            index = self.length()
        if index not in self._state:
            return None
        value = self._state.pop(index)
        i = index
        while (i + 1) in self._state:
            self._state[i] = self._state.pop(i + 1)
            i += 1
        return value

    def update(self, other) -> "Table":
        if isinstance(other, Table):
            other = other._state
        self._state.update(other)
        return self

    def to_dict(self) -> dict:
        return dict(self._state)

    def to_list(self) -> list:
        return [self._state[i] for i in range(1, self.length() + 1)]

    def __eq__(self, other):
        if isinstance(other, Table):
            return self._state == other._state
        return NotImplemented

    def __hash__(self):
        return object.__hash__(self)

    def __repr__(self):
        inner = ", ".join(f"{k!r}: {v!r}" for k, v in self._state.items())
        return f"T({{{inner}}})"


def T(*args, **kwargs) -> Table:
    """Table constructor (utils/Table.scala:318): ``T(a, b)`` ->
    ``{1: a, 2: b}``; ``T(k=v)`` adds string keys."""
    t = Table()
    for i, a in enumerate(args):
        t[i + 1] = a
    for k, v in kwargs.items():
        t[k] = v
    return t
