"""Tendrils: typed, documented, named ports (a copy of
tod_tpu/pipeline/tendril.py).

The dataflow-port abstraction of the reference's ecto runtime (every cell in
the reference declares params/inputs/outputs through ``ecto::tendrils``, e.g.
src/detection/GuessGenerator.cpp:71-99). A Tendril holds one value with a doc
string, an optional declared type, a default, and a required flag; Tendrils is
an ordered named collection with attribute access.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Optional


class Tendril:
    __slots__ = ("doc", "default", "required", "_value", "_has_value", "type_")

    def __init__(self, doc: str = "", default: Any = None,
                 required: bool = False, type_: Optional[type] = None):
        self.doc = doc
        self.default = default
        self.required = required
        self.type_ = type_
        self._value = default
        self._has_value = default is not None

    @property
    def value(self) -> Any:
        return self._value

    @value.setter
    def value(self, v: Any) -> None:
        self._value = v
        self._has_value = True

    @property
    def has_value(self) -> bool:
        return self._has_value

    def copy_spec(self) -> "Tendril":
        return Tendril(self.doc, self.default, self.required, self.type_)


class Tendrils:
    """Ordered mapping of name -> Tendril with attribute + item access."""

    def __init__(self):
        object.__setattr__(self, "_tendrils", {})

    # -- declaration -----------------------------------------------------------
    def declare(self, name: str, doc: str = "", default: Any = None,
                required: bool = False, type_: Optional[type] = None) -> Tendril:
        t = Tendril(doc, default, required, type_)
        self._tendrils[name] = t
        return t

    def declare_tendril(self, name: str, tendril: Tendril) -> None:
        self._tendrils[name] = tendril

    # -- access ----------------------------------------------------------------
    def at(self, name: str) -> Tendril:
        return self._tendrils[name]

    def __getitem__(self, name: str) -> Any:
        return self._tendrils[name].value

    def __setitem__(self, name: str, value: Any) -> None:
        if name not in self._tendrils:
            self.declare(name)
        self._tendrils[name].value = value

    def __getattr__(self, name: str) -> Any:
        tendrils = object.__getattribute__(self, "_tendrils")
        if name in tendrils:
            return tendrils[name].value
        raise AttributeError(name)

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __contains__(self, name: str) -> bool:
        return name in self._tendrils

    def __iter__(self) -> Iterator[str]:
        return iter(self._tendrils)

    def keys(self):
        return self._tendrils.keys()

    def items(self):
        return ((k, t.value) for k, t in self._tendrils.items())

    def update(self, values: Dict[str, Any]) -> None:
        for k, v in values.items():
            self[k] = v

    def missing_required(self):
        return [k for k, t in self._tendrils.items()
                if t.required and not t.has_value]
