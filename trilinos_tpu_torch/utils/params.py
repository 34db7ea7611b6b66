"""Hierarchical, validated parameter lists.

Counterpart of ``trilinos_tpu/utils/params.py`` (the part of it the
ported preconditioners use), the analogue of ``Teuchos::ParameterList``:
string keys with ``Param`` specs and eager validation, whose strict mode
catches misspelt keys.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Callable, Mapping


@dataclasses.dataclass(frozen=True)
class Param:
    """Specification of one valid parameter (name, default, doc, validator)."""

    name: str
    default: Any
    doc: str = ""
    validator: Callable[[Any], bool] | None = None
    # when set, value must be one of these (Teuchos StringValidator analogue)
    choices: tuple | None = None

    def check(self, value: Any) -> None:
        if self.choices is not None and value not in self.choices:
            raise ValueError(
                f"parameter {self.name!r}: value {value!r} not in {self.choices}"
            )
        if self.validator is not None and not self.validator(value):
            raise ValueError(f"parameter {self.name!r}: invalid value {value!r}")


class ParameterList:
    """String-keyed hierarchical config with validated defaults."""

    def __init__(self, entries: Mapping[str, Any] | None = None, name: str = ""):
        self.name = name
        self._data: dict[str, Any] = {}
        if entries:
            for k, v in entries.items():
                self[k] = v

    # -- mapping interface -------------------------------------------------
    def __setitem__(self, key: str, value: Any) -> None:
        if isinstance(value, Mapping) and not isinstance(value, ParameterList):
            value = ParameterList(value, name=key)
        self._data[key] = value

    def __getitem__(self, key: str) -> Any:
        return self._data[key]

    def __contains__(self, key: str) -> bool:
        return key in self._data

    def __repr__(self) -> str:
        return f"ParameterList({self.name!r}, {self._data!r})"

    # -- validation --------------------------------------------------------
    def validate(self, specs: Mapping[str, Param]) -> None:
        """Check values and fill defaults; unknown top-level keys raise
        (catches typos). Analogue of ``validateParametersAndSetDefaults``.
        """
        for name, spec in specs.items():
            if name in self._data:
                spec.check(self._data[name])
            else:
                self._data[name] = spec.default
        unknown = [k for k in self._data
                   if k not in specs
                   and not isinstance(self._data[k], ParameterList)]
        if unknown:
            raise ValueError(
                f"unknown parameters {unknown} (valid: {sorted(specs)})")


def make_params(p: "ParameterList | Mapping | None") -> ParameterList:
    """Coerce user input (dict / ParameterList / None) into a ParameterList."""
    if p is None:
        return ParameterList()
    if isinstance(p, ParameterList):
        return p
    return ParameterList(p)
