"""Typed, defaulted, documented parameter structs.

A copy of ``mxnet_tpu/dparam.py`` (the port imports nothing from the JAX
package).  Replacement for ``dmlc::Parameter`` / ``DMLC_DECLARE_FIELD``
(SURVEY §2.11): every operator / iterator / optimizer config in the reference
is such a struct (e.g. ``FullyConnectedParam``).  Here it is a light
dataclass-style descriptor system that:
  - coerces strings (all attrs travel as strings through Symbol JSON, exactly
    like the reference where kwargs are serialized into the graph),
  - checks ranges and enum membership,
  - self-documents (``describe()`` mirrors MXSymbolGetAtomicSymbolInfo docs).

Shapes are written like the reference: "(2, 2)" tuples parse from strings.
"""
from __future__ import annotations

import ast

from .base import MXNetError

__all__ = ["Field", "ParamStruct", "parse_tuple", "parse_bool"]


def parse_tuple(value, length=None, typ=int):
    """Parse '(2,2)' / '[2,2]' / (2,2) / 2 into a tuple of ``typ``."""
    if isinstance(value, str):
        value = ast.literal_eval(value)
    if isinstance(value, (int, float)):
        value = (value,) * (length or 1)
    out = tuple(typ(v) for v in value)
    if length is not None and len(out) != length:
        raise MXNetError("expected tuple of length %d, got %r" % (length, out))
    return out


def parse_bool(value):
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        v = value.strip().lower()
        if v in ("true", "1", "yes"):
            return True
        if v in ("false", "0", "no"):
            return False
    return bool(int(value))


class Field:
    """One declared field: type, default, range, enum, docstring."""

    def __init__(self, typ, default=None, required=False,
                 lower=None, upper=None, enum=None, doc="", length=None):
        self.typ = typ
        self.default = default
        self.required = required
        self.lower = lower
        self.upper = upper
        self.enum = enum
        self.doc = doc
        self.length = length  # for tuple fields
        self.name = None  # filled by ParamStructMeta

    def coerce(self, value):
        if value is None or (isinstance(value, str) and value.strip() == "None"):
            # only genuinely-optional fields may hold None; required/enum
            # fields must fail validation rather than defer to a runtime crash
            if not self.required and self.enum is None:
                return None
            raise MXNetError("field %s: value None is not allowed" % self.name)
        try:
            if self.typ is bool:
                value = parse_bool(value)
            elif self.typ is tuple:
                value = parse_tuple(value, self.length)
            elif self.typ is str:
                value = str(value)
            elif value is None:
                pass
            else:
                value = self.typ(value)
        except (ValueError, SyntaxError) as exc:
            raise MXNetError("field %s: cannot parse %r: %s" % (self.name, value, exc))
        if self.enum is not None and value not in self.enum:
            raise MXNetError("field %s: %r not in %s" % (self.name, value, self.enum))
        if self.lower is not None and value is not None and value < self.lower:
            raise MXNetError("field %s: %r < lower bound %r" % (self.name, value, self.lower))
        if self.upper is not None and value is not None and value > self.upper:
            raise MXNetError("field %s: %r > upper bound %r" % (self.name, value, self.upper))
        return value


class ParamStructMeta(type):
    def __new__(mcs, cls_name, bases, ns):
        fields = {}
        for base in bases:
            fields.update(getattr(base, "_fields", {}))
        for key, val in list(ns.items()):
            if isinstance(val, Field):
                val.name = key
                fields[key] = val
                del ns[key]
        ns["_fields"] = fields
        return super().__new__(mcs, cls_name, bases, ns)


class ParamStruct(metaclass=ParamStructMeta):
    """Subclass and declare ``Field``s as class attributes.

    ``MyParam(**kwargs)`` coerces/validates; unknown kwargs raise (matching
    dmlc::Parameter::Init strict mode).  ``from_attrs`` ignores attrs that are
    not declared fields (graph-level attrs like ``ctx_group`` pass through).
    """

    def __init__(self, **kwargs):
        for name, field in self._fields.items():
            if name in kwargs:
                setattr(self, name, field.coerce(kwargs.pop(name)))
            elif field.required:
                raise MXNetError(
                    "%s: required field '%s' missing" % (type(self).__name__, name))
            else:
                setattr(self, name, field.default)
        if kwargs:
            raise MXNetError(
                "%s: unknown arguments %s" % (type(self).__name__, sorted(kwargs)))

    @classmethod
    def from_attrs(cls, attrs):
        known = {k: v for k, v in attrs.items() if k in cls._fields}
        return cls(**known)

    def to_attrs(self):
        out = {}
        for name in self._fields:
            val = getattr(self, name)
            if val is not None:
                out[name] = str(val)
        return out

    @classmethod
    def describe(cls):
        lines = []
        for name, field in cls._fields.items():
            t = getattr(field.typ, "__name__", str(field.typ))
            dflt = "required" if field.required else "default=%r" % (field.default,)
            lines.append("%s : %s, %s\n    %s" % (name, t, dflt, field.doc))
        return "\n".join(lines)

    def __repr__(self):
        kv = ", ".join("%s=%r" % (n, getattr(self, n)) for n in self._fields)
        return "%s(%s)" % (type(self).__name__, kv)
