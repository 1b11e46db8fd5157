# Copy of pasero_tpu/config/core.py, verbatim.
"""Declarative typed configuration system.

Re-designed equivalent of the reference's config layer (pasero/config.py:143-495):
typed fields declared as class annotations with ``argument(...)`` descriptors,
automatic argparse generation, and merge precedence CLI > kwargs > YAML >
task-dependent defaults (pasero/config.py:235-267, 1711-1760).

This is a from-scratch implementation; only the observable semantics follow the
reference.
"""

from __future__ import annotations

import argparse
import copy
import typing
from typing import Any, Optional, Union

import yaml


class _Missing:
    def __repr__(self) -> str:
        return "MISSING"


MISSING = _Missing()


class Argument:
    """Metadata attached to a config field."""

    __slots__ = (
        "default", "aliases", "choices", "help", "nargs", "type",
        "positional", "hidden", "task_defaults",
    )

    def __init__(
        self,
        default: Any = MISSING,
        *,
        aliases: tuple = (),
        choices: Optional[tuple] = None,
        help: str = "",
        nargs: Optional[str] = None,
        type: Optional[type] = None,
        positional: bool = False,
        hidden: bool = False,
        defaults: Optional[dict] = None,  # task-name -> default (pasero/config.py 'defaults=')
    ):
        self.default = default
        self.aliases = tuple(aliases)
        self.choices = tuple(choices) if choices else None
        self.help = help
        self.nargs = nargs
        self.type = type
        self.positional = positional
        self.hidden = hidden
        self.task_defaults = dict(defaults) if defaults else None


def argument(default: Any = MISSING, **kwargs) -> Any:
    """Declare a config field: ``dropout: float = argument(0.1, help='...')``."""
    return Argument(default, **kwargs)


class Field:
    """Resolved field: name + python type + Argument metadata."""

    __slots__ = ("name", "_annotation", "arg", "_module")

    def __init__(self, name: str, annotation: Any, arg: Argument, module: str = ""):
        self.name = name
        self._annotation = annotation
        self.arg = arg
        self._module = module

    @property
    def annotation(self):
        """Resolve postponed (string) annotations lazily against the defining module."""
        ann = self._annotation
        if isinstance(ann, str):
            import sys as _sys
            namespace = {"Optional": Optional, "Union": Union, "Any": Any,
                         "list": list, "dict": dict, "tuple": tuple}
            mod = _sys.modules.get(self._module)
            if mod is not None:
                namespace = {**vars(mod), **namespace}
            try:
                ann = eval(ann, namespace)  # noqa: S307 - trusted class annotations
            except Exception:
                ann = str
            self._annotation = ann
        return ann

    # -- type introspection ------------------------------------------------
    @property
    def base_type(self):
        """Unwrap Optional[...] and list[...] to the scalar element type."""
        ann = self.annotation
        origin = typing.get_origin(ann)
        if origin is Union:  # Optional[T]
            args = [a for a in typing.get_args(ann) if a is not type(None)]
            if len(args) == 1:
                ann = args[0]
                origin = typing.get_origin(ann)
        if origin in (list, tuple):
            args = typing.get_args(ann)
            return args[0] if args else str
        return ann if isinstance(ann, type) else str

    @property
    def is_list(self) -> bool:
        ann = self.annotation
        origin = typing.get_origin(ann)
        if origin is Union:
            args = [a for a in typing.get_args(ann) if a is not type(None)]
            if len(args) == 1:
                origin = typing.get_origin(args[0])
        return origin in (list, tuple)

    @property
    def is_optional(self) -> bool:
        return typing.get_origin(self.annotation) is Union and type(None) in typing.get_args(self.annotation)

    def default_value(self):
        d = self.arg.default
        if d is MISSING:
            return None
        return copy.copy(d) if isinstance(d, (list, dict, set)) else d

    # -- coercion / validation --------------------------------------------
    def coerce(self, value):
        """Best-effort coercion of a raw (e.g. YAML/CLI) value to the field type."""
        if value is None:
            return None
        ann = self.annotation
        if typing.get_origin(ann) is Union:
            args = [a for a in typing.get_args(ann) if a is not type(None)]
            if len(args) > 1:
                # heterogeneous Union (e.g. Union[int, dict] expert counts):
                # keep values already matching a member, else coerce to the
                # first member (base_type would otherwise fall back to str)
                for a in args:
                    if (isinstance(a, type) and typing.get_origin(a) is None
                            and isinstance(value, a)):
                        return value
                first = args[0]
                if isinstance(first, type):
                    return self._coerce_scalar(value, first)
                return value
        base = self.base_type
        if self.is_list:
            if isinstance(value, str):
                value = value.split()
            return [self._coerce_scalar(v, base) for v in value]
        return self._coerce_scalar(value, base)

    @staticmethod
    def _coerce_scalar(value, base):
        if base is bool:
            if isinstance(value, str):
                return value.lower() in ("1", "true", "yes", "on")
            return bool(value)
        if base in (int, float, str):
            if base is float and isinstance(value, (int, float, str)):
                return float(value)
            if base is int and isinstance(value, (int, str)):
                return int(value)
            if base is str:
                return str(value)
        if isinstance(base, type) and isinstance(value, base):
            return value
        return value

    def check(self, value):
        if value is None:
            return
        if self.arg.choices and not self.is_list and value not in self.arg.choices:
            raise ValueError(
                f"invalid value {value!r} for --{self.cli_name()}: "
                f"choose from {self.arg.choices}"
            )
        if self.arg.choices and self.is_list:
            for v in value:
                if v not in self.arg.choices:
                    raise ValueError(
                        f"invalid value {v!r} for --{self.cli_name()}: "
                        f"choose from {self.arg.choices}"
                    )

    def cli_name(self) -> str:
        # 'continue_' parses as '--continue' (reference: config.py continue_ field)
        return self.name.rstrip("_").replace("_", "-")


class ConfigMeta(type):
    """Collects annotated fields from the class body and its bases (MRO order)."""

    def __new__(mcs, name, bases, namespace):
        cls = super().__new__(mcs, name, bases, namespace)
        fields: dict[str, Field] = {}
        for klass in reversed(cls.__mro__):
            anns = klass.__dict__.get("__annotations__", {})
            for fname, ann in anns.items():
                if fname.startswith("_"):
                    continue
                raw = klass.__dict__.get(fname, MISSING)
                if isinstance(raw, Argument):
                    arg = raw
                elif fname in fields:
                    # subclass overrides just the default of an inherited field
                    prev = fields[fname].arg
                    arg = Argument(
                        raw if raw is not MISSING else prev.default,
                        aliases=prev.aliases, choices=prev.choices,
                        help=prev.help, nargs=prev.nargs, type=prev.type,
                        positional=prev.positional, hidden=prev.hidden,
                        defaults=prev.task_defaults,
                    )
                    ann = fields[fname]._annotation
                else:
                    arg = Argument(raw)
                fields[fname] = Field(fname, ann, arg, module=klass.__module__)
            # plain class attrs (no annotation) overriding an inherited field's default
            for fname, raw in klass.__dict__.items():
                if fname.startswith("_") or isinstance(raw, Argument):
                    continue
                if fname in fields and fname not in anns and not callable(raw) \
                        and not isinstance(raw, (property, classmethod, staticmethod)):
                    prev = fields[fname]
                    fields[fname] = Field(
                        fname, prev._annotation,
                        Argument(raw, aliases=prev.arg.aliases, choices=prev.arg.choices,
                                 help=prev.arg.help, nargs=prev.arg.nargs,
                                 type=prev.arg.type, positional=prev.arg.positional,
                                 hidden=prev.arg.hidden, defaults=prev.arg.task_defaults),
                        module=prev._module,
                    )
        cls._fields = fields
        return cls


class Config(metaclass=ConfigMeta):
    """Base config. Subclass with annotated fields; instantiate with kwargs.

    Unknown kwargs raise by default (strict=True), matching the reference's
    API type checking (pasero/config.py:417-458).
    """

    _fields: dict[str, Field] = {}

    def __init__(self, strict: bool = True, **kwargs):
        for field in self._fields.values():
            setattr(self, field.name, field.default_value())
        self.update(kwargs, strict=strict)
        self.finalize()

    # -- mutation ----------------------------------------------------------
    def update(self, values: dict, strict: bool = True, coerce: bool = True):
        for key, value in values.items():
            field = self._fields.get(key)
            if field is None:
                if strict:
                    close = [f for f in self._fields if f[:3] == key[:3]]
                    hint = f" (did you mean {close[0]!r}?)" if close else ""
                    raise TypeError(f"unknown option {key!r} for {type(self).__name__}{hint}")
                continue
            if coerce:
                value = field.coerce(value)
            field.check(value)
            setattr(self, key, value)
        return self

    def finalize(self):
        """Hook for derived-value computation; called after __init__."""

    def set_defaults(self, task: str):
        """Fill still-unset fields with task-dependent defaults.

        Mirrors the reference's ``defaults={task: value}`` argument feature and
        ``set_defaults`` (used for e.g. label_smoothing and model_type varying
        between translation and language_modeling tasks).
        """
        for field in self._fields.values():
            td = field.arg.task_defaults
            if td and getattr(self, field.name, None) is None:
                if task in td:
                    setattr(self, field.name, td[task])
                elif "default" in td:
                    setattr(self, field.name, td["default"])
        return self

    # -- introspection -----------------------------------------------------
    def as_dict(self, exclude_defaults: bool = False) -> dict:
        out = {}
        for field in self._fields.values():
            value = getattr(self, field.name)
            if exclude_defaults and value == field.default_value():
                continue
            out[field.name] = value
        return out

    def non_default(self) -> dict:
        return self.as_dict(exclude_defaults=True)

    def clone(self):
        new = type(self).__new__(type(self))
        for field in self._fields.values():
            value = getattr(self, field.name)
            setattr(new, field.name, copy.copy(value) if isinstance(value, (list, dict, set)) else value)
        return new

    def __repr__(self):
        inner = ", ".join(f"{k}={v!r}" for k, v in self.non_default().items())
        return f"{type(self).__name__}({inner})"

    def __eq__(self, other):
        return type(self) is type(other) and self.as_dict() == other.as_dict()

    # -- argparse ----------------------------------------------------------
    @classmethod
    def add_args(cls, parser: argparse.ArgumentParser):
        for field in cls._fields.values():
            arg = field.arg
            if arg.hidden:
                continue
            names = []
            if arg.positional:
                names.append(field.name)
            else:
                names.append("--" + field.cli_name())
                names += [("-" if len(a) == 1 else "--") + a.replace("_", "-")
                          for a in arg.aliases]
            kwargs: dict[str, Any] = {"help": arg.help or None}
            base = arg.type or field.base_type
            default = field.default_value() if not arg.positional else MISSING
            if base is bool and not field.is_list:
                if default is True:
                    # --no-x flag to disable
                    parser.add_argument(
                        "--no-" + field.cli_name(), dest=field.name,
                        action="store_false", default=argparse.SUPPRESS, help=arg.help or None)
                    parser.add_argument(
                        *names, dest=field.name, action="store_true",
                        default=argparse.SUPPRESS, help=argparse.SUPPRESS)
                else:
                    parser.add_argument(
                        *names, dest=field.name, action="store_true",
                        default=argparse.SUPPRESS, help=arg.help or None)
                continue
            nargs = arg.nargs
            if isinstance(nargs, str) and nargs.isdigit():
                nargs = int(nargs)
            if field.is_list:
                kwargs["nargs"] = nargs if nargs is not None else "*"
            elif nargs is not None:
                kwargs["nargs"] = nargs
            kwargs["type"] = base if base in (int, float, str) else str
            if arg.choices:
                kwargs["choices"] = arg.choices
            if not arg.positional:
                kwargs["dest"] = field.name
                kwargs["default"] = argparse.SUPPRESS
            parser.add_argument(*names, **{k: v for k, v in kwargs.items() if v is not None or k == "help"})

    @classmethod
    def parse_args(cls, args=None, parser: Optional[argparse.ArgumentParser] = None,
                   **overrides) -> "Config":
        parser = parser or argparse.ArgumentParser()
        cls.add_args(parser)
        ns = parser.parse_args(args)
        cli = {k: v for k, v in vars(ns).items() if k in cls._fields}
        return cls(**{**overrides, **cli})

    @classmethod
    def extract_args(cls, namespace) -> dict:
        """Fields of this config present in an argparse namespace."""
        return {k: v for k, v in vars(namespace).items() if k in cls._fields}

    # -- YAML --------------------------------------------------------------
    def save_yaml(self, path: str, exclude_defaults: bool = False):
        with open(path, "w") as f:
            yaml.safe_dump(self.as_dict(exclude_defaults=exclude_defaults), f,
                           default_flow_style=False, sort_keys=False)

    @classmethod
    def load_yaml(cls, path: str, **overrides) -> "Config":
        with open(path) as f:
            data = yaml.safe_load(f) or {}
        data.update(overrides)
        return cls(strict=False, **data)


def merge_config_sources(
    cls: type,
    cli: Optional[dict] = None,
    kwargs: Optional[dict] = None,
    yaml_cfg: Optional[dict] = None,
    defaults: Optional[dict] = None,
    strict: bool = True,
) -> Config:
    """Precedence CLI > kwargs > YAML > task/arch defaults (pasero/config.py:1711-1760)."""
    merged: dict = {}
    for source in (defaults, yaml_cfg, kwargs, cli):
        if source:
            merged.update({k: v for k, v in source.items() if v is not None or k in merged})
    cfg = cls(strict=strict, **merged)
    return cfg
