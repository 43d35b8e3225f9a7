"""Typed configuration definition system.

Functional parity with the reference's Kafka-style ConfigDef fork
(cruise-control-core/src/main/java/.../common/config/ConfigDef.java:59):
typed keys with defaults, per-key validators, importance levels and doc
strings; parsing coerces raw string/props values to the declared type and
raises ``ConfigException`` on violation.  ``AbstractConfig`` equivalents are
built with :class:`Config`, which supports ``get_configured_instance`` for
plugin instantiation (reference: AbstractConfig.getConfiguredInstance used at
GoalOptimizer.java:134, LoadMonitor.java:151-156).
"""

from __future__ import annotations

import enum
import importlib
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Mapping, Optional, Sequence


class ConfigException(ValueError):
    """Raised on undefined keys, type mismatches, or validator failures."""


class Type(enum.Enum):
    BOOLEAN = "boolean"
    STRING = "string"
    INT = "int"
    LONG = "long"
    SHORT = "short"
    DOUBLE = "double"
    LIST = "list"
    CLASS = "class"
    PASSWORD = "password"


class Importance(enum.Enum):
    HIGH = "high"
    MEDIUM = "medium"
    LOW = "low"


class Password:
    """Opaque secret wrapper that never prints its value (ConfigDef.Password)."""

    def __init__(self, value: str):
        self.value = value

    def __repr__(self) -> str:  # pragma: no cover - trivial
        return "[hidden]"

    def __eq__(self, other: object) -> bool:
        return isinstance(other, Password) and other.value == self.value

    def __hash__(self) -> int:
        return hash(self.value)


# Sentinel mirroring ConfigDef.NO_DEFAULT_VALUE — key is required.
NO_DEFAULT = object()


def _parse_bool(value: Any) -> bool:
    if isinstance(value, bool):
        return value
    if isinstance(value, str):
        lowered = value.strip().lower()
        if lowered == "true":
            return True
        if lowered == "false":
            return False
    raise ConfigException(f"Expected boolean, got {value!r}")


def parse_type(name: str, value: Any, typ: Type) -> Any:
    """Coerce ``value`` to ``typ`` (ConfigDef.parseType semantics)."""
    if value is None:
        return None
    try:
        if typ is Type.BOOLEAN:
            return _parse_bool(value)
        if typ in (Type.STRING, Type.PASSWORD):
            if typ is Type.PASSWORD:
                return value if isinstance(value, Password) else Password(str(value))
            if not isinstance(value, str):
                raise ConfigException(f"Expected string for {name}, got {type(value).__name__}")
            return value.strip()
        if typ in (Type.INT, Type.LONG, Type.SHORT):
            if isinstance(value, bool):
                raise ConfigException(f"Expected int for {name}, got boolean")
            return int(value)
        if typ is Type.DOUBLE:
            if isinstance(value, bool):
                raise ConfigException(f"Expected double for {name}, got boolean")
            return float(value)
        if typ is Type.LIST:
            if isinstance(value, (list, tuple)):
                return list(value)
            if isinstance(value, str):
                return [] if value.strip() == "" else [v.strip() for v in value.split(",")]
            raise ConfigException(f"Expected list for {name}, got {type(value).__name__}")
        if typ is Type.CLASS:
            if isinstance(value, type) or callable(value):
                return value
            if isinstance(value, str):
                module_name, _, cls_name = value.strip().rpartition(".")
                if not module_name:
                    raise ConfigException(f"Class name {value!r} for {name} must be fully qualified")
                module = importlib.import_module(module_name)
                return getattr(module, cls_name)
            raise ConfigException(f"Expected class for {name}, got {type(value).__name__}")
    except ConfigException:
        raise
    except Exception as exc:
        raise ConfigException(f"Invalid value {value!r} for configuration {name}: {exc}") from exc
    raise ConfigException(f"Unknown type {typ} for {name}")


class Validator:
    def ensure_valid(self, name: str, value: Any) -> None:  # pragma: no cover - interface
        raise NotImplementedError


@dataclass
class Range(Validator):
    """Numeric range validator (ConfigDef.Range.between/atLeast)."""

    min: Optional[float] = None
    max: Optional[float] = None

    @classmethod
    def at_least(cls, minimum: float) -> "Range":
        return cls(min=minimum)

    @classmethod
    def between(cls, minimum: float, maximum: float) -> "Range":
        return cls(min=minimum, max=maximum)

    def ensure_valid(self, name: str, value: Any) -> None:
        if value is None:
            return
        if self.min is not None and value < self.min:
            raise ConfigException(f"Value {value} for {name} must be >= {self.min}")
        if self.max is not None and value > self.max:
            raise ConfigException(f"Value {value} for {name} must be <= {self.max}")


@dataclass
class ValidString(Validator):
    """String enumeration validator (ConfigDef.ValidString)."""

    valid: Sequence[str] = ()

    def ensure_valid(self, name: str, value: Any) -> None:
        if value is not None and value not in self.valid:
            raise ConfigException(f"Value {value!r} for {name} must be one of {list(self.valid)}")


@dataclass
class LambdaValidator(Validator):
    fn: Callable[[str, Any], None] = lambda name, value: None

    def ensure_valid(self, name: str, value: Any) -> None:
        self.fn(name, value)


@dataclass
class ConfigKey:
    name: str
    type: Type
    default: Any
    validator: Optional[Validator]
    importance: Importance
    doc: str
    group: Optional[str] = None

    @property
    def has_default(self) -> bool:
        return self.default is not NO_DEFAULT


class ConfigDef:
    """A registry of typed config keys; parse() materializes a value map."""

    def __init__(self):
        self._keys: Dict[str, ConfigKey] = {}

    def define(
        self,
        name: str,
        typ: Type,
        default: Any = NO_DEFAULT,
        validator: Optional[Validator] = None,
        importance: Importance = Importance.MEDIUM,
        doc: str = "",
        group: Optional[str] = None,
    ) -> "ConfigDef":
        if name in self._keys:
            raise ConfigException(f"Configuration {name} is defined twice")
        if default is not NO_DEFAULT and default is not None:
            default = parse_type(name, default, typ)
            if validator is not None:
                validator.ensure_valid(name, default)
        self._keys[name] = ConfigKey(name, typ, default, validator, importance, doc, group)
        return self

    def merge(self, other: "ConfigDef") -> "ConfigDef":
        for key in other._keys.values():
            if key.name in self._keys:
                raise ConfigException(f"Configuration {key.name} is defined twice")
            self._keys[key.name] = key
        return self

    @property
    def keys(self) -> Mapping[str, ConfigKey]:
        return self._keys

    def parse(self, props: Mapping[str, Any]) -> Dict[str, Any]:
        values: Dict[str, Any] = {}
        for name, key in self._keys.items():
            if name in props:
                value = parse_type(name, props[name], key.type)
            elif key.has_default:
                value = key.default
            else:
                raise ConfigException(f"Missing required configuration {name} which has no default value")
            if key.validator is not None:
                key.validator.ensure_valid(name, value)
            values[name] = value
        return values

    def doc_table(self) -> str:
        """Markdown doc table of all keys (ConfigDef.toHtmlTable analogue)."""
        lines = ["| name | type | default | importance | description |", "|---|---|---|---|---|"]
        for key in sorted(self._keys.values(), key=lambda k: k.name):
            default = "(required)" if not key.has_default else repr(key.default)
            lines.append(f"| {key.name} | {key.type.value} | {default} | {key.importance.value} | {key.doc} |")
        return "\n".join(lines)


@dataclass
class Config:
    """Parsed config values + plugin instantiation (AbstractConfig analogue)."""

    definition: ConfigDef
    originals: Dict[str, Any] = field(default_factory=dict)

    def __post_init__(self):
        self._values = self.definition.parse(self.originals)
        # Keep unknown keys available to plugins via originals(), like the
        # reference passes the full originals map to configure().
        self._unused = {k: v for k, v in self.originals.items() if k not in self.definition.keys}

    def get(self, name: str) -> Any:
        if name not in self._values:
            raise ConfigException(f"Unknown configuration {name}")
        return self._values[name]

    def __contains__(self, name: str) -> bool:
        return name in self._values

    def get_int(self, name: str) -> int:
        return int(self.get(name))

    def get_double(self, name: str) -> float:
        return float(self.get(name))

    def get_boolean(self, name: str) -> bool:
        return bool(self.get(name))

    def get_string(self, name: str) -> str:
        return self.get(name)

    def get_list(self, name: str) -> List[str]:
        return self.get(name)

    def merged_values(self) -> Dict[str, Any]:
        out = dict(self._values)
        out.update(self._unused)
        return out

    def get_configured_instance(self, name: str, expected_type: type, extra: Optional[Mapping[str, Any]] = None) -> Any:
        """Instantiate the class configured under ``name`` and configure() it."""
        cls = self.get(name)
        if isinstance(cls, str):
            cls = parse_type(name, cls, Type.CLASS)
        instance = cls()
        if not isinstance(instance, expected_type):
            raise ConfigException(f"{cls} configured under {name} is not a {expected_type.__name__}")
        configure = getattr(instance, "configure", None)
        if callable(configure):
            merged = self.merged_values()
            if extra:
                merged.update(extra)
            configure(merged)
        return instance

    def get_configured_instances(self, name: str, expected_type: type, extra: Optional[Mapping[str, Any]] = None) -> List[Any]:
        classes = self.get(name)
        out = []
        for cls in classes:
            if isinstance(cls, str):
                cls = parse_type(name, cls, Type.CLASS)
            instance = cls()
            if not isinstance(instance, expected_type):
                raise ConfigException(f"{cls} configured under {name} is not a {expected_type.__name__}")
            configure = getattr(instance, "configure", None)
            if callable(configure):
                merged = self.merged_values()
                if extra:
                    merged.update(extra)
                configure(merged)
            out.append(instance)
        return out


def load_properties(path: str) -> Dict[str, str]:
    """Parse a java-style .properties file (comments, key=value), with
    ``${env:VAR}`` substitution in values (EnvConfigProvider semantics —
    the reference resolves env indirections when loading config; unset
    variables substitute to empty)."""
    import os
    import re

    def substitute(value: str) -> str:
        return re.sub(r"\$\{env:([A-Za-z_][A-Za-z0-9_]*)\}",
                      lambda m: os.environ.get(m.group(1), ""), value)

    props: Dict[str, str] = {}
    with open(path, "r", encoding="utf-8") as fh:
        for line in fh:
            line = line.strip()
            if not line or line.startswith("#") or line.startswith("!"):
                continue
            if "=" in line:
                key, _, value = line.partition("=")
            elif ":" in line:
                key, _, value = line.partition(":")
            else:
                continue
            props[key.strip()] = substitute(value.strip())
    return props
