from cruise_control_tpu_torch.config.configdef import (
    Config,
    ConfigDef,
    ConfigException,
    Importance,
    NO_DEFAULT,
    Password,
    Range,
    Type,
    ValidString,
    load_properties,
)
from cruise_control_tpu_torch.config.constants import cruise_control_config_def


def cruise_control_config(props=None) -> Config:
    """Build the full framework Config from a props mapping (may be empty)."""
    return Config(cruise_control_config_def(), dict(props or {}))


__all__ = [
    "Config",
    "ConfigDef",
    "ConfigException",
    "Importance",
    "NO_DEFAULT",
    "Password",
    "Range",
    "Type",
    "ValidString",
    "load_properties",
    "cruise_control_config",
    "cruise_control_config_def",
]
