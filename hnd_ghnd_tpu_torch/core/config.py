"""Config system: YAML with a ``!join`` tag + recursive JSON overrides.

Counterpart of hnd_ghnd_tpu/core/config.py (reference
src/utils/main_util.py:14-26 and the myutils ``yaml_util.load_yaml_file``
call sites): every reference YAML under ``config/{org,hnd,ghnd,ext}`` uses
anchors plus a custom ``!join`` tag that concatenates a list of strings,
and runners accept a ``--json`` CLI flag whose dict is recursively merged
over the loaded config.  ``yaml`` is imported by ``load_config`` alone, so
the rest of the port runs where it is not installed.
"""
from __future__ import annotations

import json
from typing import Any, Dict


def load_config(path: str) -> Dict[str, Any]:
    """Load a YAML config file, honoring anchors and the ``!join`` tag."""
    import yaml

    class JoinLoader(yaml.SafeLoader):
        """SafeLoader extended with the ``!join`` string-concatenation
        tag."""

    def join(loader: JoinLoader, node: yaml.Node) -> str:
        return "".join(str(p) for p in loader.construct_sequence(node))

    JoinLoader.add_constructor("!join", join)
    with open(path, "r") as f:
        return yaml.load(f, Loader=JoinLoader)


def overwrite_dict(org_dict: Dict[str, Any], sub_dict: Dict[str, Any]) -> None:
    """Recursively merge ``sub_dict`` into ``org_dict`` in place.

    Dict values recurse; any other value (including lists) replaces the
    original, matching the reference override semantics
    (src/utils/main_util.py:14-21).
    """
    for key, value in sub_dict.items():
        if key in org_dict and isinstance(value, dict) and isinstance(org_dict[key], dict):
            overwrite_dict(org_dict[key], value)
        else:
            org_dict[key] = value


def overwrite_config(config: Dict[str, Any], json_str: str | None) -> Dict[str, Any]:
    """Apply a ``--json`` CLI override string onto a loaded config."""
    if json_str:
        overwrite_dict(config, json.loads(json_str))
    return config
