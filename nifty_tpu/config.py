"""Global configuration (validated-update dict, like the reference's
``nifty/config.py:42-81``).

Keys
----
``hartley_convention``:
    ``"canonical_hartley"`` (H = Re F − Im F, the default) or
    ``"non_canonical_hartley"`` (Re F + Im F, ducc's convention — what the
    reference defaults to).  Both are valid self-inverse transforms; they
    differ by a spatial reflection of the white noise.
"""

from __future__ import annotations

_config = {
    "hartley_convention": "canonical_hartley",
}

_VALID = {
    "hartley_convention": ("canonical_hartley", "non_canonical_hartley"),
}

__all__ = ["update", "_config"]


def update(key: str, value) -> None:
    """Validated update of a global configuration value."""
    if key not in _config:
        raise KeyError(f"unknown config key {key!r}; known: {sorted(_config)}")
    valid = _VALID.get(key)
    if valid is not None and value not in valid:
        raise ValueError(f"{key!r} must be one of {valid}; got {value!r}")
    _config[key] = value
