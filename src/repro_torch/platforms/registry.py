"""Name -> Platform registry (the JAX package's ``platforms/registry.py``).

``register_platform`` installs a platform (and its aliases);
``get_platform("imax3-28nm/32k")`` resolves one; ``list_platforms()``
enumerates canonical names. The builtin targets (``builtin.py``) are
registered on package import; other code registers more the same way.
"""

from __future__ import annotations

from typing import Iterable, Optional

from repro_torch.platforms.base import Platform

__all__ = ["register_platform", "get_platform", "list_platforms",
           "platform_families", "platforms_in_family"]

_REGISTRY: dict[str, Platform] = {}
_ALIASES: dict[str, str] = {}


def register_platform(platform: Platform, *,
                      overwrite: bool = False) -> Platform:
    """Install ``platform`` under its name and aliases. Re-registering a
    name raises unless ``overwrite=True`` (aliases may not shadow a
    canonical name)."""
    names = (platform.name,) + tuple(platform.aliases)
    for n in names:
        taken = n in _REGISTRY or n in _ALIASES
        if taken and not overwrite:
            raise ValueError(f"platform name {n!r} already registered "
                             f"(pass overwrite=True to replace)")
    if platform.name in _ALIASES and not overwrite:
        raise ValueError(f"{platform.name!r} is an alias of "
                         f"{_ALIASES[platform.name]!r}")
    _REGISTRY[platform.name] = platform
    for a in platform.aliases:
        _ALIASES[a] = platform.name
    return platform


def get_platform(name) -> Platform:
    """Resolve a platform by canonical name or alias (a ``Platform`` is
    returned as is); raises KeyError naming the known platforms on a
    miss."""
    if isinstance(name, Platform):
        return name
    if name in _REGISTRY:
        return _REGISTRY[name]
    if name in _ALIASES:
        return _REGISTRY[_ALIASES[name]]
    raise KeyError(
        f"unknown platform {name!r}; known platforms: "
        f"{', '.join(list_platforms())}")


def list_platforms(family: Optional[str] = None) -> list[str]:
    """Sorted canonical platform names, optionally one family only."""
    return sorted(n for n, p in _REGISTRY.items()
                  if family is None or p.family == family)


def platform_families() -> list[str]:
    return sorted({p.family for p in _REGISTRY.values()})


def platforms_in_family(family: str) -> Iterable[Platform]:
    for n in list_platforms(family):
        yield _REGISTRY[n]
