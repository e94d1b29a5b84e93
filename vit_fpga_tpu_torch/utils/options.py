"""``key=value`` command-line options, the ``aocl_utils::Options``
analogue (the port's own copy of the JAX package's utils/options.py).

The reference vendors an Intel SDK options parser that maps ``key=value``
CLI arguments to typed lookups; this is the same contract in Python, used
by the port's CLI.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, TypeVar

T = TypeVar("T")


class OptionError(ValueError):
    pass


class Options:
    """Typed ``key=value`` argument map.

    >>> opts = Options(["model=vit_b16", "batch=64", "bf16=true"])
    >>> opts.get("batch", int)
    64
    >>> opts.get("missing", str, default="x")
    'x'
    """

    def __init__(self, argv: Sequence[str] = ()):
        self._raw: Dict[str, str] = {}
        self.positional: List[str] = []
        for arg in argv:
            if "=" in arg:
                key, _, val = arg.partition("=")
                if not key:
                    raise OptionError(f"nameless option in {arg!r}")
                self._raw[key] = val
            else:
                self.positional.append(arg)

    def has(self, key: str) -> bool:
        return key in self._raw

    def get(self, key: str, typ: type = str, default: Optional[T] = None):
        if key not in self._raw:
            if default is not None:
                return default
            raise OptionError(f"option {key!r} does not exist")
        raw = self._raw[key]
        try:
            if typ is bool:
                low = raw.lower()
                if low in ("1", "true", "yes", "on"):
                    return True
                if low in ("0", "false", "no", "off"):
                    return False
                raise ValueError(raw)
            return typ(raw)
        except (TypeError, ValueError) as e:
            raise OptionError(
                f"option {key!r}={raw!r} is not a valid {typ.__name__}"
            ) from e

    def set(self, key: str, value) -> None:
        self._raw[key] = str(value)

    def keys(self):
        return self._raw.keys()
