"""Unique names for a program's variables: ``utils.unique_name``'s one
generator (``key_0``, ``key_1``, ... per key, swapped by ``guard``), so
``static`` and ``utils.unique_name.generate`` draw from one counter, as
in the reference."""
from ..utils.unique_name import (  # noqa: F401
    UniqueNameGenerator, generate, guard, switch,
)

__all__ = ["UniqueNameGenerator", "generate", "switch", "guard"]
