"""PLM planning vocabulary: what a mapped component requires of memory.

The paper's system cost is the sum of per-component areas, each of which
*includes* a private PLM (hlsim folds Mnemosyne's area into every
synthesis).  Every mapped component states what it *requires* of the
memory subsystem (:class:`PLMRequirement`): capacity, word width, ports,
and the split of its area into the private PLM and the datapath.

Capacities and areas are unit-tagged (``"mm2"`` for the analytical
backend, ``"bytes"`` for the measured shared-memory backend).
"""

from __future__ import annotations

from dataclasses import dataclass

__all__ = ["PLMRequirement"]


@dataclass(frozen=True)
class PLMRequirement:
    """One mapped component's demand on the memory subsystem.

    ``capacity`` is in words (unit ``"mm2"``) or bytes (unit
    ``"bytes"``); ``area_plm`` is the area of the *private* PLM the
    paper's per-component sum would charge for it, and ``area_logic``
    the datapath remainder.  ``capacity == 0`` marks a requirement whose
    memory cannot be split from its logic.
    """

    component: str
    capacity: int
    word_bits: int
    ports: int
    area_plm: float
    area_logic: float
    unit: str = "mm2"
    tile: int = 0
