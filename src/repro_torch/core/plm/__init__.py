"""The PLM vocabulary the synthesis backends report in."""

from .spec import PLMRequirement

__all__ = ["PLMRequirement"]
