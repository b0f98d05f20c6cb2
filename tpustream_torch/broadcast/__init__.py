"""Dynamic rules via broadcast state (docs/dynamic_rules.md).

Public surface: :class:`RuleDescriptor`/:class:`RuleSet` declare dynamic
operator parameters, :class:`RuleParam` handles drop into map/filter/CEP
predicates, :class:`RuleUpdate` records ride a control stream that
``DataStream.broadcast(rules)`` turns into a :class:`BroadcastStream`.
"""

from .rules import RuleDescriptor, RuleParam, RuleSet, RuleUpdate
from .stream import BroadcastStream, ControlFeed, parse_control_line

__all__ = [
    "BroadcastStream",
    "ControlFeed",
    "RuleDescriptor",
    "RuleParam",
    "RuleSet",
    "RuleUpdate",
    "parse_control_line",
]
