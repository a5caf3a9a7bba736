"""Geometry roles and collision filtering (the SceneGraph-registry role).

The port's copy of ``drake_tpu/geometry/scene_graph.py`` (plain Python, no
tensors).  Each geometry carries up to three roles (Drake's
geometry/geometry_roles.h): *proximity* (contact queries), *illustration*
and *perception*; only proximity-role geometries enter collision pairs.  A
``CollisionFilterManager`` edits the candidate-pair set with declarations
built from ``GeometrySet``s (collision_filter_manager.h,
collision_filter_declaration.h).  The pairs are fixed when the scene is
built: ``CollisionScene.build(..., filter_manager=...)`` consults
``CollisionFilterManager.is_filtered``.
"""

from __future__ import annotations

import dataclasses
from typing import Iterable, List, Optional, Sequence, Set, Tuple

# Role bit-flags. A geometry's ``roles`` field is an OR of these; the
# default (ALL_ROLES) matches Drake's common pattern of registering one
# shape for every consumer. Assigning a restricted role is how e.g. a
# visual-only mesh (illustration) coexists with a collision capsule
# (proximity) on the same body.
PROXIMITY = 1
ILLUSTRATION = 2
PERCEPTION = 4
ALL_ROLES = PROXIMITY | ILLUSTRATION | PERCEPTION

_ROLE_NAMES = {"proximity": PROXIMITY, "illustration": ILLUSTRATION,
               "perception": PERCEPTION}


def role_mask(roles) -> int:
    """Normalize a role spec (int mask, name, or iterable of names)."""
    if roles is None:
        return ALL_ROLES
    if isinstance(roles, int):
        return roles
    if isinstance(roles, str):
        return _ROLE_NAMES[roles]
    mask = 0
    for r in roles:
        mask |= role_mask(r)
    return mask


def has_role(geometry, role: int) -> bool:
    """True if ``geometry`` carries ``role`` (geometries without a
    ``roles`` attribute predate the role system and carry all roles)."""
    return bool(getattr(geometry, "roles", ALL_ROLES) & role)


def geometries_with_role(geometries: Sequence, role: int) -> List[int]:
    """Indices of geometries carrying ``role`` — the GetGeometries(role)
    query (geometry_state.h)."""
    return [i for i, g in enumerate(geometries) if has_role(g, role)]


@dataclasses.dataclass(frozen=True)
class GeometrySet:
    """A set of geometries named directly and/or by body — the
    geometry/geometry_set.h role (its frame-ids map to body indices
    here).  Resolution to concrete geometry names happens against a
    geometry list at apply time."""

    names: Tuple[str, ...] = ()
    bodies: Tuple[int, ...] = ()

    @staticmethod
    def of(*, names: Iterable[str] = (), bodies: Iterable[int] = ()):
        return GeometrySet(names=tuple(names), bodies=tuple(bodies))

    def resolve(self, geometries: Sequence) -> Set[str]:
        names = set(self.names)
        bodies = set(self.bodies)
        known = {g.name for g in geometries}
        missing = set(self.names) - known
        if missing:
            raise ValueError(
                f"GeometrySet names not registered: {sorted(missing)}")
        for g in geometries:
            if g.body in bodies:
                names.add(g.name)
        return names


@dataclasses.dataclass(frozen=True)
class CollisionFilterDeclaration:
    """A chainable edit of the collision-candidate set
    (collision_filter_declaration.h).  ``exclude_within(S)`` removes all
    pairs with both members in S; ``exclude_between(A, B)`` removes pairs
    with one member in each.  (Allow* statements re-add pairs; supported
    as allow_within/allow_between for filter removal.)"""

    statements: Tuple[Tuple[str, GeometrySet, Optional[GeometrySet]], ...] = ()

    def _add(self, kind, a, b=None):
        return CollisionFilterDeclaration(
            statements=self.statements + ((kind, a, b),))

    def exclude_within(self, geo_set: GeometrySet):
        return self._add("exclude_within", geo_set)

    def exclude_between(self, a: GeometrySet, b: GeometrySet):
        return self._add("exclude_between", a, b)

    def allow_within(self, geo_set: GeometrySet):
        return self._add("allow_within", geo_set)

    def allow_between(self, a: GeometrySet, b: GeometrySet):
        return self._add("allow_between", a, b)


class CollisionFilterManager:
    """Applies CollisionFilterDeclarations and answers pair-filter
    queries (collision_filter_manager.h Apply; the internal
    CollisionFilter's filtered-pair bookkeeping).

    Statements apply in order, so a later ``allow_between`` can undo an
    earlier ``exclude_within`` — matching the reference's sequential
    declaration semantics.
    """

    def __init__(self, geometries: Sequence = ()):
        self._geometries = list(geometries)
        self._filtered: Set[frozenset] = set()

    def apply(self, declaration: CollisionFilterDeclaration) -> None:
        for kind, a, b in declaration.statements:
            set_a = a.resolve(self._geometries)
            set_b = b.resolve(self._geometries) if b is not None else None
            pairs = self._pairs(set_a, set_b)
            if kind.startswith("exclude"):
                self._filtered |= pairs
            else:
                self._filtered -= pairs

    @staticmethod
    def _pairs(set_a: Set[str], set_b: Optional[Set[str]]) -> Set[frozenset]:
        if set_b is None:
            return {frozenset((x, y)) for x in set_a for y in set_a if x != y}
        return {frozenset((x, y))
                for x in set_a for y in set_b if x != y}

    def is_filtered(self, name_a: str, name_b: str) -> bool:
        return frozenset((name_a, name_b)) in self._filtered

    @property
    def filtered_pairs(self) -> Set[frozenset]:
        return set(self._filtered)
