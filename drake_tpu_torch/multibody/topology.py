"""Kinematic-loop topology: a link/joint graph -> spanning forest + cut joints.

The PyTorch counterpart of ``drake_tpu/multibody/topology.py`` (the role of
Drake's multibody/topology graph.h + forest.h: pick a spanning forest of the
link graph and model every other joint as a constraint).  The graph is a
host-side build-time object; the output is a ``MultibodyModel`` tree plus
the ball and weld constraint tuples that ``contact.plant.make_discrete_system``
accepts.

Frame conventions: every joint carries an anchor point on each side
(``p_PJ`` in the parent link frame, ``p_CJ`` in the child link frame), with
joint axes in the (axis-aligned) link frames.  The tree re-roots each link's
body frame at its inbound joint (the ModelBuilder convention), so link-frame
quantities are shifted by the stored per-link offset.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from drake_tpu_torch.multibody import kinematics as kin
from drake_tpu_torch.multibody.model import BALL, FLOATING, REVOLUTE, WELD, ModelBuilder

WORLD = "world"


@dataclass
class LinkSpec:
    name: str
    mass: float = 0.0
    com: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    inertia_com: Optional[np.ndarray] = None


@dataclass
class JointSpec:
    name: str
    parent: str
    child: str
    joint_type: str = REVOLUTE
    axis: Tuple[float, float, float] = (0.0, 1.0, 0.0)
    p_PJ: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    p_CJ: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    damping: float = 0.0


@dataclass
class Forest:
    """Spanning-forest decomposition (reference forest.h role)."""

    tree_edges: List[Tuple[JointSpec, bool]] = field(default_factory=list)
    loop_joints: List[JointSpec] = field(default_factory=list)


class LinkGraph:
    """Build-time link/joint graph with automatic loop cutting."""

    def __init__(self, gravity=(0.0, 0.0, -9.81)):
        self._links: Dict[str, LinkSpec] = {}
        self._order: List[str] = []
        self._joints: List[JointSpec] = []
        self._gravity = gravity

    def add_link(
        self,
        name: str,
        *,
        mass: float = 0.0,
        com: Sequence[float] = (0.0, 0.0, 0.0),
        inertia_com: Optional[np.ndarray] = None,
    ) -> None:
        if name in self._links or name == WORLD:
            raise ValueError(f"duplicate link {name!r}")
        self._links[name] = LinkSpec(name, mass, tuple(com), inertia_com)
        self._order.append(name)

    def add_joint(
        self,
        name: str,
        *,
        parent: str,
        child: str,
        joint_type: str = REVOLUTE,
        axis: Sequence[float] = (0.0, 1.0, 0.0),
        p_PJ: Sequence[float] = (0.0, 0.0, 0.0),
        p_CJ: Sequence[float] = (0.0, 0.0, 0.0),
        damping: float = 0.0,
    ) -> None:
        for end in (parent, child):
            if end != WORLD and end not in self._links:
                raise ValueError(f"unknown link {end!r} in joint {name!r}")
        self._joints.append(
            JointSpec(
                name, parent, child, joint_type, tuple(axis),
                tuple(p_PJ), tuple(p_CJ), damping,
            )
        )

    def spanning_forest(self) -> Forest:
        """BFS from world over the undirected link graph.

        Tree edges keep their traversal direction (``forward`` is True when
        the BFS walks parent->child of the joint spec); every remaining
        joint is a loop joint to be modeled as a constraint — the
        reference's LinkJointGraph::BuildForest discipline.
        """
        adj: Dict[str, List[Tuple[int, str]]] = {WORLD: []}
        for n in self._order:
            adj[n] = []
        for i, j in enumerate(self._joints):
            adj[j.parent].append((i, j.child))
            adj[j.child].append((i, j.parent))
        visited = {WORLD}
        used = set()
        forest = Forest()
        queue = [WORLD]
        while queue:
            u = queue.pop(0)
            for ji, v in adj[u]:
                if ji in used or v in visited:
                    continue
                used.add(ji)
                visited.add(v)
                j = self._joints[ji]
                forest.tree_edges.append((j, j.parent == u))
                queue.append(v)
        unreached = [n for n in self._order if n not in visited]
        if unreached:
            raise ValueError(f"links not connected to world: {unreached}")
        forest.loop_joints = [
            j for i, j in enumerate(self._joints) if i not in used
        ]
        return forest

    def build(self, dtype=torch.float32, device=None):
        """Returns (model, params, ball_constraints, weld_constraints), the
        parameters on `device` (None: the current CUDA device).

        Cut revolute/ball loop joints become SAP ball constraints (the
        reference four_bar's exact modeling: a cut revolute in a planar
        mechanism loses only its axis-alignment row); cut welds become weld
        constraints.  Constraint tuples feed straight into
        ``contact.plant.make_discrete_system``.
        """
        forest = self.spanning_forest()
        b = ModelBuilder(gravity=self._gravity)
        # off[link] = link-frame origin expressed in that link's BODY frame
        # (the body frame sits at the inbound joint anchor).
        off: Dict[str, np.ndarray] = {WORLD: np.zeros(3)}
        for j, forward in forest.tree_edges:
            u, v = (j.parent, j.child) if forward else (j.child, j.parent)
            p_U = np.asarray(j.p_PJ if forward else j.p_CJ, float)
            p_V = np.asarray(j.p_CJ if forward else j.p_PJ, float)
            spec = self._links[v]
            off[v] = -p_V
            com_body = np.asarray(spec.com, float) + off[v]
            b.add_body(
                v,
                parent=None if u == WORLD else u,
                joint_type=j.joint_type,
                mass=spec.mass,
                com=tuple(com_body),
                inertia_com=spec.inertia_com,
                X_PJ_xyz=tuple(off[u] + p_U),
                axis=j.axis,
                damping=j.damping,
                joint_name=j.name,
            )
        model, params = b.build(dtype, device)

        def body_and_point(link: str, p_link) -> Tuple[int, tuple]:
            if link == WORLD:
                return -1, tuple(np.asarray(p_link, float))
            return (
                model.body_index(link),
                tuple(off[link] + np.asarray(p_link, float)),
            )

        balls, welds = [], []
        eye = np.eye(3)
        for j in forest.loop_joints:
            ia, pa = body_and_point(j.parent, j.p_PJ)
            ib, pb = body_and_point(j.child, j.p_CJ)
            if j.joint_type == WELD:
                welds.append((ia, eye, pa, ib, eye, pb))
            else:
                balls.append((ia, pa, ib, pb))
        return model, params, balls, welds


def loop_residual(model, params, ball_constraints, q):
    """Stacked world-frame gaps (..., 3 n) of the cut-joint anchor pairs at q."""
    R, p = kin.forward_kinematics(model, params, q)

    def point(body, p_B):
        p_B = torch.as_tensor(p_B, dtype=q.dtype, device=q.device)
        if body < 0:
            return p_B.expand(q.shape[:-1] + (3,))
        return p[..., body, :] + (R[..., body, :, :] @ p_B.unsqueeze(-1)).squeeze(-1)

    return torch.cat([point(ia, pa) - point(ib, pb) for ia, pa, ib, pb in ball_constraints],
                     dim=-1)


def _lstsq(J, b, rcond):
    """The minimum-norm least-squares solution by SVD, singular values at
    or below rcond times the largest left out (as jnp.linalg.lstsq)."""
    U, S, Vh = torch.linalg.svd(J, full_matrices=False)
    keep = S >= rcond * S[..., :1]
    s_inv = torch.where(keep, 1.0 / torch.where(keep, S, torch.ones_like(S)), torch.zeros_like(S))
    return Vh.mT @ (s_inv * (U.mT @ b))


def assemble(model, params, ball_constraints, q_guess, *, iters: int = 40):
    """Project q_guess (nq,) onto the loop-closure manifold by Gauss-Newton;
    returns (q, the residual's norm).  Scalar-coordinate joints only (no
    quaternions)."""
    for jt in model.joint_types:
        if jt in (FLOATING, BALL):
            raise ValueError("assemble() supports scalar-coordinate joints")
    q = torch.as_tensor(q_guess)

    def res(qq):
        return loop_residual(model, params, ball_constraints, qq)

    for _ in range(iters):
        r = res(q)
        J = torch.func.jacfwd(res)(q)
        q = q + _lstsq(J, -r, 1e-8)
        if float(torch.linalg.vector_norm(res(q))) < 1e-10:
            break
    return q, float(torch.linalg.vector_norm(res(q)))
