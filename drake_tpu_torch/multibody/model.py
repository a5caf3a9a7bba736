"""Multibody model: static topology plus tensor inertial/joint parameters.

The PyTorch counterpart of ``drake_tpu/multibody/model.py``.  The topology
(parent array, joint types, dof layout) is plain Python, so the tree loops of
kinematics and dynamics unroll in Python; the numeric parameters live in a
``MultibodyParams`` of tensors shared by every lane of a batch.

Joint model (Featherstone): X_{P,B}(q) = X_PJ . X_J(q), with the motion
subspace S expressed in the child body frame.  Joints: revolute, prismatic,
weld, quaternion-floating, ball (quaternion), planar and screw; the builder
expands a universal joint into two revolutes through a massless body.
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from drake_tpu_torch.math import rotations as rot
from drake_tpu_torch.utils.device import resolve_device
from drake_tpu_torch.utils.struct import tensor_dataclass

REVOLUTE = "revolute"
PRISMATIC = "prismatic"
WELD = "weld"
FLOATING = "floating"  # q = [qw,qx,qy,qz, x,y,z], v = [w_B; v_B]
BALL = "ball"  # q = quaternion [w,x,y,z], v = w_B (3)
PLANAR = "planar"  # q = [x, y, theta] in the joint frame; v = [vx_B, vy_B, wz]
SCREW = "screw"  # q = theta about/along axis; translation = pitch*theta/(2 pi)
UNIVERSAL = "universal"  # builder only: two revolutes through a massless body

_NQ = {REVOLUTE: 1, PRISMATIC: 1, WELD: 0, FLOATING: 7, BALL: 4, PLANAR: 3, SCREW: 1}
_NV = {REVOLUTE: 1, PRISMATIC: 1, WELD: 0, FLOATING: 6, BALL: 3, PLANAR: 3, SCREW: 1}


def _check_joint_type(joint_type: str):
    if joint_type not in _NQ:
        raise ValueError(f"unknown joint type {joint_type!r}")


@tensor_dataclass
class MultibodyParams:
    """Numeric parameters, one leading axis per body."""

    mass: torch.Tensor  # (nb,)
    com: torch.Tensor  # (nb, 3) p_BoBcm_B
    inertia_com: torch.Tensor  # (nb, 3, 3) rotational inertia about com, in B
    X_PJ_R: torch.Tensor  # (nb, 3, 3) joint frame rotation in parent
    X_PJ_p: torch.Tensor  # (nb, 3) joint frame origin in parent
    axis: torch.Tensor  # (nb, 3) joint axis (child frame)
    damping: torch.Tensor  # (nb,) viscous joint damping
    gravity: torch.Tensor  # (3,) gravity in world
    screw_pitch: torch.Tensor  # (nb,) axial travel per revolution; 0 but for screws
    reflected_inertia: Optional[torch.Tensor] = None  # (nb,) gear^2 * rotor


@dataclasses.dataclass(frozen=True)
class MultibodyModel:
    """Static topology.  Bodies are indexed 0..nb-1 in topological order
    (parent[i] < i); parent[i] == -1 means the joint connects to world."""

    parent: Tuple[int, ...]
    joint_types: Tuple[str, ...]
    body_names: Tuple[str, ...]
    joint_names: Tuple[str, ...]

    def __post_init__(self):
        for jt in self.joint_types:
            _check_joint_type(jt)

    @property
    def num_bodies(self) -> int:
        return len(self.parent)

    @property
    def q_offsets(self) -> Tuple[int, ...]:
        off = np.cumsum([0] + [_NQ[jt] for jt in self.joint_types])[:-1]
        return tuple(int(o) for o in off)

    @property
    def v_offsets(self) -> Tuple[int, ...]:
        off = np.cumsum([0] + [_NV[jt] for jt in self.joint_types])[:-1]
        return tuple(int(o) for o in off)

    @property
    def num_positions(self) -> int:
        return sum(_NQ[jt] for jt in self.joint_types)

    @property
    def num_velocities(self) -> int:
        return sum(_NV[jt] for jt in self.joint_types)

    def body_index(self, name: str) -> int:
        return self.body_names.index(name)

    def default_state(self, dtype=torch.float32, device=None):
        """x = [q; v] at rest with identity quaternions, on `device` (None:
        the current CUDA device, an error without one)."""
        q = np.zeros(self.num_positions)
        for i, jt in enumerate(self.joint_types):
            if jt in (FLOATING, BALL):
                q[self.q_offsets[i]] = 1.0
        x = np.concatenate([q, np.zeros(self.num_velocities)])
        return torch.tensor(x, dtype=dtype, device=resolve_device(device))


class ModelBuilder:
    """Imperative builder mirroring MultibodyPlant's AddRigidBody/AddJoint."""

    def __init__(self, gravity=(0.0, 0.0, -9.81)):
        self._parent: List[int] = []
        self._types: List[str] = []
        self._body_names: List[str] = []
        self._joint_names: List[str] = []
        self._mass: List[float] = []
        self._com: List[np.ndarray] = []
        self._inertia: List[np.ndarray] = []
        self._X_PJ_R: List[np.ndarray] = []
        self._X_PJ_p: List[np.ndarray] = []
        self._axis: List[np.ndarray] = []
        self._damping: List[float] = []
        self._reflected: List[float] = []
        self._screw_pitch: List[float] = []
        self._gravity = np.asarray(gravity, dtype=np.float64)

    def add_body(
        self,
        name: str,
        *,
        parent: Optional[str],
        joint_type: str,
        mass: float,
        com: Sequence[float] = (0, 0, 0),
        inertia_com: Optional[np.ndarray] = None,
        X_PJ_rpy: Sequence[float] = (0, 0, 0),
        X_PJ_xyz: Sequence[float] = (0, 0, 0),
        axis: Sequence[float] = (0, 0, 1),
        damping: float = 0.0,
        joint_name: Optional[str] = None,
        screw_pitch: float = 0.0,
        axis2: Sequence[float] = (0, 1, 0),
        rotor_inertia: float = 0.0,
        gear_ratio: float = 1.0,
    ) -> int:
        """Add a body connected to `parent` (None = world) by a joint.

        ``joint_type="universal"``: rotation about ``axis`` in the parent
        frame, then ``axis2`` in the child, as two revolute joints
        ``<joint>_1`` and ``<joint>_2`` through a massless body
        ``<name>__U`` (every motion subspace stays constant in its child
        frame); q = [theta1, theta2].  ``gear_ratio**2 * rotor_inertia`` is
        the joint's reflected inertia on the mass matrix's diagonal."""
        if joint_type == UNIVERSAL:
            base = joint_name or f"{name}_joint"
            self.add_body(f"{name}__U", parent=parent, joint_type=REVOLUTE, mass=0.0,
                          X_PJ_rpy=X_PJ_rpy, X_PJ_xyz=X_PJ_xyz, axis=axis, damping=damping,
                          joint_name=base + "_1")
            return self.add_body(name, parent=f"{name}__U", joint_type=REVOLUTE, mass=mass,
                                 com=com, inertia_com=inertia_com, axis=axis2, damping=damping,
                                 joint_name=base + "_2", rotor_inertia=rotor_inertia,
                                 gear_ratio=gear_ratio)
        _check_joint_type(joint_type)
        pidx = -1 if parent is None else self._body_names.index(parent)
        idx = len(self._body_names)
        self._parent.append(pidx)
        self._types.append(joint_type)
        self._body_names.append(name)
        self._joint_names.append(joint_name or f"{name}_joint")
        self._mass.append(float(mass))
        self._com.append(np.asarray(com, dtype=np.float64))
        if inertia_com is None:
            inertia_com = np.zeros((3, 3))
        self._inertia.append(np.asarray(inertia_com, dtype=np.float64))
        rpy = torch.tensor(np.asarray(X_PJ_rpy, dtype=np.float64))
        self._X_PJ_R.append(rot.rpy_to_rotation(rpy).numpy())
        self._X_PJ_p.append(np.asarray(X_PJ_xyz, dtype=np.float64))
        a = np.asarray(axis, dtype=np.float64)
        n = np.linalg.norm(a)
        self._axis.append(a / n if n > 0 else a)
        self._damping.append(float(damping))
        self._screw_pitch.append(float(screw_pitch))
        self._reflected.append(float(gear_ratio) ** 2 * float(rotor_inertia))
        return idx

    def build(self, dtype=torch.float32, device=None) -> Tuple[MultibodyModel, MultibodyParams]:
        """(model, params) with the parameters on `device` (None: the current
        CUDA device, an error without one)."""
        device = resolve_device(device)
        model = MultibodyModel(
            parent=tuple(self._parent),
            joint_types=tuple(self._types),
            body_names=tuple(self._body_names),
            joint_names=tuple(self._joint_names),
        )

        def t(values):
            return torch.tensor(np.asarray(values, dtype=np.float64), dtype=dtype, device=device)

        params = MultibodyParams(
            mass=t(self._mass),
            com=t(np.stack(self._com)),
            inertia_com=t(np.stack(self._inertia)),
            X_PJ_R=t(np.stack(self._X_PJ_R)),
            X_PJ_p=t(np.stack(self._X_PJ_p)),
            axis=t(np.stack(self._axis)),
            damping=t(self._damping),
            gravity=t(self._gravity),
            screw_pitch=t(self._screw_pitch),
            reflected_inertia=t(self._reflected),
        )
        return model, params
