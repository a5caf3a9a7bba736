"""Parity of drake_tpu_torch's primitive contact pairs, hydroelastic patches,
box-box manifold and scene_graph copy against drake_tpu's, on the CPU in
float64.

Each case is a scene of two geometries on floating bodies (a halfspace on
the world), in both argument orders where the reference swaps them.  The
lanes come from a numpy seed: random orientations, and the first body
placed about the second at 0.6-1.1 times the sum of their sizes (two
boxes 0.3-0.8), so that
some lanes penetrate and some are apart.  Each case's JAX query is one
jitted program.  Compared: phi, p_W, n_W and the per-point
stiffness, and for hydroelastic patches the patch force sum(k max(-phi, 0)).

The box-box manifold is also held to the JAX package on the exact ties of
``tests/test_box_collision.py`` (aligned identical boxes, a small box flat
on a large one, a 45-degree twist), where the lowest-index rule of
``jax.lax.top_k`` and ``jnp.argmax`` decides which candidates are kept.

Tolerance: 1e-10 absolute (phi, points, normals), 1e-10 relative on
stiffness and patch forces; 1e-9 absolute on the patches of a cylinder or
an ellipsoid, whose points come from Newton projections onto the surface
(the rounding of the same steps in another order grows through them to
about 1.5e-10).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, run_jitted

TOL = 1e-10
LANES = 6

SHAPES = {
    "sphere": ("Sphere", dict(radius=0.1), 0.1),
    "box": ("Box", dict(size=(0.3, 0.2, 0.1)), 0.19),
    "capsule": ("Capsule", dict(radius=0.05, length=0.3), 0.2),
    "cylinder": ("Cylinder", dict(radius=0.08, length=0.2), 0.13),
    "ellipsoid": ("Ellipsoid", dict(radii=(0.12, 0.08, 0.06)), 0.1),
    "halfspace": ("HalfSpace", dict(), 0.0),
}

# (case name, shape A, shape B, A's hydro (modulus, rings) or None, B's).
CASES = [
    ("sphere-halfspace", "sphere", "halfspace", None, None),
    ("halfspace-sphere", "halfspace", "sphere", None, None),
    ("sphere-sphere", "sphere", "sphere", None, None),
    ("sphere-box", "sphere", "box", None, None),
    ("box-sphere", "box", "sphere", None, None),
    ("capsule-halfspace", "capsule", "halfspace", None, None),
    ("capsule-sphere", "capsule", "sphere", None, None),
    ("sphere-capsule", "sphere", "capsule", None, None),
    ("capsule-capsule", "capsule", "capsule", None, None),
    ("box-halfspace", "box", "halfspace", None, None),
    ("box-box", "box", "box", None, None),
    ("capsule-box", "capsule", "box", None, None),
    ("box-capsule", "box", "capsule", None, None),
    ("sphere-cylinder", "sphere", "cylinder", None, None),
    ("cylinder-sphere", "cylinder", "sphere", None, None),
    ("capsule-cylinder", "capsule", "cylinder", None, None),
    ("box-cylinder", "box", "cylinder", None, None),
    ("cylinder-box", "cylinder", "box", None, None),
    ("cylinder-halfspace", "cylinder", "halfspace", None, None),
    ("cylinder-cylinder", "cylinder", "cylinder", None, None),
    ("sphere-ellipsoid", "sphere", "ellipsoid", None, None),
    ("capsule-ellipsoid", "capsule", "ellipsoid", None, None),
    ("box-ellipsoid", "box", "ellipsoid", None, None),
    ("ellipsoid-halfspace", "ellipsoid", "halfspace", None, None),
    ("hydro sphere-halfspace", "sphere", "halfspace", (2e5, 3), None),
    ("hydro halfspace-sphere", "halfspace", "sphere", None, (2e5, 2)),
    ("hydro box-box", "box", "box", (1e6, 1), None),
    ("hydro capsule-halfspace", "capsule", "halfspace", (5e5, 2), None),
    ("hydro sphere-sphere both", "sphere", "sphere", (2e5, 2), (6e5, 1)),
    ("hydro sphere-box", "sphere", "box", (5e6, 3), None),
    ("hydro cylinder-halfspace", "cylinder", "halfspace", (3e5, 2), None),
    ("hydro ellipsoid-sphere", "ellipsoid", "sphere", (3e5, 1), None),
]


def make_case(pkg, case, dtype, **kw):
    """(model, params, scene) of one case in the package `pkg` ("jax" or
    "torch")."""
    if pkg == "jax":
        from drake_tpu.geometry import shapes as sh
        from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu.multibody.model import ModelBuilder
    else:
        from drake_tpu_torch.geometry import shapes as sh
        from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu_torch.multibody.model import ModelBuilder
    _, a, b, hydro_a, hydro_b = case
    b_ = ModelBuilder()
    geoms = []
    for name, kind, hydro in (("A", a, hydro_a), ("B", b, hydro_b)):
        cls, fields, _ = SHAPES[kind]
        body = -1
        if kind != "halfspace":
            body = b_.add_body(name, parent=None, joint_type="floating", mass=1.0,
                               inertia_com=np.eye(3) * 0.01)
        extra = {}
        if hydro is not None:
            extra = dict(hydroelastic_modulus=hydro[0], hydro_rings=hydro[1])
        geoms.append(CollisionGeometry(name=name, body=body, shape=getattr(sh, cls)(**fields),
                                       stiffness=1e5 if name == "A" else 4e5,
                                       friction=0.6 if name == "A" else 0.9, **extra))
    model, params = b_.build(dtype, **kw)
    return model, params, CollisionScene.build(geoms)


def case_lanes(case, nq, seed):
    """q (LANES, nq): both bodies' poses (a halfspace stays the world's)."""
    _, a, b, _, _ = case
    rng = np.random.default_rng(seed)
    q = np.zeros((LANES, nq))
    floating = [k for k in (a, b) if k != "halfspace"]
    size = {k: SHAPES[k][2] for k in (a, b)}
    for j, kind in enumerate(floating):
        quat = rng.standard_normal((LANES, 4))
        q[:, 7 * j : 7 * j + 4] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    if len(floating) == 2:
        u = rng.standard_normal((LANES, 3))
        u /= np.linalg.norm(u, axis=1, keepdims=True)
        # Two boxes touch only well inside their bounding spheres.
        lo, hi = (0.3, 0.8) if a == b == "box" else (0.6, 1.1)
        dist = (size[a] + size[b]) * rng.uniform(lo, hi, (LANES, 1))
        q[:, 4:7] = u * dist
    else:
        q[:, 4:6] = rng.uniform(-0.2, 0.2, (LANES, 2))
        q[:, 6] = size[floating[0]] * rng.uniform(0.4, 1.1, LANES)
    return q


def jax_reference(case, seed):
    """(q, the JAX query's phi, p_W, n_W, stiffness and patch force) of one
    case, compiled on its own (one program per case compiles in about half
    the time of one program for all)."""
    m, p, s = make_case("jax", case, jnp.float64)
    q = case_lanes(case, m.num_positions, seed)

    def run(qq):
        cd = jax.vmap(lambda q1: s.query(m, p, q1))(qq)
        k = jnp.broadcast_to(cd.stiffness, cd.phi.shape)
        return {"phi": cd.phi, "p_W": cd.p_W, "n_W": cd.n_W, "stiffness": k,
                "force": jnp.sum(k * jnp.maximum(-cd.phi, 0.0), axis=-1)}

    return q, jax.tree_util.tree_map(np.asarray, run_jitted(run, q))


@pytest.mark.parametrize("name", [c[0] for c in CASES])
def test_pair_matches_jax(name):
    import torch

    torch.set_num_threads(1)
    seed = [c[0] for c in CASES].index(name)
    case = CASES[seed]
    q, ref = jax_reference(case, seed)
    model, params, scene = make_case("torch", case, torch.float64, device="cpu")
    cd = scene.query(model, params, torch.tensor(q))
    assert scene.num_contacts == ref["phi"].shape[-1]
    tol = 1e-9 if name in ("hydro cylinder-halfspace", "hydro ellipsoid-sphere") else TOL
    for field in ("phi", "p_W", "n_W"):
        close(getattr(cd, field), ref[field], tol)
    k = cd.stiffness.expand(cd.phi.shape)
    np.testing.assert_allclose(k.numpy(), ref["stiffness"], rtol=TOL, atol=0.0)
    force = torch.sum(k * torch.clamp_min(-cd.phi, 0.0), dim=-1)
    np.testing.assert_allclose(force.numpy(), ref["force"], rtol=TOL, atol=1e-12)
    if name.startswith("hydro"):
        assert float(force.max()) > 0.0, "no lane of the case is in contact"


TIE_POSES = {
    # test_box_collision.py: aligned identical boxes, a small box flat on a
    # large one, a 45-degree twist.
    "aligned": (np.eye(3), (0.0, 0.0, 0.99), (1, 1, 1), (1, 1, 1)),
    "small_on_large": (np.eye(3), (0.1, 0.2, 0.745), (0.5, 0.5, 0.5), (1, 1, 1)),
    "twist45": (np.array([[np.cos(np.pi / 4), -np.sin(np.pi / 4), 0],
                          [np.sin(np.pi / 4), np.cos(np.pi / 4), 0], [0, 0, 1.0]]),
                (0.0, 0.0, 0.99), (1, 1, 1), (1, 1, 1)),
}


@pytest.mark.parametrize("pose", list(TIE_POSES))
def test_box_box_ties_match_jax(pose):
    import torch

    from drake_tpu.geometry import box_collision as jbc
    from drake_tpu_torch.geometry import box_collision as tbc

    Ra, pa, size_a, size_b = TIE_POSES[pose]
    ref = run_jitted(lambda R, p: jbc.box_box_contacts(R, p, size_a, jnp.eye(3, dtype=jnp.float64),
                                                       jnp.zeros(3, jnp.float64), size_b),
                     jnp.asarray(Ra), jnp.asarray(pa))
    t = lambda x: torch.tensor(np.asarray(x, np.float64))  # noqa: E731
    got = tbc.box_box_contacts(t(Ra), t(pa), size_a, t(np.eye(3)), t(np.zeros(3)), size_b)
    for g, r in zip(got, ref):
        close(g, np.asarray(r), 1e-12)
    if pose == "small_on_large":
        assert int((got[0] < 0.5).sum()) == 4


def _declaration(pkg):
    sg = pkg.scene_graph
    return (sg.CollisionFilterDeclaration()
            .exclude_within(sg.GeometrySet.of(bodies=(0, 1)))
            .exclude_between(sg.GeometrySet.of(names=("c",)), sg.GeometrySet.of(bodies=(3,)))
            .allow_between(sg.GeometrySet.of(names=("a",)), sg.GeometrySet.of(names=("b",))))


@pytest.mark.parametrize("what", ["roles", "sets", "filtered pairs", "scene pairs"])
def test_scene_graph_copy_matches_jax(what):
    """The port's copy of scene_graph gives the JAX module's role masks,
    resolved sets, filtered pairs, and the scene's pairs under a filter
    manager and restricted roles."""
    import types

    import drake_tpu.geometry.scene as jscene
    import drake_tpu.geometry.scene_graph as jsg
    import drake_tpu.geometry.shapes as jsh
    import drake_tpu_torch.geometry.scene as tscene
    import drake_tpu_torch.geometry.scene_graph as tsg
    import drake_tpu_torch.geometry.shapes as tsh

    out = {}
    for tag, sg, scene, sh in (("jax", jsg, jscene, jsh), ("torch", tsg, tscene, tsh)):
        roles = [sg.PROXIMITY, sg.ILLUSTRATION, sg.PERCEPTION, sg.ALL_ROLES,
                 sg.role_mask(None), sg.role_mask("perception"),
                 sg.role_mask(["proximity", "illustration"])]
        geoms = [scene.CollisionGeometry(n, b, sh.Sphere(0.1), roles=r) for n, b, r in
                 (("a", 0, sg.ALL_ROLES), ("b", 1, sg.ALL_ROLES), ("c", 2, sg.ALL_ROLES),
                  ("d", 3, sg.ALL_ROLES), ("e", 3, sg.ILLUSTRATION), ("f", 4, sg.ALL_ROLES))]
        fm = sg.CollisionFilterManager(geoms)
        fm.apply(_declaration(types.SimpleNamespace(scene_graph=sg)))
        out[tag] = {
            "roles": roles + [sg.geometries_with_role(geoms, sg.ILLUSTRATION),
                              sg.geometries_with_role(geoms, sg.PROXIMITY)],
            "sets": sorted(sg.GeometrySet.of(names=("a",), bodies=(3, 4)).resolve(geoms)),
            "filtered pairs": sorted(tuple(sorted(p)) for p in fm.filtered_pairs),
            "scene pairs": scene.CollisionScene.build(geoms, filter_manager=fm).pairs,
        }
    assert out["torch"][what] == out["jax"][what]


def test_collision_geometry_carried_from_jax():
    """``multibody.convert.collision_geometry_from_fields`` carries a JAX
    geometry's shape, pose, material and hydro fields into the port's."""
    import dataclasses

    from drake_tpu.geometry import shapes as jsh
    from drake_tpu.geometry.scene import CollisionGeometry as JGeometry
    from drake_tpu_torch.geometry import shapes as tsh
    from drake_tpu_torch.multibody import convert

    jg = JGeometry(name="knob", body=2, shape=jsh.Capsule(0.02, 0.1), R_BG=np.eye(3)[[1, 2, 0]],
                   p_BG=np.array([0.1, 0.0, -0.2]), stiffness=3e4, dissipation=0.3,
                   hydroelastic_modulus=5e6, hydro_rings=3, hydro_patch_radius=0.01, friction=0.7,
                   roles=5)
    fields = {f.name: getattr(jg, f.name) for f in dataclasses.fields(jg)}
    fields["shape"] = (type(jg.shape).__name__, dataclasses.asdict(jg.shape))
    tg = convert.collision_geometry_from_fields(fields)
    assert tg.shape == tsh.Capsule(0.02, 0.1)
    for f in dataclasses.fields(tg):
        if f.name != "shape":
            np.testing.assert_array_equal(np.asarray(getattr(tg, f.name)),
                                          np.asarray(getattr(jg, f.name)))
