"""Parity of drake_tpu_torch's collision scene, SAP solver and contact plant
against drake_tpu's, on the CPU in float64.

The world is the bench's (the iiwa with a free box; 9 contacts: 8 box
corners against the ground, the end-effector sphere against the box).  The
lanes come from a numpy seed: random arm poses, box orientations and
velocities; in two lanes the box is placed under the end effector so that the
sphere-box contact is active, and the box sits a few millimetres into the
ground everywhere so that corner contacts are active.  All JAX quantities of
a lane come from one jitted program: the scene query, the SAP assembly, both
SAP solves, and the planning step with its ``jacrev``.

Tolerances, each stated where it is used:
- scene query, contact frames, SapData (A, v*, J, R, vhat): 1e-10 absolute;
  the port builds J by the analytic form, the reference by ``jacfwd``;
- SAP velocities, converged and unrolled: 1e-8, with equal iteration counts;
- the planning step's state: 1e-10; its Jacobian d x_next / d [x; u]
  (27 x 34), through the IFT backward, against ``jax.jacrev`` through the
  custom_vjp: 1e-7 of max |J|.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import close, jax_world, port_params, random_lanes, run_jitted

TOL = 1e-10
SAP_V_TOL = 1e-8
JACOBIAN_RTOL = 1e-7
H = 0.04
PLAN = dict(unroll_iterations=4, line_search_points=12)


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def contact_lanes(jm, jp):
    """q, v, u for 6 lanes; lanes 0 and 1 have the box lifted under the end
    effector, its top 2.5 mm into the sphere, the others on the ground."""
    from drake_tpu.multibody import kinematics as jkin

    q, v, _, tau = random_lanes(5)
    q[:, 13] = 0.058  # 2 mm into the ground
    for lane in (0, 1):
        _, p = jkin.forward_kinematics(jm, jp, jnp.asarray(q[lane]))
        ee = np.asarray(p[jm.body_index("link7")])
        q[lane, 7:11] = [1.0, 0.0, 0.0, 0.0]
        q[lane, 11:14] = ee - np.array([0.013, 0.004, 0.06 + 0.06 - 0.0025])
    v *= 0.3
    return q, v, tau[:, :7]


@pytest.fixture(scope="module")
def contact():
    import torch

    from drake_tpu.contact import plant as jplant
    from drake_tpu.contact import sap as jsap
    from drake_tpu.geometry.scene import contact_frame as jframe
    from drake_tpu_torch import bench
    from drake_tpu_torch.multibody import convert

    jm, jp, jscene = jax_world()
    q, v, u = contact_lanes(jm, jp)
    tau = np.concatenate([u, np.zeros((u.shape[0], 6))], axis=1)
    plan_step = jplant.make_discrete_system(jm, jp, jscene, H,
                                            sap_params=jsap.SapParameters(**PLAN)).g

    def one(q1, v1, tau1):
        c = jscene.query(jm, jp, q1)
        data, _ = jsap.assemble(jm, jp, jscene, q1, v1, tau1, H)
        conv = jsap.solve_sap(data, data.v_star)
        unrl = jsap.solve_sap(data, data.v_star, jsap.SapParameters(**PLAN))
        # The planning step and its jacrev, through the custom_vjp.
        def step(z1):
            x1 = plan_step(jp, z1[:27], z1[27:])
            return x1, x1

        J, x_next = jax.jacrev(step, has_aux=True)(jnp.concatenate([q1, v1, tau1[:7]]))
        return c.phi, c.p_W, c.n_W, jframe(c.n_W), data, conv, unrl, x_next, J

    # One program for every reference quantity of this file: the reference
    # programs are large, and one compile costs less than several.
    phi, p_W, n_W, frames, data, conv, unrl, x_next, J = run_jitted(jax.vmap(one), q, v, tau)
    _, _, tscene, _ = bench.build_world(torch.float64, device="cpu")
    return {
        "jm": jm, "jp": jp, "jscene": jscene,
        "tm": convert.model_from_fields(dataclasses.asdict(jm)), "tp": port_params(jp),
        "tscene": tscene, "q": q, "v": v, "u": u, "tau": tau,
        "ref": {"phi": phi, "p_W": p_W, "n_W": n_W, "frames": frames, "data": data,
                "converged": conv, "unrolled": unrl, "x_next": x_next, "J": J},
    }


def test_bench_lanes_have_active_contacts(contact):
    phi = np.asarray(contact["ref"]["phi"])
    assert (phi[:2, 8] < 0).all(), "the sphere-box contact is not active"
    assert (phi[2:, :8] < 0).any(axis=1).all(), "a lane on the ground has no corner contact"


@pytest.mark.parametrize("field", ["phi", "p_W", "n_W", "frames"])
def test_scene_query_matches_jax(contact, field):
    import torch

    from drake_tpu_torch.geometry.scene import contact_frame

    c = contact["tscene"].query(contact["tm"], contact["tp"], torch.tensor(contact["q"]))
    got = contact_frame(c.n_W) if field == "frames" else getattr(c, field)
    close(got, contact["ref"][field])
    assert c.body_a == (-1,) * 8 + (8,) and c.body_b == (8,) * 8 + (7,)


@pytest.fixture(scope="module")
def port_data(contact):
    import torch

    from drake_tpu_torch.contact import sap

    return sap.assemble(contact["tm"], contact["tp"], contact["tscene"],
                        torch.tensor(contact["q"]), torch.tensor(contact["v"]),
                        torch.tensor(contact["tau"]), H)[0]


@pytest.mark.parametrize("field", ["A", "v_star", "J", "R", "vhat", "mu"])
def test_assemble_matches_jax(contact, port_data, field):
    """SapData at 1e-10, J (analytic form) against the reference's jacfwd J."""
    ref = getattr(contact["ref"]["data"], field)
    close(getattr(port_data, field), ref[0] if field == "mu" else ref)


@pytest.mark.parametrize("path", ["converged", "unrolled"])
def test_solve_sap_matches_jax(contact, port_data, path):
    from drake_tpu_torch.contact import sap

    params = sap.SapParameters(**PLAN) if path == "unrolled" else sap.SapParameters()
    sol = sap.solve_sap(port_data, port_data.v_star, params)
    ref = contact["ref"][path]
    close(sol.v, ref.v, SAP_V_TOL)
    close(sol.gamma, ref.gamma, SAP_V_TOL)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))
    if path == "converged":
        assert (sol.momentum_residual.numpy() <= 1e-6).all()


def test_planning_step_jacobian_matches_jax_jacrev(contact):
    """x_next and d x_next / d [x; u] of the planning step (4 unrolled SAP
    iterations) at every lane, two with the sphere-box contact active: the
    port's batched pullback through its IFT backward against jax.jacrev
    through the reference's custom_vjp."""
    import torch

    from drake_tpu_torch.contact import plant as tplant
    from drake_tpu_torch.contact import sap as tsap
    from drake_tpu_torch.trajopt import ilqr

    x = np.concatenate([contact["q"], contact["v"]], axis=1)
    tg = tplant.make_discrete_system(contact["tm"], contact["tp"], contact["tscene"], H,
                                     sap_params=tsap.SapParameters(**PLAN)).g
    got_x, got_J = ilqr.linearize(tg, contact["tp"], torch.tensor(x),
                                  torch.tensor(contact["u"]),
                                  torch.zeros(x.shape[0], dtype=torch.float64))
    ref_J = np.asarray(contact["ref"]["J"])
    close(got_x, contact["ref"]["x_next"])
    assert float(np.abs(ref_J[0, 14:, 14:21]).max()) > 0  # torques move v
    close(got_J, ref_J, JACOBIAN_RTOL * float(np.abs(ref_J).max()))


@pytest.mark.parametrize("w_scale", [0.0, 0.5])
def test_advance_positions_matches_jax(contact, w_scale):
    """The symplectic position update with the box's quaternion exponential,
    and its gradient in v (at w = 0 as well: no NaN)."""
    import torch

    from drake_tpu.contact import plant as jplant
    from drake_tpu_torch.contact import plant as tplant

    q = contact["q"][:3]
    v = np.random.default_rng(7).standard_normal((3, 13))
    v[:, 7:10] *= w_scale

    def jf(q1, v1):
        return jplant.advance_positions(contact["jm"], contact["jp"], q1, v1, H)

    ref, ref_grad = run_jitted(jax.vmap(lambda q1, v1: (
        jf(q1, v1), jax.grad(lambda w: jnp.sum(jf(q1, w) ** 2))(v1))), q, v)
    tv = torch.tensor(v, requires_grad=True)
    got = tplant.advance_positions(contact["tm"], contact["tp"], torch.tensor(q), tv, H)
    (got**2).sum().backward()
    close(got, ref)
    assert bool(torch.isfinite(tv.grad).all())
    close(tv.grad, ref_grad)


@pytest.mark.parametrize("where", ["outside", "inside"])
def test_box_sdf_gradient_matches_jax(where):
    """d(phi, n)/d p of the box SDF, NaN included: inside the box the
    reference's bare norm at 0 has a NaN gradient (a trap on record in
    BASELINE.md), which reaches the planner's Jacobian when the end
    effector's centre enters the box.  The port carries it as it is."""
    import torch

    from drake_tpu.geometry import shapes as jsh
    from drake_tpu_torch.geometry import shapes as tsh

    rng = np.random.default_rng(9)
    R = np.linalg.qr(rng.standard_normal((3, 3)))[0]
    c = rng.standard_normal(3)
    local = {"outside": [0.1, 0.03, -0.02], "inside": [0.02, -0.01, 0.03]}[where]
    p = c + R @ np.array(local)
    size = (0.12, 0.12, 0.12)

    def jf(x):
        phi, n = jsh.box_sdf_point(R, c, size, x)
        return phi + jnp.sum(n * jnp.arange(1.0, 4.0))

    ref = jax.grad(jf)(p)
    tp = torch.tensor(p, requires_grad=True)
    phi, n = tsh.box_sdf_point(torch.tensor(R), torch.tensor(c), size, tp)
    (phi + (n * torch.arange(1.0, 4.0, dtype=torch.float64)).sum()).backward()
    close(tp.grad, ref, 1e-12)
    assert np.isnan(np.asarray(ref)).all() == (where == "inside")


def test_cholesky_failure_gives_nan_as_jax():
    """A matrix that is not positive definite: JAX's cho_factor answers NaN
    and the port's helper does too (torch.linalg.cholesky would raise)."""
    import torch

    from drake_tpu_torch.utils.linalg import cho_solve, cholesky_or_nan

    M = np.array([[[2.0, 0.0], [0.0, 1.0]], [[1.0, 2.0], [2.0, 1.0]]])
    b = np.array([[1.0, 1.0], [1.0, 1.0]])
    ref = jax.vmap(lambda m, r: jax.scipy.linalg.cho_solve(jax.scipy.linalg.cho_factor(m), r))(M, b)
    got = cho_solve(cholesky_or_nan(torch.tensor(M)), torch.tensor(b))
    assert np.isnan(np.asarray(ref)[1]).all() and bool(torch.isnan(got[1]).all())
    close(got[0], ref[0], 1e-15)


def test_sap_lane_with_failed_factorization_keeps_its_iterate(port_data):
    """A lane whose Newton matrix is not positive definite (A negated here)
    takes no step: its velocity stays the guess, finite, and the converged
    loop runs its iteration budget, while the other lanes solve as before."""
    import torch

    from drake_tpu_torch.contact import sap

    A = port_data.A.clone()
    A[2] = -A[2]
    bad = port_data._replace(A=A)
    guess = port_data.v_star
    sol = sap.solve_sap(bad, guess)
    ref = sap.solve_sap(port_data, guess)
    assert torch.equal(sol.v[2], guess[2])
    assert int(sol.iterations[2]) == sap.SapParameters().max_iterations
    others = [0, 1, 3, 4, 5]
    assert torch.equal(sol.v[others], ref.v[others])


def test_unported_pairs_and_constraints_raise(contact):
    """What the port still refuses: contact with a Mesh, with a MeshSdf,
    and a MeshSdf carrying a hydroelastic patch (ROADMAP.md, the geometry
    group); every primitive pair, hydro patch and SAP constraint is taken."""
    import numpy as np

    from drake_tpu_torch.geometry import shapes as sh
    from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene

    verts = np.eye(3)
    grid = dict(grid=np.zeros((4, 4, 4)), origin=np.zeros(3), dx=0.1)
    ground = CollisionGeometry("ground", -1, sh.HalfSpace())
    ball = CollisionGeometry("ball", 1, sh.Sphere(0.1))
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CollisionScene.build([CollisionGeometry("m", 0, sh.Mesh(verts)), ground])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        CollisionScene.build([CollisionGeometry("s", 0, sh.MeshSdf(verts, **grid)), ball])
    with pytest.raises(NotImplementedError, match="hydroelastic patch.*ROADMAP"):
        CollisionScene.build([CollisionGeometry("s", 0, sh.MeshSdf(verts, **grid),
                                                hydroelastic_modulus=1e5), ground])
    assert CollisionScene.build([CollisionGeometry("a", 0, sh.Sphere(0.1)), ball]).pairs == ((0, 1),)
