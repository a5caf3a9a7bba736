"""Parity of drake_tpu_torch's continuous MultibodyPlant (multibody/plant.py),
its compliant point contact (contact/plant.py: contact_forces_continuous,
make_continuous_contact_system, step_with_forces) and the two other
discrete contact solvers, TAMSI (contact/tamsi.py) and PGS (contact/pgs.py),
against drake_tpu's, on the CPU in float64 (the bouncing-ball demo's
rollout is in tests/test_torch_bouncing_ball.py).

The worlds: the sphere on a floating joint over a ground halfspace of
tests/test_continuous_contact.py and of test_contact.py's TestPgs and
TestTamsi classes, built by both packages' ModelBuilders; and the bench's
iiwa-and-box world (9 contacts) of tests/test_torch_contact.py, whose JAX
SapData the port's solvers take as it is.  Lanes come from numpy seeds.

Tolerances: 1e-10 of scale on the plant's dynamics, the contact forces,
and the step (the port's contact Jacobian is the analytic form, the
reference's jacfwd; tests/test_torch_contact.py holds them within 1e-10);
the contact force's gradient 1e-8 of scale; TAMSI's velocities 1e-8 with equal
iteration counts (the Newton stops at a tolerance and its forward-mode
Jacobian sums in another order); PGS 1e-10 with every sweep the
reference's.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_contact import contact_lanes
from test_torch_multibody import jax_world, port_params, random_lanes, run_jitted

TOL = 1e-10
F64 = jnp.float64


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def close(got, ref, tol=TOL):
    got = got.detach().cpu().numpy() if hasattr(got, "detach") else np.asarray(got)
    ref = np.asarray(ref)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    scale = max(1.0, float(np.max(np.abs(ref)))) if ref.size else 1.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale, equal_nan=True)


def t(a):
    import torch

    return torch.as_tensor(np.array(a), dtype=torch.float64)


def ball_world(jax_side, mu=0.5, radius=0.05, mass=0.5, k=5e4, d=0.5, ground_k=1e14,
               inertia=None):
    """(model, params, scene) of a sphere on a floating joint over the
    ground, in either package (test_continuous_contact.py's _ball_world)."""
    if jax_side:
        from drake_tpu.geometry import shapes as sh
        from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu.multibody.model import ModelBuilder
    else:
        from drake_tpu_torch.geometry import shapes as sh
        from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu_torch.multibody.model import ModelBuilder
    b = ModelBuilder()
    b.add_body("ball", parent=None, joint_type="floating", mass=mass,
               inertia_com=np.eye(3) * (0.4 * mass * radius**2 if inertia is None else inertia))
    model, params = b.build(F64) if jax_side else b.build(__import__("torch").float64, "cpu")
    scene = CollisionScene.build([
        CollisionGeometry(name="ground", body=-1, shape=sh.HalfSpace(), friction=mu,
                          stiffness=ground_k),
        CollisionGeometry(name="ball", body=0, shape=sh.Sphere(radius), friction=mu,
                          stiffness=k, dissipation=d),
    ])
    return model, params, scene


def ball_states(seed, lanes=6, radius=0.05):
    """Lanes of the ball: some penetrating (moving in, out, sliding), some
    in the air."""
    rng = np.random.default_rng(seed)
    quat = rng.standard_normal((lanes, 4))
    quat /= np.linalg.norm(quat, axis=1, keepdims=True)
    z = radius + rng.uniform(-2e-3, 1e-3, lanes)
    xy = rng.standard_normal((lanes, 2))
    v = rng.standard_normal((lanes, 6))
    return np.concatenate([quat, xy, z[:, None]], 1), v


def test_plant_dynamics_match_jax():
    """qdot_from_v and make_system's dynamics of the bench world (revolute
    joints and a floating box) over seeded lanes, with and without
    applied forces, and all joints or two of them actuated."""
    from drake_tpu.multibody import plant as jplant
    from drake_tpu_torch.multibody import convert
    from drake_tpu_torch.multibody import plant as tplant

    jm, jp, _ = jax_world()
    tm, tp = convert.model_from_fields(dataclasses.asdict(jm)), port_params(jp)
    q, v, _, tau = random_lanes(3)
    x = np.concatenate([q, v], 1)
    extra = np.random.default_rng(4).standard_normal((q.shape[0], jm.num_velocities))
    jsys = jplant.make_system(jm, jp)
    jsys2 = jplant.make_system(jm, jp, actuated_joints=["link2_joint", "link5_joint"],
                               applied_forces=lambda p, q1, v1, s: jnp.sin(v1) + 0.1 * q1[:13])
    tsys = tplant.make_system(tm, tp)
    tsys2 = tplant.make_system(tm, tp, actuated_joints=["link2_joint", "link5_joint"],
                               applied_forces=lambda p, q1, v1, s: (__import__("torch").sin(v1)
                                                                    + 0.1 * q1[..., :13]))
    u7, u2 = tau[:, :7], extra[:, :2]

    def one(q1, v1, x1, a, b):
        return (jplant.qdot_from_v(jm, jp, q1, v1), jsys.f(jp, x1, a, 0.0),
                jsys2.f(jp, x1, b, 0.0))

    jq, jf, jf2 = run_jitted(jax.vmap(one), q, v, x, u7, u2)
    close(tplant.qdot_from_v(tm, tp, t(q), t(v)), jq)
    close(tsys.f(tp, t(x), t(u7), 0.0), jf)
    close(tsys2.f(tp, t(x), t(u2), 0.0), jf2)
    assert (tsys.num_inputs, tsys2.num_inputs, tsys.num_q, tsys.num_v) == (7, 2, 14, 13)


@pytest.fixture(scope="module")
def ball():
    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp

    jm, jp, js = ball_world(True)
    tm, tp, ts = ball_world(False)
    return {"jm": jm, "jp": jp, "js": js, "tm": tm, "tp": tp, "ts": ts,
            "jsys": jcp.make_continuous_contact_system(jm, jp, js),
            "tsys": tcp.make_continuous_contact_system(tm, tp, ts)}


@pytest.mark.parametrize("kw", [{}, {"dissipation_hc": 0.3, "stiction_velocity": 1e-4}])
def test_contact_forces_continuous_match_jax(ball, kw):
    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp

    q, v = ball_states(1)
    ref = run_jitted(jax.vmap(lambda a, b: jcp.contact_forces_continuous(
        ball["jm"], ball["jp"], ball["js"], a, b, **kw)), q, v)
    got = tcp.contact_forces_continuous(ball["tm"], ball["tp"], ball["ts"], t(q), t(v), **kw)
    close(got, ref)
    assert float(np.abs(np.asarray(ref)).max()) > 1.0  # contacts are active
    # Test_continuous_contact.py's settled force: k x = m g.
    x_pen = 0.5 * 9.81 / 5e4
    tau = tcp.contact_forces_continuous(ball["tm"], ball["tp"], ball["ts"],
                                        t([1, 0, 0, 0, 0, 0, 0.05 - x_pen]), t(np.zeros(6)))
    np.testing.assert_allclose(float(tau[5]), 0.5 * 9.81, rtol=1e-9)


def test_continuous_contact_dynamics_and_gradient_match_jax(ball):
    """make_continuous_contact_system's dynamics over lanes, and the
    gradient of test_continuous_contact.py:124 (d vdot_z / d z inside the
    contact) with the gradient of a state's whole xdot."""
    import torch

    q, v = ball_states(2)
    x = np.concatenate([q, v], 1)
    x0 = np.array([1, 0, 0, 0, 0, 0, 0.05 - 1e-4] + [0] * 6, dtype=float)

    def jz(z):
        return ball["jsys"].f(ball["jp"], jnp.asarray(x0).at[6].set(z), jnp.zeros(0), 0.0)[12]

    def reference(xx, z, xs):
        return (jax.vmap(lambda a: ball["jsys"].f(ball["jp"], a, jnp.zeros(0), 0.0))(xx),
                jax.grad(jz)(z),
                jax.jacrev(lambda a: ball["jsys"].f(ball["jp"], a, jnp.zeros(0), 0.0))(xs))

    jf, ref, jjac = run_jitted(reference, x, jnp.asarray(0.05 - 1e-4), x[3])
    close(ball["tsys"].f(ball["tp"], t(x), t(np.zeros((6, 0))), 0.0), jf)

    def tz(z):
        xx = t(x0).clone()
        xx[6] = z
        return ball["tsys"].f(ball["tp"], xx, t(np.zeros(0)), 0.0)[12]

    z = torch.tensor(0.05 - 1e-4, dtype=torch.float64, requires_grad=True)
    (g,) = torch.autograd.grad(tz(z), z)
    close(g, ref, 1e-8)
    assert float(g) < 0.0
    tjac = torch.autograd.functional.jacobian(
        lambda a: ball["tsys"].f(ball["tp"], a, t(np.zeros(0)), 0.0), t(x[3]))
    close(tjac, jjac, 1e-8)


def test_step_with_forces_matches_jax():
    """One SAP step of test_contact.py's sliding, falling sphere, lanes of
    other slides."""
    from drake_tpu.contact import plant as jcp
    from drake_tpu_torch.contact import plant as tcp

    jm, jp, js = ball_world(True, mu=0.5, radius=0.1, mass=1.0, k=1e6, d=10.0, ground_k=1e6)
    tm, tp, ts = ball_world(False, mu=0.5, radius=0.1, mass=1.0, k=1e6, d=10.0, ground_k=1e6)
    vx = np.array([0.0, 0.3, 3.0])
    q = np.tile([1, 0, 0, 0, 0.0, 0.0, 0.1 - 1e-4], (3, 1))
    v = np.stack([np.zeros(3), np.zeros(3), np.zeros(3), vx, np.zeros(3), np.full(3, -0.5)], 1)
    ref = run_jitted(jax.vmap(
        lambda a, b: jcp.step_with_forces(jm, jp, js, a, b, jnp.zeros(6), 0.01)[:3]), q, v)
    q1, v1, sol, contact = tcp.step_with_forces(tm, tp, ts, t(q), t(v), t(np.zeros(6)), 0.01)
    close(q1, ref[0])
    close(v1, ref[1])
    close(sol.gamma, ref[2].gamma)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(ref[2].iterations))
    assert contact.phi.shape == (3, 1)


@pytest.fixture(scope="module")
def bench_data():
    """The bench world's SapData and raw contact at 6 lanes (test_torch_contact's
    lanes), and TAMSI and PGS from the JAX package on them."""
    from drake_tpu.contact import sap as jsap
    from drake_tpu.contact.pgs import solve_pgs
    from drake_tpu.contact.tamsi import solve_tamsi

    jm, jp, jscene = jax_world()
    q, v, u = contact_lanes(jm, jp)
    tau = np.concatenate([u, np.zeros((u.shape[0], 6))], axis=1)

    def one(q1, v1, tau1):
        data, contact = jsap.assemble(jm, jp, jscene, q1, v1, tau1, 0.01)
        raw = (contact.phi, contact.stiffness, contact.dissipation, contact.friction)
        return (data, raw, solve_tamsi(data, contact, 0.01), solve_pgs(data, 100, "gs"),
                solve_pgs(data, 100, "jacobi"), jsap.solve_sap(data, data.v_star))

    return run_jitted(jax.vmap(one), q, v, tau)


def port_sap_data(data):
    from drake_tpu_torch.contact.sap import SapData

    return SapData(*(t(getattr(data, f)) for f in SapData._fields[:6]))._replace(
        mu=t(np.asarray(data.mu)[0]))


def raw_contact(raw):
    phi, k, d, mu = raw
    return types.SimpleNamespace(phi=t(phi), stiffness=t(np.asarray(k)[0]),
                                 dissipation=t(np.asarray(d)[0]), friction=t(np.asarray(mu)[0]))


def test_tamsi_matches_jax_on_the_bench_world(bench_data):
    from drake_tpu_torch.contact.tamsi import solve_tamsi

    data, raw, ref, _, _, _ = bench_data
    sol = solve_tamsi(port_sap_data(data), raw_contact(raw), 0.01)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))
    close(sol.v, ref.v, 1e-8)
    close(sol.gamma, ref.gamma, 1e-8)
    # Lanes that stop at max_iterations stop there in both packages.
    close(sol.momentum_residual, ref.momentum_residual, 1e-8)


@pytest.mark.parametrize("method", ["gs", "jacobi"])
def test_pgs_matches_jax_on_the_bench_world(bench_data, method):
    from drake_tpu_torch.contact.pgs import solve_pgs

    data, _, _, ref_gs, ref_jacobi, _ = bench_data
    ref = ref_gs if method == "gs" else ref_jacobi
    sol = solve_pgs(port_sap_data(data), 100, method)
    close(sol.v, ref.v)
    close(sol.gamma, ref.gamma)
    close(sol.momentum_residual, ref.momentum_residual)
    np.testing.assert_array_equal(sol.iterations.numpy(), np.asarray(ref.iterations))


def sphere_case(vx, k_ball, d, ground_k, pen):
    """test_contact.py's TestPgs / TestTamsi sphere: SapData and contact of
    both packages at one state."""
    import torch

    from drake_tpu.contact import sap as jsap
    from drake_tpu_torch.contact import sap as tsap

    jm, jp, js = ball_world(True, mu=0.5, radius=0.1, mass=1.0, k=k_ball, d=d,
                            ground_k=ground_k, inertia=0.4 * 0.1**2)
    tm, tp, ts = ball_world(False, mu=0.5, radius=0.1, mass=1.0, k=k_ball, d=d,
                            ground_k=ground_k, inertia=0.4 * 0.1**2)
    q = np.array([1, 0, 0, 0, 0.0, 0.0, 0.1 - pen])
    v = np.array([0, 0, 0, vx, 0.0, -0.5 if pen == 1e-4 else -0.2])
    jdata, jc = jsap.assemble(jm, jp, js, jnp.asarray(q), jnp.asarray(v), jnp.zeros(6), 0.01)
    tdata, tc = tsap.assemble(tm, tp, ts, t(q), t(v), torch.zeros(6, dtype=torch.float64), 0.01)
    return jdata, jc, tdata, tc


@pytest.mark.parametrize("vx", [0.0, 1e-6, 0.3, 3.0])
def test_tamsi_matches_jax_on_the_sphere(vx):
    """TestTamsi's cases (stiction, slow and fast slides)."""
    from drake_tpu.contact.tamsi import solve_tamsi as jtamsi
    from drake_tpu_torch.contact.tamsi import solve_tamsi as ttamsi

    jdata, jc, tdata, tc = sphere_case(vx, 1e5, 0.1, 1e10, 2e-4)
    ref = jtamsi(jdata, jc, 0.01)
    sol = ttamsi(tdata, tc, 0.01)
    assert int(sol.iterations) == int(ref.iterations)
    close(sol.v, ref.v, 1e-8)
    close(sol.gamma, ref.gamma, 1e-8)
    close(sol.momentum_residual, ref.momentum_residual, 1e-8)


@pytest.mark.parametrize("method, iterations", [("jacobi", 400), ("gs", 400), ("gs", 800),
                                                ("gs", 20)])
def test_pgs_matches_jax_on_the_sphere(method, iterations):
    """TestPgs's cases: the unique-solution slide, the binding cone, the
    fast single-contact convergence; and PGS against SAP at physics level
    as the reference's test holds them."""
    from drake_tpu.contact.pgs import solve_pgs as jpgs
    from drake_tpu_torch.contact.pgs import solve_pgs as tpgs
    from drake_tpu_torch.contact.sap import solve_sap

    vx = 3.0 if iterations == 800 else 0.3
    jdata, _, tdata, _ = sphere_case(vx, 1e6, 10.0, 1e6, 1e-4)
    ref = jpgs(jdata, iterations=iterations, method=method)
    sol = tpgs(tdata, iterations=iterations, method=method)
    close(sol.v, ref.v)
    close(sol.gamma, ref.gamma)
    close(sol.momentum_residual, ref.momentum_residual)
    if vx == 0.3 and iterations == 400:  # the unique solution's case
        sap = solve_sap(tdata, tdata.v_star)
        Rn_gn = float(tdata.R[0, 2] * sap.gamma[0, 2])
        np.testing.assert_allclose(sol.v.numpy(), sap.v.numpy(), atol=2 * Rn_gn + 5e-3)
