"""Parity of drake_tpu_torch's SAP constraint rows and Hunt-Crossley models
against drake_tpu's, on the CPU in float64: ``sap.assemble`` with joint
limits, a coupler, ball, distance and weld constraints and implicit PD, and
``solve_sap`` over them, and the implicit-function-theorem gradient of a
step with limits, PD and the Hunt-Crossley contact.

The world: a revolute-revolute-prismatic arm (a sphere pad at the tip) and
a free ball over a ground halfspace.  The lanes come from a numpy seed: the
arm about its limits (some lanes past them), the ball a few millimetres
into the ground or just above it, random velocities and torques.  Each
JAX case is a jitted program of its own, run lane by lane.

Tolerances: SapData and v, gamma within 1e-10 of each quantity's scale
(max |JAX|), equal Newton iteration counts; the IFT gradient within 1e-8 of
its scale.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_multibody import CHEAP_COMPILE, run_jitted


def run_lanes(fn, *arrays):
    """fn over the lanes (the leading axis) of `arrays`: compiled once for
    one lane (at CHEAP_COMPILE; a lane's program compiles in under half the
    time of the vmapped one) and called lane by lane, the outputs stacked."""
    lane = [a[0] for a in arrays]
    compiled = jax.jit(fn).lower(*lane).compile(compiler_options=CHEAP_COMPILE)
    outs = [compiled(*(a[i] for a in arrays)) for i in range(arrays[0].shape[0])]
    return jax.tree_util.tree_map(lambda *xs: np.stack([np.asarray(x) for x in xs]), *outs)

LANES = 4
H = 0.01
TOL = 1e-10
GRAD_TOL = 1e-8
LIMITS = (np.array([-0.4, -0.6, -0.05, 0, 0, 0, 0, 0, 0]),
          np.array([0.5, 0.7, 0.08, 0, 0, 0, 0, 0, 0]))
PD_SPECS = (("j1", 40.0, 2.0, 3.0), ("j2", 25.0, 1.0, 0.5))

# case -> (contact model, assemble options)
CASES = {
    "limits": ("cone", dict(joint_limits=LIMITS)),
    "coupler": ("cone", dict(couplers=[("j1", "j2", -0.5, 0.1)])),
    "ball": ("cone", dict(ball_constraints=[(2, (0.0, 0.0, -0.1), -1, (0.45, 0.0, 0.3))])),
    "distance": ("cone", dict(distance_constraints=[(3, (0.0, 0.0, 0.0), 1, (0.1, 0.0, 0.0), 0.6)])),
    "weld": ("cone", dict(weld_constraints=[(3, np.eye(3), (0.0, 0.0, 0.0), -1,
                                             np.eye(3), (0.8, 0.0, 0.06))])),
    "pd": ("cone", dict(pd_controllers="pd")),
    "hc_lagged": ("hc_lagged", dict()),
    "hc_similar": ("hc_similar", dict()),
    "everything": ("hc_similar", dict(joint_limits=LIMITS, couplers=[("j1", "j2", -0.5, 0.1)],
                                      ball_constraints=[(2, (0.0, 0.0, -0.1), -1,
                                                         (0.45, 0.0, 0.3))],
                                      pd_controllers="pd")),
}


def build(pkg, dtype, **kw):
    if pkg == "jax":
        from drake_tpu.geometry import shapes as sh
        from drake_tpu.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu.multibody.model import ModelBuilder
    else:
        from drake_tpu_torch.geometry import shapes as sh
        from drake_tpu_torch.geometry.scene import CollisionGeometry, CollisionScene
        from drake_tpu_torch.multibody.model import ModelBuilder
    ey = np.eye(3)
    b = ModelBuilder()
    b.add_body("l1", parent=None, joint_type="revolute", mass=1.0, com=(0, 0, -0.15),
               inertia_com=ey * 0.01, axis=(0, 1, 0), X_PJ_xyz=(0, 0, 0.6), joint_name="j1",
               damping=0.2)
    b.add_body("l2", parent="l1", joint_type="revolute", mass=0.8, com=(0, 0, -0.15),
               inertia_com=ey * 0.008, axis=(0, 1, 0), X_PJ_xyz=(0, 0, -0.3), joint_name="j2")
    b.add_body("l3", parent="l2", joint_type="prismatic", mass=0.3, inertia_com=ey * 1e-3,
               axis=(0, 0, -1), X_PJ_xyz=(0, 0, -0.25), joint_name="j3", damping=0.5)
    b.add_body("ball", parent=None, joint_type="floating", mass=0.5, inertia_com=ey * 2e-3)
    model, params = b.build(dtype, **kw)
    geoms = [
        CollisionGeometry("pad", 2, sh.Sphere(0.04), p_BG=np.array([0.0, 0.0, -0.1]),
                          stiffness=2e4, dissipation=0.1, friction=0.8),
        CollisionGeometry("ball", 3, sh.Sphere(0.05), stiffness=1e4, dissipation=0.2,
                          friction=0.5),
        CollisionGeometry("ground", -1, sh.HalfSpace(), stiffness=1e8, dissipation=0.05,
                          friction=0.7),
    ]
    return model, params, CollisionScene.build(geoms)


def lanes(seed=0):
    rng = np.random.default_rng(seed)
    q = np.zeros((LANES, 10))
    q[:, 0] = rng.uniform(-0.5, 0.6, LANES)
    q[:, 1] = rng.uniform(-0.7, 0.8, LANES)
    q[:, 2] = rng.uniform(-0.07, 0.1, LANES)
    quat = np.array([1.0, 0, 0, 0]) + 0.3 * rng.standard_normal((LANES, 4))
    q[:, 3:7] = quat / np.linalg.norm(quat, axis=1, keepdims=True)
    q[:, 7:9] = rng.uniform(0.3, 0.9, (LANES, 2)) * [1, 0.1]
    q[:, 9] = 0.05 + rng.uniform(-0.004, 0.003, LANES)
    v = 0.5 * rng.standard_normal((LANES, 9))
    tau = np.concatenate([3.0 * rng.standard_normal((LANES, 3)), np.zeros((LANES, 6))], axis=1)
    qd = rng.uniform(-0.5, 0.5, (LANES, 2))
    return q, v, tau, qd


def options(opts, qd, zeros):
    out = dict(opts)
    if "joint_limits" in out and isinstance(qd, jax.Array):  # the reference indexes them
        out["joint_limits"] = tuple(jnp.asarray(x) for x in out["joint_limits"])
    if out.get("pd_controllers") == "pd":
        out["pd_controllers"] = (PD_SPECS, qd, zeros, zeros)
    return out


DATA_FIELDS = ("A", "v_star", "J", "R", "vhat", "J_lim", "R_lim", "vhat_lim", "J_eq", "R_eq",
               "vhat_eq", "J_pd", "R_pd", "vhat_pd", "glim_pd")


def jax_case(case, q, v, tau, qd):
    from drake_tpu.contact import sap as jsap

    model, params, scene = build("jax", jnp.float64)
    model_name, opts = CASES[case]
    sp = jsap.SapParameters(contact_model=model_name)

    def one(q1, v1, tau1, qd1):
        data, _ = jsap.assemble(model, params, scene, q1, v1, tau1, H, sp,
                                **options(opts, qd1, jnp.zeros(2)))
        sol = jsap.solve_sap(data, data.v_star, sp)
        out = {f: getattr(data, f) for f in DATA_FIELDS}
        if data.hc is not None:
            out.update({f"hc_{k}": getattr(data.hc, k) for k in data.hc._fields})
        out.update(v=sol.v, gamma=sol.gamma, iterations=sol.iterations,
                   cost=jsap._total_cost(data, data.v_star, sp)[0])
        return out

    return one


@functools.lru_cache(maxsize=None)
def jax_reference(case):
    """The JAX quantities of one case over the lanes, compiled on its own
    (per case the programs compile in about half the time of one program
    for all) and kept for both tests of the case."""
    import torch

    torch.set_num_threads(1)
    q, v, tau, qd = lanes()
    return run_lanes(jax_case(case, q, v, tau, qd), q, v, tau, qd), (q, v, tau, qd)


def port_case(case, q, v, tau, qd):
    import torch

    from drake_tpu_torch.contact import sap as tsap

    model, params, scene = build("torch", torch.float64, device="cpu")
    model_name, opts = CASES[case]
    sp = tsap.SapParameters(contact_model=model_name)
    t = torch.as_tensor
    data, _ = tsap.assemble(model, params, scene, t(q), t(v), t(tau), H, sp,
                            **options(opts, t(qd), torch.zeros(qd.shape, dtype=torch.float64)))
    return data, tsap.solve_sap(data, data.v_star, sp)


def near(got, ref, tol):
    got = got.detach().expand(ref.shape).numpy()
    scale = float(np.max(np.abs(ref))) or 1.0
    np.testing.assert_allclose(got, ref, rtol=0.0, atol=tol * scale)


@pytest.mark.parametrize("case", list(CASES))
def test_assemble_matches_jax(case):
    ref, inputs = jax_reference(case)
    data, _ = port_case(case, *inputs)
    for f in DATA_FIELDS:
        got = getattr(data, f)
        if ref[f].shape[-1] == 0 or (f.startswith("J_") and ref[f].shape[-2] == 0):
            assert got is None, f
            continue
        near(got, ref[f], TOL)
    if data.hc is not None:
        for k in data.hc._fields:
            near(getattr(data.hc, k), ref[f"hc_{k}"], TOL)
    else:
        assert "hc_k" not in ref


@pytest.mark.parametrize("case", list(CASES))
def test_solve_sap_matches_jax(case):
    """solve_sap's v, gamma and Newton counts, and the convex cost at v*."""
    from drake_tpu_torch.contact import sap as tsap

    ref, inputs = jax_reference(case)
    data, sol = port_case(case, *inputs)
    near(sol.v, ref["v"], TOL)
    near(sol.gamma, ref["gamma"], TOL)
    near(tsap._total_cost(data, data.v_star, tsap.SapParameters(contact_model=CASES[case][0]))[0],
         ref["cost"], TOL)
    np.testing.assert_array_equal(sol.iterations.numpy(), ref["iterations"])
    assert int(ref["iterations"].max()) > 1


@pytest.mark.parametrize("similar", [False, True])
def test_hc_gamma_matches_jax_grad_at_the_kinks(similar):
    """The closed-form Hunt-Crossley impulse and G against -jax.grad of the
    reference's cost and its jacfwd, at vn = 0 with fe0 = 0 (the edge of the
    engaged branch) and at tangential speeds down to 0, and at random
    velocities."""
    import torch

    from drake_tpu.contact import sap as jsap
    from drake_tpu_torch.contact import sap as tsap

    rng = np.random.default_rng(3)
    n = 64
    vc = rng.standard_normal((n, 3)) * 0.1
    vc[:8, 2] = 0.0
    vc[8:16, :2] = rng.standard_normal((8, 2)) * np.logspace(-12, -5, 8)[:, None]
    vc[16:20] = 0.0
    hc = dict(k=rng.uniform(1e3, 1e5, n), d=rng.uniform(0.0, 2.0, n),
              fe0=rng.uniform(-5.0, 20.0, n), n0=rng.uniform(0.0, 0.2, n),
              eps=rng.uniform(1e-4, 1e-3, n), h=np.full(n, 0.01))
    hc["fe0"][:8] = 0.0
    mu = rng.uniform(0.2, 1.0, n)

    def one(v1, m1, *h1):
        hc1 = jsap.HcData(*h1)
        g = jsap._hc_gamma(v1, m1, hc1, similar)
        G = -jax.jacfwd(lambda x: jsap._hc_gamma(x, m1, hc1, similar))(v1)
        return g, G

    ref_g, ref_G = jax.jit(jax.vmap(one))(vc, mu, *(hc[k] for k in jsap.HcData._fields))
    t = torch.as_tensor
    g, G = tsap._hc_gamma_and_G(t(vc), t(mu), tsap.HcData(*(t(hc[k]) for k in tsap.HcData._fields)),
                                similar)
    near(g, np.asarray(ref_g), TOL)
    near(G, np.asarray(ref_G), TOL)


def test_ift_gradient_matches_jax():
    """d (w . v_next) / d (q, v, tau) through assemble and solve_sap with
    limits, PD and the hc_similar contact: the port's IFT backward against
    jax.grad through the reference's custom_vjp."""
    import torch

    from drake_tpu.contact import sap as jsap
    from drake_tpu_torch.contact import sap as tsap

    torch.set_num_threads(1)
    q, v, tau, qd = lanes(seed=5)
    w = np.random.default_rng(6).standard_normal(9)
    opts = dict(joint_limits=LIMITS, pd_controllers="pd")
    jm, jp, js = build("jax", jnp.float64)
    sp = jsap.SapParameters(contact_model="hc_similar")

    def loss(q1, v1, tau1, qd1):
        data, _ = jsap.assemble(jm, jp, js, q1, v1, tau1, H, sp,
                                **options(opts, qd1, jnp.zeros(2)))
        return jnp.dot(w, jsap.solve_sap(data, data.v_star, sp).v)

    ref = run_lanes(jax.grad(loss, argnums=(0, 1, 2, 3)), q, v, tau, qd)
    tm, tp, ts = build("torch", torch.float64, device="cpu")
    tsp = tsap.SapParameters(contact_model="hc_similar")
    args = [torch.tensor(x, requires_grad=True) for x in (q, v, tau, qd)]
    data, _ = tsap.assemble(tm, tp, ts, *args[:3], H, tsp,
                            **options(opts, args[3], torch.zeros((LANES, 2), dtype=torch.float64)))
    out = tsap.solve_sap(data, data.v_star, tsp).v @ torch.tensor(w)
    grads = torch.autograd.grad(out.sum(), args)
    for g, r in zip(grads, ref):
        near(g, r, GRAD_TOL)
