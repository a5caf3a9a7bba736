"""Parity of drake_tpu_torch's MathematicalProgram, branch-and-bound, Shor
relaxation and systems/optimization against drake_tpu's, on the CPU in
float64.

The programs are those of tests/test_program.py, test_conic.py,
test_semidefinite_relaxation.py, test_debug.py and the tutorial's sections
2 and 3, built by tests/solver_cases.py once with each package; each is
solved by both packages' ``Solve()`` (the port's with ``device="cpu"``),
which chip_smoke.py phase 20 also runs on the card.

Tolerances:
- exact on ``program_type``, ``info["solver"]``, the success flag, the back
  end's iteration count and the MIP's node count;
- 1e-10 of max(1, |reference|) on the solution and the cost: the same
  iterations in another summation order (the port's lower Cholesky factor,
  batched products; its derivatives by reverse mode where the reference
  takes some forward), over up to thousands of ADMM iterations;
- 1e-6 on the fixed points' residuals, as tests/test_debug.py.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest

import solver_cases as sc
from test_torch_multibody import close

TOL = 1e-10


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module", autouse=True)
def _cheap_jax_compile():
    """The reference's programs compile with XLA's cheap settings while
    these tests run (as ``run_jitted`` compiles the other parity programs):
    ``Solve`` compiles a new program for each of its many small problems."""
    before = jax.config.values["jax_disable_most_optimizations"]
    jax.config.update("jax_disable_most_optimizations", True)
    yield
    jax.config.update("jax_disable_most_optimizations", before)


def scaled(got, ref, tol=TOL):
    ref = np.asarray(ref, float)
    close(np.asarray(got, float), ref, tol * max(1.0, float(np.abs(ref).max())))


def iterations(info):
    """The back end's iteration count, or the MIP's node count; None for
    the reference's AL-Newton, which reports none."""
    if "mip_nodes" in info:
        return ("nodes", info["mip_nodes"])
    for key in ("qp", "conic", "result"):
        if hasattr(info.get(key), "iterations"):
            return (key, int(info[key].iterations))
    return None


def summary(prog, res):
    return {"type": prog.program_type(), "solver": res.solver_info["solver"],
            "success": res.is_success(), "z": np.asarray(res._z, float),
            "cost": res.optimal_cost, "iterations": iterations(res.solver_info), "result": res}


def jax_mods():
    from drake_tpu.solvers import al_newton, program, semidefinite_relaxation

    return types.SimpleNamespace(program=program, semidefinite_relaxation=semidefinite_relaxation,
                                 al_newton=al_newton, stack=jnp.stack)


def port_mods():
    import torch

    from drake_tpu_torch.solvers import al_newton, program, semidefinite_relaxation

    return types.SimpleNamespace(program=program, semidefinite_relaxation=semidefinite_relaxation,
                                 al_newton=al_newton, stack=torch.stack)


@pytest.fixture(scope="module")
def reference():
    out = {}
    for name, (prog, _, options) in sc.programs(jax_mods()).items():
        out[name] = summary(prog, prog.Solve(options=options))
    return out


@pytest.fixture(scope="module")
def port():
    out = {}
    for name, (prog, _, options) in sc.programs(port_mods()).items():
        out[name] = summary(prog, prog.Solve(device="cpu", options=options))
    return out


@pytest.mark.parametrize("name", sc.PROGRAM_NAMES)
def test_solve_matches_jax(reference, port, name):
    """Classification, dispatch, success, the solution, the cost and the
    iteration (or node) count of each program are the reference's."""
    ref, got = reference[name], port[name]
    assert got["type"] == ref["type"]
    assert got["solver"] == ref["solver"]
    assert got["success"] == ref["success"]
    scaled(got["z"], ref["z"])
    scaled(got["cost"], ref["cost"])
    if ref["iterations"] is not None:
        assert got["iterations"] == ref["iterations"]
    assert isinstance(got["result"]._z, np.ndarray)


def test_every_program_type_is_dispatched(port):
    """The cases reach every program type and every back end."""
    assert {v["type"] for v in port.values()} == {"lp", "qp", "conic", "nlp"}
    assert {v["solver"] for v in port.values()} == {"ipm", "conic_admm", "sqp/al"}
    assert {v["iterations"][0] for v in port.values()} == {"qp", "conic", "result", "nodes"}


def test_answers_of_the_jax_tests(port):
    """The known optima that the JAX package's tests and the tutorial hold
    their programs to."""
    z = {name: v["z"] for name, v in port.items()}
    close(z["tutorial_qp"], [0.5, 0.5], 1e-6)
    close(z["tutorial_nlp_sqp"], [2.0 / np.sqrt(5.0), 1.0 / np.sqrt(5.0)], 1e-4)
    close(z["tutorial_nlp_al_mu1"], [2.0 / np.sqrt(5.0), 1.0 / np.sqrt(5.0)], 1e-4)
    close(z["box_and_two_sided_rows"], [1.0, 1.5], 1e-5)
    close(z["lp"], [1.0, 1.0], 1e-5)
    close(z["rosenbrock_with_constraint"], [1.0, 1.0], 1e-4)
    assert port["socp_min_norm"]["cost"] == pytest.approx(1.0 / np.sqrt(2.0), abs=1e-4)
    assert port["rotated_lorentz_cone"]["cost"] == pytest.approx(2.0, abs=1e-4)
    assert port["sdp_max_eigenvalue"]["cost"] == pytest.approx(
        np.linalg.eigvalsh([[2.0, 1.0], [1.0, 3.0]])[-1], abs=1e-4)
    close(np.round(z["mip_knapsack"]), [0.0, 1.0, 1.0], 0.0)
    assert port["mip_knapsack"]["cost"] == pytest.approx(-6.0, abs=1e-4)
    close(np.round(z["mip_quadratic"]), [0.0, 1.0], 0.0)
    assert port["shor_binary_quadratic"]["cost"] == pytest.approx(-2.0, abs=5e-3)
    assert port["shor_nonconvex_box"]["cost"] == pytest.approx(-2.0, abs=5e-3)
    close(z["quadratic_constraint_nlp"], [1.0, 0.0], 1e-3)


def test_al_newton_defaults_stop_short_of_the_tutorial_answer(reference, port):
    """With its default options AL-Newton stops on feasibility alone, 1.4e-2
    from the tutorial's answer in both packages (the same digits); from
    mu0 = 1 it reaches the answer within 1e-6."""
    answer = np.array([2.0, 1.0]) / np.sqrt(5.0)
    for got in (reference, port):
        assert got["tutorial_nlp_al"]["success"]
        assert 1e-2 < np.abs(got["tutorial_nlp_al"]["z"] - answer).max() < 2e-2
        assert np.abs(got["tutorial_nlp_al_mu1"]["z"] - answer).max() < 1e-6


def test_shor_relaxation_is_the_reference(reference, port):
    """The relaxation's x, read off its moment matrix."""
    from drake_tpu.solvers import semidefinite_relaxation as jsr
    from drake_tpu_torch.solvers import semidefinite_relaxation as tsr

    progs = sc.programs(port_mods())
    for name in ("shor_convex_qp", "shor_nonconvex_box", "shor_binary_quadratic"):
        M, n = progs[name][1]["M"], progs[name][1]["n"]
        scaled(tsr.extract_x(port[name]["result"], M, n),
               jsr.extract_x(reference[name]["result"], M, n))
    close(tsr.extract_x(port["shor_convex_qp"]["result"], progs["shor_convex_qp"][1]["M"], 2),
          [1.0, 1.0], 2e-3)


def test_program_type_detection():
    import torch

    from drake_tpu_torch.solvers.program import MathematicalProgram

    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(1)
    prog.AddLinearCost([1.0], x)
    assert prog.program_type() == "lp"
    prog.AddQuadraticCost(np.eye(1), np.zeros(1), x)
    assert prog.program_type() == "qp"
    prog.AddCost(lambda xx: torch.sum(xx**4), x)
    assert prog.program_type() == "nlp"


def test_constraint_size_is_probed_without_the_device():
    """AddConstraint reads a function's output size off a meta tensor, and
    off a CPU one where the function cannot take a meta tensor."""
    import torch

    from drake_tpu_torch.solvers.program import MathematicalProgram

    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(3)
    prog.AddConstraint(lambda z: torch.outer(z[:2], z[1:]), 0.0, 1.0, x)
    host = torch.tensor([1.0, 2.0, 3.0], dtype=torch.float64)
    prog.AddConstraint(lambda z: z * host + float(z.sum() * 0), -1.0, 1.0, x)
    assert [len(r.lb) for r in prog._constraints] == [4, 3]


def test_quadratic_constraint_makes_its_tensors_once():
    """AddQuadraticConstraint's function makes its tensors once per dtype
    and device, not at each call."""
    import torch

    from drake_tpu_torch.solvers.program import MathematicalProgram, _Quadratic

    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(2)
    prog.AddQuadraticConstraint(2 * np.eye(2), np.ones(2), 1.0, 1.0, x)
    fn = prog._constraints[0].fn
    assert isinstance(fn, _Quadratic)
    z = torch.tensor([0.5, -0.25], dtype=torch.float64)
    close(fn(z), 0.5 * 2 * (0.25 + 0.0625) + 0.25, 1e-15)
    made = fn._made[(z.dtype, z.device)]
    fn(z)
    assert len(fn._made) == 1 and fn._made[(z.dtype, z.device)] is made


def test_solve_without_device_needs_the_card():
    """``Solve()`` with no device runs on the current CUDA device, and
    raises on a machine without one rather than solving on the CPU."""
    import torch

    from drake_tpu_torch.solvers.program import MathematicalProgram

    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(2)
    prog.AddQuadraticErrorCost(np.eye(2), [1.0, -2.0], x)
    if torch.cuda.is_available():
        close(prog.Solve().GetSolution(x), [1.0, -2.0], 1e-6)
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            prog.Solve()
        close(prog.Solve(device="cpu").GetSolution(x), [1.0, -2.0], 1e-6)


# ---- systems/optimization ----------------------------------------------------------------


def test_fixed_point_pendulum_matches_jax():
    """tests/test_debug.py's upright pendulum: the port's equilibrium is the
    reference's, with the residual below 1e-6 and w = 0."""
    import torch

    from drake_tpu.systems.base import ContinuousSystem as JSystem
    from drake_tpu.systems.optimization import find_fixed_point as jfind
    from drake_tpu_torch.systems.base import ContinuousSystem as TSystem
    from drake_tpu_torch.systems.optimization import find_fixed_point as tfind

    x0, u0 = sc.PENDULUM_GUESS
    jf = sc.pendulum_f(jnp.stack, jnp.sin)
    ref = jfind(JSystem(f=jf, num_states=2, num_inputs=1), x0, u0, x_cost_weight=1e-4)
    tf = sc.pendulum_f(torch.stack, torch.sin)
    got = tfind(TSystem(f=tf, num_states=2, num_inputs=1), x0, u0, x_cost_weight=1e-4,
                device="cpu")
    assert got[2] and ref[2]
    scaled(got[0], ref[0])
    scaled(got[1], ref[1])
    resid = tf(None, torch.tensor(got[0]), torch.atleast_1d(torch.tensor(got[1])), 0.0)
    close(resid, np.zeros(2), 1e-6)
    assert abs(got[0][1]) < 1e-6


def test_fixed_point_of_the_acrobot_matches_jax():
    """The acrobot about upright: the port's model takes one lane (x of
    shape (4,)) inside the program as it is, and the port's equilibrium is
    the reference's."""
    import torch

    from drake_tpu.models import acrobot as ja
    from drake_tpu.systems.optimization import find_fixed_point as jfind
    from drake_tpu_torch.models import acrobot as ta
    from drake_tpu_torch.systems.optimization import find_fixed_point as tfind

    x0, u0 = np.array([np.pi - 0.1, 0.05, 0.1, 0.0]), np.array([0.3])
    tp = ta.default_params(torch.float64, "cpu")
    ref = jfind(ja.make_system(ja.default_params(jnp.float64)), x0, u0, x_cost_weight=1e-3)
    got = tfind(ta.make_system(tp), x0, u0, x_cost_weight=1e-3, device="cpu")
    assert got[2] and ref[2]
    scaled(got[0], ref[0])
    scaled(got[1], ref[1])
    xdot = ta.dynamics(tp, torch.tensor(got[0]), torch.atleast_1d(torch.tensor(got[1])))
    close(xdot, np.zeros(4), 1e-6)


def test_fixed_point_of_the_quadrotor_is_hover():
    """The quadrotor from a tilted, yawed guess: its model takes one lane
    (x of shape (12,)) inside the program; the equilibrium is level (roll
    and pitch 0, the yaw free), at rest, each rotor at m g / 4 within 1e-6.
    (Its dynamics are held to the reference's by
    tests/test_torch_quadrotor.py; the solve here by the pendulum's and the
    acrobot's parity above.)"""
    import torch

    from drake_tpu_torch.models import quadrotor
    from drake_tpu_torch.systems.optimization import find_fixed_point

    p = quadrotor.default_params(torch.float64, "cpu")
    x0 = np.zeros(12)
    x0[3:6] = [0.05, -0.02, 0.3]
    u0 = np.asarray(quadrotor.hover_input(p)) + np.array([0.2, -0.1, 0.0, 0.1])
    xs, us, ok = find_fixed_point(quadrotor.make_system(p), x0, u0, x_cost_weight=1e-3,
                                  device="cpu")
    assert ok
    xdot = quadrotor.dynamics(p, torch.tensor(xs), torch.tensor(us))
    close(xdot, np.zeros(12), 1e-6)
    close(xs[[3, 4, 6, 7, 8, 9, 10, 11]], np.zeros(8), 1e-6)
    close(us, np.full(4, float(p.mass * p.gravity) / 4), 1e-6)


def test_add_system_constraint_requires_contiguous():
    from drake_tpu_torch.solvers.program import MathematicalProgram
    from drake_tpu_torch.systems.base import ContinuousSystem
    from drake_tpu_torch.systems.optimization import add_system_constraint

    sys_ = ContinuousSystem(f=lambda p, x, u, t: x, num_states=2, num_inputs=1)
    prog = MathematicalProgram()
    x = prog.NewContinuousVariables(2, "x")
    prog.NewContinuousVariables(1, "gap")
    u = prog.NewContinuousVariables(1, "u")
    with pytest.raises(ValueError, match="contiguous"):
        add_system_constraint(prog, sys_, lambda p, x_, u_, t: x_, x, u, 0.0, 0.0)
