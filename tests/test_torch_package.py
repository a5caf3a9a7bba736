"""Package hygiene of drake_tpu_torch: it loads no JAX, launches no kernel on
the CPU, and its tensor dataclass behaves like the JAX package's pytree
dataclass.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import dataclasses
import json
import os
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    """torch on one thread while these tests run: pytest-xdist runs several
    workers on the same cores, and torch's default of one thread per core
    then oversubscribes them and slows these tests several-fold."""
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _loaded(imports, roots):
    """Packages under `roots` that a fresh interpreter has loaded after
    running the statements `imports` from the repo root."""
    code = (
        f"import json, sys\n{imports}\n"
        "print(json.dumps(sorted(m for m in sys.modules\n"
        f"    if m.split('.')[0] in {tuple(roots)!r})))\n"
    )
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env.update(PYTHONPATH=REPO, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-c", code], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120, check=True,
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


PORT_MODULES = (
    "drake_tpu_torch",
    "drake_tpu_torch.mpm.solver",
    "drake_tpu_torch.mpm.convert",
    "drake_tpu_torch.ops.mpm_kernels",
    "drake_tpu_torch.ops._build",
    "drake_tpu_torch.math.rotations",
    "drake_tpu_torch.math.spatial",
    "drake_tpu_torch.math.transforms",
    "drake_tpu_torch.multibody.model",
    "drake_tpu_torch.multibody.kinematics",
    "drake_tpu_torch.multibody.dynamics",
    "drake_tpu_torch.multibody.convert",
    "drake_tpu_torch.models.iiwa",
    "drake_tpu_torch.geometry.shapes",
    "drake_tpu_torch.geometry.scene",
    "drake_tpu_torch.systems.base",
    "drake_tpu_torch.systems.integrators",
    "drake_tpu_torch.systems.simulator",
    "drake_tpu_torch.models.quadrotor",
    "drake_tpu_torch.models.pendulum",
    "drake_tpu_torch.solvers",
    "drake_tpu_torch.solvers.ipm",
    "drake_tpu_torch.solvers.sqp",
    "drake_tpu_torch.trajopt.dircol",
    "drake_tpu_torch.examples.pendulum_dircol",
    "drake_tpu_torch.examples.quadrotor_mpc",
    "drake_tpu_torch.benchmarks.bench_quadrotor_mpc",
    "drake_tpu_torch.benchmarks.bench_dircol_f32",
    "drake_tpu_torch.contact.sap",
    "drake_tpu_torch.contact.plant",
    "drake_tpu_torch.contact.coupled_plant",
    "drake_tpu_torch.mpm.coupling",
    "drake_tpu_torch.mpm.grid_contact",
    "drake_tpu_torch.mpm.tiles",
    "drake_tpu_torch.mpm.tiles_contact",
    "drake_tpu_torch.mpm.cloth",
    "drake_tpu_torch.examples",
    "drake_tpu_torch.examples.mpm_bagging",
    "drake_tpu_torch.examples.mpm_cloth_demo",
    "drake_tpu_torch.trajopt.ilqr",
    "drake_tpu_torch.control.mpc",
    "drake_tpu_torch.control.mppi",
    "drake_tpu_torch.bench",
    "drake_tpu_torch.benchmarks",
    "drake_tpu_torch.benchmarks.paddle_blob",
    "drake_tpu_torch.benchmarks.bench_coupled_world",
    "drake_tpu_torch.benchmarks.bench_coupled_mpc",
    "drake_tpu_torch.benchmarks.bench_mpm_substeps",
    "drake_tpu_torch.benchmarks.bench_update_grid",
    "drake_tpu_torch.utils.device",
    "drake_tpu_torch.utils.linalg",
    "drake_tpu_torch.utils.struct",
    "drake_tpu_torch.utils.scan",
    "drake_tpu_torch.models.acrobot",
    "drake_tpu_torch.models.cart_pole",
    "drake_tpu_torch.math.riccati",
    "drake_tpu_torch.control.lqr",
    "drake_tpu_torch.control.energy_shaping",
    "drake_tpu_torch.control.estimators",
    "drake_tpu_torch.examples.acrobot_swingup",
    "drake_tpu_torch.examples.cart_pole_lqr",
    "drake_tpu_torch.examples.acrobot_spong",
    "drake_tpu_torch.examples.acrobot_spong_optimize",
    "drake_tpu_torch.examples.acrobot_lqr_estimator",
    "drake_tpu_torch.solvers.al_newton",
    "drake_tpu_torch.solvers.qp",
    "drake_tpu_torch.solvers.conic",
    "drake_tpu_torch.solvers.lcp",
    "drake_tpu_torch.solvers.block_cholesky",
    "drake_tpu_torch.solvers.program",
    "drake_tpu_torch.solvers.branch_and_bound",
    "drake_tpu_torch.solvers.semidefinite_relaxation",
    "drake_tpu_torch.systems.optimization",
    "drake_tpu_torch.math.trajectories",
    "drake_tpu_torch.systems.primitives",
    "drake_tpu_torch.systems.diagram",
    "drake_tpu_torch.systems.comms",
    "drake_tpu_torch.control.controllers",
    "drake_tpu_torch.multibody.plant",
    "drake_tpu_torch.contact.tamsi",
    "drake_tpu_torch.contact.pgs",
    "drake_tpu_torch.io",
    "drake_tpu_torch.io.pubsub",
    "drake_tpu_torch.examples.bouncing_ball",
    "drake_tpu_torch.examples.rimless_wheel",
    "drake_tpu_torch.examples.compass_gait",
    "drake_tpu_torch.geometry.scene_graph",
    "drake_tpu_torch.geometry.box_collision",
    "drake_tpu_torch.multibody.force_elements",
    "drake_tpu_torch.multibody.topology",
    "drake_tpu_torch.examples.rod2d",
    "drake_tpu_torch.examples.rolling_sphere",
    "drake_tpu_torch.examples.atlas_drop",
    "drake_tpu_torch.examples.allegro_hand",
    "drake_tpu_torch.examples.simple_gripper",
    "drake_tpu_torch.examples.four_bar",
    "drake_tpu_torch.examples.strandbeest",
    "drake_tpu_torch.examples.planar_gripper",
    "drake_tpu_torch.examples.spatula_slip_control",
    "drake_tpu_torch.examples.bushing_suspension",
)


def test_import_loads_no_jax():
    imports = "import " + ", ".join(PORT_MODULES)
    assert _loaded(imports, ("jax", "jaxlib", "drake_tpu")) == []


def test_every_port_module_is_checked():
    """PORT_MODULES lists every module of the package, so that the check
    above covers a module added later."""
    root = os.path.join(REPO, "drake_tpu_torch")
    found = set()
    for dirpath, _, files in os.walk(root):
        for name in files:
            if name.endswith(".py") and name != "__init__.py":
                rel = os.path.relpath(os.path.join(dirpath, name[:-3]), REPO)
                found.add(rel.replace(os.sep, "."))
    assert found <= set(PORT_MODULES)


def test_collecting_port_tests_loads_no_torch():
    """Importing the port's test files, as every pytest worker does at
    collection, loads neither torch nor the port, nor the JAX package's
    Pallas kernels (and with them the Mosaic extensions)."""
    imports = (
        "sys.path.insert(0, 'tests')\n"
        "import test_torch_mpm_kernels, test_torch_mpm_solver, test_torch_package, "
        "test_torch_multibody, test_torch_contact, test_torch_mpc, test_torch_coupled, "
        "test_torch_mppi, test_torch_grid_contact, test_torch_cloth, test_torch_tiles, "
        "test_torch_tiles_contact, test_torch_systems, test_torch_quadrotor, test_torch_dircol, "
        "test_torch_control, test_torch_acrobot, test_torch_solvers, test_torch_program, "
        "test_torch_trajectories, test_torch_hybrid, test_torch_primitives, "
        "test_torch_continuous_contact, test_torch_bouncing_ball, test_torch_comms, "
        "test_torch_joints, test_torch_primitive_contact, test_torch_sap_constraints, "
        "test_torch_force_elements, test_torch_contact_demos"
    )
    loaded = _loaded(imports, ("torch", "drake_tpu_torch", "drake_tpu", "jax"))
    assert [m for m in loaded if m.split(".")[0] in ("torch", "drake_tpu_torch")] == []
    assert "drake_tpu.ops.mpm_kernels" not in loaded
    assert [m for m in loaded if "pallas" in m or "mosaic" in m] == []


def test_cpu_path_launches_no_kernel():
    """On CPU tensors every dispatcher takes its plain version: the launch
    counters stay 0 and no library is built or loaded."""
    import torch

    from drake_tpu_torch.mpm import solver as T
    from drake_tpu_torch.mpm import tiles
    from drake_tpu_torch.ops import _build
    from drake_tpu_torch.ops import mpm_kernels as tmk

    tmk.reset_launch_counts()
    config = T.MpmConfig(
        grid_size=(16, 16, 16), dx=1.0 / 16, dt=1e-4,
        max_active_blocks=16, block_capacity=512,
    )
    state = T.make_particle_block(
        config, (0.4, 0.4, 0.4), (0.6, 0.6, 0.6), device="cpu"
    )
    state = T.simulate(config, state, 2)
    state = T.mpm_substep_blocked(config, state)
    state = tiles.simulate_tiled(config, state, 2, resort_every=2)
    assert int(state.dropped) == 0
    assert bool(torch.isfinite(state.x).all())
    assert tmk.LAUNCHES == {"update_grid": 0, "update_grid_blocks": 0, "p2g_block": 0,
                            "g2p_block": 0}
    assert _build.load_library.cache_info().currsize == 0


def test_library_name_follows_source_hash():
    from drake_tpu_torch.ops import _build

    path = _build.library_path()
    assert path.parent == _build.BUILD_DIR
    assert path.name.startswith("mpm_kernels_") and path.suffix == ".so"
    assert _build.SOURCE.exists()
    # Every C entry point the wrappers call is declared in the source.
    src = _build.SOURCE.read_text()
    for name in _build.SIGNATURES:
        assert f"int {name}(" in src


@pytest.mark.parametrize(
    "name", ["mpm_update_grid", "mpm_update_grid_blocks", "mpm_empty", "mpm_p2g_block",
             "mpm_g2p_block"]
)
def test_ctypes_signature_matches_the_c_entry_point(name):
    """The argtypes a wrapper declares have the arity and the pointer, int
    and float kinds of the C entry point's parameters (a mismatch would cut
    a pointer to 32 bits or shift every later argument)."""
    import ctypes
    import re

    from drake_tpu_torch.ops import _build

    src = _build.SOURCE.read_text()
    params = re.search(rf"\nint {name}\((.*?)\)\s*\{{", src, re.S).group(1)
    kinds = []
    for param in params.split(","):
        ctype = param.rsplit(None, 1)[0]
        kinds.append(
            ctypes.c_void_p if "*" in ctype
            else ctypes.c_float if ctype.strip() == "float" else ctypes.c_int
        )
    assert list(_build.SIGNATURES[name]) == kinds


def test_signatures_cover_every_c_entry_point():
    import re

    from drake_tpu_torch.ops import _build

    src = _build.SOURCE.read_text()
    assert set(_build.SIGNATURES) == set(re.findall(r"\nint (mpm_\w+)\(", src))


def test_row_layout_constants_match_the_kernel():
    """The widths the wrappers check and allocate by are those the CUDA
    source is written for."""
    import re

    from drake_tpu_torch.ops import _build
    from drake_tpu_torch.ops import mpm_kernels as mk

    src = _build.SOURCE.read_text()

    def constant(name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src).group(1))

    assert constant("kNodes") == mk.P2G_NODES
    assert constant("kP2GChannels") == mk.P2G_NV
    assert constant("kG2PChannels") == mk.G2P_VEL_CH
    assert constant("kG2POut") == mk.G2P_OUT
    # K3 copies packed columns 16:40 and writes 24 floats a row, both as
    # kG2PRowVec float4.
    assert 4 * constant("kG2PRowVec") == mk.PACKED_COLS - 16 == mk.G2P_OUT


def test_state_dropped_defaults_to_the_device_of_x():
    """A state made without `dropped` gets its zero beside `x`, whatever the
    current CUDA device is (and on a machine without one)."""
    import torch

    from drake_tpu_torch.mpm import solver as T

    z = torch.zeros((2, 3), dtype=torch.float64, device="cpu")
    s = T.MpmState(x=z, v=z, F=z, C=z, volume=z, mass=z)
    assert s.dropped.device == z.device
    assert s.dropped.dtype == torch.int32 and int(s.dropped) == 0
    kept = torch.ones((), dtype=torch.int32)
    assert s.replace(dropped=kept).replace(x=z + 1).dropped is kept


def test_tensor_dataclass_replace_and_to():
    import torch

    from drake_tpu_torch.utils.struct import static_field, tensor_dataclass

    @tensor_dataclass
    class _Pair:
        a: torch.Tensor
        n: torch.Tensor
        tag: str = static_field(default="t")

    p = _Pair(a=torch.ones(3), n=torch.zeros((), dtype=torch.int32))
    q = p.replace(a=torch.zeros(3))
    assert torch.equal(p.a, torch.ones(3)) and torch.equal(q.a, torch.zeros(3))
    with pytest.raises(dataclasses.FrozenInstanceError):
        p.a = torch.zeros(3)
    r = p.to(device="cpu", dtype=torch.float64)
    assert r.a.dtype == torch.float64
    assert r.n.dtype == torch.int32  # integer fields keep their type
    assert r.tag == "t"


def test_state_to_moves_floats_only():
    import torch

    from drake_tpu_torch.mpm import solver as T

    config = T.MpmConfig(grid_size=(16, 16, 16), dx=1.0 / 16)
    s = T.make_particle_block(
        config, (0.4, 0.4, 0.4), (0.5, 0.5, 0.5), dtype=torch.float64, device="cpu"
    )
    s32 = s.to(dtype=torch.float32)
    for f in ("x", "v", "F", "C", "volume", "mass"):
        assert getattr(s32, f).dtype == torch.float32
        np.testing.assert_allclose(
            getattr(s32, f).numpy(), getattr(s, f).numpy().astype(np.float32)
        )
    assert s32.dropped.dtype == torch.int32


def _tiny_state_arrays(n=4):
    return {
        "x": np.full((n, 3), 0.5), "v": np.zeros((n, 3)),
        "F": np.tile(np.eye(3), (n, 1, 1)), "C": np.zeros((n, 3, 3)),
        "volume": np.ones(n), "mass": np.ones(n),
    }


def _entry_points():
    """name -> callable(device) for every entry point that makes tensors."""
    from drake_tpu_torch.mpm import cloth, convert
    from drake_tpu_torch.mpm import solver as T
    from drake_tpu_torch.utils.device import resolve_device

    config = T.MpmConfig(grid_size=(16, 16, 16), dx=1.0 / 16)
    box = ((0.4, 0.4, 0.4), (0.5, 0.5, 0.5))

    return {
        "resolve_device": lambda device: resolve_device(device),
        "make_particle_block": lambda device: T.make_particle_block(
            config, *box, device=device
        ),
        "state_from_numpy": lambda device: convert.state_from_numpy(
            _tiny_state_arrays(), device=device
        ),
        "make_grid_cloth": lambda device: cloth.make_grid_cloth(
            cloth.ClothConfig(), 3, 3, device=device
        ),
        "cloth_state_from_numpy": lambda device: convert.cloth_state_from_numpy(
            _tiny_cloth_arrays(), device=device
        ),
    }


def _tiny_cloth_arrays():
    return {
        "x": np.zeros((3, 3)), "v": np.zeros((3, 3)), "C": np.zeros((3, 3, 3)),
        "mass": np.ones(3), "faces": np.asarray([[0, 1, 2]], np.int32),
        "Dm_inv": np.eye(2)[None], "area": np.ones(1),
    }


ENTRY_POINTS = ["resolve_device", "make_particle_block", "state_from_numpy",
                "make_grid_cloth", "cloth_state_from_numpy"]


@pytest.mark.parametrize("name", ENTRY_POINTS)
def test_no_device_means_the_card_never_the_cpu(name):
    """With no `device`, an entry point places its tensors on the current
    CUDA device; on a machine without one it raises and makes no CPU
    tensor."""
    import torch

    make = _entry_points()[name]
    if torch.cuda.is_available():
        got = make(None)
        device = got if isinstance(got, torch.device) else got.dropped.device
        assert device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)


@pytest.mark.parametrize("name", ENTRY_POINTS)
@pytest.mark.parametrize("device", ["cpu", "torch.device"])
def test_device_cpu_is_honoured(name, device):
    import torch

    want = torch.device("cpu")
    got = _entry_points()[name]("cpu" if device == "cpu" else want)
    if isinstance(got, torch.device):
        assert got == want
        return
    for f in dataclasses.fields(got):
        assert getattr(got, f.name).device == want, f.name
    assert got.dropped.dtype == torch.int32 and int(got.dropped) == 0


def _nlp_entry_points():
    """name -> callable(device) returning a tensor, for the entry points of
    the quadrotor MPC and the pendulum dircol."""
    import torch

    from drake_tpu_torch.benchmarks import bench_quadrotor_mpc
    from drake_tpu_torch.examples import (acrobot_lqr_estimator, acrobot_spong,
                                          acrobot_spong_optimize, acrobot_swingup, cart_pole_lqr,
                                          pendulum_dircol)
    from drake_tpu_torch.control import controllers
    from drake_tpu_torch.examples import bouncing_ball, compass_gait, rimless_wheel
    from drake_tpu_torch.io.pubsub import PubSub
    from drake_tpu_torch.math import trajectories
    from drake_tpu_torch.models import acrobot, cart_pole, pendulum, quadrotor
    from drake_tpu_torch.multibody import convert
    from drake_tpu_torch.systems import comms, primitives
    from drake_tpu_torch.utils.device import resolve_device

    PP = trajectories.PiecewisePolynomial

    return {
        "quadrotor.default_params": lambda device: quadrotor.default_params(device=device).mass,
        "pendulum.default_params": lambda device: pendulum.default_params(device=device).mass,
        "pendulum_dircol.build_problem": lambda device: pendulum_dircol.build_problem(
            device=device)[2],
        "DircolProblem.bounds": lambda device: pendulum_dircol.build_problem(
            device="cpu")[1].bounds(torch.float64, device)[0],
        "bench_quadrotor_mpc.build": lambda device: bench_quadrotor_mpc.build(
            device=device)["us0"],
        "acrobot.default_params": lambda device: acrobot.default_params(device=device).m1,
        "acrobot.params_from_numpy": lambda device: acrobot.params_from_numpy(
            acrobot.params_to_numpy(acrobot.default_params(device="cpu")), device=device).m1,
        "acrobot.make_system": lambda device: acrobot.make_system(
            acrobot.default_params(device=device)).default_params.l2,
        "acrobot.upright_state": lambda device: acrobot.upright_state(device=device),
        "cart_pole.default_params": lambda device: cart_pole.default_params(device=device).mc,
        "cart_pole.params_from_numpy": lambda device: cart_pole.params_from_numpy(
            cart_pole.params_to_numpy(cart_pole.default_params(device="cpu")),
            device=device).mp,
        "cart_pole.make_system": lambda device: cart_pole.make_system(
            cart_pole.default_params(device=device)).default_params.l,
        "acrobot_swingup.build": lambda device: acrobot_swingup.build(device)[2],
        # The examples' run() at a depth of one step.
        "cart_pole_lqr.run": lambda device: cart_pole_lqr.run(device=device, steps=1)["errs"],
        "acrobot_spong.run": lambda device: acrobot_spong.run(device=device, batch=2,
                                                              steps=1)["errs"],
        "acrobot_spong_optimize.run": lambda device: acrobot_spong_optimize.run(
            device=device, scenarios=2, candidates=2, iters=1, steps=1)["best_gains"],
        "acrobot_lqr_estimator.run": lambda device: acrobot_lqr_estimator.run(
            device=device, steps=1)["xs"],
        # The continuous-time and hybrid simulation slice.
        "PiecewisePolynomial.first_order_hold": lambda device: PP.first_order_hold(
            [0.0, 1.0], [[0.0], [1.0]], device=device).coeffs,
        "BsplineTrajectory.make_clamped_uniform": lambda device: (
            trajectories.BsplineTrajectory.make_clamped_uniform(np.eye(4), device=device).knots),
        "PiecewisePose.make": lambda device: trajectories.PiecewisePose.make(
            [0.0, 1.0], np.eye(2, 3), [[1.0, 0, 0, 0], [0, 1.0, 0, 0]],
            device=device).orientation.quats,
        "trajectory_from_numpy": lambda device: convert.trajectory_from_numpy(
            "PiecewisePolynomial", {"breaks": np.arange(2.0), "coeffs": np.ones((1, 4, 1))},
            device=device).coeffs,
        "linear_system": lambda device: primitives.linear_system(
            np.eye(2), np.ones((2, 1)), device=device).output(
                None, torch.zeros(2, dtype=torch.float64, device=resolve_device(device)),
                torch.zeros(1, dtype=torch.float64, device=resolve_device(device))),
        "mlp_init": lambda device: primitives.mlp_init(torch.Generator().manual_seed(0), [2, 3],
                                                       device=device).weights[0],
        "random_source": lambda device: primitives.random_source(
            torch.Generator().manual_seed(0), (2,), device=device),
        "first_order_hold": lambda device: primitives.first_order_hold(
            [0.0, 1.0], [[0.0], [1.0]], device=device)(0.5),
        "pid_controller": lambda device: controllers.pid_controller(
            [1.0], [1.0], [1.0], lambda s: (0.0, 0.0), 0.1, device=device)(
                0.0, torch.zeros(2, dtype=torch.float64, device=resolve_device(device)), 0.0)[0],
        "subscriber_input": lambda device: comms.subscriber_input(comms.SubscriberState(
            PubSub("memq://entry"), "C", (1,)), device=device)()[0],
        "bouncing_ball.run": lambda device: bouncing_ball.run(
            device=device, dtype=torch.float64, steps=2, queries=3, verbose=False)["xs"],
        "compass_gait.Walker": lambda device: compass_gait.Walker(device=device).masses,
        "rimless_wheel.rollout": lambda device: rimless_wheel.rollout(
            torch.ones((), device=resolve_device(device)), t_final=0.002)[0],
    }


NLP_ENTRY_POINTS = ["quadrotor.default_params", "pendulum.default_params",
                    "pendulum_dircol.build_problem", "DircolProblem.bounds",
                    "bench_quadrotor_mpc.build", "acrobot.default_params",
                    "acrobot.params_from_numpy", "acrobot.make_system", "acrobot.upright_state",
                    "cart_pole.default_params", "cart_pole.params_from_numpy",
                    "cart_pole.make_system", "acrobot_swingup.build", "cart_pole_lqr.run",
                    "acrobot_spong.run", "acrobot_spong_optimize.run", "acrobot_lqr_estimator.run",
                    "PiecewisePolynomial.first_order_hold",
                    "BsplineTrajectory.make_clamped_uniform",
                    "PiecewisePose.make", "trajectory_from_numpy", "linear_system", "mlp_init",
                    "random_source", "first_order_hold", "pid_controller", "subscriber_input",
                    "bouncing_ball.run", "compass_gait.Walker", "rimless_wheel.rollout"]


@pytest.mark.parametrize("name", NLP_ENTRY_POINTS)
def test_nlp_entry_points_default_to_the_card(name):
    """With no `device` the entry points of the quadrotor, the dircol, the
    acrobot, the cart-pole and their examples, and of the continuous-time
    and hybrid simulation slice (trajectories, primitives, controllers,
    comms, the three demos), place their tensors on the current CUDA
    device, and raise without one; with ``"cpu"`` they stay on the CPU."""
    import torch

    make = _nlp_entry_points()[name]
    assert make("cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)


def _solver_entry_points():
    """name -> callable(device) returning a tensor or an array, for the
    optimization layer's entry points, on the inputs of
    tests/solver_cases.py (host arrays: the device comes from `device`)."""
    import sys

    sys.path.insert(0, os.path.join(REPO, "tests"))
    import solver_cases as sc

    from drake_tpu_torch.solvers import al_newton, block_cholesky, conic, lcp, program, qp
    from drake_tpu_torch.systems import optimization
    from drake_tpu_torch.systems.base import ContinuousSystem

    def program_solve(device):
        prog = program.MathematicalProgram()
        x = prog.NewContinuousVariables(2)
        prog.AddQuadraticErrorCost(np.eye(2), [1.0, -2.0], x)
        return prog.Solve(device=device).solver_info["qp"].w

    def fixed_point(device):
        import torch

        f = sc.pendulum_f(torch.stack, torch.sin)
        system = ContinuousSystem(f=f, num_states=2, num_inputs=1)
        return optimization.find_fixed_point(system, *sc.PENDULUM_GUESS, device=device)[0]

    def block_factor(device):
        chol = block_cholesky.BlockSparseCholesky(2, 2, [(1, 0)])
        return chol.factor(4 * np.eye(2)[None].repeat(2, 0), {(1, 0): np.eye(2)},
                           device=device)[0]

    (P, q, A, l, u), _ = sc.admm_qps()
    cP, cc, cA, cb, dims = sc.pinned_socps(sc.seeded_targets(2))
    return {
        "qp.solve_qp": lambda device: qp.solve_qp(P, q, A, l, u, device=device).x,
        "conic.solve_conic": lambda device: conic.solve_conic(
            cP, cc, cA, cb, conic.ConeDims(**dims), device=device).x,
        "al_newton.solve": lambda device: al_newton.solve(
            sc.rosenbrock_cost, sc.line_constraint, sc.rosenbrock_starts(2), device=device).z,
        "lcp.solve_lcp_fb": lambda device: lcp.solve_lcp_fb(*sc.spd_lcps(2, 3),
                                                            device=device)[0],
        "BlockSparseCholesky.factor": block_factor,
        "MathematicalProgram.Solve": program_solve,
        "find_fixed_point": fixed_point,
    }


SOLVER_ENTRY_POINTS = ["qp.solve_qp", "conic.solve_conic", "al_newton.solve",
                       "lcp.solve_lcp_fb", "BlockSparseCholesky.factor",
                       "MathematicalProgram.Solve", "find_fixed_point"]


@pytest.mark.parametrize("name", SOLVER_ENTRY_POINTS)
def test_solver_entry_points_default_to_the_card(name):
    """The back ends put arrays from the host on the current CUDA device
    unless asked for the CPU, and MathematicalProgram.Solve and
    find_fixed_point solve there; without a card they raise."""
    import torch

    make = _solver_entry_points()[name]
    got = make("cpu")
    assert isinstance(got, np.ndarray) or got.device == torch.device("cpu")
    if torch.cuda.is_available():
        got = make(None)
        assert isinstance(got, np.ndarray) or got.device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)


def _contact_entry_points():
    """name -> callable(device) returning a tensor, for the entry points of
    the discrete plant's constraints and the rigid-contact demos (the demos'
    run() at a depth of one step)."""
    import torch

    from drake_tpu_torch.examples import (allegro_hand, atlas_drop, bushing_suspension, four_bar,
                                          planar_gripper, rod2d, rolling_sphere, simple_gripper,
                                          spatula_slip_control, strandbeest)
    from drake_tpu_torch.multibody import convert, force_elements, topology
    from drake_tpu_torch.multibody.model import ModelBuilder

    def model(device):
        b = ModelBuilder()
        b.add_body("ball", parent=None, joint_type="ball", mass=1.0)
        return b.build(torch.float64, device)

    def elements(device):
        b = force_elements.ForceElementBuilder(model("cpu")[0])
        return b.build(torch.float64, device)[1].bu_k

    def graph(device):
        g = topology.LinkGraph()
        g.add_link("a", mass=1.0)
        g.add_joint("j", parent=topology.WORLD, child="a")
        return g.build(torch.float64, device)[1].mass

    f64 = dict(dtype=torch.float64, verbose=False)
    return {
        "ModelBuilder.build ball": lambda device: model(device)[1].mass,
        "MultibodyModel.default_state": lambda device: model("cpu")[0].default_state(
            torch.float64, device),
        "ForceElementBuilder.build": elements,
        "LinkGraph.build": graph,
        "force_elements_from_numpy": lambda device: convert.force_elements_from_numpy(
            {"spring_bodies": [], "joint_spring_joints": [], "bushing_bodies": [],
             "door_hinge_joints": []}, {"bu_k": np.zeros((0, 6))} | {
                k: np.zeros((0,)) for k in ("sd_p_AP", "sd_p_BQ", "sd_free_length",
                                            "sd_stiffness", "sd_damping", "js_stiffness",
                                            "js_nominal", "bu_X_AF_R", "bu_X_AF_p", "bu_X_CM_R",
                                            "bu_X_CM_p", "bu_d", "dh_cfg")}, device=device)[1].bu_k,
        "rod2d.run": lambda device: rod2d.run(device=device, steps=1, **f64)["x_hi"],
        "rolling_sphere.run": lambda device: rolling_sphere.run(
            device=device, settle=1, steps=1, **f64)["point"]["x_roll"],
        "atlas_drop.run": lambda device: atlas_drop.run(device=device, steps=1, **f64)["x"],
        "allegro_hand.run": lambda device: allegro_hand.run(
            device=device, load_steps=1, grasp_steps=1, **f64)["x_grasp"],
        "simple_gripper.run": lambda device: simple_gripper.run(
            device=device, steps=1, **f64)["hold"]["x"],
        "four_bar.run": lambda device: four_bar.run(device=device, seconds=0.002,
                                                    **f64)["x_constraint"],
        "strandbeest.run": lambda device: strandbeest.run(device=device, seconds=0.002,
                                                          **f64)["x"],
        "planar_gripper.run": lambda device: planar_gripper.run(device=device, steps=1,
                                                                **f64)["x"],
        "spatula_slip_control.run": lambda device: spatula_slip_control.run(
            device=device, steps=1, **f64)["hydro strong"]["x"],
        "bushing_suspension.run": lambda device: bushing_suspension.run(
            device=device, steps=2, **f64)["x"],
    }


CONTACT_ENTRY_POINTS = ["ModelBuilder.build ball", "MultibodyModel.default_state",
                        "ForceElementBuilder.build", "LinkGraph.build",
                        "force_elements_from_numpy", "rod2d.run", "rolling_sphere.run",
                        "atlas_drop.run", "allegro_hand.run", "simple_gripper.run", "four_bar.run",
                        "strandbeest.run", "planar_gripper.run", "spatula_slip_control.run",
                        "bushing_suspension.run"]


@pytest.mark.parametrize("name", CONTACT_ENTRY_POINTS)
def test_contact_entry_points_default_to_the_card(name):
    """With no `device` the builders of the new joints, force elements and
    loop topology, and the rigid-contact demos, place their tensors on the
    current CUDA device, and raise without one; with ``"cpu"`` they stay on
    the CPU."""
    import torch

    make = _contact_entry_points()[name]
    assert make("cpu").device == torch.device("cpu")
    if torch.cuda.is_available():
        assert make(None).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make(None)
