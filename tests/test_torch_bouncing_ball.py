"""The bouncing-ball demo (drake_tpu_torch/examples/bouncing_ball.py)
against the JAX package's, on the CPU in float64: the continuous contact
plant (Hunt-Crossley normal force, regularized friction) over the demo's
first 3,000 rk4 steps of 1e-4 s (the fall and the first impact) through
``simulator.simulate``, and the dense output on a grid over them.

Tolerance: 1e-10 of scale (the port's contact Jacobian is the analytic
form, the reference's jacfwd; tests/test_torch_contact.py holds them
within 1e-10).  The port's eager rollout takes most of this file's time.

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from test_torch_continuous_contact import F64, ball_world, close
from test_torch_multibody import run_jitted


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_bouncing_ball_matches_jax_over_3000_steps():
    """examples/bouncing_ball.py's world and step over its first 3,000 rk4
    steps (the fall and the first impact), and its dense output."""
    import torch

    from drake_tpu.contact.plant import make_continuous_contact_system
    from drake_tpu.systems import simulator as jsim
    from drake_tpu_torch.examples import bouncing_ball

    jm, jp, js = ball_world(True, mu=0.4, radius=0.05, mass=0.1, k=2e4, d=0.3, ground_k=1e12)
    jsys = make_continuous_contact_system(jm, jp, js)
    x0 = np.array([1, 0, 0, 0, 0, 0, 0.35] + [0] * 6, dtype=float)
    us = jnp.zeros((3000, 0), F64)

    def rollout(x):
        xs, ts = jsim.simulate(jsys, jp, x, us, 1e-4)
        traj = jsim.dense_output(jsys, jp, xs, ts, us)
        return xs, jax.vmap(traj.value)(jnp.linspace(0.0, 0.3, 1201))

    jxs, jz = run_jitted(rollout, jnp.asarray(x0))
    out = bouncing_ball.run(device="cpu", dtype=torch.float64, steps=3000, queries=1201,
                            verbose=False)
    close(out["xs"], jxs)
    close(out["z"], np.asarray(jz)[:, 6])
    assert float(np.asarray(jxs)[:, 6].min()) < 0.05  # it met the ground
