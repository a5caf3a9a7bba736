"""The JAX package's float32 readings behind chip_smoke.py phase 21's gates.

The card has no JAX, so phase 21 holds the port's float32 demos on the
card to constants: this script computes them with the JAX package on the
CPU in float32 (the JAX examples' type on a chip), from the models of
examples/bouncing_ball.py, examples/rimless_wheel.py and
examples/compass_gait.py as the port's tests write them for the JAX
package, and prints them as one JSON object (``SYSTEMS_JAX_F32`` in
chip_smoke.py):

- the bouncing ball: its rk4 steps at h = 1e-4 and the dense output at
  chip_smoke.py's STEPS_BALL and BALL_QUERIES, the apexes, the apex ratio
  and the apex-to-apex time;
- the rimless wheel: 20 s at dt 1e-3, the strikes and the last
  post-impact speed; and over the lanes of phase 21c (the pushes drawn
  from numpy's seed 0, HYBRID_LANE_SECONDS), each lane's strikes, one
  digit a lane in lane order;
- the compass gait: 12 s at dt 2e-3, the strikes, the last post-impact
  state and the Poincare contraction.

Run from the repo root:  JAX_PLATFORMS=cpu python tests/systems_reference.py
"""

import json
import os
import sys

import numpy as np

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, HERE)
sys.path.insert(0, os.path.dirname(HERE))

HYBRID_LANES = 1024
HYBRID_LANE_SECONDS = 3.0
PUSH_RANGE = (0.9, 1.6)


def wheel_pushes(lanes=HYBRID_LANES, seed=0):
    """Phase 21c's initial speeds: uniform in PUSH_RANGE from numpy's seed,
    float32."""
    return np.random.default_rng(seed).uniform(*PUSH_RANGE, lanes).astype(np.float32)


def main():
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp

    from drake_tpu.contact.plant import make_continuous_contact_system
    from drake_tpu.systems import simulator as jsim
    from test_torch_continuous_contact import ball_world
    from test_torch_hybrid import j_compass_gait, j_rimless

    F32 = jnp.float32
    out = {}

    # The bouncing ball (examples/bouncing_ball.py).
    jm, jp, js = ball_world(True, mu=0.4, radius=0.05, mass=0.1, k=2e4, d=0.3, ground_k=1e12)
    jp = jax.tree_util.tree_map(lambda a: jnp.asarray(a, F32), jp)
    jsys = make_continuous_contact_system(jm, jp, js)
    x0 = jnp.asarray([1, 0, 0, 0, 0, 0, 0.35] + [0] * 6, F32)
    import chip_smoke

    steps, queries = chip_smoke.STEPS_BALL, chip_smoke.BALL_QUERIES
    us = jnp.zeros((steps, 0), F32)

    @jax.jit
    def ball(x):
        xs, ts = jsim.simulate(jsys, jp, x, us, 1e-4)
        traj = jsim.dense_output(jsys, jp, xs, ts, us)
        tq = jnp.linspace(0.0, steps * 1e-4, queries)
        return tq, jax.vmap(lambda s: traj.value(s)[6])(tq)

    tq, z = (np.asarray(a) for a in ball(x0))
    apexes = [(float(tq[i]), float(z[i])) for i in range(1, len(z) - 1)
              if z[i] > z[i - 1] and z[i] >= z[i + 1] and z[i] > 0.05 + 0.01]
    h1, h2 = apexes[0][1] - 0.05, apexes[1][1] - 0.05
    out["ball"] = {"apexes": apexes[:4], "n_apexes": len(apexes), "ratio": h2 / h1,
                   "t_flight": apexes[1][0] - apexes[0][0]}

    # The rimless wheel (examples/rimless_wheel.py), and phase 21c's lanes.
    system, touchdown = j_rimless(F32)
    alpha = np.pi / 8

    def wheel(x, t_final):
        return jsim.simulate_hybrid(system, None, x, t_final, 1e-3, witnesses=(touchdown,))

    xs, _, counts = jax.jit(lambda x: wheel(x, 20.0))(jnp.asarray([0.08 - alpha, 1.2], F32))
    xs = np.asarray(xs)
    resets = np.where(np.diff(xs[:, 0]) < -alpha)[0]
    out["wheel"] = {"strikes": int(counts[0]), "w_meas": float(xs[resets[-1] + 1, 1])}
    pushes = wheel_pushes()
    x0s = np.stack([np.full(HYBRID_LANES, 0.08 - alpha, np.float32), pushes], axis=1)
    _, _, lane_counts = jax.jit(jax.vmap(lambda x: wheel(x, HYBRID_LANE_SECONDS)))(x0s)
    lane_counts = np.asarray(lane_counts)[:, 0]
    assert lane_counts.max() < 10  # one digit a lane
    out["wheel_lanes"] = {"seconds": HYBRID_LANE_SECONDS, "strikes_sum": int(lane_counts.sum()),
                          "strikes_min": int(lane_counts.min()),
                          "strikes_max": int(lane_counts.max()),
                          "strikes": "".join(str(int(c)) for c in lane_counts)}

    # The compass gait (examples/compass_gait.py).
    system, witness, _ = j_compass_gait()
    xs, _, counts = jax.jit(lambda x: jsim.simulate_hybrid(
        system, None, x, 12.0, 2e-3, witnesses=(witness,)))(jnp.asarray([0.0, 0.0, 0.4, -2.0], F32))
    xs = np.asarray(xs)
    swaps = np.where(np.abs(np.diff(xs[:, 0])) > 0.1)[0]
    post = xs[swaps + 1]
    out["compass"] = {"strikes": int(counts[0]), "post_last": post[-1].tolist(),
                      "d_last": float(np.linalg.norm(post[-1] - post[-2]))}
    print(json.dumps(out))


if __name__ == "__main__":
    main()
