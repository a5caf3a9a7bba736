"""Parity of drake_tpu_torch's pub/sub comms (systems/comms.py, over the
port's copy of io/pubsub.py and io/native/pubsub.cpp) against drake_tpu's,
on the CPU.

The two transports are separate builds of the same C++ source (each
package's own copy); every test here runs on in-process memq:// buses.  The
cases are tests/test_comms.py's (the decimated publishing rollout, the
latest-value subscriber, the hardware-in-the-loop round trip), run by both
packages on the same inputs, and the messages each bus delivers are held
equal: the same channels, and payloads equal within 1e-12 (float64 states
of rollouts computed by each package) or byte for byte (the same arrays).

torch and the port are imported when a test here runs, not when pytest
collects this file (see tests/test_torch_mpm_kernels.py).
"""

import filecmp
import os
import time

import jax.numpy as jnp
import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _torch_one_thread():
    import torch

    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def drain(node, sub):
    out = []
    while True:
        msg = node.receive(sub)
        if msg is None:
            return out
        out.append(msg)


def test_native_source_is_the_reference_copy():
    """The port's transport is built from its own copy of the C++ source,
    identical to the reference's, into drake_tpu_torch/_build."""
    from drake_tpu_torch.io import pubsub

    assert filecmp.cmp(pubsub._SRC, os.path.join(REPO, "drake_tpu", "io", "native", "pubsub.cpp"),
                       shallow=False)
    path = pubsub._build_library()
    assert os.path.dirname(path) == str(pubsub.BUILD_DIR)
    assert os.path.basename(path).startswith("pubsub_") and path.endswith(".so")


def test_both_copies_serialize_the_same_bytes_and_deliver_the_same_messages(monkeypatch):
    """serialize_arrays of the same arrays (numpy, or a torch tensor in the
    port) gives the same bytes in both packages (the zip's timestamp held
    fixed), and the same publications reach a wildcard subscriber of each
    bus with the same channels and bytes, in order."""
    import torch

    from drake_tpu.io import pubsub as jps
    from drake_tpu_torch.io import pubsub as tps

    monkeypatch.setattr(time, "time", lambda: 1.7e9)
    rng = np.random.default_rng(0)
    arrays = {"x": rng.standard_normal((3, 4)), "t": np.asarray(0.25, np.float32),
              "k": np.arange(5, dtype=np.int32)}
    ref = jps.serialize_arrays(**arrays)
    assert tps.serialize_arrays(**arrays) == ref
    assert tps.serialize_arrays(**{k: torch.as_tensor(v) for k, v in arrays.items()}) == ref
    back = tps.deserialize_arrays(ref)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype

    received = []
    for mod, bus in ((jps, "memq://cmp_ref"), (tps, "memq://cmp_port")):
        pub, listener = mod.PubSub(bus), mod.PubSub(bus)
        sub = listener.subscribe("STATE*")
        for i in range(4):
            pub.publish(f"STATE_{i % 2}", mod.serialize_arrays(i=np.asarray(i), **arrays))
        pub.publish("OTHER", b"ignored")
        received.append(drain(listener, sub))
    assert [c for c, _ in received[0]] == ["STATE_0", "STATE_1", "STATE_0", "STATE_1"]
    assert received[0] == received[1]


def _double_integrator(pkg, h=0.1):
    if pkg == "jax":
        from drake_tpu.systems.base import DiscreteSystem

        def g(params, x, u, t):
            return jnp.array([x[0] + h * x[1], x[1] + h * u[0]])
    else:
        import torch

        from drake_tpu_torch.systems.base import DiscreteSystem

        def g(params, x, u, t):
            return torch.stack([x[0] + h * x[1], x[1] + h * u[0]])

    return DiscreteSystem(g=g, num_states=2, num_inputs=1, time_step=h)


def _messages(mod, node, sub):
    return [(c, mod.deserialize_arrays(b)) for c, b in drain(node, sub)]


def assert_same_messages(got, ref, tol=1e-12):
    assert [c for c, _ in got] == [c for c, _ in ref]
    for (_, g), (_, r) in zip(got, ref):
        assert sorted(g) == sorted(r)
        for k in r:
            assert g[k].dtype == r[k].dtype and g[k].shape == r[k].shape, k
            np.testing.assert_allclose(g[k], r[k], rtol=0.0, atol=tol)


@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_publishing_rollout_matches_jax(dtype):
    """tests/test_comms.py's decimated rollout, seeded inputs: the states
    and the messages (steps 0, 3, 6, 9 and the final one)."""
    import torch

    from drake_tpu.io import pubsub as jps
    from drake_tpu.systems import comms as jcomms
    from drake_tpu_torch.io import pubsub as tps
    from drake_tpu_torch.systems import comms as tcomms

    us = np.random.default_rng(1).standard_normal((10, 1)).astype(dtype)
    x0 = np.array([0.5, -0.2], dtype)
    out = {}
    for pkg, mod, comms, bus in (("jax", jps, jcomms, f"memq://pub_ref_{dtype}"),
                                 ("torch", tps, tcomms, f"memq://pub_port_{dtype}")):
        node, listener = mod.PubSub(bus), mod.PubSub(bus)
        sub = listener.subscribe("STATE")
        if pkg == "jax":
            xs = jcomms.publishing_rollout(_double_integrator("jax"), None, jnp.asarray(x0),
                                           jnp.asarray(us), node, "STATE", publish_every=3)
        else:
            xs = tcomms.publishing_rollout(_double_integrator("torch"), None,
                                           torch.as_tensor(x0), torch.as_tensor(us), node,
                                           "STATE", publish_every=3)
        out[pkg] = (np.asarray(xs), _messages(mod, listener, sub))
    tol = 1e-12 if dtype == "float64" else 1e-6
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0.0, atol=tol)
    assert len(out["jax"][1]) == 5
    assert_same_messages(out["torch"][1], out["jax"][1], tol)


def test_subscriber_input_latest_value():
    """tests/test_comms.py's latest-value semantics: count 0 before any
    message, then the latest of two, as tensors on the asked device."""
    import torch

    from drake_tpu_torch.io.pubsub import PubSub
    from drake_tpu_torch.systems import comms

    node, commander = PubSub("memq://sub_port"), PubSub("memq://sub_port")
    sub = comms.SubscriberState(node, "CMD", shape=(1,), field="u")
    fetch = comms.subscriber_input(sub, device="cpu")
    payload, count = fetch()
    assert int(count) == 0 and payload.device == torch.device("cpu")
    pub = comms.make_publisher(commander, "CMD", field="u")
    pub(np.asarray(0.0), np.array([2.5]))
    pub(torch.tensor(0.1), torch.tensor([3.5]))  # latest wins
    payload, count = fetch()
    assert int(count) == 2
    np.testing.assert_allclose(payload.numpy(), [3.5])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            comms.subscriber_input(sub)


@pytest.mark.parametrize("preload", [True, False])
def test_closed_loop_rollout_with_comms_matches_jax(preload):
    """tests/test_comms.py's hardware-in-the-loop round trip: a command
    preloaded on the bus (or none: the default held) drives the plant; the
    states, inputs and the published states equal the JAX package's."""
    import torch

    from drake_tpu.io import pubsub as jps
    from drake_tpu.systems import comms as jcomms
    from drake_tpu_torch.io import pubsub as tps
    from drake_tpu_torch.systems import comms as tcomms

    out = {}
    for pkg, mod, comms in (("jax", jps, jcomms), ("torch", tps, tcomms)):
        bus = f"memq://hil_{pkg}_{preload}"
        node, remote, listener = mod.PubSub(bus), mod.PubSub(bus), mod.PubSub(bus)
        state_sub = listener.subscribe("STATE")
        cmd = comms.SubscriberState(node, "CMD", shape=(1,), field="u")
        if preload:
            remote.publish("CMD", mod.serialize_arrays(u=np.array([1.0], np.float32)))
        if pkg == "jax":
            xs, us = jcomms.closed_loop_rollout_with_comms(
                _double_integrator("jax"), None, jnp.zeros(2, jnp.float32),
                lambda p, x, u_ext, t: u_ext, 5, node, "STATE", command_sub=cmd,
                publish_every=2)
        else:
            xs, us = tcomms.closed_loop_rollout_with_comms(
                _double_integrator("torch"), None, torch.zeros(2, dtype=torch.float32),
                lambda p, x, u_ext, t: u_ext, 5, node, "STATE", command_sub=cmd,
                publish_every=2)
        out[pkg] = (np.asarray(xs), np.asarray(us), _messages(mod, listener, state_sub))
    np.testing.assert_allclose(out["torch"][0], out["jax"][0], rtol=0.0, atol=1e-6)
    np.testing.assert_allclose(out["torch"][1], out["jax"][1], rtol=0.0, atol=0.0)
    np.testing.assert_allclose(out["torch"][1], np.full((5, 1), 1.0 if preload else 0.0))
    assert len(out["jax"][2]) == 3
    assert_same_messages(out["torch"][2], out["jax"][2], 1e-6)
