"""Pub/sub comms wired into simulation loops (the systems/lcm tier).

The PyTorch counterpart of ``drake_tpu/systems/comms.py``.  Drake wires LCM
into a simulation as systems: LcmPublisherSystem publishes an input port on
a periodic event, LcmSubscriberSystem holds the latest decoded message as
state, and LcmInterfaceSystem pumps the handler inside the simulator.  The
reference embeds the host's comms in its compiled ``lax.scan`` as ordered
``io_callback``s; the port's rollout is a Python loop, so each callback is a
plain host call inside the loop, in the same order: publish the state when
a message is due, poll the latest command, step.

The transport is the port's copy of ``io/pubsub`` (memq:// in-process buses
and UDP multicast).  These helpers are for single rollouts
(hardware-in-the-loop, teleoperation, visualization), as the reference's:
each publish or poll waits for the device.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from drake_tpu_torch.io.pubsub import PubSub, deserialize_arrays, serialize_arrays
from drake_tpu_torch.utils.device import resolve_device


def make_publisher(node: PubSub, channel: str, field: str = "x") -> Callable:
    """``publish(t, x)``: serializes {t, field: x} (arrays or tensors) onto
    ``channel`` in the self-describing array format (the Serializer role)."""

    def publish(t, x):
        node.publish(channel, serialize_arrays(t=t, **{field: x}))
        return np.zeros((), np.int32)

    return publish


def _step_time(k: int, h: float, like: torch.Tensor):
    """The reference's k.astype(x.dtype) * h, on the state's device."""
    return torch.tensor(k, dtype=like.dtype, device=like.device) * h


def publishing_rollout(dsys, params: Any, x0: torch.Tensor, us: torch.Tensor, node: PubSub,
                       channel: str, publish_every: int = 1, field: str = "x"):
    """Discrete rollout that publishes the state every k-th step (and the
    final state): the LcmPublisherSystem-in-a-Diagram role.  Messages arrive
    in simulation order.  Returns xs (num_steps + 1, nx)."""
    publish = make_publisher(node, channel, field)
    h = dsys.time_step
    x = x0
    xs = [x0]
    for k in range(us.shape[0]):
        t = _step_time(k, h, x)
        if k % publish_every == 0:
            publish(t, x)
        x = dsys.g(params, x, us[k], t)
        xs.append(x)
    publish(_step_time(us.shape[0], h, x), x)
    return torch.stack(xs)


class SubscriberState:
    """Host-side latest-value store for a channel (LcmSubscriberSystem's
    state): ``poll()`` drains the transport and returns ``(payload,
    count)``, count the messages received so far (0: nothing yet, the
    payload then zeros)."""

    def __init__(self, node: PubSub, channel: str, shape, dtype=np.float32, field: str = "u"):
        self.node = node
        self.sub_id = node.subscribe(channel)
        self.shape = tuple(shape)
        self.dtype = np.dtype(dtype)
        self.field = field
        self._latest = np.zeros(self.shape, self.dtype)
        self._count = 0

    def poll(self):
        self.node.handle(0)
        while True:
            msg = self.node.receive(self.sub_id)
            if msg is None:
                break
            arrays = deserialize_arrays(msg[1])
            if self.field in arrays:
                payload = np.asarray(arrays[self.field], self.dtype)
                if payload.shape == self.shape:
                    self._latest = payload
                    self._count += 1
        return self._latest, np.asarray(self._count, np.int32)


def subscriber_input(sub: SubscriberState, device=None):
    """``fetch() -> (payload, count)``: the latest message as tensors on
    `device` (None: the current CUDA device), polled from the transport at
    each call."""
    device = resolve_device(device)

    def fetch():
        payload, count = sub.poll()
        return torch.as_tensor(payload, device=device), torch.as_tensor(count, device=device)

    return fetch


def closed_loop_rollout_with_comms(dsys, params: Any, x0: torch.Tensor, policy: Callable,
                                   num_steps: int, node: PubSub, state_channel: str,
                                   command_sub: Optional[SubscriberState] = None,
                                   publish_every: int = 1, u_default=None):
    """Hardware-in-the-loop rollout: each step publishes the state on
    ``state_channel`` (when due), polls the latest external command (held
    at ``u_default`` until the first message, as LcmSubscriberSystem's
    initial value), and advances the plant with ``policy(params, x, u_ext,
    t)``.  Returns (xs (num_steps + 1, nx), us (num_steps, nu))."""
    publish = make_publisher(node, state_channel, "x")
    h = dsys.time_step
    if u_default is None:
        u_default = x0.new_zeros((dsys.num_inputs,))
    fetch = subscriber_input(command_sub, x0.device) if command_sub is not None else None
    x = x0
    xs, us = [x0], []
    for k in range(num_steps):
        t = _step_time(k, h, x)
        if k % publish_every == 0:
            publish(t, x)
        u_ext = u_default
        if fetch is not None:
            payload, count = fetch()
            if int(count) > 0:
                u_ext = payload.to(x.dtype)
        u = policy(params, x, u_ext, t)
        x = dsys.g(params, x, u, t)
        xs.append(x)
        us.append(u)
    return torch.stack(xs), torch.stack(us)
