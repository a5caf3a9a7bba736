#!/usr/bin/env python3
"""On-card smoke run of drake_tpu_torch, the PyTorch + CUDA port of the MPM
substep.  Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits 1):

1. build the hand-written kernels from drake_tpu_torch/ops/csrc with nvcc;
2. hold each kernel (K1 grid update, K2 blocked P2G, K3 blocked G2P) against
   its plain PyTorch version on the card, on substep inputs of the bench
   scene (v and F perturbed from a fixed seed so that every channel is live);
3. drive the main path -- ``simulate`` (K2 + K1) and ``mpm_substep_blocked``
   (K2 + K1 + K3), 200 substeps each, and the same two with
   ``xla_only=True`` (the plain versions) -- on the elastic-block scene of
   benchmarks/bench_mpm_substeps.py at 17,576 and 132,651 particles; check
   dropped == 0, finite state, free fall (mean v_z = -g t), and kernel vs
   plain agreement in x and v, and count the kernel launches of that run;
4. time each kernel against its plain version at the main path's shapes.

The last two lines are a JSON object of per-kernel results and
``{"ok": true, "device": {...}}``.  There is no CPU path: without a CUDA
device the script exits 1 and prints no result.
"""

from __future__ import annotations

import dataclasses
import json
import subprocess
import sys
import time
import traceback

SUBSTEPS = 200
WARMUP_SUBSTEPS = 3
KERNEL_REPS = 20
SEED = 0
# Kernel vs plain, max |x| and |v| difference after 200 substeps (float32;
# different summation orders; far below a cell of 1/64).
MAX_DIFF_PATHS = 1e-4
# Free fall: mean v_z against -g t (as tests/test_mpm.py).
FREE_FALL_RTOL = 1e-3

KERNELS = {
    # name: (route, source, the TPU kernel it replaces)
    "update_grid": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                    "drake_tpu/ops/mpm_kernels.py:59"),
    "p2g_block": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                  "drake_tpu/ops/mpm_kernels.py:267"),
    "g2p_block": ("cuda", "drake_tpu_torch/ops/csrc/mpm_kernels.cu",
                  "drake_tpu/ops/mpm_kernels.py:536"),
}


class SmokeFailure(Exception):
    pass


def check(cond, msg):
    if not cond:
        raise SmokeFailure(msg)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    check(out, "nvidia-smi printed nothing")
    return out[0].strip()


def scene(mpm, scale, device):
    """The elastic block of benchmarks/bench_mpm_substeps.py (--scale)."""
    config = mpm.MpmConfig(grid_size=(64, 64, 128), dx=1.0 / 64, dt=1e-4)
    half = 0.1 * scale
    lo = (0.5 - half, 0.5 - half, 0.6 - half)
    hi = (0.5 + half, 0.5 + half, 0.6 + half)
    state = mpm.make_particle_block(config, lo, hi, device=device)
    return config.capacities_for(state.x.shape[0]), state


def time_ms(torch, fn, reps):
    """Mean device time of `fn` over `reps` calls, by CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def kernel_cases(torch, np, mpm, mk, config, state):
    """(name, kernel call, plain call, error bounds) at the substep inputs
    of `state`, perturbed so that stress, u0 and C are all nonzero."""
    rng = np.random.default_rng(SEED)
    n = state.x.shape[0]
    dev = state.x.device
    v = torch.as_tensor(0.1 * rng.standard_normal((n, 3)), dtype=torch.float32, device=dev)
    F = torch.as_tensor(
        np.eye(3) + 0.01 * rng.standard_normal((n, 3, 3)), dtype=torch.float32, device=dev
    )
    s = state.replace(v=v, F=F)
    pmax = config.block_capacity
    dxi2 = 4.0 / config.dx**2
    sort = mpm.sort_particles(config, s)
    grid = mpm.particle_to_grid_blocked(dataclasses.replace(config, xla_only=True), s)
    mass = grid.mass.contiguous()
    mom = grid.momentum.movedim(-1, 0).contiguous()
    grid_args = (mass, mom, config.dt, config.gravity, config.wall_width)
    vel = mk.update_grid_reference(*grid_args)
    node_pos = mpm.window_node_pos(config, sort.active, torch.float32)
    vel_ext = mpm.block_velocity_windows(config, vel.movedim(0, -1), sort.active, node_pos)
    p2g_args = (sort.packed, sort.starts, sort.counts, pmax)
    g2p_args = (sort.packed, vel_ext, sort.starts, sort.counts, pmax, dxi2, config.dt)

    # Bounds on |kernel - plain|, as (label, last-axis columns, bound) from
    # the plain output: 1e-5 of the output's scale, for float32 sums taken
    # in another order (and with fused multiply-adds).
    def bound_k1(ref):
        return [("v", slice(None), 1e-5 * max(1.0, float(ref.abs().max())))]

    def bound_k2(ref):
        return [("all", slice(None), 1e-5 * float(ref.abs().max()))]

    def bound_k3(ref):
        # C = dxi2 (sum w v n - v x) is a difference of terms of size
        # dxi2 |v| |x|: its rounding scales with that, not with |C|.
        vmax = float(ref[..., 3:6].abs().max())
        xmax = max(1.0, float(ref[..., 0:3].abs().max()))
        return [
            ("x,v,F", slice(0, 15), 1e-5 * max(1.0, float(ref[..., :15].abs().max()))),
            ("C", slice(15, 24), 1e-5 * dxi2 * vmax * xmax),
        ]

    return [
        ("update_grid", lambda: mk.update_grid_cuda(*grid_args),
         lambda: mk.update_grid_reference(*grid_args), bound_k1),
        ("p2g_block", lambda: mk.p2g_block_cuda(*p2g_args),
         lambda: mk.p2g_block_reference(*p2g_args), bound_k2),
        ("g2p_block", lambda: mk.g2p_block_cuda(*g2p_args),
         lambda: mk.g2p_block_reference(*g2p_args), bound_k3),
    ]


def kernel_parity(torch, name, kernel, plain, bounds):
    got = kernel()
    ref = plain()
    torch.cuda.synchronize()
    check(got.shape == ref.shape, f"{name}: shape {tuple(got.shape)} vs {tuple(ref.shape)}")
    check(bool(torch.isfinite(got).all()), f"{name}: non-finite output")
    diff = (got - ref).abs()
    ok, parts = True, []
    for label, cols, bound in bounds(ref):
        err = float(diff[..., cols].max())
        ok = ok and err <= bound
        parts.append(f"{label} {err:.3e} <= {bound:.3e}")
    return float(diff.max()), ok, "; ".join(parts)


def run_path(torch, mpm, path, config, state, n):
    """Drive `n` substeps of one path; returns (state, device ms)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    if path == "simulate":
        out = mpm.simulate(config, state, n)
    else:
        out = state
        for _ in range(n):
            out = mpm.mpm_substep_blocked(config, out)
    end.record()
    end.synchronize()
    return out, start.elapsed_time(end)


def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs only on the card",
              file=sys.stderr)
        return 1
    from drake_tpu_torch.mpm import solver as mpm
    from drake_tpu_torch.ops import _build
    from drake_tpu_torch.ops import mpm_kernels as mk

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    card = card_line()
    print(card)  # the card's name and power limit, as nvidia-smi prints them
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, "
          f"device {torch.cuda.get_device_name(0)}")

    # ---- 1. build ----------------------------------------------------------
    t0 = time.perf_counter()
    lib = _build.build()
    _build.load_library()
    print(f"[build] {time.perf_counter() - t0:.2f} s -> {lib.name}")
    log = lib.with_suffix(".log")
    if log.exists():
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line or "Compiling" in line:
                print(f"[build] {line.strip()}")

    scales = {1: scene(mpm, 1, dev), 2: scene(mpm, 2, dev)}
    errs = {name: 0.0 for name in KERNELS}
    kernel_ms, plain_ms = {}, {}

    # ---- 2. per-kernel parity ---------------------------------------------
    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        tag = (f"scale={scale} n={n} A={config.max_active_blocks} "
               f"pmax={config.block_capacity}")
        for name, kernel, plain, bounds in kernel_cases(torch, np, mpm, mk, config, state):
            err, ok, detail = kernel_parity(torch, name, kernel, plain, bounds)
            errs[name] = max(errs[name], err)
            print(f"[parity {tag}] {name}: max|kernel - plain| = {err:.3e} "
                  f"({detail}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} disagrees with its plain version at scale {scale}")
        # Warm-up of every path before the counted run.
        for path in ("simulate", "blocked"):
            for cfg in (config, dataclasses.replace(config, xla_only=True)):
                run_path(torch, mpm, path, cfg, state, WARMUP_SUBSTEPS)
    torch.cuda.synchronize()

    # ---- 3. main path, counted ---------------------------------------------
    mk.reset_launch_counts()
    results = {}
    for scale, (config, state) in scales.items():
        plain_cfg = dataclasses.replace(config, xla_only=True)
        for path in ("simulate", "blocked"):
            before = dict(mk.LAUNCHES)
            out_k, ms_k = run_path(torch, mpm, path, config, state, SUBSTEPS)
            mid = dict(mk.LAUNCHES)
            out_p, ms_p = run_path(torch, mpm, path, plain_cfg, state, SUBSTEPS)
            torch.cuda.synchronize()
            launched = {k: mid[k] - before[k] for k in mk.LAUNCHES}
            check(dict(mk.LAUNCHES) == mid, f"plain {path} path launched a kernel")
            want = {"update_grid": SUBSTEPS, "p2g_block": SUBSTEPS,
                    "g2p_block": SUBSTEPS if path == "blocked" else 0}
            check(launched == want, f"{path} launches {launched}, expected {want}")
            results[(scale, path)] = (out_k, ms_k, out_p, ms_p)
    launches = dict(mk.LAUNCHES)
    print(f"[launches] main path: {json.dumps(launches)}")
    for name in KERNELS:
        check(launches[name] > 0, f"{name} was never launched by the main path")

    t = SUBSTEPS * scales[1][0].dt
    for (scale, path), (out_k, ms_k, out_p, ms_p) in results.items():
        n = out_k.x.shape[0]
        for label, out, ms in (("kernel", out_k, ms_k), ("plain", out_p, ms_p)):
            dropped = int(out.dropped)
            finite = all(bool(torch.isfinite(f).all()) for f in (out.x, out.v, out.F, out.C))
            vz = float(out.v[:, 2].double().mean())
            rel = abs(vz - (-9.81 * t)) / (9.81 * t)
            print(f"[run scale={scale} n={n}] {path} {label}: {SUBSTEPS} substeps, "
                  f"dropped={dropped}, finite={finite}, mean v_z={vz!r} "
                  f"(-g t={-9.81 * t!r}, rel {rel:.2e}), "
                  f"{SUBSTEPS / (ms / 1e3)!r} substeps/s ({ms / SUBSTEPS!r} ms/substep) "
                  f"[{card}]")
            check(dropped == 0, f"{path} {label} dropped {dropped} particles")
            check(finite, f"{path} {label}: non-finite state")
            check(rel <= FREE_FALL_RTOL, f"{path} {label}: free fall off by {rel:.2e}")
        dx_max = float((out_k.x - out_p.x).abs().max())
        dv_max = float((out_k.v - out_p.v).abs().max())
        ok = max(dx_max, dv_max) <= MAX_DIFF_PATHS
        print(f"[run scale={scale} n={n}] {path}: max|x_kernel - x_plain| = {dx_max:.3e}, "
              f"max|v_kernel - v_plain| = {dv_max:.3e} (<= {MAX_DIFF_PATHS:.0e}) "
              f"{'ok' if ok else 'FAIL'}")
        check(ok, f"{path}: kernel and plain paths disagree")

    # ---- 4. kernel times ---------------------------------------------------
    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        for name, kernel, plain, _ in kernel_cases(torch, np, mpm, mk, config, state):
            k_ms = time_ms(torch, kernel, KERNEL_REPS)
            p_ms = time_ms(torch, plain, KERNEL_REPS)
            kernel_ms[name], plain_ms[name] = k_ms, p_ms
            print(f"[time scale={scale} n={n}] {name}: kernel {k_ms!r} ms, "
                  f"plain {p_ms!r} ms [{card}]")

    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "max_abs_err": errs[name],
         "ms": kernel_ms[name], "plain_ms": plain_ms[name]}
        for name, (route, source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main()
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
