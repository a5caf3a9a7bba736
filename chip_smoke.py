#!/usr/bin/env python3
"""On-card smoke run of drake_tpu_torch, the PyTorch + CUDA port of the MPM
substep.  Run from the root of a checkout, on a machine with one NVIDIA GPU:

    python3 chip_smoke.py

Phases (each prints its lines; any failure exits 1):

1. build the hand-written kernels from drake_tpu_torch/ops/csrc with nvcc;
2. hold each kernel (K1 grid update, K2 blocked P2G, K3 blocked G2P) against
   its plain PyTorch version on the card, on substep inputs of the bench
   scene (v and F perturbed from a fixed seed so that every channel is live)
   at both sizes, and at the small size with the capacities cut: blocks that
   overflow ``block_capacity`` (counts clamped to a pmax that is no multiple
   of a kernel's chunk) and blocks beyond ``max_active_blocks``; and hold K2
   to its contract on the rows' order: a block whose rows are not sorted by
   cell comes out as NaN, every other block as before;
3. drive the main path -- ``simulate`` (K2 + K1) and ``mpm_substep_blocked``
   (K2 + K1 + K3), 200 substeps each, and the same two with
   ``xla_only=True`` (the plain versions) -- on the elastic-block scene of
   benchmarks/bench_mpm_substeps.py at 17,576 and 132,651 particles; check
   dropped == 0, finite state, free fall (mean v_z = -g t), and kernel vs
   plain agreement in x and v, and count the kernel launches of that run;
4. time each kernel at the main path's shapes, back to back (inputs warm in
   the L2 cache) and with the cache flushed before every call (cold), beside
   its plain version and its bound: the larger of its bytes over the card's
   memory rate and its operations over the card's float32 rate.

``python3 chip_smoke.py --profile`` adds a fifth phase: ``torch.profiler``
over 20 substeps of each kernel path, for the device time, the busy share
and the kernel count of a substep.

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
PROFILE_SUBSTEPS = 20
SEED = 0
# Published peaks of an H100 SXM (NVIDIA's data sheet): device memory rate and
# float32 rate outside the tensor cores.  A kernel's bound is the larger of
# its bytes over the first and its operations over the second.
PEAK_BYTES_PER_S = 3.35e12
PEAK_F32_FLOPS = 67e12
# Written between two cold calls: several times the 50 MB L2 cache, and long
# enough on the card for the host to queue the next call behind it.
FLUSH_BYTES = 512 * 2**20
# Spin on the card while the host queues the calls of a timed loop, so that
# the events bracket back-to-back kernels and not the host's dispatch.  The
# spin is torch.cuda._sleep, a private function of PyTorch (its own tests use
# it); should it go, any kernel of a few ms in front of the loop does the same.
SPIN_CYCLES = 5_000_000
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
    """Mean device time of `fn` over `reps` back-to-back calls, by CUDA
    events (inputs and outputs stay warm in the L2 cache)."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def time_cold_ms(torch, fn, reps, flush):
    """Mean device time of `fn` over `reps` calls, each between its own pair
    of events and after `flush` (larger than the L2 cache) was overwritten,
    so that no input or output of the call is cached."""
    fn()
    torch.cuda.synchronize()
    pairs = []
    for i in range(reps):
        flush.fill_(i)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        pairs.append((start, end))
    torch.cuda.synchronize()
    return sum(s.elapsed_time(e) for s, e in pairs) / reps


def bound_ms(nbytes, flops):
    """(least time in ms the card could take, what bounds it)."""
    t_bytes = nbytes / PEAK_BYTES_PER_S * 1e3
    t_flops = flops / PEAK_F32_FLOPS * 1e3
    return max(t_bytes, t_flops), "bytes" if t_bytes >= t_flops else "operations"


def kernel_cases(torch, np, mpm, mk, config, state):
    """(name, kernel call, plain call, error bounds, bytes, operations) at
    the substep inputs of `state`, perturbed so that stress, u0 and C are
    all nonzero.  Bytes count what the function needs of every input, read
    once, and every output written once: K2 uses packed columns 0:28, K3
    columns 16:40 (taps, base, x, F) and every block's window, those of
    blocks without particles too.  Operations count the float32 multiplies
    and adds of the taken particles."""
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

    A = sort.starts.shape[0]
    taken = n - int(sort.dropped)
    table_bytes = 2 * A * 4  # starts and counts
    k1_bytes = 4 * (mass.numel() + 2 * mom.numel())
    k2_bytes = 4 * (n * 28 + A * mk.P2G_NV * mk.P2G_NODES) + table_bytes
    k3_bytes = 4 * (n * (mk.PACKED_COLS - 16) + vel_ext.numel()
                    + A * pmax * mk.G2P_OUT) + table_bytes
    k1_flops = mass.numel() * 3 * 2
    k2_flops = taken * 27 * (2 + 2 * 13)
    k3_flops = taken * (27 * (2 + 2 * mk.G2P_VEL_CH) + 150)
    return [
        ("update_grid", lambda: mk.update_grid_cuda(*grid_args),
         lambda: mk.update_grid_reference(*grid_args), bound_k1, k1_bytes, k1_flops),
        ("p2g_block", lambda: mk.p2g_block_cuda(*p2g_args),
         lambda: mk.p2g_block_reference(*p2g_args), bound_k2, k2_bytes, k2_flops),
        ("g2p_block", lambda: mk.g2p_block_cuda(*g2p_args),
         lambda: mk.g2p_block_reference(*g2p_args), bound_k3, k3_bytes, k3_flops),
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


def profile_paths(torch, mpm, scales, card):
    """torch.profiler over PROFILE_SUBSTEPS substeps of each kernel path:
    device time, busy share and kernel count per substep, and the three
    hand-written kernels' device time per call."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    def self_device_us(avg):
        for attr in ("self_device_time_total", "self_cuda_time_total"):
            value = getattr(avg, attr, None)
            if value is not None:
                return float(value)
        return 0.0

    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        for path in ("simulate", "blocked"):
            run_path(torch, mpm, path, config, state, WARMUP_SUBSTEPS)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_path(torch, mpm, path, config, state, PROFILE_SUBSTEPS)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3 / PROFILE_SUBSTEPS
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                run_path(torch, mpm, path, config, state, PROFILE_SUBSTEPS)
                torch.cuda.synchronize()
                traced_ms = (time.perf_counter() - t0) * 1e3
            avgs = [a for a in prof.key_averages() if a.device_type == DeviceType.CUDA]
            device_ms = sum(self_device_us(a) for a in avgs) / 1e3
            check(device_ms > 0, "the profiler recorded no device time")
            count = sum(a.count for a in avgs)
            print(f"[profile scale={scale} n={n}] {path} kernel: wall "
                  f"{wall_ms!r} ms/substep (no profiler), device kernels "
                  f"{device_ms / PROFILE_SUBSTEPS!r} ms/substep, busy "
                  f"{device_ms / traced_ms!r}, "
                  f"{count / PROFILE_SUBSTEPS!r} kernels/substep [{card}]")
            for a in avgs:
                for kernel in ("update_grid_kernel", "p2g_block_kernel", "g2p_block_kernel"):
                    if kernel in a.key:
                        print(f"[profile scale={scale} n={n}] {path}: {kernel} "
                              f"{self_device_us(a) / 1e3 / a.count!r} ms/call "
                              f"x {a.count} [{card}]")


def order_contract(torch, mpm, mk, config, state):
    """K2 on rows that break its contract: the fullest block's rows reversed,
    so that they stay that block's but are no longer sorted by cell.  The
    kernel must answer that block with NaN in its 13 live channels and every
    other block exactly as on the sorted rows."""
    sort = mpm.sort_particles(config, state)
    a = int(sort.counts.argmax())
    first, count = int(sort.starts[a]), int(sort.counts[a])
    cells = sort.packed[first:first + count, 25:28]
    check(bool((cells != cells[0]).any()), "the fullest block holds one cell only")
    rows = torch.arange(state.x.shape[0], device=sort.packed.device)
    rows[first:first + count] = rows[first:first + count].flip(0)
    args = (sort.starts, sort.counts, config.block_capacity)
    good = mk.p2g_block_cuda(sort.packed, *args)
    bad = mk.p2g_block_cuda(sort.packed[rows].contiguous(), *args)
    torch.cuda.synchronize()
    others = torch.ones(sort.starts.shape[0], dtype=torch.bool, device=good.device)
    others[a] = False
    check(bool(torch.isfinite(good).all()), "p2g_block: non-finite on sorted rows")
    check(bool(torch.isnan(bad[a, :13]).all()) and bool((bad[a, 13:] == 0).all()),
          "p2g_block: a block out of cell order was not marked NaN")
    check(torch.equal(bad[others], good[others]),
          "p2g_block: a block out of cell order changed another block")
    print(f"[parity n={state.x.shape[0]}] p2g_block: block {a} ({count} rows) reversed "
          f"-> NaN in its channels 0:13, the other {int(others.sum())} blocks unchanged ok")


def main(argv) -> int:
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
    timed = {}

    # ---- 2. per-kernel parity ---------------------------------------------
    def parity(scale, config, state):
        tag = (f"scale={scale} n={state.x.shape[0]} A={config.max_active_blocks} "
               f"pmax={config.block_capacity}")
        dropped = int(mpm.sort_particles(config, state).dropped)
        for name, kernel, plain, bounds, _, _ in kernel_cases(
                torch, np, mpm, mk, config, state):
            # kernel_parity synchronises: a fault shows at the kernel at fault.
            err, ok, detail = kernel_parity(torch, name, kernel, plain, bounds)
            errs[name] = max(errs[name], err)
            print(f"[parity {tag} dropped={dropped}] {name}: max|kernel - plain| "
                  f"= {err:.3e} ({detail}) {'ok' if ok else 'FAIL'}")
            check(ok, f"{name} disagrees with its plain version at {tag}")
        return dropped

    # Capacities cut at the small size: every full block overflows a pmax of
    # 200 (no multiple of 32), and with 8 active blocks the others are left out.
    config1, state1 = scales[1]
    for cut in (dict(block_capacity=200), dict(max_active_blocks=8)):
        dropped = parity(1, dataclasses.replace(config1, **cut), state1)
        check(dropped > 0, f"{cut} dropped no particle: the case tests nothing")
    order_contract(torch, mpm, mk, config1, state1)
    for scale, (config, state) in scales.items():
        check(parity(scale, config, state) == 0, "the bench scene dropped particles")
        # Warm-up of every path before the counted run.
        for path in ("simulate", "blocked"):
            for cfg in (config, dataclasses.replace(config, xla_only=True)):
                run_path(torch, mpm, path, cfg, state, WARMUP_SUBSTEPS)
    torch.cuda.synchronize()

    # ---- 3. main path, counted ---------------------------------------------
    mk.reset_launch_counts()
    results = {}
    per_substep = {name: {} for name in KERNELS}
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
            for name in KERNELS:
                per_substep[name][path] = launched[name] / SUBSTEPS
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
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=dev)
    for scale, (config, state) in scales.items():
        n = state.x.shape[0]
        for name, kernel, plain, _, nbytes, flops in kernel_cases(
                torch, np, mpm, mk, config, state):
            # kernel, plain, plain, kernel: both orders within one run.
            warm = [time_ms(torch, kernel, KERNEL_REPS)]
            p_ms = [time_ms(torch, plain, KERNEL_REPS), time_ms(torch, plain, KERNEL_REPS)]
            warm.append(time_ms(torch, kernel, KERNEL_REPS))
            cold = time_cold_ms(torch, kernel, KERNEL_REPS, flush)
            least, bound_by = bound_ms(nbytes, flops)
            timed[name] = {
                "ms": sum(warm) / 2, "cold_ms": cold, "plain_ms": sum(p_ms) / 2,
                "bound_ms": least, "bound_by": bound_by,
            }
            print(f"[time scale={scale} n={n}] {name}: kernel warm {warm!r} ms, "
                  f"cold {cold!r} ms, plain {p_ms!r} ms, bound {least!r} ms "
                  f"({nbytes} bytes, {flops} operations: {bound_by}), share of "
                  f"bound warm {least * 2 / sum(warm):.3f} cold {least / cold:.3f} [{card}]")
    del flush

    # ---- 5. profile (on request) --------------------------------------------
    if "--profile" in argv:
        profile_paths(torch, mpm, scales, card)

    # Times are those of the larger size (the last timed); no single PyTorch
    # call computes any of the three functions, so library_ms is null.
    print(json.dumps({"kernels": [
        {"name": name, "route": route, "source": source, "replaces": replaces,
         "launches": launches[name], "launches_per_substep": per_substep[name],
         "max_abs_err": errs[name], **timed[name], "library_ms": None}
        for name, (route, source, replaces) in KERNELS.items()
    ]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    try:
        code = main(sys.argv[1:])
    except Exception:  # any failed phase: report and exit non-zero
        traceback.print_exc()
        print("chip_smoke: FAILED", file=sys.stderr)
        code = 1
    sys.exit(code)
