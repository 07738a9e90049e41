"""Benchmark: flagship MGMC sampling throughput on one GPU.

Problem: the flagship deployment of ``tests/fixtures/flagship.cfg`` - 2d
posterior on a 256x256 lattice (255^2 unknowns), shifted-Laplace FD prior
(Lambda = 0.2), 8 point measurements with variances of about 1e-6, 5-level SOR
W-cycle MGMC - in float32.

* Device path: 256 independent chains stepped in lockstep (every chain is a
  valid MCMC chain), plus one chain for a like-for-like latency figure.  Times
  are host-clock intervals around device loops of many steps, each ended by
  ``block_until_ready``; the median of three repetitions with fresh keys.
* Baseline: ``native/baseline_mgmc.cc``, a single-core C++ re-creation of the
  reference's CSR hot path in float64, on the same hierarchy, built and run in
  the same call by a child process that stays on the CPU.

Options: ``--ab`` also times the distilled coarse subtree against the composed
one and the band-Cholesky sampler's recursive doubling against its sequential
scan, in turns (A B B A A B B A); ``--trace DIR`` writes a ``jax.profiler`` trace of a
few flagship steps and the loop's optimised HLO (``hlo.txt``) to DIR and
reduces the trace to device time per named scope of the cycle.

Exits non-zero without a GPU.  Prints the card's name and power limit, then one
JSON line.
"""

from __future__ import annotations

import argparse
import json
import os
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent
NX = 256
NLEVEL = 5
CYCLE = 2
NCHAINS = 256


def build_problem():
    """The flagship posterior operator (``NX`` cells per axis) in JAX's
    default float dtype."""
    from multigridmc_tpu.drivers.common import build_operators
    from multigridmc_tpu.utils.config import load_config

    config = load_config(REPO / "tests" / "fixtures" / "flagship.cfg")
    config.lattice.nx = config.lattice.ny = NX
    _, op, _ = build_operators(config)
    return op


def card_identity() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60)
    return out.stdout.strip()


def compile_loop(step, x, nsteps: int):
    """Compile a device loop of ``nsteps`` steps of ``step(key, x)`` and run
    it once; returns (compiled loop, compile seconds, state)."""
    import jax

    from multigridmc_tpu.utils.runtime import sampling_key

    def loop(key, x):
        return jax.lax.fori_loop(
            0, nsteps, lambda k, x: step(jax.random.fold_in(key, k), x), x)

    t0 = time.perf_counter()
    run = jax.jit(loop).lower(sampling_key(0), x).compile()
    t_compile = time.perf_counter() - t0
    return run, t_compile, jax.block_until_ready(run(sampling_key(0), x))


def time_loop(run, x, nsteps: int, seeds) -> tuple:
    """Median seconds per step of a compiled loop over fresh keys, and the
    final state."""
    import jax

    from multigridmc_tpu.utils.runtime import sampling_key

    times = []
    for seed in seeds:
        t0 = time.perf_counter()
        x = jax.block_until_ready(run(sampling_key(seed), x))
        times.append(time.perf_counter() - t0)
    return float(np.median(times)) / nsteps, x


def timed_loop(step, x, nsteps: int):
    """(compile seconds, median seconds per step of 3 repetitions, state)."""
    run, t_compile, x = compile_loop(step, x, nsteps)
    dt, x = time_loop(run, x, nsteps, (1, 2, 3))
    return t_compile, dt, x


def measure_device(ab: bool, trace_dir: str | None) -> dict:
    import jax
    import jax.numpy as jnp

    from multigridmc_tpu.samplers.cholesky import BandCholeskySampler
    from multigridmc_tpu.samplers.mgmc import MultigridMCSampler

    op = build_problem()
    dtype = op.coeffs.dtype
    dev = jax.devices()[0]
    t0 = time.perf_counter()
    sampler = MultigridMCSampler(op, nlevel=NLEVEL, smoother="SOR",
                                 coarse_solver="Cholesky", omega=1.0, cycle=CYCLE)
    out = {"setup_s": time.perf_counter() - t0,
           "distill_level": sampler.distill_level}
    f = jnp.asarray(np.random.default_rng(0).uniform(size=op.vshape), dtype)

    def mgmc(s):
        return lambda key, x: s.apply(key, f, x)

    x1 = jnp.zeros(op.vshape, dtype)
    tc, dt, _ = timed_loop(mgmc(sampler), x1, 400)
    out.update(single_chain_compile_s=tc, single_chain_ms_per_sample=1e3 * dt,
               single_chain_samples_per_sec=1.0 / dt)
    xb = jnp.zeros((NCHAINS,) + op.vshape, dtype)
    nsteps = 100
    run, tc, xb = compile_loop(mgmc(sampler), xb, nsteps)
    dt, xb = time_loop(run, xb, nsteps, (1, 2, 3))
    if not bool(jnp.isfinite(xb).all()):
        raise AssertionError("non-finite samples")
    out.update(nchains=NCHAINS, batched_compile_s=tc, batched_ms_per_step=1e3 * dt,
               batched_samples_per_sec=NCHAINS / dt)
    out["peak_bytes_in_use"] = int((dev.memory_stats() or {}).get("peak_bytes_in_use", 0))

    if trace_dir:
        # one traced call of the same compiled loop: nsteps flagship steps
        with jax.profiler.trace(trace_dir):
            time_loop(run, xb, nsteps, (99,))
        hlo = run.as_text()
        (Path(trace_dir) / "hlo.txt").write_text(hlo)
        out["trace_steps"] = nsteps
        out["trace"] = scope_times(trace_dir, hlo, nsteps)
        if not out["trace"]["attribution_complete"]:
            print(f"bench: {out['trace']['unattributed_share']:.1%} of the traced "
                  "device time has no scope; the per-scope times are lower "
                  "bounds", file=sys.stderr)

    if ab:
        def variant(distill):
            if (sampler.distilled is not None) == distill:
                return sampler
            return MultigridMCSampler(op, nlevel=NLEVEL, smoother="SOR", omega=1.0,
                                      cycle=CYCLE, distill=distill)

        variants = {"distilled": mgmc(variant(True)), "composed": mgmc(variant(False))}
        out["subtree_ms_per_step"] = ab_turns(variants, xb, 100)
        t0 = time.perf_counter()
        band = {"doubling": BandCholeskySampler(op, parallel=True),
                "scan": BandCholeskySampler(op, parallel=False)}
        out["band_setup_s"] = time.perf_counter() - t0
        out["band_ms_per_step"] = {
            f"{nc} chains": ab_turns(
                {k: (lambda s: lambda key, x: s.apply(key, f, x))(s) for k, s in band.items()},
                jnp.zeros((nc,) + op.vshape, dtype) if nc > 1 else x1, 20)
            for nc in (1, NCHAINS)}
    return out


SCOPE = re.compile(r"(L\d+_(?:descend|ascend)|coarse|distilled)")
HLO_OP = re.compile(r"^\s*(?:ROOT\s+)?%?([\w.\-]+)\s*=.*?op_name=\"([^\"]*)\"")
# matrix products in optimised GPU HLO: cuBLAS calls and Triton GEMM fusions
HLO_GEMM = re.compile(r'custom_call_target="__cublas\$\w*gemm|"__triton_gemm"')
#: largest share of the traced device time that may have no scope before the
#: per-scope times are reported as incomplete
MAX_UNATTRIBUTED = 0.05


def hlo_op_names(hlo_text: str) -> dict:
    """Instruction name -> op_name metadata of the optimised HLO; kernels carry
    the instruction's name, also with '.' -> '_'."""
    names = {}
    for line in hlo_text.splitlines():
        m = HLO_OP.match(line)
        if m:
            names[m.group(1)] = names[m.group(1).replace(".", "_")] = m.group(2)
    return names


def hlo_scopes(hlo_text: str) -> dict:
    """Instruction name -> MGMC scope (the named scopes of samplers/mgmc.py)."""
    scopes = {}
    for name, op_name in hlo_op_names(hlo_text).items():
        s = SCOPE.search(op_name)
        if s:
            scopes[name] = s.group(1)
    return scopes


def hlo_gemm_scopes(hlo_text: str) -> list:
    """The scope of every GEMM instruction, in the order the optimised HLO
    lists them (its schedule order within a computation); "other" where the
    op_name has no scope."""
    out = []
    for line in hlo_text.splitlines():
        if HLO_GEMM.search(line):
            m = SCOPE.search(line)
            out.append(m.group(1) if m else "other")
    return out


def scope_times(trace_dir: str, hlo_text: str, nsteps: int) -> dict:
    """Reduce a ``jax.profiler`` trace of ``nsteps`` steps to device time per
    named scope of the MGMC cycle (``L<level>_descend``/``_ascend``,
    ``coarse``, ``distilled``; see samplers/mgmc.py), the device busy time
    (union of kernel intervals) and the traced window on the device's clock,
    all in nanoseconds.  A kernel is attributed through the HLO instruction it
    runs (its name or a stat of its trace event) and that instruction's
    op_name in ``hlo_text``.

    cuBLAS kernels launched from a CUDA graph (XLA's command buffers) carry
    no HLO name.  When there are exactly ``nsteps`` times as many of them as
    the HLO has GEMM instructions, the k-th of a step, in device time order,
    is the k-th GEMM instruction and takes its scope (``gemm.by_order``);
    otherwise they stay unattributed.  ``attribution_complete`` is false when
    more than ``MAX_UNATTRIBUTED`` of the device time has no scope; the
    largest unattributed kernels are listed by kernel name, HLO instruction
    and op_name."""
    from jax.profiler import ProfileData

    paths = sorted(Path(trace_dir).glob("**/*.xplane.pb"))
    if not paths:
        raise FileNotFoundError(f"no trace under {trace_dir}")
    data = ProfileData.from_file(str(paths[-1]))
    scopes = hlo_scopes(hlo_text)
    op_names = hlo_op_names(hlo_text)
    gemm_scopes = hlo_gemm_scopes(hlo_text)
    per_scope, intervals, other, unnamed_gemms = {}, [], {}, []
    gemm_kernels, gemm_ns = 0, 0.0

    def add(key, dur, label):
        per_scope[key] = per_scope.get(key, 0.0) + dur
        if key == "other":
            other[label] = other.get(label, 0.0) + dur

    for plane in data.planes:
        if not plane.name.startswith("/device:GPU"):
            continue
        for line in plane.lines:
            for ev in line.events:
                start, dur = ev.start_ns, ev.duration_ns
                intervals.append((start, start + dur))
                stats = {k: str(v) for k, v in ev.stats}
                is_gemm = "gemm" in ev.name.lower()
                if is_gemm:
                    gemm_kernels += 1
                    gemm_ns += dur
                names = [ev.name] + list(stats.values())
                key = next((scopes[n] for n in names if n in scopes), None)
                if key is None:
                    m = SCOPE.search(" ".join(names))
                    key = m.group(1) if m else "other"
                hlo_op = stats.get("hlo_op", "")
                label = (f"{ev.name[:60]} | {hlo_op} | "
                         f"{op_names.get(hlo_op, stats.get('name', ''))[-80:]}")
                if key == "other" and is_gemm:
                    unnamed_gemms.append((start, dur, label))
                else:
                    add(key, dur, label)
    if not intervals:
        raise ValueError(f"no device events in {paths[-1]}")
    by_order = bool(unnamed_gemms) and len(unnamed_gemms) == nsteps * len(gemm_scopes)
    for i, (_, dur, label) in enumerate(sorted(unnamed_gemms)):
        add(gemm_scopes[i % len(gemm_scopes)] if by_order else "other", dur, label)
    intervals.sort()
    busy, end = 0.0, -float("inf")
    for s, e in intervals:
        if s > end:
            busy += e - s
            end = e
        elif e > end:
            busy += e - end
            end = e
    window = max(e for _, e in intervals) - intervals[0][0]
    unattributed = per_scope.get("other", 0.0) / sum(per_scope.values())
    return {"window_ns": window, "busy_ns": busy, "kernels": len(intervals),
            "hlo_scoped_instructions": len(scopes),
            "scope_ns": dict(sorted(per_scope.items())),
            "unattributed_share": unattributed,
            "attribution_complete": unattributed <= MAX_UNATTRIBUTED,
            "gemm": {"hlo_instructions": len(gemm_scopes),
                     "trace_kernels_per_step": gemm_kernels / nsteps,
                     "trace_ns": gemm_ns, "by_order": by_order},
            "top_other_ns": dict(sorted(other.items(), key=lambda kv: -kv[1])[:16])}


def ab_turns(variants: dict, x, nsteps: int) -> dict:
    """Per-step milliseconds of two step functions, compiled first and then
    timed in turns A B B A A B B A; median per variant, plus compile seconds."""
    a, b = variants
    runs, out = {}, {}
    for name, step in variants.items():
        runs[name], out[f"{name}_compile_s"], _ = compile_loop(step, x, nsteps)
    times = {a: [], b: []}
    for i, name in enumerate((a, b, b, a, a, b, b, a)):
        dt, _ = time_loop(runs[name], x, nsteps, (100 + i,))
        times[name].append(1e3 * dt)
    out.update({name: float(np.median(t)) for name, t in times.items()})
    return out


def measure_baseline() -> dict:
    """Build and run the native float64 baseline in a child process that
    stays on the CPU; returns its JSON record."""
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    out = subprocess.run(
        [sys.executable, "-m", "multigridmc_tpu.utils.baseline_export",
         str(NX), str(NLEVEL), str(CYCLE), "5", "50"],
        check=True, capture_output=True, text=True, cwd=str(REPO), timeout=1200,
        env=env,
    )
    result = json.loads(out.stdout.strip().splitlines()[-1])
    result["cycle"] = CYCLE
    return result


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ab", action="store_true")
    parser.add_argument("--trace", default=None)
    args = parser.parse_args(argv)

    import jax

    from multigridmc_tpu.utils.runtime import configure_runtime

    devices = jax.devices()
    if devices[0].platform != "gpu":
        print(f"bench: no GPU (JAX's devices are {devices})", file=sys.stderr)
        return 1
    card = card_identity()
    print(f"card: {card}", flush=True)
    configure_runtime(default_x64=False)
    device = measure_device(args.ab, args.trace)

    baseline = measure_baseline()
    value = device["batched_samples_per_sec"]
    d = devices[0]
    record = {
        "metric": "mgmc_samples_per_sec",
        "value": value,
        "unit": "samples/s",
        "vs_baseline": value / baseline["samples_per_sec"],
        "device": {"platform": d.platform, "kind": d.device_kind, "count": len(devices)},
        "card": card,
        "detail": {
            "problem": f"2d {NX}x{NX} posterior, {NLEVEL}-level W-cycle MGMC, SOR, float32",
            "gpu": device,
            "baseline_cpu": baseline,
        },
    }
    print(json.dumps(record))
    return 0


if __name__ == "__main__":
    sys.exit(main())
