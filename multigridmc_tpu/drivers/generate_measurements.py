"""Generate a random measurement configuration file.

Counterpart of ``python/generate_measurements.py``: draws random,
well-separated measurement locations in the unit square/cube (plus one sample
location), random measured means and variances, and emits them in libconfig
syntax compatible with :mod:`multigridmc_tpu.utils.config` and the reference's
``measurements_template.cfg`` (cf. ``generate_measurements.py:98-157``).

Usage: ``python -m multigridmc_tpu.drivers.generate_measurements --dim 2 --nmeas 8``
"""

from __future__ import annotations

import argparse

import numpy as np


def distance_boundary(x: np.ndarray) -> float:
    """Distance from a point to the domain boundary
    (cf. ``generate_measurements.py:44-47``)."""
    return float(np.minimum(np.abs(x), np.abs(1.0 - x)).min())


def sample_points(n: int, dim: int, dmin: float = 0.1, seed: int = 2154157) -> np.ndarray:
    """Random points in [0,1]^d, pairwise (and boundary) separated by dmin
    (cf. ``generate_measurements.py:50-70``)."""
    rng = np.random.default_rng(seed=seed)
    points: list[np.ndarray] = []
    attempts = 0
    while len(points) < n:
        attempts += 1
        if attempts > 100000:
            raise RuntimeError("cannot place points with requested separation")
        p = rng.uniform(low=0, high=1, size=dim)
        if distance_boundary(p) < 0.5 * dmin:
            continue
        if any(np.linalg.norm(p - q) < dmin for q in points):
            continue
        points.append(p)
    return np.asarray(points)


def average(n: int, mu_low: float, mu_high: float, seed: int = 2511541) -> np.ndarray:
    rng = np.random.default_rng(seed=seed + 1)
    return rng.uniform(low=mu_low, high=mu_high, size=n)


def variance(n: int, sigma_low: float, sigma_high: float, seed: int = 2511541) -> np.ndarray:
    rng = np.random.default_rng(seed=seed)
    return rng.uniform(low=sigma_low, high=sigma_high, size=n)


def format_config(dim, nmeas, locations, sample_location, mean, var) -> str:
    def fmt(a):
        return "[" + ", ".join(repr(float(v)) for v in np.asarray(a).flatten()) + "]"

    lines = [
        f"dim =  {dim} ;",
        f"n =  {nmeas};",
        f"measurement_locations =  {fmt(locations)} ;",
        f"sample_location =  {fmt(sample_location)} ;",
        f"mean =  {fmt(mean)} ;",
        f"variance =  {fmt(var)} ;",
    ]
    return "\n".join(lines) + "\n"


def main(argv=None):
    parser = argparse.ArgumentParser("Generate measurement configuration")
    parser.add_argument("--dim", type=int, default=2, choices=[2, 3])
    parser.add_argument("--nmeas", type=int, default=8)
    parser.add_argument("--dmin", type=float, default=0.2)
    parser.add_argument("--seed", type=int, default=2154157)
    parser.add_argument("--output", type=str, default=None, help="write to file instead of stdout")
    args = parser.parse_args(argv)

    p = sample_points(args.nmeas + 1, args.dim, args.dmin, args.seed)
    mean = average(args.nmeas, 1.0, 4.0)
    var = variance(args.nmeas, 1e-6, 2e-6)
    text = format_config(args.dim, args.nmeas, p[:-1], p[-1], mean, var)
    if args.output:
        with open(args.output, "w") as fh:
            fh.write(text)
    else:
        print(text, end="")


if __name__ == "__main__":
    main()
