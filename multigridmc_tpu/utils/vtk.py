"""Legacy-ASCII VTK output of lattice fields.

Counterpart of ``src/auxilliary/vtk_writer{,2d,3d}.{hh,cc}``: writes
``STRUCTURED_POINTS`` datasets over the full vertex grid (boundary vertices
emitted as zero, origin shifted by -0.5 as in ``vtk_writer2d.cc:8-53`` /
``vtk_writer3d.cc:8-60``), plus the POLYDATA circle marker for the sample
location (``vtk_writer2d.cc:56-84``).
"""

from __future__ import annotations

from typing import Dict

import numpy as np

from ..lattice import Lattice


class VTKWriter:
    """Collects labelled grid fields and writes one legacy VTK file
    (cf. ``vtk_writer.hh:19-49``)."""

    def __init__(self, filename: str, lattice: Lattice, verbose: int = 0):
        if lattice.dim not in (2, 3):
            raise ValueError("VTK output supports 2d and 3d lattices only")
        self.filename = filename
        self.lattice = lattice
        self.verbose = verbose
        self.states: Dict[str, np.ndarray] = {}

    def add_state(self, field, label: str) -> None:
        self.states[label] = np.asarray(field).reshape(self.lattice.vshape)

    def write(self) -> None:
        lat = self.lattice
        shape = lat.shape  # (nx, ny[, nz])
        h = lat.h
        dims = [n + 1 for n in shape]
        with open(self.filename, "w") as out:
            out.write("# vtk DataFile Version 2.0\n")
            out.write("Sample state\n")
            out.write("ASCII\n")
            out.write("DATASET STRUCTURED_POINTS\n")
            if lat.dim == 2:
                out.write(f"DIMENSIONS {dims[0]} {dims[1]} 1 \n")
                out.write("ORIGIN -0.5 -0.5 0.0\n")
                out.write(f"SPACING {h[0]} {h[1]} 0\n")
            else:
                out.write(f"DIMENSIONS {dims[0]} {dims[1]} {dims[2]}\n")
                out.write("ORIGIN -0.5 -0.5 -5.0\n")
                out.write(f"SPACING {h[0]} {h[1]} {h[2]}\n")
            out.write("\n")
            out.write(f"POINT_DATA {int(np.prod(dims))}\n")
            for label, phi in self.states.items():
                if self.verbose > 0:
                    print(f"Writing {label}")
                out.write(f"SCALARS {label} double 1\n")
                out.write("LOOKUP_TABLE default\n")
                # full vertex grid incl. boundary zeros, x fastest
                full = np.zeros([n + 1 for n in reversed(shape)])
                full[(slice(1, -1),) * lat.dim] = phi
                data = full.reshape(-1)
                data = np.where(np.abs(data) < 1e-20, 0.0, data)
                out.write("\n".join(f"{v:.12g}" for v in data))
                out.write("\n")


def write_vtk_circle(centre, radius: float, filename: str, npoints: int = 100) -> None:
    """POLYDATA circle marker around the sample location
    (``vtk_writer2d.cc:56-84``)."""
    centre = np.asarray(centre, dtype=np.float64)
    z_offset = 1e-6
    with open(filename, "w") as out:
        out.write("# vtk DataFile Version 2.0\n")
        out.write("Sample state\n")
        out.write("ASCII\n")
        out.write("DATASET POLYDATA\n")
        out.write("\n")
        out.write(f"POINTS {npoints} double\n")
        for j in range(npoints):
            x = centre[0] + radius * np.cos(2 * np.pi * j / npoints) - 0.5
            y = centre[1] + radius * np.sin(2 * np.pi * j / npoints) - 0.5
            out.write(f"{x:g} {y:g} {z_offset:g}\n")
        out.write(f"POLYGONS 1 {npoints + 1}\n")
        out.write(str(npoints) + "".join(f" {j}" for j in range(npoints)) + "\n")
