"""XDMF sidecar generator for ParaView visualization of HDF5 snapshots
(counterpart of the JAX package's ``tools/xdmf.py``, host-only, needing
``h5py``).

For every snapshot in a directory (sorted by the stored ``time`` scalar)
write an ``xmf######.xmf`` XML sidecar describing a curvilinear 2-D mesh plus
node-centered scalar attributes, and one shared ``cartesian.nc`` holding the
2-D meshgrid coordinates.  ParaView opens the .xmf files directly.

Coordinate lookup prefers the snapshot layout (per-variable groups, e.g.
``temp/x``) and falls back to top-level ``x``/``y`` datasets.
"""

from __future__ import annotations

import os
from typing import Sequence

import numpy as np


def sorted_h5_files(root: str) -> list[tuple[float, str]]:
    """(time, path) for every .h5 in ``root``, sorted by the stored time
    scalar (files without one sort as time 0)."""
    import h5py

    out = []
    for name in os.listdir(root):
        if not name.endswith(".h5"):
            continue
        path = os.path.join(root, name)
        t = 0.0
        try:
            with h5py.File(path, "r") as f:
                if "time" in f:
                    t = float(np.asarray(f["time"]))
        except OSError:
            continue
        out.append((t, path))
    out.sort(key=lambda p: p[0])
    return out


def _read_coords(path: str, attrs: Sequence[str]):
    import h5py

    with h5py.File(path, "r") as f:
        for g in (*attrs, None):
            xkey = f"{g}/x" if g else "x"
            ykey = f"{g}/y" if g else "y"
            if xkey in f and ykey in f:
                return np.asarray(f[xkey]), np.asarray(f[ykey])
        raise KeyError(f"no coordinate datasets found in {path}")


def _read_time(path: str):
    import h5py

    with h5py.File(path, "r") as f:
        return float(np.asarray(f["time"])) if "time" in f else None


class XdmfWriter:
    """One snapshot -> one .xmf sidecar."""

    def __init__(
        self,
        fname: str,
        attrs: Sequence[str],
        variables: Sequence[str],
        xmfname: str | None = None,
    ):
        self.fname = fname
        self.attrs = list(attrs)
        self.variables = list(variables)
        x, y = _read_coords(fname, self.attrs)
        self.x, self.y = x, y
        self.nx, self.ny = x.size, y.size
        parent = os.path.dirname(fname)
        self.cname = os.path.join(parent, "cartesian.nc") if parent else "cartesian.nc"
        self.time = _read_time(fname)
        if xmfname is None:
            xmfname = (
                fname[:-3] + ".xmf" if fname.endswith(".h5") else "default.xmf"
            )
        self.xmfname = xmfname

    def create_cartesian(self, overwrite: bool = False) -> None:
        """Write the shared 2-D meshgrid file."""
        import h5py

        if not overwrite and os.path.exists(self.cname):
            return
        xx, yy = np.meshgrid(self.x, self.y, indexing="ij")
        with h5py.File(self.cname, "w") as f:
            f.create_dataset("x", data=xx)
            f.create_dataset("y", data=yy)

    def _geometry(self) -> str:
        cname = os.path.basename(self.cname)
        dims = f"{self.nx:6d}{self.ny:6d}"
        lines = ['<Geometry GeometryType="X_Y">']
        for axis in ("x", "y"):
            lines.append(
                f'<DataItem Dimensions="{dims}" NumberType="Float" '
                f'Precision="4" Format="HDF">{cname}:/{axis}</DataItem>'
            )
        lines.append("</Geometry>")
        return "\n".join(lines) + "\n"

    def _attribute(self, aname: str, vname: str) -> str:
        fname = os.path.basename(self.fname)
        dims = f"{self.nx:6d}{self.ny:6d}"
        return (
            self._geometry()
            + f'<Attribute Name="{aname}" AttributeType="Scalar" Center="Node">\n'
            + f'<DataItem Dimensions="{dims}" NumberType="Float" '
            + f'Precision="4" Format="HDF">{fname}:/{vname}</DataItem>\n'
            + "</Attribute>\n"
        )

    def write(self) -> None:
        with open(self.xmfname, "w") as f:
            f.write('<?xml version="1.0" ?>\n')
            f.write('<!DOCTYPE Xdmf SYSTEM "Xdmf.dtd" []>\n')
            f.write('<Xdmf Version="2.0">\n<Domain>\n')
            f.write('<Grid Name="Box" GridType="Uniform">\n')
            f.write(
                f'<Topology TopologyType="3DSMesh" '
                f'NumberOfElements="{self.nx:6d}{self.ny:6d}"/>\n'
            )
            for aname, vname in zip(self.attrs, self.variables):
                f.write(self._attribute(aname, vname))
            t = self.time if self.time is not None else 0.0
            f.write(f'<Time Value=" {t:12.10}" />\n')
            f.write("</Grid>\n</Domain>\n</Xdmf>\n")


def create_xmf(
    root: str,
    attrs: Sequence[str] = ("temp", "ux", "uy", "pres"),
    variables: Sequence[str] = ("temp/v", "ux/v", "uy/v", "pres/v"),
) -> list[str]:
    """Generate xmf sidecars for every snapshot under ``root``; returns the
    list of files written."""
    written = []
    for i, (_, path) in enumerate(sorted_h5_files(root)):
        xmfname = os.path.join(root, f"xmf{i:06d}.xmf")
        w = XdmfWriter(path, attrs, variables, xmfname)
        w.create_cartesian(overwrite=False)
        w.write()
        written.append(xmfname)
        print(f"Created xmf for {path} => {xmfname}")
    return written
