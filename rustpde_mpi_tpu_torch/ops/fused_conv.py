"""The fused convection chain of the Navier step, on a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_conv.py``.  For one
convected field ``vhat`` in an input space and the physical convection
velocities ``ux``, ``uy``:

    dvdx  = Gx1 @ vhat @ Gy0^T,   dvdy = Gx0 @ vhat @ Gy1^T
    total = ux * (dvdx + bcdx) + uy * (dvdy + bcdy)      (bc terms optional)
    out   = Fx @ total @ Fy^T   on the 2/3-rule kept block, zero elsewhere

which is the dealiased ``u . grad(v)`` in the scratch space's spectral
storage.  On a CUDA tensor :meth:`FusedConv.apply` runs the hand-written
kernels of ``csrc/fused_conv.cu`` (four launches, three of them of the
generic GEMM of ``csrc/fused_stage.cu``; see fused_conv.cu) and adds
one to ``FusedConv.launches``; on a CPU tensor it runs
:meth:`FusedConv.plain`.  Any other device raises.
"""

from __future__ import annotations

import torch

from ..config import to_device
from . import _build


class FusedConv:
    """The fused convection chain for one (input space, scratch space)
    pair on the spaces' device and dtype."""

    def __init__(self, space_in, field_space, scale):
        if space_in.shape_physical != field_space.shape_physical:
            raise ValueError("conv spaces must share the physical grid")
        if (space_in.device, space_in.dtype) != (field_space.device, field_space.dtype):
            raise ValueError("conv spaces must share device and dtype")
        self.device, self.dtype = space_in.device, space_in.dtype
        self.scale = tuple(scale)
        bx_in, by_in = space_in.bases
        fx_b, fy_b = field_space.bases
        gx1 = bx_in.axis_operator(("bwd_grad", 1)).matrix / self.scale[0]
        gx0 = bx_in.axis_operator("bwd").matrix
        gy1 = by_in.axis_operator(("bwd_grad", 1)).matrix / self.scale[1]
        gy0 = by_in.axis_operator("bwd").matrix
        op_fx = fx_b.axis_operator("fwd_cut")
        op_fy = fy_b.axis_operator("fwd_cut")
        # natural order: the kept rows are the leading prefix
        self.kx, self.ky = op_fx.dealias_rows, op_fy.dealias_rows
        self.nx, self.ny = space_in.shape_physical
        self.mx, self.my = gx0.shape[1], gy0.shape[1]
        self.out_shape = field_space.shape_spectral
        def put(m):
            return to_device(m, self.device, self.dtype)

        self.gx1, self.gx0 = put(gx1), put(gx0)
        self.gy0t, self.gy1t = put(gy0.T), put(gy1.T)
        self.fx = put(op_fx.matrix[: self.kx])
        self.fyt = put(op_fy.matrix[: self.ky].T)
        #: kernel applications on CUDA tensors (each is 4 grid launches)
        self.launches = 0

    # -- accounting -------------------------------------------------------

    @property
    def flops(self) -> float:
        """Multiply-add flops (2 per FMA) of one application, as the JAX
        package's ``FusedConv.flops``."""
        syn = 2.0 * self.nx * self.mx * self.my * 2 + 2.0 * self.nx * self.my * self.ny * 2
        fwd = 2.0 * self.nx * self.ny * self.ky + 2.0 * self.kx * self.nx * self.ky
        return syn + fwd

    def bytes_moved(self, with_bc: bool) -> float:
        """Bytes one application must move at least: operator matrices and
        inputs read once, the spectral output written once."""
        mats = sum(m.numel() for m in (self.gx1, self.gx0, self.gy0t, self.gy1t, self.fx, self.fyt))
        phys = self.nx * self.ny * (4 if with_bc else 2)
        n = mats + phys + self.mx * self.my + self.out_shape[0] * self.out_shape[1]
        return float(n) * torch.finfo(self.dtype).bits / 8

    # -- the chain --------------------------------------------------------

    def _check(self, ux, uy, vhat, bc_dx, bc_dy) -> None:
        if (bc_dx is None) != (bc_dy is None):
            raise ValueError("pass both bc derivative fields or neither")
        args = [("ux", ux, (self.nx, self.ny)), ("uy", uy, (self.nx, self.ny)),
                ("vhat", vhat, (self.mx, self.my))]
        if bc_dx is not None:
            args += [("bc_dx", bc_dx, (self.nx, self.ny)), ("bc_dy", bc_dy, (self.nx, self.ny))]
        for name, x, shape in args:
            if x.device != self.device or x.dtype != self.dtype:
                raise ValueError(f"conv input {name}: {x.dtype} on {x.device}, "
                                 f"expected {self.dtype} on {self.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"conv input {name}: shape {tuple(x.shape)}, expected {shape}")

    def apply(self, ux, uy, vhat, bc_dx=None, bc_dy=None) -> torch.Tensor:
        """The dealiased convection term: the CUDA kernels on a CUDA device,
        the plain chain on the CPU."""
        self._check(ux, uy, vhat, bc_dx, bc_dy)
        if self.device.type == "cpu":
            return self.plain(ux, uy, vhat, bc_dx, bc_dy)
        if self.device.type != "cuda":
            raise RuntimeError(f"no fused-conv kernel for device {self.device}")
        bcs = (None, None) if bc_dx is None else (bc_dx.contiguous(), bc_dy.contiguous())
        out = self._launch(ux.contiguous(), uy.contiguous(), vhat.contiguous(), *bcs)
        self.launches += 1
        return out

    def plain(self, ux, uy, vhat, bc_dx=None, bc_dy=None) -> torch.Tensor:
        """The same chain in plain ``torch.matmul`` (the CPU path and the
        kernel's yardstick)."""
        dvdx = torch.matmul(torch.matmul(self.gx1, vhat), self.gy0t)
        dvdy = torch.matmul(torch.matmul(self.gx0, vhat), self.gy1t)
        if bc_dx is not None:
            dvdx = dvdx + bc_dx
            dvdy = dvdy + bc_dy
        total = ux * dvdx + uy * dvdy
        out = torch.zeros(self.out_shape, device=self.device, dtype=self.dtype)
        out[: self.kx, : self.ky] = torch.matmul(self.fx, torch.matmul(total, self.fyt))
        return out

    def _launch(self, ux, uy, vhat, bc_dx, bc_dy) -> torch.Tensor:
        lib = _build.load("fused_conv")
        gemm = _build.gemm(self.dtype)
        dual = lib.rp_conv_dual_f64 if self.dtype == torch.float64 else lib.rp_conv_dual_f32
        kw = dict(device=self.device, dtype=self.dtype)
        nx, ny, my = self.nx, self.ny, self.my
        # 1. A1 = Gx1 @ vhat, A0 = Gx0 @ vhat in one grid
        a1 = torch.empty((nx, my), **kw)
        a0 = torch.empty((nx, my), **kw)
        _build.launch_jobs(gemm, [
            _build.job(a1, [(self.gx1, vhat)], M=nx, N=my),
            _build.job(a0, [(self.gx0, vhat)], M=nx, N=my),
        ], self.device)
        # 2. total = ux*(A1 @ Gy0^T + bcdx) + uy*(A0 @ Gy1^T + bcdy)
        total = torch.empty((nx, ny), **kw)
        bcx = None if bc_dx is None else bc_dx.data_ptr()
        bcy = None if bc_dy is None else bc_dy.data_ptr()
        _build.check(dual(nx, ny, my, a1.data_ptr(), a0.data_ptr(), my,
                          self.gy0t.data_ptr(), self.gy1t.data_ptr(), ny,
                          ux.data_ptr(), uy.data_ptr(), bcx, bcy, ny,
                          total.data_ptr(), ny, _build.stream_handle(self.device)),
                     dual.__name__)
        # 3. T = total @ Fy^T (kept columns)
        t = torch.empty((nx, self.ky), **kw)
        _build.launch_jobs(gemm, [_build.job(t, [(total, self.fyt)], M=nx, N=self.ky)],
                           self.device)
        # 4. out = Fx @ T on the kept block, zeros over the rest
        out = torch.empty(self.out_shape, **kw)
        _build.launch_jobs(gemm, [_build.job(
            out, [(self.fx, t)], M=self.kx, N=self.ky,
            Mout=self.out_shape[0], Nout=self.out_shape[1])], self.device)
        return out


def build_model_convs(model) -> dict:
    """``{id(space): FusedConv}`` for a Navier2D model's convection spaces
    (velx/vely share one space object; temp has its own), so the step's
    ``conv`` routes by identity."""
    specs: dict[int, FusedConv] = {}
    for space in (model.velx_space, model.temp_space):
        if id(space) not in specs:
            specs[id(space)] = FusedConv(space, model.field_space, model.scale)
    return specs
