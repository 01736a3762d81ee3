"""The fused convection chain of the Navier step, on a CUDA kernel.

Counterpart of the JAX package's ``ops/pallas_conv.py``.  For one
convected field ``vhat`` in an input space and the physical convection
velocities ``ux``, ``uy``:

    dvdx  = Gx1 @ vhat @ Gy0^T,   dvdy = Gx0 @ vhat @ Gy1^T
    total = ux * (dvdx + bcdx) + uy * (dvdy + bcdy)      (bc terms optional)
    out   = Fx @ total @ Fy^T   on the 2/3-rule kept block, zero elsewhere

which is the dealiased ``u . grad(v)`` in the scratch space's spectral
storage.

On a periodic space (a Fourier r2c x axis) ``vhat`` and the output are
complex: the kernels take the x operators in their split Re/Im form
(``Base.axis_operator``), ``vhat`` stacked as ``[Re; Im]`` real rows, and
the forward's kept rows ``[0:kc]`` (Re) and ``[m:m+kc]`` (Im) compacted to
``[0:kc] + [kc:2kc]``; the complex modes are reassembled from the two
halves on the way out, as the JAX kernel's wrapper does
(``pallas_conv.py:284-316``).  The stacking and the reassembly are one
copy each a launch.

``ux``, ``uy`` and ``vhat`` may carry a leading member dim (an ensemble of
K states of one model): the chain then runs for every member, the operator
matrices and the BC gradients shared, each of the four launches serving all
K members (the JAX package's ``jax.vmap`` over ``pallas_call``), and the
stacking and the reassembly stay one copy each for all members.

On a CUDA tensor :meth:`FusedConv.apply` runs the hand-written
kernels of ``csrc/fused_conv.cu`` (four launches, three of them of the
generic GEMM of ``csrc/fused_stage.cu``; see fused_conv.cu) and adds
one to ``FusedConv.launches``; on a CPU tensor it runs
:meth:`FusedConv.plain`.  Any other device raises.  As in
``ops/fused_step.py``, the operator constants and the scratch keep their
rows on 16-byte boundaries.
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
        #: vhat and the output are complex (a Fourier r2c x axis)
        self.complex = space_in.spectral_is_complex
        if field_space.spectral_is_complex != self.complex:
            raise ValueError("mixed complex/real x-axes are unsupported")
        gx1 = bx_in.axis_operator(("bwd_grad", 1)).matrix / self.scale[0]
        gx0 = bx_in.axis_operator("bwd").matrix
        gy1 = by_in.axis_operator(("bwd_grad", 1)).matrix / self.scale[1]
        gy0 = by_in.axis_operator("bwd").matrix
        op_fx = fx_b.axis_operator("fwd_cut")
        op_fy = fy_b.axis_operator("fwd_cut")
        # the kept rows: a leading prefix in natural order, [0:kc] and
        # [m:m+kc] of a split axis (both parts compacted to 2 kc rows)
        kept_x = op_fx.kept_rows
        self.kx, self.ky = len(kept_x), op_fy.dealias_rows
        self.nx, self.ny = space_in.shape_physical
        self.mx, self.my = gx0.shape[1], gy0.shape[1]
        self.out_shape = field_space.shape_spectral
        self.out_dtype = field_space.spectral_dtype
        def put(m):
            return _build.aligned(to_device(m, self.device, self.dtype))

        self.gx1, self.gx0 = put(gx1), put(gx0)
        self.gy0t, self.gy1t = put(gy0.T), put(gy1.T)
        self.fx = put(op_fx.matrix[kept_x])
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

    def bytes_moved(self, with_bc: bool, members: int = 1) -> float:
        """Bytes one application to ``members`` members must move at least:
        operator matrices (and the BC gradients) read once, each member's
        inputs read once and its spectral output written once (a complex
        one as its real and imaginary parts)."""
        mats = sum(m.numel() for m in (self.gx1, self.gx0, self.gy0t, self.gy1t, self.fx, self.fyt))
        phys = self.nx * self.ny * (2 * members + (2 if with_bc else 0))
        out = self.out_shape[0] * self.out_shape[1] * (2 if self.complex else 1)
        n = mats + phys + members * (self.mx * self.my + out)
        return float(n) * torch.finfo(self.dtype).bits / 8

    # -- the chain --------------------------------------------------------

    def _check(self, ux, uy, vhat, bc_dx, bc_dy) -> tuple:
        """Validate the inputs; returns the leading member shape of ``ux``,
        ``uy`` and ``vhat`` (``()`` or ``(K,)``; the BC gradients are
        shared)."""
        if (bc_dx is None) != (bc_dy is None):
            raise ValueError("pass both bc derivative fields or neither")
        lead = tuple(vhat.shape[:-2])
        if len(lead) > 1:
            raise ValueError(f"conv input vhat: at most one member dim, got shape "
                             f"{tuple(vhat.shape)}")
        mx = self.mx // 2 if self.complex else self.mx
        args = [("ux", ux, lead + (self.nx, self.ny)), ("uy", uy, lead + (self.nx, self.ny)),
                ("vhat", vhat, lead + (mx, self.my))]
        if bc_dx is not None:
            args += [("bc_dx", bc_dx, (self.nx, self.ny)), ("bc_dy", bc_dy, (self.nx, self.ny))]
        for name, x, shape in args:
            want = self.out_dtype if name == "vhat" else self.dtype
            if x.device != self.device or x.dtype != want:
                raise ValueError(f"conv input {name}: {x.dtype} on {x.device}, "
                                 f"expected {want} on {self.device}")
            if tuple(x.shape) != shape:
                raise ValueError(f"conv input {name}: shape {tuple(x.shape)}, expected {shape}")
        return lead

    def apply(self, ux, uy, vhat, bc_dx=None, bc_dy=None) -> torch.Tensor:
        """The dealiased convection term: the CUDA kernels on a CUDA device,
        the plain chain on the CPU; member-stacked inputs run every member,
        each launch serving all of them."""
        lead = self._check(ux, uy, vhat, bc_dx, bc_dy)
        if self.device.type == "cpu":
            return self.plain(ux, uy, vhat, bc_dx, bc_dy)
        if self.device.type != "cuda":
            raise RuntimeError(f"no fused-conv kernel for device {self.device}")
        bcs = (None, None) if bc_dx is None else (bc_dx.contiguous(), bc_dy.contiguous())
        out = self._launch(ux.contiguous(), uy.contiguous(), self._stack(vhat), *bcs, lead=lead)
        self.launches += 1
        return out

    def plain(self, ux, uy, vhat, bc_dx=None, bc_dy=None) -> torch.Tensor:
        """The same chain in plain ``torch.matmul`` (the CPU path and the
        kernel's yardstick)."""
        vhat = self._stack(vhat)
        dvdx = torch.matmul(torch.matmul(self.gx1, vhat), self.gy0t)
        dvdy = torch.matmul(torch.matmul(self.gx0, vhat), self.gy1t)
        if bc_dx is not None:
            dvdx = dvdx + bc_dx
            dvdy = dvdy + bc_dy
        total = ux * dvdx + uy * dvdy
        return self._unstack(torch.matmul(self.fx, torch.matmul(total, self.fyt)))

    def _stack(self, vhat) -> torch.Tensor:
        """The kernels' real input: ``vhat`` itself, or a complex one's
        ``[Re; Im]`` rows in one row-aligned copy."""
        return _build.stack_planes(vhat) if self.complex else vhat.contiguous()

    def _unstack(self, kept) -> torch.Tensor:
        """The output from the kept block ``kept`` (kx x ky real rows; a
        complex output's Re rows then Im rows; a member dim in front),
        zero elsewhere."""
        lead = tuple(kept.shape[:-2])
        out = torch.zeros(lead + tuple(self.out_shape), device=self.device, dtype=self.out_dtype)
        if self.complex:
            kc = self.kx // 2
            torch.view_as_real(out)[..., :kc, : self.ky, :].copy_(
                kept.view(*lead, 2, kc, self.ky).movedim(-3, -1))
        else:
            out[..., : self.kx, : self.ky] = kept
        return out

    def _launch(self, ux, uy, vhat, bc_dx, bc_dy, lead=()) -> torch.Tensor:
        """The chain's four launches; ``lead`` is ``(K,)`` for K members
        (every scratch and the output carry the member dim)."""
        lib = _build.load("fused_conv")
        gemm = _build.gemm(self.dtype)
        dual = lib.rp_conv_dual_f64 if self.dtype == torch.float64 else lib.rp_conv_dual_f32
        kw = dict(device=self.device, dtype=self.dtype)
        nx, ny, my = self.nx, self.ny, self.my
        k = lead[0] if lead else 1
        dev = self.device
        # 1. A1 = Gx1 @ vhat, A0 = Gx0 @ vhat in one grid
        a1 = _build.padded(*lead, nx, my, **kw)
        a0 = _build.padded(*lead, nx, my, **kw)
        _build.launch_jobs(gemm, [
            _build.job(a1, [(self.gx1, vhat)], M=nx, N=my, members=k),
            _build.job(a0, [(self.gx0, vhat)], M=nx, N=my, members=k),
        ], dev, k)
        # 2. total = ux*(A1 @ Gy0^T + bcdx) + uy*(A0 @ Gy1^T + bcdy)
        total = _build.padded(*lead, nx, ny, **kw)
        bcx = None if bc_dx is None else bc_dx.data_ptr()
        bcy = None if bc_dy is None else bc_dy.data_ptr()
        vec = _build.rows_aligned(a1, a0) | _build.rows_aligned(self.gy0t, self.gy1t) << 1
        strides = [x.stride(0) if lead else 0 for x in (a1, ux, total)]
        if lead and (a0.stride(0) != strides[0] or uy.stride(0) != strides[1]):
            raise ValueError("conv operands of one member stride expected")
        _build.call(dual, dev, nx, ny, my, a1.data_ptr(), a0.data_ptr(), a1.stride(-2),
                    self.gy0t.data_ptr(), self.gy1t.data_ptr(), self.gy0t.stride(0),
                    ux.data_ptr(), uy.data_ptr(), bcx, bcy, ny,
                    total.data_ptr(), total.stride(-2), vec, k, *strides)
        # 3. T = total @ Fy^T (kept columns)
        t = _build.padded(*lead, nx, self.ky, **kw)
        _build.launch_jobs(gemm, [_build.job(t, [(total, self.fyt)], M=nx, N=self.ky,
                                             members=k)], dev, k)
        # 4. out = Fx @ T on the kept block, zeros over the rest (a complex
        # output is reassembled from the kept block's two halves)
        if self.complex:
            kept = torch.empty((*lead, self.kx, self.ky), **kw)
            _build.launch_jobs(gemm, [_build.job(kept, [(self.fx, t)], M=self.kx, N=self.ky,
                                                 members=k)], dev, k)
            return self._unstack(kept)
        out = torch.empty((*lead, *self.out_shape), **kw)
        _build.launch_jobs(gemm, [_build.job(
            out, [(self.fx, t)], M=self.kx, N=self.ky,
            Mout=self.out_shape[0], Nout=self.out_shape[1], members=k)], dev, k)
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
