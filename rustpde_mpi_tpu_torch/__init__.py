"""rustpde_mpi_tpu_torch — the PyTorch/CUDA port of rustpde_mpi_tpu.

A second package beside the JAX one, held against it by the tests.  It
ports the convection DNS step of ``Navier2D``, with Rayleigh-Benard
(``"rbc"``) or horizontal-convection (``"hc"``) boundary conditions, in
the confined cell (Chebyshev x Chebyshev) and the horizontally periodic
one (Fourier r2c x Chebyshev, ``periodic=True``), on both of the JAX
package's routes: the fused route (the convection chain and the
implicit stages as kernels) and the default, dense route on the solver
objects (``HholtzAdi``, ``Poisson``, ``Hholtz``), whose banded
substitutions run as a kernel.  The kernels are hand-written CUDA for
Hopper (``csrc/``, built with ``nvcc`` at first use), with plain PyTorch
versions on the CPU.

Entry points run on the CUDA card unless the caller passes
``device="cpu"``::

    from rustpde_mpi_tpu_torch import Navier2D, integrate, make_mesh

    model = Navier2D.new_confined(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc")
    integrate(model, 1.0, 0.1)
    dense = Navier2D.new_confined(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc",
                                  step_kernel="dense", conv_kernel="dense")
    meshed = Navier2D.new_confined(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc",
                                   mesh=make_mesh(4))
    periodic = Navier2D.new_periodic(128, 129, 1e5, 1.0, 1e-2, 1.0, "hc",
                                     mesh=make_mesh(4))

The linearised and perturbation models ``Navier2DLnse`` and
``Navier2DNonLin`` (about a ``MeanFields`` base state, with the hand
adjoint ``grad_adjoint``, ``grad_autodiff`` through the banded kernel's
backward, and ``grad_fd``) run on the dense and meshed routes, and the
steady-state finder ``Navier2DAdjoint`` on every route; all three run as
``NavierEnsemble`` templates, built through ``workloads.build_model``::

    lnse = Navier2DLnse(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc",
                        mean=MeanFields.new_rbc(129, 129))
    ens = build_steady_ensemble(nx=33, ny=33, ra=1e4, k=2)

The meshed model runs the dense route on fields split over 4 ranks of one
card (:mod:`.parallel`), in either cell, every pencil flip (of real or
complex pencils) through a hand-written CUDA transpose kernel.  Fourier axes transform on ``torch.fft``; Chebyshev axes
by dense products or by FFT (``method="matmul"|"fft"``).

Solid obstacles (``set_solid`` with the ``solid_*`` mask builders, a
Brinkman penalization after each step) and the scenario modifiers
(``scenario=ScenarioConfig(coriolis=..., passive_scalar=...,
scalar_kappa=...)``: the f-plane Coriolis terms, a passive scalar ``scal``
with its Sherwood number) run on every route::

    model = Navier2D.new_confined(129, 129, 1e5, 1.0, 1e-2, 1.0, "rbc",
                                  scenario=ScenarioConfig(coriolis=2.0,
                                                          passive_scalar=True))
    model.set_solid(*solid_roughness_sinusoid(*model.x, 0.1, 10.0))

``NavierEnsemble`` steps K member states of one model together, every
kernel launch of a step serving all K members (the JAX package's vmapped
ensemble), on every route; ``geometry_sweep`` runs K obstacle geometries
as one ensemble::

    ens = NavierEnsemble.from_seeds(model, range(8))
    ens.update_n(50)
    nu = ens.eval_nu()          # shape (8,)

``update_n`` steps in the JAX package's chunks: a chunk freezes at the
first step whose state is not finite, and with ``set_stability(
StabilityConfig())`` it carries the CFL, kinetic-energy and |div|
sentinels and rolls back on a CFL-ceiling trip (``ChunkStatus``).  On the
card every step of a chunk replays one captured CUDA graph.
``set_stats(StatsConfig(stride=16))`` carries the in-scan statistics
(running averages, profiles, spectra, budget residuals) through the chunks
(``stats_summary``, ``export_stats``); ``set_dt`` changes the step size
with a per-rung cache, which ``StabilityGovernor`` drives on a
``DtLadder``::

    model.set_stats(StatsConfig())
    gov = StabilityGovernor(StabilityConfig(), model.dt)
    model.set_stability(gov.cfg)
    decision = gov.on_chunk(model.update_n(100))
    if decision.action in ("retry", "adjust"):
        model.set_dt(decision.dt)
        model.clear_pre_divergence()

``integrate(model, t, dt_save, overlap=True)`` checks the break criterion
one chunk late from a future (``exit_future``), so the host never waits on
the card at a boundary; an attached ``IOPipeline`` (``IOConfig().pipeline()``)
writes the callback's snapshots on a background worker and prints its
lines from futures.  ``set_integrity(IntegrityConfig())`` arms the
on-device state digests (``state_digest_async``, equal bit for bit to the
JAX package's) and the shadow audits (``shadow_digest_async``)::

    model.io_pipeline = IOConfig().pipeline()
    integrate(model, 1.0, 0.1, overlap=True)
    model.io_pipeline.drain()

The Swift-Hohenberg models run on ``Space1`` and ``BiPeriodicSpace2``::

    sh = SwiftHohenberg2D(2048, 2048, r=0.35, dt=0.02, length=20.0)
    sh.update_n(128)
    sh.pattern_energy()

``ResilientRunner`` keeps a long run alive: rolling checkpoints and
auto-resume, checkpoint-then-exit on SIGTERM, NaN rollback with dt
backoff, the governor, the integrity audits, the dispatch watchdog and
deterministic fault injection (``fault="nan@100"``); ``telemetry`` holds
the metrics, the exporters, the flight recorder and the compile log, and
``eigenmode_sweep``/``steady_state_find`` run their campaigns under the
runner::

    runner = ResilientRunner(model, max_time=1.0, save_intervall=0.1,
                             run_dir="data/run1", checkpoint_every_s=300)
    summary = runner.run()     # resumes when run1 holds checkpoints

Several processes run as one job on ``torch.distributed`` (gloo, host
objects only; ``parallel.multihost``): each holds its own model on its own
card, the root decides every flag that leads into a collective, and the
runner writes sharded two-phase checkpoints that restore onto any mesh;
``parallel.sanitizer`` catches a collective sequence that went out of
step (``CollectiveDesyncError``).  Or one model spans them, each process
holding some ranks of ``multihost.global_pencil_mesh``, on one host (its
flips through CUDA IPC) or several (through pinned host memory and a
socket between hosts; ``initialize_distributed``'s ``host=`` declares
processes of one machine on different hosts)::

    multihost.initialize_distributed("localhost:29500", 2, rank)
    summary = ResilientRunner(model, 1.0, 0.1, run_dir="data/mp").run()

``SimServer`` serves simulation requests from a durable queue as
continuously batched ensemble campaigns (``serve``; its fleet of
replicas, proxies, leases and the autoscaler in ``serve.fleet``)::

    from rustpde_mpi_tpu_torch.config import ServeConfig

    server = SimServer(ServeConfig(run_dir="data/serve", slots=8))
    server.submit({"ra": 1e7, "nx": 129, "ny": 129, "dt": 2e-3, "horizon": 1.0})
    summary = server.serve()
"""

from . import config  # noqa: F401  (import first: turns TF32 off)
from .config import (IntegrityConfig, IOConfig, NavierConfig, StabilityConfig,  # noqa: F401
                     StatsConfig)
from .bases import (Base, BaseKind, BiPeriodicSpace2, Space1, Space2, cheb_dirichlet,  # noqa: F401
                    cheb_dirichlet_neumann, cheb_neumann, chebyshev, fourier_c2c, fourier_r2c)
from .convert import state_from_numpy, state_to_numpy  # noqa: F401
from .field import Field1, Field2, average, average_axis, norm_l2  # noqa: F401
from .integrity import IntegrityError, QuarantineLedger, digest_tree  # noqa: F401
from .models.campaign import CampaignModelBase  # noqa: F401
from .models.boundary_conditions import (bc_hc_values, bc_rbc_values,  # noqa: F401
                                         bc_zero_values, pres_bc_rbc_values)
from .models.ensemble import NavierEnsemble  # noqa: F401
from .models.lnse import Navier2DLnse, Navier2DNonLin  # noqa: F401
from .models.meanfield import MeanFields  # noqa: F401
from .models.navier import Navier2D, NavierScalarState, NavierState  # noqa: F401
from .models.opt_routines import steepest_descent_energy_constrained  # noqa: F401
from .models.steady_adjoint import AdjointState, Navier2DAdjoint  # noqa: F401
from .models.statistics import Statistics  # noqa: F401
from .models.stats import StatsEngine, StatsState, export_stats  # noqa: F401
from .models.swift_hohenberg import SwiftHohenberg1D, SwiftHohenberg2D  # noqa: F401
from .models.solid_masks import (solid_cylinder_inner, solid_porosity,  # noqa: F401
                                 solid_porosity_interpolate, solid_rectangle,
                                 solid_roughness_sinusoid)
from .parallel import Decomp2d, Mesh, make_mesh  # noqa: F401
from .solver import FastDiag, Hholtz, HholtzAdi, Poisson, TensorSolver  # noqa: F401
from .utils.governor import (ChunkStatus, DtLadder, GovernorDecision, RunHealth,  # noqa: F401
                             StabilityGovernor)
from .utils.integrate import Integrate, integrate  # noqa: F401
from .utils.io_pipeline import AsyncWriteError, IOPipeline, ObservableFuture  # noqa: F401
from .utils.journal import JournalWriter, read_journal  # noqa: F401
from .utils.checkpoint import CheckpointError  # noqa: F401
from .utils.faults import FaultSpecError  # noqa: F401
from .utils.resilience import DispatchHang, DivergenceError, ResilientRunner  # noqa: F401
from .parallel.sanitizer import CollectiveDesyncError  # noqa: F401
from .serve import AdmissionError, RequestFailed, SimRequest, SimServer  # noqa: F401
from . import telemetry  # noqa: F401
from .telemetry import MetricsRegistry, ThroughputMonitor  # noqa: F401
from .utils.vorticity import (vorticity_auto, vorticity_from_file,  # noqa: F401
                              vorticity_from_file_periodic)
from .workloads import (ScenarioConfig, build_eigenmode_ensemble,  # noqa: F401
                        build_model, build_steady_ensemble, critical_rayleigh, eigenmode_sweep,
                        geometry_sweep, growth_rates, model_kinds, register_model_kind,
                        solo_ensemble_parity, steady_state_find, validate_campaign_model)

__version__ = "0.1.0"
