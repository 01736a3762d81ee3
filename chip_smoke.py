#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA card.

Run from the root of a checkout, with no arguments::

    python3 chip_smoke.py

It builds the port's CUDA kernels from ``rustpde_mpi_tpu_torch/csrc`` with
``nvcc`` (sm_90a) and then, raising on the first failure, drives the fused
route of the step (``Navier2D``'s default) in phases 1-5 and the dense
route (``step_kernel="dense", conv_kernel="dense"``, the JAX package's
default step on its solver objects) in phases 6-11:

1. holds every fused kernel against its plain PyTorch version on the card:
   every stage instance and both convection variants at 129^2 and 1025^2
   in f64 (limit 1e-12 of max|plain|) and at 129^2 in f32 (limit 1e-4),
   and times the kernel, the plain version and the chain in the fewest
   cuBLAS calls PyTorch offers (``library_ms``) at 1025^2 f64 (each
   queued behind a GPU spin, and the kernel back to back too), with the
   kernel's achieved TFLOP/s and its share of the bound; a case over its
   limit runs the kernel and the plain version once more each and prints
   the three errors (which side moved) before it fails.  First it prints
   the block tiles of the two fused kernels (read from
   ``csrc/tile_gemm.cuh``); last, the convection chain's four launches are
   timed one by one (profiler) beside cuBLAS on the same products;
2. reruns the head of the f64 golden Nusselt trajectory of PARITY.json at
   129^2 through the kernels (rel 1e-6);
3. steps the same 129^2 model 10 steps on the card and on the CPU (plain
   versions) and compares the states (rel 1e-11);
4. drives the main path, the ``rbc1025`` configuration (1025^2, Ra=1e9,
   Pr=1, dt=1e-4, f64), for 50 steps through ``integrate`` (two save
   windows, each one ``Navier2D.update_n``, whose every step replays the
   step captured as a CUDA graph: the capture, its time and its memory
   are printed first), checks that every step launched 3 fused
   convection chains and 7 fused stages (counted over the replays), then
   times 50 more steps of bare ``update_n`` (ms/step) and checks the
   observables;
5. profiles 5 more steps (device time by kernel, device busy share, the
   host-idle share of the wall) and times the divergence freeze's own
   work (the finite check and the selects into the carry) alone;
6. holds the banded-substitution kernel against its plain version: every
   banded solve the dense step builds (ADI axes 0 and 1 with one factor
   set, the Poisson tensor solver's per-lane factors along axis 1, and the
   same factors along axis 0) at 129^2 (f64, f32) and 1025^2 (f64), same
   limits as phase 1 but relative to each lane's own scale, checks that
   each took the parity path (two chains a lane) and prints its tile, copy
   width and shared memory, and times the kernel (queued behind a GPU
   spin, so that the wrapped launch's host time stays out), the plain
   version and one ``torch.matmul`` with precomputed inverses
   (``library_ms``: the axis's dense inverse for one factor set, the batch
   of every lane's inverse for per-lane factors) at 1025^2 f64;
7. checks the confined manufactured solutions of the JAX package's
   ``examples/solve_hholtz.py`` (HholtzAdi, 257^2) and
   ``examples/solve_poisson.py`` (Poisson, Hholtz c=0.1, 65^2) on the card,
   with methods banded and dense/fd (tol 1e-6);
8. reruns the golden head of phase 2 on the dense route;
9. compares card and CPU after 10 dense-route steps at 129^2 (rel 1e-11);
10. drives ``rbc1025`` on the dense route as phase 4 does (exactly 7 banded
    launches a step) and profiles it as phase 5 does;
11. times one ``HholtzAdi.solve`` and one ``Poisson.solve`` at the
    ``rbc1025`` shapes with the banded recurrence and with dense/fd, queued
    and back to back;

and the meshed route, ``Navier2D(..., mesh=make_mesh(4))`` (the dense
step on fields split over 4 ranks that all live on the one card, every
pencil flip through the pencil-transpose kernel), in phases 12-13:

12. holds the pencil-transpose kernel bit for bit (tolerance 0: it is a
    copy) against its plain ring version in both directions at the
    ``rbc1025`` spectral (1023^2, padded to 1024^2) and physical (1025^2,
    padded to 1028^2) shapes in f64 and at 129^2 in f64 and f32, and at
    every pencil shape a meshed ``rbc1025`` step flips; times the kernel
    (cold L2: a 512 MB write before each launch, and behind a GPU spin so
    that the host's launch overhead stays out of the reading), its plain
    version and one ``.contiguous()`` of the permuted view
    (``library_ms``, cold L2 too) at each; and holds the banded kernel
    against its plain version at every input a meshed ``rbc1025`` step
    gives it (rank-stacked pencils, identity-padded systems, the Poisson
    solve's factor batch stride), logged from one step: on random values
    at phase 6's per-lane limit and on the step's own values at 1e-11 of
    the solve's scale (the routes' limit), checked for the parity path and
    timed as phase 6 times it (on random values, on them with the step's
    zero pad, and on the step's values) and with the L2 flushed, with the
    same library yardsticks built from the padded factors;
13. reruns the golden head on the mesh, compares meshed and serial dense
    steps on the card after 10 steps at 129^2 (rel 1e-11), drives
    ``rbc1025`` on the mesh as phase 4 does (exactly 37 flips and 7
    banded launches a step, and 10 flips for each of the two save-window
    callbacks' observables) and profiles it.

After the profile of each route (phases 5, 10 and 13), phase 14 holds the
chunk contract on that route's ``rbc1025`` model: ``update_n(10)`` through
the graph against 10 eager ``update()`` calls bit for bit; the divergence
freeze (a NaN in temp mode 0: ``step_n`` executes 1 step, ``update_n(7)``
steps once in each of its two buckets, the same non-finite entries and the
rest bit for bit against eager steps, ``exit()`` True); the stability
sentinels armed against the plain chunk bit for bit, with the
``ChunkStatus``; and one CFL spike rolled back, ``integrate`` stopping
with ``"break"``.

Then the horizontally periodic cell (Fourier r2c x Chebyshev, complex
state; the ``periodic1024`` configuration: 1024x1025, Ra=1e9, Pr=1,
dt=1e-4, f64), on the fused route and then the dense one:

15. holds the fused kernels (every stage, the L-less Poisson stage
    included, and both conv variants, on complex inputs) and the banded
    kernel (the ADI Chebyshev axis with one factor set and the Poisson
    solve with one set per Fourier mode, complex right-hand sides as real
    lanes) against their plain versions at the reference's periodic
    example size, 128x129, in f64 (1e-12) and f32 (1e-4), and at
    ``periodic1024`` f64, timed as phases 1 and 6 time them;
16. steps the example size (Ra=1e5, dt=0.01) 10 steps on each route on the
    card and on the CPU, and the fused route against the dense one on the
    card (rel 1e-11 of each field's scale);
18. drives ``periodic1024`` on each route as phase 4 does (exactly 3 conv
    and 7 stage launches a step on the fused route, 4 banded launches on
    the dense one), profiles it as phase 5 does, and holds the chunk gates
    of phase 14 on it;

Then the periodic cell on the mesh, and the
horizontal-convection (HC) boundary conditions (a cosine-heated bottom, an
insulated top: the temperature's y base is Dirichlet-Neumann, so its solve
runs the banded kernel's general path, one chain a lane):

19. ``periodic1024`` on the meshed route (4 ranks, complex spectral
    pencils): the pencil transpose bit for bit against its plain ring and
    ``.contiguous()`` on the complex128 and complex64 spectral pencils of
    128x129 and at every pencil a meshed step flips (26 of its 37 flips
    complex), timed cold as phase 12 times it; the banded kernel at every
    input the step gives it (complex y-pencils as two planes of real
    lanes, the Poisson lanes' factor sets offset by the rank), as phase 12
    holds it; meshed against serial dense at 128x129 (rel 1e-11); the main
    path (exactly 37 flips and 4 banded launches a step), the profile and
    the chunk gates of phase 14;
20. ``hc1025`` (``rbc1025`` with ``bc="hc"``) on the fused route, then
    the dense one: the route's kernels against their plain versions at
    129^2 (f64 1e-12, f32 1e-4) and at ``hc1025``, timed (the general-path
    temperature solve among the banded cases); the main path (the dense
    route's 7 banded launches a step, one of them on the general path),
    the profile and the chunk gates;
21. HC's correctness at 129^2 and 128x129 (Ra=1e5, dt=0.01, the
    reference's HC examples), 10 steps on every route (fused, dense,
    meshed): card vs CPU rel 1e-11 of each field's scale (the card's
    transform method on both sides), meshed vs dense 1e-11, fused vs dense
    1e-11 with ``pseu`` at ``PSEU_ROUTES_LIMIT`` beside the JAX package's
    own difference;
22. ``rbc1025_scn``: ``rbc1025`` with the scenario modifiers and an
    obstacle (``ScenarioConfig(coriolis=2.0, passive_scalar=True)`` at
    matched diffusivity, the scalar released equal to the temperature, and
    ``solid_roughness_sinusoid(x, y, 0.1, 10.0)`` through ``set_solid``, the
    defaults of the JAX package's ``examples/navier_rbc_roughness.py``) on
    the fused, dense and meshed routes: the route's kernel instances against
    their plain versions, timed (the five-term ``vely`` stage, the scalar's
    stage and its conv chain on the temperature's instance; the banded
    solves with the scalar's two on the temperature's solver; every flip and
    banded input of a meshed step), the main path (exactly 4 conv and 8
    stage launches a step; 9 banded; 56 flips and 9 banded, 13 flips an
    observables read), the profile, the mirror (``scal`` against ``temp``,
    expected bit for bit, limit 1e-10 as the example) and Sherwood against
    Nu (rel 1e-11), and the chunk gates of phase 14;
23. the JAX package's scenario checks at 129^2 and 128x129 (Ra=1e5,
    dt=0.01, every modifier with the scalar at 3x the thermal diffusivity):
    card vs CPU on every route (1e-11 of each field's scale, ``scal``
    included), meshed vs dense on the card (1e-11); the Coriolis force
    absorbed by the pressure at 129^2, Ra=1e4, 50 steps (velocities and
    temperature rel < 1e-3 of the non-rotating run, pressure > 1e-2: the
    JAX package's ``tests/test_workloads.py``); a cylinder stopping the
    flow at 129^2, Ra=1e5, 100 steps (inner speed < 2e-3 and the fluid's
    > 50x it: ``tests/test_solid_masks.py``);
17. last, the two transform methods of the Chebyshev axes: at ``rbc1025``
    and ``periodic1024`` the velocity space's transforms under ``"fft"``
    against ``"matmul"`` (1e-12), each timed, and each route of each cell
    stepped with each method (bare ``update_n`` ms/step), which sets the
    card's default.

Then ensembles, K member states of one model stepped together (the JAX
package's ``NavierEnsemble``, its ``jax.vmap`` of the step), every kernel
launch of a step serving all K members:

25. (after phase 14 of each of the fused, dense and meshed routes, on that
    route's ``rbc1025`` model) ``rbc1025`` with K = 4 members on the fused
    route and K = 2 on the dense and meshed ones: each kernel's
    member-axis instance (every instance one K-member step launches)
    against its plain version (1e-12 of max|plain|; the flips bit for bit),
    each member bit for bit its one-member launch (the fused kernels and
    the flips), timed queued behind a GPU spin and as a CUDA graph against
    K one-member launches of it as one graph (``solo_ms``), the plain
    version and one library call
    (batched ``torch.matmul``; a ``matmul`` by precomputed inverses for the
    banded solve; ``.contiguous()`` for the flip), with the bound of the
    K-member work; the K-member step's capture, launches exactly a solo
    step's, and bare ``update_n`` ms/step against K times the solo route's;
    member 0 against the solo model after 10 steps (1e-12 of each field's
    scale, bit for bit on the fused route);
24. ``ensemble129`` (129^2, Ra=1e7, dt=2e-3, ``from_seeds(range(K),
    amp=0.1)``, K in {1, 8, 32}) on the fused, dense and meshed routes:
    the capture (time, pool, memory), launches a step exactly a solo
    step's, bare ``update_n`` ms/step and member-steps/s over 50 steps,
    device busy and host idle from a 5-step profile; at K = 32 the
    member-axis kernel instances as phase 25 holds and times them; then
    K = 8 members against solo models of their seeds after 10 steps, NaN
    isolation (member 0 poisoned in temp mode 0 dies with no step counted,
    the others bit for bit an unpoisoned ensemble's), an all-dead ensemble
    ending ``integrate`` with ``"break"``, and the sentinel chunk (member
    3's velocities at 4x the CFL ceiling roll the chunk back and ``pinned``
    marks member 3 alone);
26. ``geometry_sweep`` at 129^2 (Ra=1e5, dt=0.01) on each route: four
    obstacles from the ``solid_*`` builders as one ensemble of a plain
    model, each member against a solo ``set_solid`` run (1e-12 of each
    field's scale, bit for bit on the fused route).

27. checkpoints in the JAX package's gathered snapshot layout
    (``utils/checkpoint.py``): on ``rbc1025`` (the fused main model after
    phase 25, the meshed one after its phase 25), ``periodic1024`` fused
    (after its phase 14) and ``ensemble129`` K = 8 fused (a member dead,
    uneven ``steps_done``), the snapshot staged on the card
    (``snapshot_to_host``: ms, MB; ``snapshot_digest``: ms) and restored
    into a fresh model (into an ensemble built at K = 32, whose graph is
    dropped and recaptured) through the file reader's group restore (and
    through an HDF5 file where ``h5py`` imports): every stored leaf bit for
    bit, ``pseu`` zero, ``time``/K/mask/``steps_done`` exact, then 50 steps
    of ``update_n`` at the route's launches a step; at 129^2 (Ra=1e7,
    dt=2e-3) on the fused, dense and meshed routes, HC (``hc129``), the
    periodic 128x129 cell (fused, meshed) and the scenario cell with its
    scalar, a snapshot restored on the card and on the CPU (the card's
    transform method): the two stagings' ``vhat``, coordinate and scalar
    datasets bit for bit, ``v`` to 1e-12 of its scale, the digests' equality
    printed, a meshed staging's ``vhat`` bit for bit a serial model's, 10
    steps on each side to 1e-11 of each field's scale (``pseu``, which is
    not stored, 1e-10), and the card's restarted run bit for bit its run
    without a restart; the 129^2 snapshot restored at 257^2 on both, 10
    steps, the same limits.  Its callback
    part runs after phase 4 (``rbc1025`` fused) and phase 18
    (``periodic1024`` fused): ``integrate`` (50 steps, 2 callbacks, no
    snapshot) a second time, each callback timed in parts beside the first
    run's (phase_main times every route's), and one callback profiled.

28. the in-scan statistics and the dt governor: on ``rbc1025`` (after
    each route's phase 27 or 25) 50 steps of bare ``update_n`` with
    ``set_stats(StatsConfig(stride=16))`` against the same run without,
    the states bit for bit, the launches counted (a step's, plus the
    sample graph's own on the steps that replay it), ms/step on and off
    (off, on, on, off), one sample's device ms (profiler) and the sample
    graph's capture; ``set_dt`` dt -> dt/2 -> dt (first-visit and revisit
    ms, the bytes a rung holds), after each move every fused stage against
    its plain version on the new operators (1e-12 of max|plain|), one
    graph step against one eager step bit for bit, 50 steps finite; the
    staged snapshot's ``stats_state`` restored bit for bit; on the fused
    route a governed run: phase 14's CFL spike fed through
    ``StabilityGovernor.on_chunk``, each ``retry``/``adjust`` applied with
    ``set_dt``, the dt trajectory and ``RunHealth`` printed, the run
    finite and back at the anchor; then, at 129^2 (stride 2, 20 steps),
    every route's statistics on the card against the CPU (1e-11 of each
    leaf's scale, the health vector); and ``ensemble129`` K = 32 fused:
    member-steps/s with statistics on and off, members' sums against solo
    runs', ``set_dt`` on the ensemble, its staged snapshot.

30. (last, before the kernels line) 30a: ``sh2048`` (the JAX benchmark's
    Swift-Hohenberg cell, ``SwiftHohenberg2D(2048, 2048, r=0.35, dt=0.02,
    length=20)``), timed as the benchmark times it (a warm-up window of 128
    steps, the windows 128 and 512, then three 128/512 pairs: ms/step the
    median slope; each ``update_n`` one replay of one captured graph), its
    gate (the pattern energy grew over the 2688 steps, the field finite),
    and the card against the CPU at 64^2 and 1-D nx = 256 after 50 steps
    (1e-12 of the spectrum's scale); 30b: the linearised model's
    ``grad_autodiff`` on the meshed route at 129^2 over 50 steps, its exact
    flip (forward and backward) and banded launches, against the dense
    route's on the card and the CPU's (rel 1e-9), wall and peak; the flip's
    backward (the inverse flip through autograd) bit for bit its plain ring
    at every shape a meshed ``rbc1025`` step flips, its one launch timed
    with the L2 flushed beside the forward launch, the plain ring and
    ``.contiguous()``;
    30c: ``integrate(overlap=True)`` against the blocking loop on fused
    ``rbc1025`` (chunks of 25 steps, a callback each, an ``IOPipeline`` on
    the overlapped run): the same state bit for bit, ms/step of each over
    ten back-to-back pairs after one warm-up window each (medians, spreads,
    each pair's gain) and each's host-idle share (profiler); the async writer's
    submit-to-done time for a staged 84 MB snapshot against the synchronous
    staging and digest; the same state on the dense and meshed routes at
    129^2 and an ensemble (K = 4), and a state poisoned after chunk 2
    breaking at most one chunk late on each; 30d: the integrity layer on
    fused ``rbc1025``: the run with a digest after every chunk bit for bit
    the run without, one digest's ms and its share of a 25-step chunk
    (fails above 2%), the card's digest equal to the CPU's (also after
    digests of 40 other shapes), shadow audits
    equal to the live digest after plain, sentinel and statistics chunks,
    a flipped bit seen; shadow audits on the dense and meshed routes at
    129^2 and a meshed ensemble (K = 4).

31. (after 30) the resilient runner (``ResilientRunner``) on the card,
    with its checkpoints in HDF5 files where ``h5py`` imports and else in
    the runner's private in-memory store (``checkpoint_store=`` says
    which): 31a NaN recovery on fused ``rbc1025`` (200 steps, ``nan@100``,
    one retry at dt/2; the journal's events in order, final dt 5e-5, Nu
    and fields against a clean run at 5e-5, exact launches; the faulted,
    clean and recovery-overhead walls), and the same on the meshed route
    at 129^2 (banded launches exact, flips counted); 31b a governed CFL
    spike (``governor129``'s sizing) against the ungoverned run; 31c a
    ``bitflip`` under the integrity audits (mismatch, in-memory rollback,
    the final state bit for bit a clean run's, the ledger's strike); 31d
    the ``slow`` fault against a 5 s dispatch deadline (``DispatchHang``
    within the deadline + 2 s, the flight record's ``dispatch`` spans);
    31e ``kill@k`` then resume in a child process at 129^2 (bit for bit an
    uninterrupted run, the checkpoint's dt restored); 31f the harness's
    price: 200 steps in chunks of 25 under the runner with telemetry on
    and off against bare ``update_n``, ten back-to-back triples (the
    states on and off bit for bit, the median telemetry overhead at most
    2%, the runner's overhead, host-idle shares); 31g ``eigenmode_sweep``
    at the example's full settings (Ra_c within 5% of 1707.76) and
    ``steady_state_find`` at its defaults (converged), with their walls
    and banded launches; 31h ``step_flops`` of fused ``rbc1025`` against
    its wrappers' sum, ``mfu_estimate`` from 31f's bare rate, the device
    memory gauges.

32. (after 31) sharded two-phase checkpoints on a mesh: meshed ``rbc1025``
    on ``make_mesh(4)``, integrity armed, 10 steps under the runner with
    ``IOConfig(sharded_checkpoints=True)`` (the in-memory store); its final
    staged sharded snapshot restores through the in-memory slab catalog
    onto ``make_mesh(2)``, a serial dense model and a fresh
    ``make_mesh(4)``, bit for bit with the digest verified, and each then
    steps 10 steps bit for bit as the same model run from the state placed
    as the gathered reader places it (the 4-rank one as the writer's own
    run); the sharded staging ms beside the gathered staging of the same
    state; files too where ``h5py`` imports.
33. two controllers on the one card: two processes on gloo over
    localhost, each a fused ``rbc129`` replica under the runner with the
    sanitizer armed at cadence 8: a stop on rank 0 alone stops both at
    step 100, one on rank 1 alone is ignored, the replicas bit for bit
    equal, the sanitizer's overhead on 200 steps (armed against disarmed,
    three pairs), one ``root_decides`` handshake in µs, and
    ``skip_broadcast@5:host1`` raising ``CollectiveDesyncError`` on both
    processes; the children's exit codes checked, a wedge killed at the
    phase's timeout.
34. a served campaign at full width: ``SimServer`` on the fused route,
    ``rbc1025``, four lanes, chunks of 8, six requests (seeds 0-5, 24-48
    steps) and ``nan@16``: every in-flight request retries at dt/2, two
    lanes refill; both buckets come from the warm pool (the dt/2 one
    captured on the pool's thread while the first bucket served).  Every
    request done, each Nu within 1e-8 of a solo run on the card, every
    replayed step exactly a solo step's launches, the served fused inputs
    (a refilled lane beside a dead NaN lane; the retried requests) against
    the plain versions at phase 25's limit; admission to first chunk warm
    and cold, served member-steps/s beside bare ``update_n``, the
    scheduler's host time a boundary and its parts;
35. the serving soak (the JAX package's ``serve129``): 64 requests of 8-13
    steps through 8 lanes at 129^2, drained by a real SIGTERM
    (``kill@24``), restored mid-trajectory by a second server that takes
    ``nan@48``: every request resolved once, none failed, three results
    within 1e-8 of solo runs, a drained and restored request bit for bit
    its solo run; member-steps/s and latency percentiles beside a bare
    K = 8 ``update_n``;
36. the fleet on the card: a proxy here, two replicas spawned by
    ``LocalProcessLauncher`` (``--device cuda``), 16 requests from two
    tenants (one with a deadline); the replica holding a lease SIGKILLed
    after it persisted its continuations, a survivor breaking its lease
    after the 3 s TTL and resuming them, the autoscaler
    (``min_replicas=max_replicas=2``) repairing the capacity with one
    spawn; every request done once, the children's exit codes checked.
    Then a 258^2 bucket served as a gang on a 2-rank sub-mesh of the card
    (``SubmeshConfig(shapes=(2,), shard_min_nx=257)``): its flips and
    banded solves on the step's own inputs against the plain versions,
    their launches counted, the final state against a solo
    ``make_mesh(2)`` run.

37. a mesh whose ranks span processes (``multihost.global_pencil_mesh``):
    2 processes x 2 ranks and 4 x 1 on the one card (and one process a
    card, 4 ranks over them, when the machine has two cards or more;
    ``phase37 cards`` names the count), each process its ranks stacked on
    its card, every flip through the kernel's remote form (chunks pushed
    into the peers' receive slabs through CUDA IPC, completion on flags in
    the slabs).  In each layout: the remote flip at every shape and dtype a
    meshed ``rbc1025`` step and a meshed ``periodic1024`` step flip, bit
    for bit against its plain version (the gloo all-to-all), timed cold
    (the L2 flushed, each window opened after a rank gather, so no
    process's flush lies in it) and warm (a captured graph of 20 flips,
    replayed by every process together after a barrier) beside its plain
    version, the library's ``copy_`` of the same chunks into the
    IPC-mapped peer slabs, timed the same two ways (and NCCL's
    ``all_to_all_single`` with a card a process), and the one-process flip
    of the same global shape (phase 12); 50 steps of bare ``update_n`` of
    meshed ``rbc1025`` and 10 of ``periodic1024`` (captured), ms/step
    beside the one-process ``make_mesh(4)`` run here, exactly 37 flips, one
    rank gather (the freeze probe's sum) and the route's banded launches a
    step on every process, the states against the one-process run (each
    layout prints its rule: within 1e-12 of each field's scale where a
    process holds several ranks, and at 129^2 for every layout; where a
    process holds one rank, whose lone GEMMs round apart from the batched
    ones at 1025^2, within the larger of that and the one-process run's own
    one-ulp sensitivity times the steps), with whether they are bit for
    bit; the golden head at 129^2 (200 steps, rel 1e-6 of
    ``PARITY.json``); a NaN on the last process's ranks freezing every
    process at the same step, each spawn under its own deadline.  The
    ``kernels`` line gains the remote flip's entry (``ring_push``).
38. the paths of a model whose mesh spans 2 processes x 2 ranks on the one
    card (and, on a machine of several cards, a card a process: 4 x 1 on
    four cards, held by phase 37's one-ulp-scaled rule), through the
    entry points a user calls, each beside the same path
    on the one-process ``make_mesh(4)`` run here first: meshed ``rbc1025``
    with its statistics at stride 16 over 100 steps (the running sums bit
    for bit); ``NavierEnsemble`` of 2 seeded members over 50 steps (every
    member bit for bit, the digests equal, 37 flips, 1 rank gather and 7
    banded launches a step); ``ResilientRunner`` over 200 steps with a NaN
    on rank 1's process at step 100 (checkpoints in the in-memory store:
    the journal's event types in order and the recovered state bit for bit
    the one-process runner's, and that state bit for bit a clean run at
    dt/2); ``grad_autodiff`` of the linearised model at 129^2 over 50 steps
    (rel 1e-12 of the one-process mesh's, the flip and banded launches
    forward and backward exactly phase 30b's).  Every remote flip and
    banded solve the new paths launch (the member axis, the statistics'
    gathers, the digests' gathers, the backward flips and the banded
    backward) is logged at its shape and held against its plain version on
    random values (flips bit for bit, banded solves 1e-12 of each lane's
    scale).  Each path's ms/step or wall beside the one-process run's; the
    launches of each path on earlier lines and in the ``kernels`` line
    (``span_paths_launches`` of the remote flip's and the banded entry).

The serving phases keep campaign checkpoints in the runner's in-memory
store where ``h5py`` does not import, and parked continuations as
``.npz`` shards there.

Every phase that reaches a save-window callback sets ``write_intervall``
past its run's end (no flow snapshot; ``h5py`` need not import), and the
script runs in a temporary working directory, where the callbacks append
``data/info.txt``.  It prints whether ``h5py`` imports.

The profiles of the dense and meshed routes list each banded launch of
one step, to set beside the launches timed alone.  The ``kernels`` line
sums each kernel over one step of the route it was ported for, and over a
step of each other route that runs it (``mesh_*``, ``periodic_fused_*``,
``periodic_dense_*``, ``periodic_mesh_*``, ``hc_fused_*``,
``hc_dense_*``, ``scn_fused_*``, ``scn_dense_*``, ``scn_mesh_*``), and
over a K-member step of each ensemble route (``ens129_fused_*`` and the
like at K = 32, ``ens1025_*`` at phase 25's K, with ``solo_ms`` beside
the kernel's), with every kernel's launches on every route.  The flip's
entry reads its 37 flips with the L2 flushed (``ms``, as the other
kernels' rows are not: they are timed warm), back to back (``warm_ms``),
and inside the profiled replays of a meshed ``rbc1025`` step (phase 13's
profile, ``in_step_ms``).  ``serve_launches``, ``soak_launches`` and
``fleet_launches`` are the launches of phases 34, 35 and 36 (the fleet's
in this process: the gang's).

It prints the card's name and power limit, a ``{"kernels": [...]}`` line
and, as its last line, ``{"ok": true, "device": {...}}``.  Without a CUDA
device, or without the package beside it, it exits non-zero and prints no
result.
"""

from __future__ import annotations

import json
import math
import os
import socket
import statistics
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))

#: the H100 SXM's published peaks (NVIDIA data sheet, dense, 700 W): FP64
#: with tensor cores, FP32 without them (TF32 is off), HBM3 bandwidth
F64_TFLOPS = 67.0
F32_TFLOPS = 67.0
HBM_TB_PER_S = 3.35

RBC1025 = dict(nx=1025, ny=1025, ra=1e9, pr=1.0, dt=1e-4, aspect=1.0, bc="rbc")
#: the periodic flagship (``bench.py:119,2227``): Fourier r2c x Chebyshev
PERIODIC1024 = dict(nx=1024, ny=1025, ra=1e9, pr=1.0, dt=1e-4, aspect=1.0, bc="rbc",
                    periodic=True)
#: the reference's periodic example size (``examples/navier_rbc_periodic.py``)
PERIODIC128 = dict(nx=128, ny=129, ra=1e5, pr=1.0, dt=0.01, aspect=1.0, bc="rbc", periodic=True)
#: the horizontal-convection flagship: ``rbc1025`` with the cosine-heated
#: bottom and the insulated top (the reference's ``navier_hc`` example)
HC1025 = dict(RBC1025, bc="hc")
#: the horizontal-convection correctness cells of phase 21, 10 steps each,
#: at the reference's HC examples' parameters (Ra=1e5, dt=0.01:
#: ``examples/navier_mpi.py --bc hc``, ``examples/navier_rbc_periodic.py
#: --bc hc``); at the golden head's Ra=1e7, dt=2e-3 the dense route's temp
#: differs between any two correct roundings by ≈1e-11 of its scale after 10
#: steps (the JAX package against the port on the CPU: 1.01e-11)
HC_CELLS = {"hc129": dict(nx=129, ny=129, ra=1e5, pr=1.0, dt=0.01, aspect=1.0, bc="hc"),
            "hc_periodic128": dict(PERIODIC128, bc="hc")}
#: the scenario cell of phase 22 (``rbc1025_scn``): ``rbc1025`` with these
#: modifiers, the scalar released equal to the temperature, and the
#: roughness obstacle (height, wavenumber) of
#: ``examples/navier_rbc_roughness.py``
SCN_SCENARIO = dict(coriolis=2.0, passive_scalar=True)
ROUGHNESS = (0.1, 10.0)
#: phase 23's cells, the JAX package's scenario and roughness examples'
#: parameters (``examples/navier_rbc_roughness.py``: Ra=1e5, dt=0.01)
SCN_CELLS = {"scn129": dict(nx=129, ny=129, ra=1e5, pr=1.0, dt=0.01, aspect=1.0, bc="rbc"),
             "scn_periodic128": dict(PERIODIC128)}
#: the mirror's limit, as ``examples/navier_rbc_scenarios.py`` holds it
MIRROR_LIMIT = 1e-10
MAIN_STEPS = 50
#: how far the fused route's pseudo-pressure may stray from the dense
#: route's, relative to its scale, after 10 steps of ``PERIODIC128``: the
#: JAX package's own two routes differ by 8.03e-11 there (fast
#: diagonalisation against the banded solve of the Poisson problem)
PSEU_ROUTES_LIMIT = 1e-10
#: the JAX package's own fused route against its dense one after 10 steps
#: of each phase 21 cell, relative to pseu's scale, on the CPU (measured, with
#: the port's, by tests/test_torch_hc.py::test_routes_differ_as_the_reference_routes_do):
#: phase 21 holds the card's routes to ``PSEU_ROUTES_LIMIT`` there too
REFERENCE_ROUTES_DIFF = {"hc129": {"pseu": 4.38e-11}, "hc_periodic128": {"pseu": 6.79e-11}}
STAGE_TAGS = ("velx", "vely", "temp", "scal", "div", "poisson", "projx", "projy")
DENSE = dict(step_kernel="dense", conv_kernel="dense")
#: kernel launches a step of each route
PER_STEP = {"fused": {"fused_conv": 3, "fused_stage": 7}, "dense": {"banded_solve": 7},
            "mesh": {"banded_solve": 7, "ring_transpose": 37},
            "periodic_fused": {"fused_conv": 3, "fused_stage": 7},
            "periodic_dense": {"banded_solve": 4},
            "periodic_mesh": {"banded_solve": 4, "ring_transpose": 37},
            "hc_fused": {"fused_conv": 3, "fused_stage": 7}, "hc_dense": {"banded_solve": 7},
            "scn_fused": {"fused_conv": 4, "fused_stage": 8}, "scn_dense": {"banded_solve": 9},
            "scn_mesh": {"banded_solve": 9, "ring_transpose": 56}}
#: kernel launches of one save-window callback (the observables): the
#: meshed routes flip pencils there too (Sherwood 3 more)
PER_CALLBACK = {"mesh": {"ring_transpose": 10}, "periodic_mesh": {"ring_transpose": 10},
                "scn_mesh": {"ring_transpose": 13}}
#: grid launches a step of each route's hand-written kernels, by a part of
#: the kernel's name: what a profile that recorded every device event of a
#: step holds (a fused conv chain is 3 generic-GEMM launches and 1 dual,
#: the 7 fused stages 16 generic-GEMM launches, 14 in the periodic cell,
#: whose Poisson stage has no left and no B0 product); the profiler has been
#: seen to drop some events of graph replays
PROFILE_LAUNCHES = {"fused": {"gemm_jobs_kernel": 25, "conv_dual_kernel": 3},
                    "dense": {"banded_kernel": 7},
                    "mesh": {"banded_kernel": 7, "ring_transpose_kernel": 37},
                    "periodic_fused": {"gemm_jobs_kernel": 23, "conv_dual_kernel": 3},
                    "periodic_dense": {"banded_kernel": 4},
                    "periodic_mesh": {"banded_kernel": 4, "ring_transpose_kernel": 37},
                    "hc_fused": {"gemm_jobs_kernel": 25, "conv_dual_kernel": 3},
                    "hc_dense": {"banded_kernel": 7},
                    "scn_fused": {"gemm_jobs_kernel": 30, "conv_dual_kernel": 4},
                    "scn_dense": {"banded_kernel": 9},
                    "scn_mesh": {"banded_kernel": 9, "ring_transpose_kernel": 56}}
PROFILE_ATTEMPTS = 3
#: ranks of the meshed route (all on the one card)
MESH_RANKS = 4
#: bytes written before each launch of a cold-L2 timing: 10x the 50 MB L2
FLUSH_BYTES = 512 * 2**20
#: a GPU spin ahead of a timed launch or loop of short kernels (≈10 ms at
#: the H100's 1.98 GHz), long enough for the host to enqueue the work
#: behind it, so the device time read does not include the host's launch
#: overhead (tens of µs a wrapped launch against a ≈5 µs kernel)
SLEEP_CYCLES = 20_000_000
#: how far a banded case's library yardstick may stray from the kernel,
#: relative to each lane's scale: a product with a precomputed inverse
#: rounds otherwise than the substitution, more so as n grows
LIBRARY_LIMIT = 1e-8
#: how far the banded kernel may stray from its plain version on a meshed
#: step's own input, relative to the solve's scale: the limit the routes
#: are held to against each other (the same algebra, rounded otherwise:
#: the kernel contracts to FMAs), as the step's Poisson lanes cancel where
#: random ones do not
STEP_INPUT_LIMIT = 1e-11
#: launches a queued timing of a meshed banded solve enqueues behind one
#: spin: a wrapped launch of a complex pencil's solve costs ≈0.18 ms of host
#: time, so 50 of them outlast the ≈10 ms spin and the reading turns into
#: the host's
QUEUED_REPS = 20


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def ptxas_summary(log: str) -> list:
    """``(kernel, registers line, spills line)`` for each entry function in
    a ``-Xptxas -v`` log."""
    out, kernel, spills = [], "?", ""
    for line in log.splitlines():
        if "Compiling entry function" in line:
            kernel = line.split("'")[1]
        elif "spill stores" in line:
            spills = line.strip()
        elif "Used" in line and "registers" in line:
            out.append((kernel, line.split(":", 1)[1].strip(), spills))
    return out


def time_ms(torch, fn, reps: int) -> float:
    """Mean device time of ``fn()`` over ``reps`` calls, by CUDA events."""
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


def time_cold_ms(torch, fn, reps: int, spin: int = SLEEP_CYCLES // 50) -> float:
    """Mean device time of ``fn()`` with the L2 cache flushed before each
    call (a ``FLUSH_BYTES`` write, then a spin of ``spin`` cycles that keeps
    the device busy while the host enqueues the call: a call with more host
    work than one launch, an autograd backward, needs a longer one), by a
    CUDA event pair around each call."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device="cuda")
    fn()
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(spin)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def time_queued_ms(torch, fn, reps: int) -> tuple[float, float]:
    """``(device ms, host ms)`` a call of ``fn()`` over ``reps`` calls
    enqueued behind a ``SLEEP_CYCLES`` spin: the device time of
    back-to-back calls (warm L2), and the host's time to enqueue one."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SLEEP_CYCLES)
    start.record()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    host = time.perf_counter() - t0
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps, host * 1e3 / reps


def time_graph_ms(torch, fn, reps: int) -> float:
    """Device ms of ``fn()`` captured as one CUDA graph, by CUDA events over
    ``reps`` replays: the launches' host time stays out however many
    launches ``fn`` makes (``fn`` must not sync with the host)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        fn()
    try:
        return time_ms(torch, graph.replay, reps)
    finally:
        graph.reset()


def rel_err(torch, a, b) -> tuple[float, float]:
    diff = float(torch.max(torch.abs(a - b)))
    scale = float(torch.max(torch.abs(b)))
    if not (math.isfinite(diff) and math.isfinite(scale)):
        raise AssertionError("non-finite kernel or plain output")
    return diff, diff / scale if scale else diff


def lane_rel_err(torch, a, b, axis) -> tuple[float, float]:
    """Max abs diff, and the max over lanes of the diff relative to that
    lane's max|b| along the solve ``axis``: the per-lane systems differ in
    scale by many orders (the Poisson solver's nudged singular lane), and a
    global scale would hide the small lanes."""
    diff, _ = rel_err(torch, a, b)
    scale = torch.amax(torch.abs(b), dim=axis, keepdim=True)
    rel = torch.abs(a - b) / torch.where(scale > 0, scale, torch.ones_like(scale))
    return diff, float(torch.max(rel))


# -- library yardsticks (timed here only; the port never calls them) ---------


def stage_library(torch, st, xs):
    xs = [st._stack(x) for x in xs]
    if st.has_l:
        m = sum(torch.linalg.multi_dot([l, x, rt]) for l, x, rt in zip(st.ls, xs, st.rts))
    else:
        m = xs[0] @ st.rts[0]
    if st.dinv is not None:
        m = m * st.dinv
    if st.b1t is not None:
        m = torch.linalg.multi_dot([st.b0, m, st.b1t]) if st.b0 is not None else m @ st.b1t
    if st.const is not None:
        m = m + st.const
    if st.mask is not None:
        m = m * st.mask
    return st._unstack(m)


def conv_library(torch, fc, ux, uy, vhat, bcdx=None, bcdy=None):
    gx = torch.stack([fc.gx1, fc.gx0])
    gy = torch.stack([fc.gy0t, fc.gy1t])
    d = torch.matmul(torch.matmul(gx, fc._stack(vhat)), gy)
    if bcdx is not None:
        d = d + torch.stack([bcdx, bcdy])
    total = ux * d[0] + uy * d[1]
    return fc._unstack(torch.linalg.multi_dot([fc.fx, total, fc.fyt]))


# -- phases -------------------------------------------------------------------


def kernel_cases(torch, model, rng):
    """``(kernel, label, run_kernel, run_plain, run_library, flops, bytes)``
    for every stage instance and both conv variants of ``model``, on random
    inputs made from ``rng``."""

    def rand(shape, cplx=False):
        return random_field(torch, rng, shape, model.dtype, model.device, cplx)

    cplx = model.periodic
    cases = []
    for tag in STAGE_TAGS:
        st = model._stages.get(tag)
        if st is None:  # the scalar's stage exists in a scalar scenario only
            continue
        xs = [rand((k0 // 2 if cplx else k0, k1), cplx) for k0, k1 in zip(st.k0, st.k1)]
        cases.append(("fused_stage", tag, lambda st=st, xs=xs: st.apply(*xs),
                      lambda st=st, xs=xs: st.plain(*xs),
                      lambda st=st, xs=xs: stage_library(torch, st, xs),
                      st.flops, st.bytes_moved))
    fc_u = model._convs[id(model.velx_space)]
    fc_t = model._convs[id(model.temp_space)]
    n = (model.nx, model.ny)
    for label, fc, with_bc in (("conv", fc_u, False), ("conv_bc", fc_t, True)):
        args = [rand(n), rand(n), rand((fc.mx // 2 if cplx else fc.mx, fc.my), cplx)]
        if with_bc:
            args += [rand(n), rand(n)]
        cases.append(("fused_conv", label, lambda fc=fc, a=args: fc.apply(*a),
                      lambda fc=fc, a=args: fc.plain(*a),
                      lambda fc=fc, a=args: conv_library(torch, fc, *a),
                      fc.flops, fc.bytes_moved(with_bc)))
    return cases


def case_per_step(model, label) -> int:
    """Launches of a fused case in one step of the fused route: the conv
    chain without bc runs for velx and vely, the one with bc for temp (and
    once more for a passive scalar), each stage once."""
    if label == "conv":
        return 2
    if label == "conv_bc":
        return 2 if "scal" in model.state._fields else 1
    return 1


def random_field(torch, rng, shape, dtype, device, cplx=False):
    """Uniform values in [-1, 1) of ``shape`` on ``device`` (complex, of
    the complex counterpart of ``dtype``, when ``cplx``)."""
    a = rng.uniform(-1.0, 1.0, size=shape)
    if cplx:
        a = a + 1j * rng.uniform(-1.0, 1.0, size=shape)
        dtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    return torch.as_tensor(a, dtype=dtype).to(device)


def label_of(model) -> str:
    """The configuration a model was built at (the timed cells are
    ``rbc1025``, ``hc1025``, ``periodic1024`` and ``rbc1025_scn``)."""
    scn = "_scn" if scenario_of(model) else ""
    return f"{'periodic' if model.periodic else model.bc}{model.nx}{scn}"


def scenario_of(model) -> bool:
    """Whether ``model`` runs a scenario modifier or an obstacle."""
    return model.scenario is not None or model.solid is not None


def tile_config() -> dict:
    """The fused kernels' block tiles as ``csrc/tile_gemm.cuh`` declares
    them (``using GemmTile = Tile<BM, BN, WARPS_M, WARPS_N, BK,
    BLOCKS_PER_SM>``, the same for ``DualTile``), by name."""
    import re

    text = open(os.path.join(ROOT, "rustpde_mpi_tpu_torch", "csrc", "tile_gemm.cuh")).read()
    tiles = {}
    for name, args in re.findall(r"using (\w+Tile) = Tile<([^>]*)>;", text):
        bm, bn, wm, wn, bk, per_sm = (int(x) for x in args.split(","))
        tiles[name] = {"block": f"{bm}x{bn}", "bm": bm, "bn": bn, "warps": f"{wm}x{wn}",
                       "warp_tile": f"{bm // wm}x{bn // wn}", "depth_step": bk,
                       "blocks_per_sm": per_sm, "mma": "m16n8k8 f64"}
    if set(tiles) != {"GemmTile", "DualTile"}:
        raise AssertionError(f"tile_gemm.cuh declares tiles {sorted(tiles)}")
    return tiles


def conv_launches(torch, fc, args, reps=10):
    """Phase 1, the convection chain by launch: device ms of each of its
    four launches (A1/A0, the dual kernel, the two forward GEMMs) over
    ``reps`` applications of ``fc`` to ``args``, from torch.profiler in
    launch order; cuBLAS on the same products (the dual's two as one
    batched ``matmul``, without its epilogue); and each launch's grid in
    blocks of its tile.  Prints one line."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fc.apply(*args)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            fc.apply(*args)
        torch.cuda.synchronize()
    evs = sorted((e.time_range.start, e.time_range.end - e.time_range.start)
                 for e in prof.events() if e.device_type == DeviceType.CUDA
                 and ("gemm_jobs_kernel" in e.name or "conv_dual_kernel" in e.name))
    kernel_ms = None
    if len(evs) == 4 * reps:
        kernel_ms = [sum(evs[4 * i + j][1] for i in range(reps)) / reps / 1e3 for j in range(4)]
    ux, uy, vhat = args[:3]
    gx, gy = torch.stack([fc.gx1, fc.gx0]), torch.stack([fc.gy0t, fc.gy1t])
    a = torch.matmul(gx, vhat)
    total = ux * uy
    t = torch.matmul(total, fc.fyt)
    cublas_ms = [time_ms(torch, fn, 10) for fn in (
        lambda: torch.matmul(gx, vhat), lambda: torch.matmul(a, gy),
        lambda: torch.matmul(total, fc.fyt), lambda: torch.matmul(fc.fx, t))]
    tiles = tile_config()
    bm, bn = tiles["GemmTile"]["bm"], tiles["GemmTile"]["bn"]
    dm, dn = tiles["DualTile"]["bm"], tiles["DualTile"]["bn"]
    blocks = [2 * -(-fc.nx // bm) * -(-fc.my // bn), -(-fc.nx // dm) * -(-fc.ny // dn),
              -(-fc.nx // bm) * -(-fc.ky // bn), -(-fc.kx // bm) * -(-fc.ky // bn)]
    print(f"phase1 conv launches at {fc.nx}^2: " + json.dumps(
        {"launches": ["A1,A0 = Gx1,Gx0 @ vhat", "dual", "T = total @ Fy^T", "out = Fx @ T"],
         "kernel_ms": kernel_ms if kernel_ms is not None else "not measured",
         "cublas_ms": cublas_ms, "grid_blocks": blocks}))


def phase_kernels(torch, model, limit, timing, phase="phase1"):
    """Phase 1 (phase 15 for the periodic cell) at one model size/dtype;
    returns per-case records."""
    import numpy as np

    rng = np.random.default_rng(1)
    route = route_of(model)
    records = []
    f64 = model.dtype == torch.float64
    peak = (F64_TFLOPS if f64 else F32_TFLOPS) * 1e12
    for kernel, label, run_k, run_p, run_l, flops, nbytes in kernel_cases(torch, model, rng):
        out_k = run_k()
        torch.cuda.synchronize()
        out_p = run_p()
        diff, rel = rel_err(torch, out_k, out_p)
        rec = {"kernel": kernel, "route": route, "case": label, "n": model.nx,
               "per_step": case_per_step(model, label),
               "dtype": str(model.dtype).replace("torch.", ""),
               "max_abs_err": diff, "max_rel_err": rel}
        if timing:
            t_op = flops / peak * 1e3
            t_mem = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
            # queued behind a GPU spin, so that the wrappers' host time (the
            # periodic cell's stacking copies add a dozen ops a launch) stays
            # out; back to back as well (kernel_loop_ms)
            queued, host = time_queued_ms(torch, run_k, 10)
            rec.update(kernel_ms=queued, kernel_enqueue_ms=host,
                       kernel_loop_ms=time_ms(torch, run_k, 10),
                       plain_ms=time_queued_ms(torch, run_p, 10)[0],
                       library_ms=time_queued_ms(torch, run_l, 10)[0], flops=flops, bytes=nbytes,
                       bound_ms=max(t_op, t_mem),
                       bound_by="operations" if t_op >= t_mem else "bytes")
            rec.update(tflops=flops / rec["kernel_ms"] * 1e-9,
                       library_tflops=flops / rec["library_ms"] * 1e-9,
                       bound_share=rec["bound_ms"] / rec["kernel_ms"])
        print(f"{phase} " + json.dumps(rec))
        if not rel <= limit:
            again_k = run_k()
            torch.cuda.synchronize()
            again_p = run_p()
            print(f"{phase} FAILED " + json.dumps({
                "kernel": kernel, "case": label, "n": model.nx,
                "kernel_vs_plain": rel,
                "kernel_again_vs_plain": rel_err(torch, again_k, out_p)[1],
                "kernel_vs_plain_again": rel_err(torch, out_k, again_p)[1],
                "kernel_repeat_bit_equal": bool(torch.equal(out_k, again_k)),
                "plain_repeat_bit_equal": bool(torch.equal(out_p, again_p))}))
            raise AssertionError(f"{kernel}/{label} at {model.nx}^2: rel err {rel:.3e} > {limit:g}")
        records.append(rec)
    if timing and route == "fused":
        n = (model.nx, model.ny)
        fc = model._convs[id(model.velx_space)]
        conv_launches(torch, fc, [torch.as_tensor(rng.uniform(-1.0, 1.0, size=s), dtype=model.dtype)
                                  .to(model.device) for s in (n, n, (fc.mx, fc.my))])
    return records


def phase_golden(pt, phase="phase2", **route):
    with open(os.path.join(ROOT, "PARITY.json"), encoding="utf-8") as fh:
        gold = json.load(fh)
    cfg = gold["config"]
    model = pt.Navier2D(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], cfg["dt"],
                        cfg["aspect"], cfg["bc"], device="cuda", **route)
    model.init_random(cfg["amp"], seed=0)
    worst = 0.0
    for row in gold["nu_f64"][:4]:
        model.update_n(cfg["sample_every"])
        vals = dict(zip(("nu", "nuvol", "re"), model.get_observables()[:3]))
        if abs(model.time - row["time"]) > 1e-9:
            raise AssertionError(f"time {model.time} != {row['time']}")
        for key, val in vals.items():
            rel = abs(val / row[key] - 1.0)
            worst = max(worst, rel)
            if not rel <= 1e-6:
                raise AssertionError(f"golden {key} at t={row['time']}: {val} vs {row[key]}")
    if not all(k.launches for ks in model.kernels().values() for k in ks):
        raise AssertionError("the golden run did not launch every kernel")
    print(f"{phase} golden 129^2 f64 200 steps {route or 'fused'}: max rel dev {worst:.3e} "
          "(limit 1e-6)")


def phase_card_vs_cpu(pt, phase="phase3", **route):
    models = {}
    for dev in ("cuda", "cpu"):
        m = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device=dev, **route)
        m.init_random(0.1, seed=0)
        m.update_n(10)
        models[dev] = pt.convert.state_to_numpy(m)
    worst = 0.0
    for name, ref in models["cpu"].items():
        rel = float(abs(models["cuda"][name] - ref).max() / max(abs(ref).max(), 1e-300))
        worst = max(worst, rel)
        if not rel <= 1e-11:
            raise AssertionError(f"card vs cpu {name}: rel {rel:.3e} > 1e-11")
    print(f"{phase} card vs cpu 129^2 f64 10 steps {route or 'fused'}: max rel diff "
          f"{worst:.3e} (limit 1e-11)")


def reset_counts(model):
    for ks in model.kernels().values():
        for k in ks:
            k.launches = 0


def count_launches(model) -> dict:
    return {name: sum(k.launches for k in ks) for name, ks in model.kernels().items()}


def route_of(model) -> str:
    """The route a model runs, as ``PER_STEP`` names it: ``scn_`` and the
    route with a scenario or an obstacle; ``mesh`` and ``periodic_mesh`` on
    a mesh, else the step kernel prefixed with the periodic cell or the HC
    boundary conditions."""
    if scenario_of(model):
        return "scn_" + ("mesh" if model.mesh is not None else model.step_kernel)
    if model.mesh is not None:
        return "periodic_mesh" if model.periodic else "mesh"
    prefix = "periodic_" if model.periodic else ("hc_" if model.bc == "hc" else "")
    return prefix + model.step_kernel


def phase_main(torch, pt, model, phase="phase4"):
    """The main path as a user drives it: ``integrate`` over two save
    windows of 25 steps (each one ``update_n``), launch counts set to 0
    just before and read just after.  Its wall time includes the two
    save-window callbacks (observables read back to the host, a print), so
    the step time is taken apart, over 50 more steps of bare ``update_n``.
    Each step of a chunk replays the step's CUDA graph, which is built
    (:func:`prepare_chunks`) before the counts are set to 0, so the counts
    are the replays' launches.  ``write_intervall`` is set past the run's
    end, so the callbacks write no flow snapshot; each callback is timed
    in parts (:func:`timed_callbacks`)."""
    prepare_chunks(torch, model, phase)
    model.write_intervall = 1e9  # no flow snapshot: the card machine may lack h5py
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    with timed_callbacks(torch, model) as callbacks:
        status = pt.integrate(model, MAIN_STEPS * model.dt, MAIN_STEPS // 2 * model.dt)
    torch.cuda.synchronize()
    wall_integrate = time.perf_counter() - t0
    CALLBACK_MS[label_of(model), route_of(model)] = callbacks
    print(f"{phase} {label_of(model)} {route_of(model)} route: the save-window callbacks of "
          "integrate, ms each: " + json.dumps(callbacks))
    launches = count_launches(model)
    if status != "time_limit" or abs(model.time - MAIN_STEPS * model.dt) > model.dt / 2:
        raise AssertionError(f"integrate ended with {status!r} at t={model.time}")
    route = route_of(model)
    want = {k: v * MAIN_STEPS + 2 * PER_CALLBACK.get(route, {}).get(k, 0)
            for k, v in PER_STEP[route].items()}
    if launches != want:
        raise AssertionError(f"expected launches {want}, got {launches}")
    t0 = time.perf_counter()
    model.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    nu, nuvol, re, div = model.get_observables()[:4]
    print(f"{phase} {label_of(model)} f64 {route_of(model)} route: update_n {MAIN_STEPS} steps in {wall:.4f} s = "
          f"{wall / MAIN_STEPS * 1e3:.4f} ms/step; integrate {MAIN_STEPS} steps with 2 "
          f"save-window callbacks in {wall_integrate:.4f} s = "
          f"{wall_integrate / MAIN_STEPS * 1e3:.4f} ms/step; launches in integrate "
          f"{launches}; at t={model.time:.4f}: Nu={nu!r} Nuvol={nuvol!r} "
          f"Re={re!r} |div|={div!r}")
    # an RBC cell carries heat upward (Nu > 0); HC's plate flux averages to
    # about zero (heated and cooled halves of one plate), and roughness
    # elements held at the plate temperatures take the plates' gradient
    # away: there the flow must move
    moving = nu > 0.0 if model.bc == "rbc" and model.solid is None else re > 0.0
    if not all(math.isfinite(v) for v in (nu, nuvol, re, div)) or not moving:
        raise AssertionError(f"{label_of(model)} observables not finite, or Nu <= 0 (rbc) "
                             "or Re <= 0 (hc, an obstacle)")
    return launches, wall / MAIN_STEPS * 1e3


def prepare_chunks(torch, model, phase):
    """Build ``model``'s chunk runner: one eager step on a scratch copy of
    the state warms every kernel wrapper up, then the step is captured as
    a CUDA graph.  Prints its wall time, the graph's private pool, the peak
    of ``torch.cuda.max_memory_allocated`` over it beside the memory held
    before, and the launches a replay adds, which must be one step's."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = model.chunk_runner()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not runner.captured:
        raise AssertionError("the chunk runner did not capture a CUDA graph on the card")
    names = [name for name, ks in model.kernels().items() for _ in ks]
    per_replay = {}
    for name, d in zip(names, runner.delta):
        per_replay[name] = per_replay.get(name, 0) + d
    route = route_of(model)
    # the cuFFT plans a captured step uses come from its warm-up; a cache
    # short of its maximum has evicted none of them
    plans = torch.backends.cuda.cufft_plan_cache
    print(f"{phase} chunk graph {label_of(model)} f64 {route} route: warm-up and capture {wall:.3f} s; "
          f"graph pool {runner.pool_bytes / 2**20:.1f} MiB; max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB ({held / 2**20:.1f} MiB held "
          f"before); launches a replay {per_replay}; cuFFT plan cache {plans.size} of "
          f"{plans.max_size}")
    if per_replay != PER_STEP[route]:
        raise AssertionError(f"a replay launches {per_replay}, a step {PER_STEP[route]}")
    if plans.size >= plans.max_size:
        raise AssertionError("the cuFFT plan cache is full: a captured plan may be evicted")


def freeze_ms(torch, model, reps=50) -> float:
    """Device ms of one step's freeze (the plain chunk's bookkeeping: the
    finite check, the five selects into the carry, the counter and the
    flag) on a copy of ``model``'s state, captured as a CUDA graph of its
    own as the step's graph holds it, by CUDA events over ``reps``
    replays."""
    carry = [f.clone() for f in model.state]
    carry += [torch.ones((), dtype=torch.bool, device=carry[0].device),
              torch.zeros((), dtype=torch.int32, device=carry[0].device)]
    stepped = model.state
    model._freeze(carry, stepped)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        model._freeze(carry, stepped)
    return time_ms(torch, graph.replay, reps)


def phase_profile(torch, model, bare_ms, steps=5, phase="phase5"):
    """Where the time of a main-path step goes: device time by kernel name
    and the device's busy share over ``steps`` steps, from torch.profiler
    (run after the counted main-path run, so its launches are not read);
    on the dense and meshed routes also each banded launch of the last
    step, in launch order (velx axis 1, 0; vely axis 1, 0; Poisson; temp
    axis 1, 0), to set beside the launches timed alone (phases 6, 12).
    The host-idle share is read twice: of the profiled wall (the profiler
    adds its own host time to every launch), and of ``bare_ms``, the
    unprofiled ms/step of the main-path run, against the profiled busy
    time.  A profile that did not record every launch of the route's
    kernels (``PROFILE_LAUNCHES``) is taken again, up to
    ``PROFILE_ATTEMPTS`` times.  Last, the freeze's own device time
    (:func:`freeze_ms`).  Returns ``{kernel name: device ms/step}`` of the
    profiled replays, None if no attempt recorded every launch."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    route = route_of(model)
    want = {k: v * steps for k, v in PROFILE_LAUNCHES[route].items()}
    model.update_n(1)
    for attempt in range(1, PROFILE_ATTEMPTS + 1):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            model.update_n(steps)
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans, by_name, banded = [], {}, []
        for ev in prof.events():
            if ev.device_type != DeviceType.CUDA:
                continue
            start, end = ev.time_range.start, ev.time_range.end
            spans.append((start, end))
            tot, cnt = by_name.get(ev.name, (0.0, 0))
            by_name[ev.name] = (tot + (end - start), cnt + 1)
            if "banded_kernel" in ev.name:
                banded.append((start, end - start))
        got = {k: sum(c for name, (_, c) in by_name.items() if k in name) for k in want}
        if got == want:
            break
        print(f"{phase} profile attempt {attempt}: recorded launches {got}, {steps} steps launch "
              f"{want}: the profiler lost device events")
    else:
        print(f"{phase} profile: no complete record in {PROFILE_ATTEMPTS} attempts; device busy "
              "not measured")
        return None
    spans.sort()
    busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
    for s, e in spans[1:]:
        if s > cur_e:
            busy += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    busy += cur_e - cur_s
    total = sum(t for t, _ in by_name.values())
    selects = sum(t for name, (t, _) in by_name.items() if "where" in name)
    print(f"{phase} profile {label_of(model)} f64 {route} route {steps} steps: wall {wall_us / steps / 1e3:.4f} ms/step, "
          f"device busy {busy / steps / 1e3:.4f} ms/step ({busy / wall_us:.4f} of wall, "
          f"host idle share {1.0 - busy / wall_us:.4f}), "
          f"kernel time {total / steps / 1e3:.4f} ms/step; host idle share of the bare "
          f"update_n ({bare_ms:.4f} ms/step) {1.0 - busy / steps / 1e3 / bare_ms:.4f}")
    freeze = freeze_ms(torch, model)
    print(f"{phase} freeze {label_of(model)} f64 {route} route: {freeze:.4f} ms/step as a graph "
          f"of its own ({freeze / (busy / steps / 1e3):.4f} of the step's busy time); select "
          f"kernels in the profile {selects / steps / 1e3:.4f} ms/step")
    for name, (t, cnt) in sorted(by_name.items(), key=lambda kv: -kv[1][0])[:12]:
        print(f"{phase}   {t / steps / 1e3:9.4f} ms/step {cnt / steps:6.1f} calls/step "
              f"{t / total:7.4f}  {name[:90]}")
    if banded:
        per_step = PER_STEP[route]["banded_solve"]
        last = [d / 1e3 for _, d in sorted(banded)[-per_step:]]
        print(f"{phase} banded launches of the last profiled step, ms in launch order: {last}")
    return {name: t / steps / 1e3 for name, (t, _) in by_name.items()}


# -- chunked stepping --------------------------------------------------------------


def same_state(torch, a, b) -> bool:
    """Bit for bit, non-finite entries where the other state has them."""
    return all(torch.equal(torch.isfinite(x), torch.isfinite(y))
               and torch.equal(torch.nan_to_num(x), torch.nan_to_num(y)) for x, y in zip(a, b))


def state_diffs(torch, a, b) -> dict:
    """Max |a - b| per field over the entries finite in both, and the
    field's scale."""
    out = {}
    for name, x, y in zip(a._fields, a, b):
        both = torch.isfinite(x) & torch.isfinite(y)
        out[name] = (float(torch.max(torch.abs(x - y)[both])), float(torch.max(torch.abs(y[both]))))
    return out


def phase_chunks(torch, pt, model, phase="phase14"):
    """The chunk contract on the card, on the route's ``rbc1025`` model
    (its state and time put back after):

    1. ``update_n(10)``, each step a replay of the captured step, against
       10 eager ``update()`` calls, bit for bit;
    2. the divergence freeze: with temp mode 0 NaN, ``step_n(state, 8)``
       executes 1 step and returns the eager step's state (the same
       non-finite entries, the rest bit for bit); ``update_n(7)`` (buckets
       4 and 3, the flag restarting at each) returns two eager steps' state,
       and ``exit()`` is True;
    3. the sentinels (``StabilityConfig()`` armed) against the plain chunk,
       ``update_n(10)`` bit for bit, with the ``ChunkStatus`` and the wall
       ms/step of both chunks;
    4. one CFL spike: the velocities scaled so that the CFL is 4x the
       ceiling; ``integrate`` stops with ``"break"``, the chunk rolled back
       to its start (state and time), ``exit()`` latched until
       ``clear_pre_divergence()``."""
    route = route_of(model)
    s0, t0 = model.state, model.time
    # 1. graph against eager
    model.update_n(10)
    chunk = model.state
    model.state, model.time = s0, t0
    for _ in range(10):
        model.update()
    if not same_state(torch, chunk, model.state):
        raise AssertionError(f"{route}: graph chunk vs eager steps differ: "
                             f"{state_diffs(torch, chunk, model.state)}")
    print(f"{phase} {route} route: update_n(10) through the graph equals 10 eager update() "
          "bit for bit")
    # 2. the freeze
    temp = s0.temp.clone()
    temp.view(-1)[0] = float("nan")
    bad = s0._replace(temp=temp)
    stepped, done = model.step_n(bad, 8)
    one = model._step(bad)
    two = model._step(one)
    model.state = bad
    model.update_n(7)
    nonfinite = {n: int((~torch.isfinite(f)).sum()) for n, f in zip(one._fields, model.state)}
    if int(done) != 1 or not same_state(torch, stepped, one) or \
            not same_state(torch, model.state, two) or not model.exit():
        raise AssertionError(f"{route}: NaN freeze: steps_done {int(done)}, one step "
                             f"{same_state(torch, stepped, one)}, two buckets "
                             f"{same_state(torch, model.state, two)}, exit {model.exit()}")
    print(f"{phase} {route} route: NaN in temp mode 0: step_n(8) steps_done=1, its state the "
          f"eager step's; update_n(7) the state of 2 eager steps (non-finite entries {nonfinite}); "
          "exit() True")
    # 3. the sentinels against the plain chunk
    model.state, model.time = s0, t0
    model.update_n(10)
    plain = model.state
    cfg = pt.config.StabilityConfig()
    model.set_stability(cfg)
    model.state, model.time = s0, t0
    prepare_chunks(torch, model, f"{phase} sentinels")
    status = model.update_n(10)
    if status.pre_divergence or status.steps_done != 10 or not status.finite or \
            not same_state(torch, model.state, plain):
        raise AssertionError(f"{route}: armed chunk {status} or its state differs from the plain "
                             f"chunk's: {state_diffs(torch, model.state, plain)}")
    # wall ms/step of MAIN_STEPS-step chunks, plain, armed, armed, plain (the
    # armed chunk's one fetch of its scalars included)
    chunk_ms = {False: [], True: []}
    for armed in (False, True, True, False):
        model.set_stability(cfg if armed else None)
        model.state, model.time = s0, t0
        torch.cuda.synchronize()
        t = time.perf_counter()
        model.update_n(MAIN_STEPS)
        torch.cuda.synchronize()
        chunk_ms[armed].append((time.perf_counter() - t) / MAIN_STEPS * 1e3)
    print(f"{phase} {route} route: sentinels armed, update_n(10) bit for bit the plain chunk; "
          f"update_n({MAIN_STEPS}) wall ms/step armed {chunk_ms[True]}, plain {chunk_ms[False]}; "
          "status " + json.dumps(status._asdict()))
    model.set_stability(cfg)
    # 4. a CFL spike
    factor = 4.0 * cfg.max_cfl / status.cfl_max
    spiked = s0._replace(velx=s0.velx * factor, vely=s0.vely * factor)
    model.state, model.time = spiked, t0
    result = pt.integrate(model, t0 + 10 * model.dt, None)
    spike = model.last_chunk_status
    latched = model.exit()
    model.clear_pre_divergence()
    if result != "break" or not spike.pre_divergence or model.time != t0 or \
            model.state is not spiked or not latched or model.exit():
        raise AssertionError(f"{route}: CFL spike x{factor:.4g}: integrate {result!r}, {spike}, "
                             f"time {model.time} (start {t0}), latched {latched}")
    print(f"{phase} {route} route: CFL spike (velocities x{factor:.4g}): integrate 'break', "
          f"rolled back to t={t0:.4f}, exit() latched until cleared; status "
          + json.dumps(spike._asdict()))
    model.set_stability(None)
    model.state, model.time = s0, t0


# -- the dense route ------------------------------------------------------------


def banded_inverses(torch, kernel, chunk=128):
    """``(sets, n, n)``: the inverse ``U_j^-1 L_j^-1`` of every factor set
    of ``kernel`` (a ``BandedSolve``; one set unless its factors are per
    lane), built on its device ``chunk`` sets at a time."""
    n, p, q = kernel.n, kernel.p, kernel.q
    lower, upper = kernel.lower, kernel.upper
    if not kernel.per_lane:
        lower, upper = lower[..., None], upper[..., None]
    sets = lower.shape[-1]
    eye = torch.eye(n, device=kernel.device, dtype=kernel.dtype)
    out = torch.empty((sets, n, n), device=kernel.device, dtype=kernel.dtype)
    for j0 in range(0, sets, chunk):
        lanes = slice(j0, min(j0 + chunk, sets))
        low = eye.repeat(lanes.stop - j0, 1, 1)
        upp = torch.zeros_like(low)
        for d in range(1, p + 1):
            low.diagonal(-d, 1, 2).copy_(lower[d - 1, d:, lanes].T)
        for d in range(q + 1):
            upp.diagonal(d, 1, 2).copy_(upper[d, : n - d, lanes].T)
        linv = torch.linalg.solve_triangular(low, eye, upper=False, unitriangular=True)
        out[lanes] = torch.linalg.solve_triangular(upp, linv, upper=True)
    return out


def banded_cases(torch, pt, model, rng, timing):
    """``(label, solver, b, axis, per_step, library)`` for every banded
    solve of ``model``'s dense step on random inputs: the ADI axes of the
    velocity solver (applied twice a step, velx and vely) and of the
    temperature solver (twice with a scalar at matched diffusivity; the
    scalar's own solver otherwise), the Poisson tensor solver's per-lane factors along
    axis 1 and, off the step (``per_step`` 0), along axis 0.  When
    ``timing``, ``library`` is one ``torch.matmul`` that solves the same
    systems with precomputed inverses: the dense inverse of the axis (one
    factor set) or the batch of every lane's inverse (per-lane factors)."""

    def rand(shape):
        return random_field(torch, rng, shape, model.dtype, model.device, model.periodic)

    cases = []
    # a Fourier axis solves by a diagonal, with no kernel; the off-step
    # axis-0 Poisson case is a confined one
    axes = (1,) if model.periodic else (1, 0)
    adis = [("velx", model.solver_velx, 2), ("temp", model.solver_temp, 1)]
    if model.solver_scal is model.solver_temp:  # a scalar at matched diffusivity
        adis[1] = ("temp", model.solver_temp, 2)
    elif model.solver_scal is not None:
        adis.append(("scal", model.solver_scal, 1))
    for tag, adi, per_step in adis:
        dense = pt.solver.HholtzAdi(adi.space, adi.c, method="dense") if timing else None
        for axis in axes:
            b = rand(adi.space.shape_spectral)
            lib = None if dense is None else (
                lambda d=dense.solvers[axis], b=b, axis=axis: d.solve(b, axis))
            cases.append((f"{tag}_axis{axis}", adi.solvers[axis].solver, b, axis, per_step, lib))
    banded = model.solver_pres._solver.banded
    b = rand(model.pseu_space.shape_spectral)
    inv = banded_inverses(torch, banded.kernel) if timing else None
    poisson = [("poisson_axis1", b, 1, 1)]
    if not model.periodic:
        poisson.append(("poisson_axis0", b.T.contiguous(), 0, 0))
    for label, rhs, axis, per_step in poisson:
        lib = None if inv is None else (
            lambda rhs=rhs, axis=axis: lane_matmul(torch, inv, rhs.movedim(axis, -1)).movedim(-1, axis))
        cases.append((label, banded, rhs, axis, per_step, lib))
    return cases


def lane_matmul(torch, inv, rhs):
    """``inv[l] @ rhs[l]`` for every lane ``l`` of ``rhs`` ``(lanes, n)``
    (real or complex; real ``inv`` ``(lanes, n, n)``), one ``torch.matmul``."""
    if rhs.is_complex():
        return torch.view_as_complex(torch.matmul(inv, torch.view_as_real(rhs)).contiguous())
    return torch.matmul(inv, rhs[..., None])[..., 0]


def banded_layout(solver, b, axis) -> dict:
    """How the banded kernel runs ``solver``'s solve of ``b`` along
    ``axis``: its path (parity-split chains or one chain a lane), the lanes
    of a block's tile, whether it copies ``b`` 16 bytes at a time, and its
    shared memory a block (the column tile and the ring; ptxas reports no
    dynamic shared memory)."""
    from rustpde_mpi_tpu_torch.ops import banded_solve as bsm

    kernel = solver.kernel
    views = []
    solver._along(lambda v: views.append(v) or v, b, axis)
    view = views[0]  # real: a complex b's real and imaginary parts are its planes
    terms = max(kernel.chain_lower.shape[0], kernel.chain_upper.shape[0])
    rows_contiguous = view.stride(-2) == 1 and view.stride(-1) != 1
    return {"path": kernel.path, "tile_lanes": kernel.tile_lanes, "view_strides": view.stride(),
            "copy_bytes": 16 if bsm.vector_copies(view, kernel.tile_lanes) else view.element_size(),
            "shared_bytes": bsm.shared_bytes(kernel.n, view.element_size(), kernel.systems,
                                             kernel.tile_lanes, kernel.per_lane, terms,
                                             rows_contiguous)}


def phase_banded(torch, pt, model, limit, timing, phase="phase6"):
    """Phase 6 (phase 15 for the periodic cell: complex right-hand sides,
    their real and imaginary parts two batch entries of one launch) at one
    model size/dtype; returns per-case records."""
    import numpy as np

    rng = np.random.default_rng(2)
    peak = (F64_TFLOPS if model.dtype == torch.float64 else F32_TFLOPS) * 1e12
    route = route_of(model)
    records = []
    for label, solver, b, axis, per_step, lib in banded_cases(torch, pt, model, rng, timing):
        out_k = solver.solve(b, axis)
        torch.cuda.synchronize()
        diff, rel = lane_rel_err(torch, out_k, solver.plain(b, axis), axis)
        rec = {"kernel": "banded_solve", "route": route, "case": label, "n": model.nx,
               "per_step": per_step,
               "per_lane": solver.kernel.per_lane,
               "dtype": str(model.dtype).replace("torch.", ""),
               "max_abs_err": diff, "max_rel_err": rel}
        if lib is not None:
            rec["library_max_rel_err"] = lane_rel_err(torch, lib(), out_k, axis)[1]
        rec.update(banded_layout(solver, b, axis))
        if timing:
            n = b.shape[axis]
            shape3 = (2 if b.is_complex() else 1, n, b.numel() // n)
            flops, nbytes = solver.kernel.flops(shape3), solver.kernel.bytes_moved(shape3)
            t_op = flops / peak * 1e3
            t_mem = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
            queued, host = time_queued_ms(torch, lambda: solver.solve(b, axis), 50)
            rec.update(kernel_ms=queued, kernel_enqueue_ms=host,
                       kernel_loop_ms=time_ms(torch, lambda: solver.solve(b, axis), 10),
                       plain_ms=time_ms(torch, lambda: solver.plain(b, axis), 10),
                       library_ms=None if lib is None else time_queued_ms(torch, lib, 10)[0],
                       flops=flops, bytes=nbytes, bound_ms=max(t_op, t_mem),
                       bound_by="operations" if t_op >= t_mem else "bytes")
        print(f"{phase} " + json.dumps(rec))
        if rec["path"] != expected_path(model, label):
            raise AssertionError(f"banded_solve/{label}: the step's system took the {rec['path']} path")
        if not rel <= limit:
            raise AssertionError(f"banded_solve/{label} at {model.nx}^2: rel err {rel:.3e} > {limit:g}")
        if not rec.get("library_max_rel_err", 0.0) <= LIBRARY_LIMIT:
            raise AssertionError(f"banded_solve/{label}: the library yardstick solves another "
                                 f"system (rel err {rec['library_max_rel_err']:.3e})")
        records.append(rec)
    return records


def expected_path(model, label) -> str:
    """The banded kernel's path for the solve ``label`` of ``model``'s
    step: the general path (one chain a lane) for the horizontal-convection
    temperature's y solve, whose Dirichlet-Neumann band couples rows of both
    parities; two chains a lane (even and odd rows) for every other."""
    return "general" if model.bc == "hc" and label.startswith("temp_axis1") else "parity"


def phase_mms(torch, pt):
    """The confined manufactured solutions of the JAX package's
    examples/solve_hholtz.py and examples/solve_poisson.py, on the card."""
    import numpy as np

    hn = math.pi / 2.0

    def setup(n):
        sp = pt.Space2(pt.cheb_dirichlet(n), pt.cheb_dirichlet(n), device="cuda",
                       dtype=torch.float64)
        xs, ys = (b.points for b in sp.bases)
        return sp, np.cos(hn * xs)[:, None] * np.cos(hn * ys)[None, :]

    def solve(sp, solver, f):
        rhs = sp.to_ortho(sp.forward(torch.as_tensor(f, device=sp.device)))
        return sp.backward(solver.solve(rhs)).cpu().numpy()

    checks = []
    sp, u = setup(257)
    alpha = 1e-5
    for method in ("banded", "dense"):
        solver = pt.solver.HholtzAdi(sp, (alpha, alpha), method=method)
        err = float(np.abs(solve(sp, solver, u) - u / (1.0 + alpha * 2.0 * hn * hn)).max())
        checks.append((f"hholtz_adi 257^2 {method}", err, solver))
    sp, u = setup(65)
    for method in ("banded", "fd"):
        solver = pt.solver.Poisson(sp, (1.0, 1.0), method=method)
        checks.append((f"poisson 65^2 {method}",
                       float(np.abs(solve(sp, solver, -2.0 * hn * hn * u) - u).max()), solver))
        solver = pt.solver.Hholtz(sp, (0.1, 0.1), method=method)
        checks.append((f"hholtz 65^2 c=0.1 {method}",
                       float(np.abs(solve(sp, solver, u * (1.0 + 0.2 * hn * hn)) - u).max()), solver))
    for label, err, solver in checks:
        launched = sum(k.launches for k in solver.kernels())
        print(f"phase7 {label}: max |err| {err:.3e} (tol 1e-6), banded launches {launched}")
        if not err < 1e-6:
            raise AssertionError(f"{label}: max |err| {err:.3e}")
        if launched != len(solver.kernels()):
            raise AssertionError(f"{label}: each banded solver should launch once")


def phase_solvers(torch, pt, model):
    """Phase 11: one whole solve at the rbc1025 shapes, the banded
    recurrence against the dense inverse (ADI) and fast diagonalisation
    (Poisson): the device time of a solve queued behind a GPU spin (10
    reps), and back to back (``*_loop_ms``, 10 reps: what a caller that
    launches one solve after another waits, host time included)."""
    import numpy as np

    rng = np.random.default_rng(3)
    adi = model.solver_velx
    pres_space = model.pseu_space
    times = {}
    for label, solvers, shape in (
            ("hholtz_adi", {"banded": adi, "dense": pt.solver.HholtzAdi(adi.space, adi.c, method="dense")},
             adi.space.shape_physical),
            ("poisson", {"banded": model.solver_pres,
                         "fd": pt.solver.Poisson(pres_space, (1.0, 1.0), method="fd")},
             pres_space.shape_physical)):
        rhs = torch.as_tensor(rng.uniform(-1.0, 1.0, shape), dtype=model.dtype).to(model.device)
        for method, solver in solvers.items():
            times[f"{label}_{method}_ms"] = time_queued_ms(torch, lambda s=solver: s.solve(rhs), 10)[0]
            times[f"{label}_{method}_loop_ms"] = time_ms(torch, lambda s=solver: s.solve(rhs), 10)
    print("phase11 " + json.dumps(times))
    return times


# -- the meshed route ------------------------------------------------------------------


def banded_solvers(model) -> dict:
    """``{label: BandedSolver}`` of the banded solves of ``model``'s dense
    step (velx and vely share one ADI solver, and a scalar at matched
    diffusivity the temperature's)."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    adis = [("velx", model.solver_velx), ("temp", model.solver_temp)]
    if model.solver_scal not in (None, model.solver_temp):
        adis.append(("scal", model.solver_scal))
    out = {f"{tag}_axis{axis}": adi.solvers[axis].solver for tag, adi in adis
           for axis in (1, 0) if isinstance(adi.solvers[axis].solver, BandedSolver)}
    out["poisson"] = model.solver_pres._solver.banded
    return out


def step_inputs(torch, model):
    """What one meshed step gives its kernels: ``{(input shape, x_to_y,
    dtype): flips}``, ``{(solver label, input shape, axis, factor batch stride):
    solves}`` and, under the same keys, a copy of the first input of each
    such solve.  The mesh's transpose and the model's banded solvers are
    wrapped for the step to log their inputs, and the model's state and
    time are put back after it (this step's launches are not read)."""
    flips, solves, inputs = {}, {}, {}

    def count(log, key):
        log[key] = log.get(key, 0) + 1

    ring = model.mesh.ring

    def log_flip(block, x_to_y, apply=ring.apply):
        count(flips, (tuple(block.shape), bool(x_to_y), str(block.dtype).replace("torch.", "")))
        return apply(block, x_to_y)

    wrapped = [(ring, "apply", log_flip)]
    for label, solver in banded_solvers(model).items():
        def log_solve(b, axis, factor_batch_stride=0, factor_batch_period=0, label=label,
                      solve=solver.solve):
            key = (label, tuple(b.shape), axis, factor_batch_stride)
            count(solves, key)
            inputs.setdefault(key, b.clone())
            return solve(b, axis, factor_batch_stride, factor_batch_period)

        wrapped.append((solver, "solve", log_solve))
    state, t = model.state, model.time
    for obj, name, fn in wrapped:
        setattr(obj, name, fn)
    try:
        model.update()  # one eager step: a chunk would capture the logging into its graph
    finally:
        for obj, name, _ in wrapped:
            delattr(obj, name)
        model.state, model.time = state, t
    torch.cuda.synchronize()
    return flips, solves, inputs


def phase_mesh_banded(torch, model, solves, inputs, limit, phase="phase12"):
    """Phase 12 (phase 19 for the periodic cell: complex y-pencils, the
    real and imaginary parts two planes of one launch), the banded kernel
    on the meshed route: every input a meshed step of the cell gives it (``solves``, ``inputs``, from
    :func:`step_inputs`), random and as the step gave it, against the
    plain version at ``limit`` of each lane's scale (random input) and at
    ``STEP_INPUT_LIMIT`` of the solve's scale (the step's input).  On the step's input the Poisson solve's nudged singular lane
    is held apart: its solution is the rhs's rounding amplified
    (``step_input_singular_rel_err``).  Timed warm (10 reps, as phase 6 times) on the
    random input, on the same values with the step's exact zeros (the pad
    rows and lanes: all of them, the lanes only, the rows only), on the
    step's own input and on the random input again, then with the L2
    flushed; ``library_ms`` one ``torch.matmul`` with the inverses of the
    padded systems, per lane for the Poisson solve (rank r reads lanes
    r * stride..).  Returns the records."""
    import numpy as np

    rng = np.random.default_rng(13)
    route = route_of(model)
    solvers = banded_solvers(model)
    pres = model.solver_pres._solver
    singular = np.flatnonzero(np.abs(pres.lam + pres.alpha) < 1e-8)
    inverses = {}
    records = []
    for (label, shape, axis, stride), per_step in sorted(solves.items()):
        solver = solvers[label]
        given = inputs[(label, shape, axis, stride)]
        b = random_field(torch, rng, shape, model.dtype, model.device, given.is_complex())
        out_k = solver.solve(b, axis, stride)
        torch.cuda.synchronize()
        diff, rel = lane_rel_err(torch, out_k, solver.plain(b, axis, stride), axis)
        out_given = solver.solve(given, axis, stride)
        torch.cuda.synchronize()
        plain_given = solver.plain(given, axis, stride)
        err = torch.abs(out_given - plain_given)
        apart = torch.zeros_like(err[..., :1] if axis == b.ndim - 1 else err[:, :1],
                                 dtype=torch.bool)
        if label == "poisson":  # y-pencil lanes: global lane i is rank i // stride's lane i % stride
            for i in singular:
                apart[i // stride, i % stride] = True
        kept = torch.where(apart, torch.zeros_like(plain_given), plain_given)
        rel_given = float(torch.max(torch.where(apart, torch.zeros_like(err), err))) / \
            float(torch.max(torch.abs(kept)))
        rel_apart = float(torch.max(torch.where(apart, err, torch.zeros_like(err)))) / \
            float(torch.max(torch.abs(plain_given)))
        zeros = given == 0
        others = tuple(d for d in range(b.ndim) if d != axis)
        variants = {"zero_pattern": b * ~zeros,
                    "zero_lanes": b * ~torch.all(zeros, dim=axis, keepdim=True),
                    "zero_rows": b * ~torch.all(zeros, dim=others, keepdim=True)}
        if label not in inverses:
            inverses[label] = banded_inverses(torch, solver.kernel)
        inv = inverses[label]
        if not solver.kernel.per_lane and b.is_complex():
            if axis != b.ndim - 1:
                raise AssertionError(f"banded_solve/{label}: complex solve along axis {axis}")

            def lib(inv=inv[0], b=b):  # the real view's Re and Im rows in one product
                out = torch.matmul(torch.view_as_real(b).transpose(-1, -2), inv.T)
                return torch.view_as_complex(out.transpose(-1, -2).contiguous())
        elif not solver.kernel.per_lane:
            def lib(inv=inv[0], b=b, axis=axis):
                return torch.movedim(torch.matmul(inv, torch.movedim(b, axis, -2)), -2, axis)
        else:
            if axis != b.ndim - 1:
                raise AssertionError(f"banded_solve/{label}: per-lane solve along axis {axis}")
            ranks, lanes = b.shape[0], b.shape[1]
            idx = (torch.arange(ranks, device=b.device)[:, None] * stride
                   + torch.arange(lanes, device=b.device)[None, :])
            lane_inv = inv.view(ranks, lanes, *inv.shape[1:]) if ranks * stride == inv.shape[0] \
                and stride == lanes else inv[idx]

            def lib(inv=lane_inv, b=b):
                return lane_matmul(torch, inv, b)
        n = shape[axis]
        shape3 = (2 if b.is_complex() else 1, n, b.numel() // n)
        flops, nbytes = solver.kernel.flops(shape3), solver.kernel.bytes_moved(shape3)
        t_op = flops / (F64_TFLOPS * 1e12) * 1e3
        t_mem = nbytes / (HBM_TB_PER_S * 1e12) * 1e3
        rec = {"kernel": "banded_solve", "route": route, "case": label, "shape": list(shape),
               "axis": axis, "factor_batch_stride": stride, "per_step": per_step,
               "per_lane": solver.kernel.per_lane, "dtype": str(model.dtype).replace("torch.", ""),
               "max_abs_err": diff, "max_rel_err": rel,
               "step_input_max_rel_err": rel_given, "step_input_singular_rel_err": rel_apart,
               "step_input_zeros": int(zeros.sum()),
               "library_max_rel_err": lane_rel_err(torch, lib(), out_k, axis)[1],
               **banded_layout(solver, b, axis)}
        rec["kernel_ms"], rec["kernel_enqueue_ms"] = time_queued_ms(
            torch, lambda: solver.solve(b, axis, stride), QUEUED_REPS)
        rec["kernel_loop_ms"] = time_ms(torch, lambda: solver.solve(b, axis, stride), 10)
        for name, v in variants.items():
            rec[f"kernel_{name}_ms"] = time_queued_ms(
                torch, lambda v=v: solver.solve(v, axis, stride), QUEUED_REPS)[0]
        rec.update(
            kernel_step_input_ms=time_queued_ms(torch, lambda: solver.solve(given, axis, stride), QUEUED_REPS)[0],
            kernel_repeat_ms=time_queued_ms(torch, lambda: solver.solve(b, axis, stride), QUEUED_REPS)[0],
            kernel_cold_ms=time_cold_ms(torch, lambda: solver.solve(b, axis, stride), 10),
            plain_ms=time_ms(torch, lambda: solver.plain(b, axis, stride), 3),
            library_ms=time_queued_ms(torch, lib, 10)[0], flops=flops, bytes=nbytes,
            bound_ms=max(t_op, t_mem), bound_by="operations" if t_op >= t_mem else "bytes")
        print(f"{phase} " + json.dumps(rec))
        if rec["path"] != expected_path(model, label):
            raise AssertionError(f"banded_solve/{label} {shape}: the step's system took the "
                                 f"{rec['path']} path")
        if not (rel <= limit and rel_given <= STEP_INPUT_LIMIT):
            raise AssertionError(f"banded_solve/{label} {shape} on the mesh: rel err {rel:.3e} "
                                 f"(limit {limit:g}), on the step's input {rel_given:.3e} "
                                 f"(limit {STEP_INPUT_LIMIT:g})")
        if not rec["library_max_rel_err"] <= LIBRARY_LIMIT:
            raise AssertionError(f"banded_solve/{label} {shape}: the library yardstick solves "
                                 f"another system (rel err {rec['library_max_rel_err']:.3e})")
        records.append(rec)
    step = {key: sum(r["per_step"] * r[key] for r in records)
            for key in records[0] if key.startswith("kernel_") or key in (
                "plain_ms", "library_ms", "bound_ms")}
    print(f"{phase} banded_solve, one meshed {label_of(model)} step "
          f"({sum(r['per_step'] for r in records)} launches): " + json.dumps(step))
    return records


def ring_case(torch, pt, mesh, pencil_shape, x_to_y, dtype, rng):
    """A random input of ``pencil_shape`` with a zero pad, as the step
    gives the flip (complex values for a complex ``dtype``)."""
    p = mesh.nranks
    if x_to_y:
        shape = (pencil_shape[1], pencil_shape[2] * p)
        place = "place_x_pencil"
    else:
        shape = (pencil_shape[1] * p, pencil_shape[2])
        place = "place_y_pencil"
    values = rng.uniform(-1.0, 1.0, size=shape)
    if dtype.is_complex:
        values = values + 1j * rng.uniform(-1.0, 1.0, size=shape)
    return getattr(pt.parallel.Decomp2d(shape, mesh), place)(values, dtype)


def ring_library(block, p, x_to_y):
    """One PyTorch call for the same function: ``.contiguous()`` of the
    permuted view (timed here only; the port never calls it)."""
    if x_to_y:
        c, w = block.shape[1] // p, block.shape[2]
        return block.view(p, p, c, w).permute(1, 2, 0, 3).contiguous().view(p, c, p * w)
    c, w = block.shape[1], block.shape[2] // p
    return block.view(p, c, p, w).permute(2, 0, 1, 3).contiguous().view(p, p * c, w)


def square_ring_checks(torch, p):
    """Phase 12's fixed flips: ``(label, pencil shape, x_to_y, dtype,
    timed)`` of the rbc1025 spectral and physical squares (timed) and the
    129^2 ones in f64 and f32."""
    checks = []
    for label, n, timed in (("rbc1025_spectral", 1023, True), ("rbc1025_physical", 1025, True),
                            ("n129_physical", 129, False), ("n129_spectral", 127, False)):
        np_ = n + (-n) % p
        for x_to_y in (True, False):
            shape = (p, np_, np_ // p) if x_to_y else (p, np_ // p, np_)
            dtypes = (torch.float64,) if timed else (torch.float64, torch.float32)
            for dtype in dtypes:
                checks.append((label, shape, x_to_y, dtype, timed))
    return checks


def complex_ring_checks(torch, p, cfg):
    """Phase 19's fixed flips: the complex spectral pencils of ``cfg``'s
    periodic cell (nx/2+1 modes by ny-2 rows, padded to ``p``) in
    complex128 and complex64, both directions, untimed."""
    m0, m1 = cfg["nx"] // 2 + 1, cfg["ny"] - 2
    n0, n1 = m0 + (-m0) % p, m1 + (-m1) % p
    return [(f"periodic{cfg['nx']}_spectral", (p, n0, n1 // p) if x_to_y else (p, n0 // p, n1),
             x_to_y, dtype, False)
            for x_to_y in (True, False) for dtype in (torch.complex128, torch.complex64)]


def phase_ring(torch, pt, mesh, flips, fixed, route="mesh", phase="phase12"):
    """Phase 12 (phase 19 for the periodic cell, whose step flips complex
    pencils): the pencil-transpose kernel bit for bit against its plain
    ring and against the library call, both directions, at the ``fixed``
    checks and at every shape a meshed step of the cell flips (``flips``,
    timed).  Returns the records of the step's flips (``per_step``: how
    often a step flips that shape)."""
    import numpy as np

    rng = np.random.default_rng(12)
    p = mesh.nranks
    ring = mesh.ring
    checks = [c + (0,) for c in fixed]  # (label, pencil shape, x_to_y, dtype, timed, per_step)
    for (shape, x_to_y, dtype), count in sorted(flips.items()):
        checks.append(("step", shape, x_to_y, getattr(torch, dtype), True, count))
    records = []
    for label, shape, x_to_y, dtype, timed, per_step in checks:
        block = ring_case(torch, pt, mesh, shape, x_to_y, dtype, rng)
        before = ring.launches
        out = ring.apply(block, x_to_y)
        torch.cuda.synchronize()
        plain = ring.plain(block, x_to_y)
        lib = ring_library(block, p, x_to_y)
        diff = float(torch.max(torch.abs(out - plain)))
        rec = {"kernel": "ring_transpose", "route": route, "case": label, "shape": list(shape),
               "x_to_y": x_to_y, "per_step": per_step,
               "dtype": str(dtype).replace("torch.", ""), "max_abs_err": diff,
               "max_rel_err": diff / float(torch.max(torch.abs(plain)))}
        if not (torch.equal(out, plain) and torch.equal(out, lib)) or ring.launches != before + 1:
            raise AssertionError(f"ring_transpose {label} {shape} x_to_y={x_to_y} {dtype}: "
                                 f"kernel differs from its plain version (max {diff:.3e}) or "
                                 "did not launch once")
        if timed:
            nbytes = ring.bytes_moved(block)
            warm, host = time_queued_ms(torch, lambda: ring.apply(block, x_to_y), 50)
            rec.update(kernel_ms=time_cold_ms(torch, lambda: ring.apply(block, x_to_y), 50),
                       kernel_warm_ms=warm, kernel_enqueue_ms=host,
                       plain_ms=time_queued_ms(torch, lambda: ring.plain(block, x_to_y), 10)[0],
                       library_ms=time_cold_ms(torch, lambda: ring_library(block, p, x_to_y), 50),
                       bytes=nbytes, bound_ms=nbytes / (HBM_TB_PER_S * 1e12) * 1e3,
                       bound_by="bytes")
        print(f"{phase} " + json.dumps(rec))
        records.append(rec)
    return [r for r in records if r["per_step"]]


def phase_meshed_vs_serial(pt, cfg=None, phase="phase13"):
    """Phase 13 (phase 19 for the periodic cell at ``PERIODIC128``): the
    meshed route against the serial dense route on the card after 10 steps
    (rel 1e-11 of each field's scale), by default at 129^2."""
    cfg = cfg or dict(nx=129, ny=129, ra=1e7, pr=1.0, dt=2e-3, aspect=1.0, bc="rbc")
    states = {}
    for name, route in (("mesh", dict(mesh=pt.make_mesh(MESH_RANKS))), ("serial", DENSE)):
        m = pt.Navier2D(**cfg, device="cuda", **route)
        m.init_random(0.1, seed=0)
        m.update_n(10)
        states[name] = pt.convert.state_to_numpy(m)
    worst = 0.0
    for name, ref in states["serial"].items():
        rel = float(abs(states["mesh"][name] - ref).max() / max(abs(ref).max(), 1e-300))
        worst = max(worst, rel)
        if not rel <= 1e-11:
            raise AssertionError(f"meshed vs serial {name}: rel {rel:.3e} > 1e-11")
    print(f"{phase} meshed ({MESH_RANKS} ranks) vs serial dense {cfg['nx']}x{cfg['ny']} "
          f"{cfg['bc']}{' periodic' if cfg.get('periodic') else ''} f64 10 steps on the card: "
          f"max rel diff {worst:.3e} (limit 1e-11)")


# -- the periodic cell -----------------------------------------------------------------


def phase_periodic_small(pt):
    """Phase 16: the periodic cell at the reference's example size
    (``PERIODIC128``, 10 steps): each route on the card against the same
    route on the CPU (plain versions, FFT transforms), to 1e-11 of each
    field's scale; and the fused route against the dense one on the card,
    to 1e-11 for ``temp``, ``velx``, ``vely`` and ``pres``.  The
    pseudo-pressure is held apart there, to ``PSEU_ROUTES_LIMIT``: the two
    routes solve its Poisson problem by other algorithms (fast
    diagonalisation against the banded tensor solver), whose roundings
    differ by 8.03e-11 of its scale in the JAX package's own two routes at
    this size (and by the same on the CPU here, printed beside it)."""
    states = {}
    for route in ("fused", "dense"):
        for dev in ("cuda", "cpu"):
            m = pt.Navier2D(**PERIODIC128, device=dev, step_kernel=route, conv_kernel=route)
            m.init_random(0.1, seed=0)
            m.update_n(10)
            states[(route, dev)] = pt.convert.state_to_numpy(m)
            obs = m.get_observables()
            if not all(math.isfinite(v) for v in obs):
                raise AssertionError(f"periodic128 {route} on {dev}: observables {obs}")

    def rel(a, b, name):
        ref = states[b][name]
        return float(abs(states[a][name] - ref).max() / max(abs(ref).max(), 1e-300))

    for label, a, b in (("fused route, card vs cpu", ("fused", "cuda"), ("fused", "cpu")),
                        ("dense route, card vs cpu", ("dense", "cuda"), ("dense", "cpu")),
                        ("fused vs dense on the card", ("fused", "cuda"), ("dense", "cuda"))):
        diffs = {name: rel(a, b, name) for name in states[b]}
        apart = {"pseu"} if a[0] != b[0] else set()
        worst = max(v for k, v in diffs.items() if k not in apart)
        line = f"max rel diff {worst:.3e} (limit 1e-11)"
        if apart:
            cpu = rel(("fused", "cpu"), ("dense", "cpu"), "pseu")
            line += (f"; pseu {diffs['pseu']:.3e} (limit {PSEU_ROUTES_LIMIT:g}; the same routes "
                     f"on the CPU {cpu:.3e})")
        print(f"phase16 periodic128 f64 (Ra=1e5, dt=0.01) 10 steps, {label}: {line}")
        if not worst <= 1e-11 or (apart and not diffs["pseu"] <= PSEU_ROUTES_LIMIT):
            raise AssertionError(f"periodic128 {label}: {diffs}")


def transform_cases(pt, torch, cfg):
    """``{method: Space2}`` of the velocity space of ``cfg``'s cell on the
    card, one for each Chebyshev transform method."""
    bx = (pt.bases.fourier_r2c if cfg.get("periodic") else pt.bases.cheb_dirichlet)(cfg["nx"])
    by = pt.bases.cheb_dirichlet(cfg["ny"])
    return {m: pt.Space2(bx, by, device="cuda", dtype=torch.float64, method=m)
            for m in ("matmul", "fft")}


def phase_methods(torch, pt):
    """Phase 17: the two transform methods of the Chebyshev axes on the
    card.  At ``rbc1025`` and ``periodic1024`` the velocity space's
    forward, backward, ``to_ortho`` and both derivative syntheses under
    ``"fft"`` against ``"matmul"`` (1e-12 of the result's scale), each
    timed (10 reps); then, on each route of each cell, a model built with
    each method, ``MAIN_STEPS`` bare ``update_n`` steps timed (ms/step),
    matmul then fft.  Returns ``{cell route: {method: ms}}``; the faster
    method is the card's default (``bases.CARD_METHOD``)."""
    import numpy as np

    rng = np.random.default_rng(17)
    out = {}
    for name, cfg in (("rbc1025", RBC1025), ("periodic1024", PERIODIC1024)):
        spaces = transform_cases(pt, torch, cfg)
        v = torch.as_tensor(rng.uniform(-1.0, 1.0, spaces["fft"].shape_physical)).to("cuda")
        vhat = spaces["matmul"].forward(v)
        ops = {"forward": (lambda sp: sp.forward(v)), "backward": (lambda sp: sp.backward(vhat)),
               "to_ortho": (lambda sp: sp.to_ortho(vhat)),
               "backward_gradient_x": (lambda sp: sp.backward_gradient(vhat, (1, 0))),
               "backward_gradient_y": (lambda sp: sp.backward_gradient(vhat, (0, 1)))}
        rec = {}
        for op, fn in ops.items():
            got = {m: fn(sp) for m, sp in spaces.items()}
            _, rel = rel_err(torch, got["fft"], got["matmul"])
            rec[op] = {"fft_vs_matmul_rel": rel, **{f"{m}_ms": time_ms(torch, lambda sp=sp: fn(sp), 10)
                                                  for m, sp in spaces.items()}}
            if not rel <= 1e-12:
                raise AssertionError(f"{name} {op}: fft vs matmul rel {rel:.3e} > 1e-12")
        print(f"phase17 transforms {name} f64 velocity space, fft vs matmul: " + json.dumps(rec))
        for route in ("fused", "dense"):
            times = {}
            for method in ("matmul", "fft"):
                model = pt.Navier2D(**cfg, device="cuda", step_kernel=route, conv_kernel=route,
                                    method=method)
                model.init_random(0.1, seed=0)
                model.chunk_runner()
                model.update_n(2)
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                model.update_n(MAIN_STEPS)
                torch.cuda.synchronize()
                times[method] = (time.perf_counter() - t0) / MAIN_STEPS * 1e3
                del model
                torch.cuda.empty_cache()
            out[f"{name} {route}"] = times
            print(f"phase17 {name} f64 {route} route, bare update_n {MAIN_STEPS} steps: "
                  f"matmul {times['matmul']:.4f} ms/step, fft {times['fft']:.4f} ms/step "
                  f"(faster: {min(times, key=times.get)}; the card's default "
                  f"{pt.bases.CARD_METHOD})")
    return out


def phase_step_inputs(torch, model, phase):
    """:func:`step_inputs` of one meshed step of ``model``, printed, with
    the flips and the banded solves counted against ``PER_STEP``."""
    flips, solves, inputs = step_inputs(torch, model)
    print(f"{phase} flips of one meshed {label_of(model)} step: " + json.dumps(
        [{"shape": list(k[0]), "x_to_y": k[1], "dtype": k[2], "count": v}
         for k, v in sorted(flips.items())]))
    print(f"{phase} banded solves of one meshed {label_of(model)} step: " + json.dumps(
        [{"solver": k[0], "shape": list(k[1]), "axis": k[2], "factor_batch_stride": k[3],
          "count": v} for k, v in sorted(solves.items())]))
    route = route_of(model)
    for name, counted in (("ring_transpose", sum(flips.values())),
                          ("banded_solve", sum(solves.values()))):
        if counted != PER_STEP[route][name]:
            raise AssertionError(f"a meshed {label_of(model)} step ran {name} {counted} times")
    return flips, solves, inputs


def phase_periodic_mesh(torch, pt, records, launches, bare_ms):
    """Phase 19: ``periodic1024`` on the meshed route (4 ranks on the card,
    complex spectral pencils): the pencil-transpose kernel on the complex
    spectral pencils of ``PERIODIC128`` (complex128 and complex64) and at
    every pencil a meshed ``periodic1024`` step flips, bit for bit and
    timed (cold L2) as phase 12 times it; the banded kernel at every input
    the step gives it, as phase 12 holds it; meshed against serial dense at
    ``PERIODIC128`` (rel 1e-11); then the main path (exactly 37 flips and 4
    banded launches a step), the profile and the chunk gates of phase 14."""
    t0 = time.perf_counter()
    mesh = pt.make_mesh(MESH_RANKS)
    model = pt.Navier2D(**PERIODIC1024, mesh=mesh)
    model.init_random(0.1, seed=0)
    print(f"periodic1024 meshed-route model build ({mesh}): {time.perf_counter() - t0:.2f} s")
    flips, solves, inputs = phase_step_inputs(torch, model, "phase19")
    records += phase_ring(torch, pt, mesh, flips,
                          complex_ring_checks(torch, MESH_RANKS, PERIODIC128),
                          "periodic_mesh", "phase19")
    records += phase_mesh_banded(torch, model, solves, inputs, 1e-12, "phase19")
    del inputs
    print("phase19 ok")
    phase_meshed_vs_serial(pt, PERIODIC128, "phase19")
    launches["periodic_mesh"], bare_ms["periodic_mesh"] = phase_main(torch, pt, model, "phase19")
    phase_profile(torch, model, bare_ms["periodic_mesh"], phase="phase19")
    phase_chunks(torch, pt, model)


def phase_hc1025(torch, pt, records, launches, bare_ms):
    """Phase 20: ``hc1025`` on the fused route, then the dense one: the
    route's kernels against their plain versions at ``hc129`` (f64 1e-12,
    f32 1e-4) and at ``hc1025`` f64, timed (the fused kernels fed HC's
    operators as phase 1 holds them; the banded kernel as phase 6, its
    temperature y solve on the general path, one chain a lane); the main
    path (3 conv and 7 stage launches, or 7 banded launches of which one a
    step runs the general path), the profile and the chunk gates of phase
    14."""
    for route in ("fused", "dense"):
        t0 = time.perf_counter()
        model = pt.Navier2D.new_confined(**HC1025, device="cuda", step_kernel=route,
                                         conv_kernel=route)
        print(f"hc1025 {route}-route model build: {time.perf_counter() - t0:.2f} s")
        for dt in (torch.float64, torch.float32):
            small = pt.Navier2D(**HC_CELLS["hc129"], device="cuda", dtype=dt, step_kernel=route,
                                conv_kernel=route)
            limit = 1e-12 if dt == torch.float64 else 1e-4
            if route == "fused":
                phase_kernels(torch, small, limit, False, "phase20")
            else:
                phase_banded(torch, pt, small, limit, False, "phase20")
        if route == "fused":
            records += phase_kernels(torch, model, 1e-12, True, "phase20")
        else:
            records += phase_banded(torch, pt, model, 1e-12, True, "phase20")
        print(f"phase20 {route} ok")
        key = route_of(model)
        launches[key], bare_ms[key] = phase_main(torch, pt, model, "phase20")
        if route == "dense":
            general = [k for k in model.kernels()["banded_solve"] if k.path == "general"]
            runs = [k.launches for k in general]
            print(f"phase20 hc1025 dense route: general-path banded solves {len(general)}, "
                  f"launched {runs} times in the {2 * MAIN_STEPS} counted steps")
            if runs != [2 * MAIN_STEPS]:
                raise AssertionError(f"hc1025: the general path launched {runs} times")
        phase_profile(torch, model, bare_ms[key], phase="phase20")
        phase_chunks(torch, pt, model)
        del model
        torch.cuda.empty_cache()


def phase_hc_small(pt):
    """Phase 21: HC's correctness at ``HC_CELLS`` (129^2 confined, 128x129
    periodic), 10 steps from ``init_random(0.1, seed=0)`` on every route
    (fused, dense, meshed on 4 ranks): each on the card against the same
    route on the CPU (plain versions) with the card's Chebyshev transform
    method, to 1e-11 of each field's scale (against the CPU's own "fft"
    method too, printed: the two methods round HC's lift otherwise, and
    after 10 steps at Ra=1e5 the temperature's scale is 1/70 of the lift's,
    3.5e-3 against 0.243); the fused route
    against the dense one on the card to 1e-11, pseu to
    ``PSEU_ROUTES_LIMIT``, printed beside the same routes on the CPU and
    the JAX package's own routes (``REFERENCE_ROUTES_DIFF``);
    the meshed route against the dense one on the card to 1e-11."""
    for cell, cfg in HC_CELLS.items():
        states = {}
        for route in ("fused", "dense", "mesh"):
            # (device, Chebyshev transform method: on a mesh the method of
            # the host's lift transforms, its pencils' axes being products)
            runs = [("cuda", None), ("cpu", pt.bases.CARD_METHOD), ("cpu", pt.bases.CPU_METHOD)]
            for dev, method in runs:
                if route == "mesh":
                    kw = dict(mesh=pt.make_mesh(MESH_RANKS, dev), method=method)
                else:
                    kw = dict(device=dev, step_kernel=route, conv_kernel=route, method=method)
                m = pt.Navier2D(**cfg, **kw)
                m.init_random(0.1, seed=0)
                m.update_n(10)
                key = (route, dev) if dev == "cuda" or method == pt.bases.CARD_METHOD else \
                    (route, "cpu_fft")
                states[key] = pt.convert.state_to_numpy(m)
                obs = m.get_observables()
                if not all(math.isfinite(v) for v in obs):
                    raise AssertionError(f"{cell} {route} on {dev}: observables {obs}")

        def rel(a, b, name):
            ref = states[b][name]
            return float(abs(states[a][name] - ref).max() / max(abs(ref).max(), 1e-300))

        limits = {"pseu": PSEU_ROUTES_LIMIT}
        for label, a, b, lims in (
                ("fused route, card vs cpu", ("fused", "cuda"), ("fused", "cpu"), {}),
                ("dense route, card vs cpu", ("dense", "cuda"), ("dense", "cpu"), {}),
                ("meshed route, card vs cpu", ("mesh", "cuda"), ("mesh", "cpu"), {}),
                ("meshed vs dense on the card", ("mesh", "cuda"), ("dense", "cuda"), {}),
                ("fused vs dense on the card", ("fused", "cuda"), ("dense", "cuda"), limits)):
            diffs = {name: rel(a, b, name) for name in states[b]}
            over = {k: v for k, v in diffs.items() if not v <= lims.get(k, 1e-11)}
            line = f"max rel diff {max(v for k, v in diffs.items() if k not in lims):.3e} (limit 1e-11)"
            for name, lim in lims.items():
                cpu = rel(("fused", "cpu"), ("dense", "cpu"), name)
                line += (f"; {name} {diffs[name]:.3e} (limit {lim:g}; the same routes on the CPU "
                         f"{cpu:.3e}, the JAX package's {REFERENCE_ROUTES_DIFF[cell][name]:.3e})")
            if b[1] == "cpu":
                fft = max(rel(a, (b[0], "cpu_fft"), name) for name in states[b])
                line += f"; against the CPU's {pt.bases.CPU_METHOD!r} method {fft:.3e}"
            print(f"phase21 {cell} f64 10 steps, {label}: {line}")
            if over:
                raise AssertionError(f"{cell} {label}: {over}")


# -- the scenario modifiers and solid obstacles -------------------------------------------


def scenario_model(pt, cfg, route, device="cuda", scenario=SCN_SCENARIO, method=None):
    """A model of ``cfg`` on ``route`` (fused, dense, mesh) with ``scenario``
    and the roughness obstacle, from ``init_random(0.1, seed=0)``; a scalar
    at matched diffusivity is released equal to the temperature (its
    spectral state copied), at another diffusivity as half of it."""
    cfg = dict(cfg)
    periodic = cfg.pop("periodic", False)
    if route == "mesh":
        kw = dict(mesh=pt.make_mesh(MESH_RANKS, device))
    else:
        kw = dict(device=device, step_kernel=route, conv_kernel=route)
    model = pt.Navier2D(**cfg, periodic=periodic, method=method,
                        scenario=pt.ScenarioConfig(**scenario), **kw)
    model.init_random(0.1, seed=0)
    model.set_solid(*pt.solid_roughness_sinusoid(*model.x, *ROUGHNESS))
    if "scal" in model.state._fields:
        matched = scenario.get("scalar_kappa") is None
        temp = model.state.temp
        model.state = model.state._replace(scal=temp.clone() if matched else 0.5 * temp)
    return model


def phase_mirror(torch, model, phase="phase22"):
    """The passive scalar released equal to the temperature at matched
    diffusivity against the temperature (expected bit for bit; limit
    ``MIRROR_LIMIT`` of the physical fields, as the JAX package's example
    holds it), and Sherwood against Nu (rel 1e-11)."""
    bit = torch.equal(model.state.scal, model.state.temp)
    drift = float(abs(model.get_field("scal") - model.get_field("temp")).max())
    obs = dict(zip(model.observable_names, model.get_observables()))
    rel = abs(obs["sherwood"] / obs["nu"] - 1.0)
    print(f"{phase} {label_of(model)} {route_of(model)} route at t={model.time:.4f}: scal vs temp "
          f"bit for bit {bit}, max |scal - temp| {drift:.3e} (limit {MIRROR_LIMIT:g}); "
          f"sherwood {obs['sherwood']!r} vs nu {obs['nu']!r}: rel {rel:.3e} (limit 1e-11)")
    if not (drift <= MIRROR_LIMIT and rel <= 1e-11):
        raise AssertionError(f"{label_of(model)}: the scalar left the temperature ({drift:.3e}) "
                             f"or sherwood left nu ({rel:.3e})")


def phase_scn1025(torch, pt, records, launches, bare_ms):
    """Phase 22: ``rbc1025_scn`` on the fused, dense and meshed routes: the
    route's kernels against their plain versions, timed (phases 1, 6 and
    12 at this cell), the main path with its exact launches, the profile,
    the mirror and Sherwood (:func:`phase_mirror`), and the chunk gates of
    phase 14."""
    for route in ("fused", "dense", "mesh"):
        t0 = time.perf_counter()
        model = scenario_model(pt, RBC1025, route)
        print(f"rbc1025_scn {route}-route model build and set_solid: "
              f"{time.perf_counter() - t0:.2f} s")
        if route == "fused":
            records += phase_kernels(torch, model, 1e-12, True, "phase22")
        elif route == "dense":
            records += phase_banded(torch, pt, model, 1e-12, True, "phase22")
        else:
            flips, solves, inputs = phase_step_inputs(torch, model, "phase22")
            records += phase_ring(torch, pt, model.mesh, flips, [], "scn_mesh", "phase22")
            records += phase_mesh_banded(torch, model, solves, inputs, 1e-12, "phase22")
            del inputs
        print(f"phase22 {route} ok")
        key = route_of(model)
        launches[key], bare_ms[key] = phase_main(torch, pt, model, "phase22")
        phase_mirror(torch, model)
        phase_profile(torch, model, bare_ms[key], phase="phase22")
        phase_chunks(torch, pt, model)
        del model
        torch.cuda.empty_cache()


def phase_scn_small(pt):
    """Phase 23: the JAX package's scenario checks on the card.  At
    ``SCN_CELLS`` (129^2 and 128x129, Ra=1e5, dt=0.01), every modifier with
    the scalar at 3x the thermal diffusivity and the roughness obstacle, 10
    steps on every route: card vs CPU (the card's transform method on both
    sides) to 1e-11 of each field's scale, ``scal`` included, and meshed vs
    dense on the card to 1e-11.  Then at 129^2: the Coriolis force (f=2)
    absorbed by the pressure (Ra=1e4, 50 steps from ``set_velocity(0.1, 1,
    1)``/``set_temperature(0.1, 1, 1)``: velocities and temperature within
    rel 1e-3 of the non-rotating run, the pressure more than 1e-2 apart,
    ``tests/test_workloads.py``), and a cylinder (radius 0.3) stopping the
    flow (Ra=1e5, 100 steps from ``set_velocity(0.2, 1, 1)``/
    ``set_temperature(0.2, 1, 1)``: the inner speed below 2e-3 and the
    fluid's over 50x it, ``tests/test_solid_masks.py``)."""
    for cell, cfg in SCN_CELLS.items():
        ka = pt.models.functions.get_ka(cfg["ra"], cfg["pr"], 2.0)
        scenario = dict(SCN_SCENARIO, scalar_kappa=3.0 * ka)
        states = {}
        for route in ("fused", "dense", "mesh"):
            for dev, method in (("cuda", None), ("cpu", pt.bases.CARD_METHOD)):
                m = scenario_model(pt, cfg, route, dev, scenario, method)
                m.update_n(10)
                states[(route, dev)] = pt.convert.state_to_numpy(m)
                obs = m.get_observables()
                if not all(math.isfinite(v) for v in obs):
                    raise AssertionError(f"{cell} {route} on {dev}: observables {obs}")

        def rel(a, b, name):
            ref = states[b][name]
            return float(abs(states[a][name] - ref).max() / max(abs(ref).max(), 1e-300))

        for label, a, b in (("fused route, card vs cpu", ("fused", "cuda"), ("fused", "cpu")),
                            ("dense route, card vs cpu", ("dense", "cuda"), ("dense", "cpu")),
                            ("meshed route, card vs cpu", ("mesh", "cuda"), ("mesh", "cpu")),
                            ("meshed vs dense on the card", ("mesh", "cuda"), ("dense", "cuda"))):
            diffs = {name: rel(a, b, name) for name in states[b]}
            print(f"phase23 {cell} f64 10 steps (coriolis 2, scalar at 3x ka, roughness), "
                  f"{label}: max rel diff {max(diffs.values()):.3e} (limit 1e-11); scal "
                  f"{diffs['scal']:.3e}")
            if not max(diffs.values()) <= 1e-11:
                raise AssertionError(f"{cell} {label}: {diffs}")
    # the Coriolis force is absorbed by the pressure
    cfg = dict(SCN_CELLS["scn129"], ra=1e4)
    runs = {}
    for name, scenario in (("base", None), ("rot", pt.ScenarioConfig(coriolis=2.0))):
        m = pt.Navier2D(**cfg, device="cuda", scenario=scenario)
        m.set_velocity(0.1, 1.0, 1.0)
        m.set_temperature(0.1, 1.0, 1.0)
        m.update_n(50)
        runs[name] = m
    drift = {}
    for name in ("velx", "vely", "temp", "pres"):
        a, b = runs["base"].get_field(name), runs["rot"].get_field(name)
        drift[name] = float(abs(a - b).max() / max(abs(a).max(), 1e-300))
    print("phase23 rotating frame f=2, 129^2 Ra=1e4, 50 steps, fused route: rel drift "
          + json.dumps(drift) + " (velocities and temp < 1e-3, pres > 1e-2)")
    if not (max(drift["velx"], drift["vely"], drift["temp"]) < 1e-3 < 1e-2 < drift["pres"]):
        raise AssertionError(f"the Coriolis force was not absorbed by the pressure: {drift}")
    # a cylinder stops the flow inside it
    m = pt.Navier2D.new_confined(**SCN_CELLS["scn129"], device="cuda")
    mask, value = pt.solid_cylinder_inner(*m.x, 0.0, 0.0, 0.3)
    m.set_solid(mask, value)
    m.set_velocity(0.2, 1.0, 1.0)
    m.set_temperature(0.2, 1.0, 1.0)
    m.update_n(100)
    speed = (m.get_field("velx") ** 2 + m.get_field("vely") ** 2) ** 0.5
    deep = mask > 0.99
    inner, fluid = float(speed[deep].max()), float(speed[~deep].max())
    print(f"phase23 cylinder r=0.3, 129^2 Ra=1e5, 100 steps, fused route: max speed inside "
          f"{inner:.3e} (limit 2e-3), in the fluid {fluid:.3e} ({fluid / inner:.1f}x, limit 50x)")
    if m.exit() or not (inner < 2e-3 and fluid > 50.0 * inner):
        raise AssertionError("the cylinder did not stop the flow inside it")


# -- ensembles: K members of one model, every launch serving all K -----------------------


#: phase 24's cell, the JAX package's ``ensemble129`` (``bench.py:104,227,2852``:
#: 129^2, Ra=1e7, dt=2e-3, K in {1, 8, 32}), seeded as its ``from_seeds``
ENSEMBLE129 = dict(nx=129, ny=129, ra=1e7, pr=1.0, dt=2e-3, aspect=1.0, bc="rbc")
ENSEMBLE_KS = (1, 8, 32)
#: the members whose kernel instances phase 24 times (the ``ens129_*`` rows)
ENSEMBLE_TIMED_K = 32
#: phase 25's members at ``rbc1025``, by route
ENSEMBLE1025_K = {"fused": 4, "dense": 2, "mesh": 2}
#: phase 26's cell: the sweep at the JAX package's roughness example's
#: parameters (``examples/navier_rbc_roughness.py``: Ra=1e5, dt=0.01)
SWEEP129 = dict(nx=129, ny=129, ra=1e5, pr=1.0, dt=0.01, aspect=1.0, bc="rbc")
#: members against solo models on the same route and card, relative to each
#: field's scale (the fused route is expected bit for bit: a member's blocks
#: run a one-member launch's tile loop)
ENSEMBLE_LIMIT = 1e-12
ENSEMBLE_STEPS = 10
#: at ``rbc1025`` cuBLAS runs a lone 1025^2 DGEMM with another kernel than
#: the batched product of K members (on an NVIDIA H100 80GB HBM3 no batched
#: form of the product matched the lone one bit for bit at 1025^2; at 129^2
#: and 513^2 every form did: ``scripts/batched_gemm_bits.py``), so members
#: and solo runs round their transforms apart at every step, and the
#: preconditioned Chebyshev solves amplify it (the dense route's
#: temperature solve alone: 3.5e-10 from last-bit differences of its
#: input).  Phase 25 holds member 0 to the larger of ``ENSEMBLE_LIMIT`` and
#: this factor times the route's own sensitivity, the solo run against the
#: solo run from a start state moved by one ulp: rounding injected at each
#: of the ``ENSEMBLE_STEPS`` steps, not once.
ULP_STEPS_FACTOR = ENSEMBLE_STEPS


def route_model(pt, cfg, route, **kw):
    """A model of ``cfg`` on ``route`` ("fused", "dense" or "mesh", 4 ranks
    on the card), with no initial condition set."""
    if route == "mesh":
        return pt.Navier2D(**cfg, mesh=pt.make_mesh(MESH_RANKS), **kw)
    return pt.Navier2D(**cfg, device="cuda", **(DENSE if route == "dense" else {}), **kw)


def prepare_ensemble(torch, ens, route, label, phase):
    """Build the ensemble's chunk runner (warm-up and the K-member step's
    capture) and print its time, the graph's pool, ``max_memory_allocated``
    and the launches a replay adds, which must be a solo step's."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    runner = ens.chunk_runner()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    if not runner.captured:
        raise AssertionError("the ensemble's chunk runner did not capture a CUDA graph")
    per_replay = {}
    for name, d in zip([n for n, ks in ens.model.kernels().items() for _ in ks], runner.delta):
        per_replay[name] = per_replay.get(name, 0) + d
    info = {"capture_s": wall, "graph_pool_mib": runner.pool_bytes / 2**20,
            "max_memory_allocated_mib": torch.cuda.max_memory_allocated() / 2**20,
            "held_before_mib": held / 2**20, "launches_a_replay": per_replay}
    print(f"{phase} chunk graph {label} K={ens.k} {route} route: " + json.dumps(info))
    if per_replay != PER_STEP[route]:
        raise AssertionError(f"a K={ens.k} replay launches {per_replay}, a solo step "
                             f"{PER_STEP[route]}")
    return info


def device_busy(torch, run, steps, want):
    """``(device busy us, wall us)`` of ``run()`` (``steps`` steps) under
    torch.profiler, taken again (up to ``PROFILE_ATTEMPTS`` times) until it
    recorded the launches ``want`` (by a part of the kernel's name); None
    when no attempt did."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_ATTEMPTS):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            run()
            torch.cuda.synchronize()
            wall_us = (time.perf_counter() - t0) * 1e6
        spans = sorted((e.time_range.start, e.time_range.end) for e in prof.events()
                       if e.device_type == DeviceType.CUDA)
        got = {k: sum(1 for e in prof.events() if e.device_type == DeviceType.CUDA
                      and k in e.name) for k in want}
        if got == {k: v * steps for k, v in want.items()} and spans:
            busy, cur_s, cur_e = 0.0, spans[0][0], spans[0][1]
            for s, e in spans[1:]:
                if s > cur_e:
                    busy += cur_e - cur_s
                    cur_s, cur_e = s, e
                else:
                    cur_e = max(cur_e, e)
            return busy + cur_e - cur_s, wall_us
    return None


def max_rel_diff(torch, a, b) -> float:
    """The largest field difference of two states relative to the field's
    scale (``b``'s)."""
    worst = 0.0
    for x, y in zip(a, b):
        scale = float(torch.max(torch.abs(y)))
        worst = max(worst, float(torch.max(torch.abs(x - y))) / (scale or 1.0))
    return worst


def field_rel_diffs(torch, a, b) -> dict:
    """Each field's largest difference between two states relative to the
    field's scale (``b``'s)."""
    out = {}
    for name, x, y in zip(b._fields, a, b):
        scale = float(torch.max(torch.abs(y)))
        out[name] = float(torch.max(torch.abs(x - y))) / (scale or 1.0)
    return out


def ensemble_vs_solo(torch, pt, cfg, route, ens, members, steps, phase, **kw):
    """Members ``members`` of ``ens`` (``from_seeds``, advanced ``steps``
    steps) against solo models of their seeds on the same route and card:
    the largest relative difference of any field, and whether every member
    is bit for bit its solo run."""
    worst, bitwise = 0.0, True
    for i in members:
        solo = route_model(pt, cfg, route, **kw)
        solo.init_random(0.1, seed=i)
        solo.update_n(steps)
        member = ens.member_state(i)
        worst = max(worst, max_rel_diff(torch, member, solo.state))
        bitwise = bitwise and all(torch.equal(x, y) for x, y in zip(member, solo.state))
    print(f"{phase} {route} route: members {list(members)} after {steps} steps against solo "
          f"models of their seeds: max rel diff {worst:.3e} (limit {ENSEMBLE_LIMIT:g}); bit for "
          f"bit {bitwise}")
    if not worst <= ENSEMBLE_LIMIT or (route == "fused" and not bitwise):
        raise AssertionError(f"{route}: ensemble members differ from their solo runs "
                             f"({worst:.3e}, bitwise {bitwise})")
    return worst, bitwise


def ensemble_checks(torch, pt, route, phase="phase24"):
    """Phase 24's checks on ``route`` at ``ENSEMBLE129``: K = 8 members
    against solo models after 10 steps; NaN isolation (member 0 poisoned in
    temp mode 0 dies with no step counted, the others bit for bit those of
    an unpoisoned ensemble); an all-dead ensemble ends ``integrate`` with
    ``"break"``; the sentinel chunk (member 3's velocities at 4x the CFL
    ceiling roll the chunk back and ``pinned`` marks member 3 alone)."""
    model = route_model(pt, ENSEMBLE129, route)
    ens = pt.NavierEnsemble.from_seeds(model, range(8))
    start = ens.state
    ens.update_n(ENSEMBLE_STEPS)
    ensemble_vs_solo(torch, pt, ENSEMBLE129, route, ens, range(8), ENSEMBLE_STEPS, phase)
    # NaN isolation
    poisoned = pt.NavierEnsemble(model, start)
    bad = poisoned.member_state(0)
    temp = bad.temp.clone()
    temp[(0,) * temp.ndim] = float("nan")
    poisoned.set_member(0, bad._replace(temp=temp))
    poisoned.update_n(ENSEMBLE_STEPS)
    alive, done = poisoned.alive().tolist(), poisoned.steps_done.tolist()
    survivors = all(torch.equal(x[1:], y[1:]) for x, y in zip(poisoned.state, ens.state))
    frozen = torch.isnan(poisoned.state.temp[0]).any().item()
    print(f"{phase} {route} route: NaN in member 0's temp mode 0: alive {alive}, steps_done "
          f"{done}, member 0 frozen at its poisoned state {frozen}, members 1-7 bit for bit "
          f"the unpoisoned ensemble's {survivors}; exit() {poisoned.exit()}")
    if alive != [False] + [True] * 7 or done != [0] + [ENSEMBLE_STEPS] * 7 or not survivors \
            or not frozen or poisoned.exit():
        raise AssertionError(f"{route}: NaN isolation failed")
    # all dead
    dead = pt.NavierEnsemble(model, start)
    dead.mark_dead(range(8))
    dead.write_intervall = 1e9  # no ensemble snapshot: the card machine may lack h5py
    result = pt.integrate(dead, 4 * model.dt, 2 * model.dt)
    print(f"{phase} {route} route: all members dead: integrate {result!r}, steps_done "
          f"{dead.steps_done.tolist()}")
    if result != "break" or dead.steps_done.any():
        raise AssertionError(f"{route}: an all-dead ensemble ran on ({result!r})")
    # the sentinel chunk
    spiked = pt.NavierEnsemble(model, start)
    spiked.set_stability(pt.config.StabilityConfig())
    member = spiked.member_state(3)
    _, (cfl, _, _) = model._step(member, with_sentinels=True)
    factor = 4.0 * spiked._stability.max_cfl / float(cfl)
    spiked.set_member(3, member._replace(velx=member.velx * factor, vely=member.vely * factor))
    before = spiked.state
    status = spiked.update_n(ENSEMBLE_STEPS)
    rolled = spiked.state is before and spiked.time == 0.0 and spiked.exit()
    print(f"{phase} {route} route: member 3's velocities x{factor:.4g} (CFL 4x the ceiling): "
          f"rolled back and latched {rolled}; status " + json.dumps(status._asdict()))
    if not (status.pre_divergence and status.pinned == (False,) * 3 + (True,) + (False,) * 4
            and rolled):
        raise AssertionError(f"{route}: the sentinel chunk did not pin member 3 alone")
    spiked.set_stability(None)


def phase_ensemble129(torch, pt, records, launches):
    """Phase 24: ``ensemble129`` (``from_seeds(range(K), amp=0.1)``, K in
    ``ENSEMBLE_KS``) on the fused, dense and meshed routes, beside a solo
    model's bare ``update_n`` on the route.  For each K: the
    capture (time, pool, memory, launches a replay), ``MAIN_STEPS`` counted
    steps (launches exactly ``MAIN_STEPS`` times a solo step's, whatever
    K), ``MAIN_STEPS`` timed steps of bare ``update_n`` (ms/step and
    member-steps/s), a 5-step profile (device busy, host idle); at K =
    ``ENSEMBLE_TIMED_K`` the route's member-axis kernel instances against
    their plain versions, timed (``ens129_*`` rows); then the route's
    checks (:func:`ensemble_checks`)."""
    rows = []
    for route in ("fused", "dense", "mesh"):
        solo = route_model(pt, ENSEMBLE129, route)
        solo.init_random(0.1, seed=0)
        solo.chunk_runner()
        solo.update_n(5)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        solo.update_n(MAIN_STEPS)
        torch.cuda.synchronize()
        solo_ms = (time.perf_counter() - t0) / MAIN_STEPS * 1e3
        print(f"phase24 ensemble129 solo Navier2D {route} route: bare update_n "
              f"{solo_ms:.4f} ms/step ({1e3 / solo_ms:.1f} steps/s)")
        del solo
        for k in ENSEMBLE_KS:
            model = route_model(pt, ENSEMBLE129, route)
            ens = pt.NavierEnsemble.from_seeds(model, range(k), amp=0.1)
            cap = prepare_ensemble(torch, ens, route, "ensemble129", "phase24")
            reset_counts(model)
            ens.update_n(MAIN_STEPS)
            torch.cuda.synchronize()
            counted = count_launches(model)
            want = {name: v * MAIN_STEPS for name, v in PER_STEP[route].items()}
            if counted != want:
                raise AssertionError(f"ensemble129 K={k} {route}: launches {counted}, a solo "
                                     f"route's {want}")
            t0 = time.perf_counter()
            ens.update_n(MAIN_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            prof = device_busy(torch, lambda: ens.update_n(5), 5, PROFILE_LAUNCHES[route])
            nu = ens.eval_nu()
            row = {"cell": "ensemble129", "route": route, "K": k,
                   "ms_per_step": wall / MAIN_STEPS * 1e3,
                   "member_steps_per_s": k * MAIN_STEPS / wall,
                   "solo_ms_per_step": solo_ms,
                   "ratio_to_K_solo": wall / MAIN_STEPS * 1e3 / (k * solo_ms),
                   "launches_per_step": {n: v // MAIN_STEPS for n, v in counted.items()},
                   "device_busy_ms_per_step": None if prof is None else prof[0] / 5e3,
                   "profiled_wall_ms_per_step": None if prof is None else prof[1] / 5e3,
                   "host_idle_share_of_bare": None if prof is None else
                   1.0 - prof[0] / 5e3 / (wall / MAIN_STEPS * 1e3),
                   "nu_mean": float(nu.mean()), **cap}
            print("phase24 " + json.dumps(row))
            if not (ens.alive().all() and bool(torch.isfinite(torch.as_tensor(nu)).all())):
                raise AssertionError(f"ensemble129 K={k} {route}: a member died or Nu is not "
                                     "finite")
            rows.append(row)
            if k == ENSEMBLE_TIMED_K:
                key = f"ens129_{route}"
                launches[key] = {n: v // MAIN_STEPS for n, v in counted.items()}
                records += member_kernel_records(torch, ens, key, "phase24")
            del ens, model
            torch.cuda.empty_cache()
        ensemble_checks(torch, pt, route)
        print(f"phase24 {route} ok")
    return rows


# -- the member-axis kernel instances, timed ---------------------------------------------


def member_stage_library(torch, st, xs):
    """The stage on member-stacked inputs in batched ``torch.matmul``
    calls (timed here only)."""
    xs = [st._stack(x) for x in xs]
    m = None
    for t, (rt, x) in enumerate(zip(st.rts, xs)):
        y = torch.matmul(torch.matmul(st.ls[t], x) if st.has_l else x, rt)
        m = y if m is None else m + y
    if st.dinv is not None:
        m = m * st.dinv
    if st.b1t is not None:
        m = torch.matmul(m, st.b1t)
    if st.const is not None:
        m = m + st.const
    if st.b0 is not None:
        m = torch.matmul(st.b0, m)
    if st.mask is not None:
        m = m * st.mask
    return st._unstack(m)


def member_conv_library(torch, fc, ux, uy, vhat, bcdx=None, bcdy=None):
    """The convection chain on member-stacked inputs in batched
    ``torch.matmul`` calls (timed here only)."""
    gx = torch.stack([fc.gx1, fc.gx0])
    gy = torch.stack([fc.gy0t, fc.gy1t])
    d = torch.matmul(torch.matmul(gx, fc._stack(vhat)[:, None]), gy)
    if bcdx is not None:
        d = d + torch.stack([bcdx, bcdy])
    total = ux * d[:, 0] + uy * d[:, 1]
    return fc._unstack(torch.matmul(fc.fx, torch.matmul(total, fc.fyt)))


def logged_step_inputs(torch, ens):
    """What one K-member step of ``ens`` gives its banded solves and pencil
    flips: ``{key: (count, first input)}`` with key ``("flip", shape,
    x_to_y, dtype)`` or ``("solve", label, shape, axis, factor batch
    stride, factor batch period)``, from one eager step with the wrappers
    logging (the launch counters put back after it; no state changes)."""
    from rustpde_mpi_tpu_torch.ops.banded import BandedSolver

    model = ens.model
    log = {}

    def note(key, x):
        count, first = log.get(key, (0, None))
        log[key] = (count + 1, first if first is not None else x.clone())

    wrapped = []
    before = [(k, k.launches) for ks in model.kernels().values() for k in ks]
    if model.mesh is not None:
        ring = model.mesh.ring

        def flip(block, x_to_y, apply=ring.apply):
            note(("flip", tuple(block.shape), bool(x_to_y), block.dtype), block)
            return apply(block, x_to_y)

        wrapped.append((ring, "apply", flip))
    if model.step_kernel == "dense":
        for label, solver in banded_solvers(model).items():
            if not isinstance(solver, BandedSolver):
                continue

            def solve(b, axis, factor_batch_stride=0, factor_batch_period=0, label=label,
                      inner=solver.solve):
                note(("solve", label, tuple(b.shape), axis, factor_batch_stride,
                      factor_batch_period), b)
                return inner(b, axis, factor_batch_stride, factor_batch_period)

            wrapped.append((solver, "solve", solve))
    for obj, name, fn in wrapped:
        setattr(obj, name, fn)
    try:
        model._step(ens.state)
    finally:
        for obj, name, _ in wrapped:
            delattr(obj, name)
        for k, n in before:
            k.launches = n
    torch.cuda.synchronize()
    return log


def banded_member_library(torch, solver, inv, b, axis, stride, period):
    """One ``torch.matmul`` with precomputed inverses that solves a
    member-stacked ``b`` as the banded solve does (the members as more
    right-hand sides of the same systems; timed here only)."""
    if not solver.kernel.per_lane:
        return torch.movedim(torch.matmul(inv[0], torch.movedim(b, axis, -2)), -2, axis)
    if axis != b.ndim - 1:
        raise AssertionError("a per-lane member solve along another axis than the last")
    lanes = b.shape[-2]
    if period:  # (K, P, c, n): rank r's lanes r * stride ..
        sets = inv.view(period, lanes, *inv.shape[1:]) if stride == lanes else None
        if sets is None:
            raise AssertionError("a per-lane pencil solve whose ranks' lanes are not contiguous")
        rhs = b.permute(1, 2, 3, 0)  # (P, c, n, K)
    else:  # (K, lanes, n)
        sets = inv
        rhs = b.permute(1, 2, 0)
    return torch.matmul(sets, rhs).movedim(-1, 0)


def member_kernel_records(torch, ens, route_key, phase):
    """Every member-axis kernel instance one K-member step of ``ens``
    launches, against its plain version (1e-12 of max|plain|; the flips
    bit for bit), timed queued behind a GPU spin: the kernel (one launch
    for the K members; also as a CUDA graph, ``kernel_graph_ms``), K
    one-member launches of it captured as one graph (``solo_ms``: their
    host time would outrun the spin), the plain version, and one library
    call (batched ``torch.matmul``; a ``matmul``
    by precomputed inverses for a banded solve; ``.contiguous()`` of the
    permuted view for a flip), with the bound of the K-member work.
    Returns the records (``route`` is ``route_key``)."""
    import numpy as np

    model = ens.model
    k = ens.k
    rng = np.random.default_rng(24)
    peak = F64_TFLOPS * 1e12
    cases = []  # (kernel, case, per_step, run, run_solo, run_plain, run_lib, flops, bytes, exact)
    if model._stages is not None:
        cplx = model.periodic
        for tag in STAGE_TAGS:
            st = model._stages.get(tag)
            if st is None:
                continue
            xs = [random_field(torch, rng, (k, k0 // 2 if cplx else k0, k1), model.dtype,
                               model.device, cplx) for k0, k1 in zip(st.k0, st.k1)]
            flops, nbytes = st.cost(k)
            cases.append(("fused_stage", tag, 1, lambda st=st, xs=xs: st.apply(*xs),
                          lambda st=st, xs=xs: [st.apply(*(x[i] for x in xs)) for i in range(k)],
                          lambda st=st, xs=xs: st.plain(*xs),
                          lambda st=st, xs=xs: member_stage_library(torch, st, xs),
                          flops, nbytes, False))
        n = (k, model.nx, model.ny)
        for label, space, with_bc in (("conv", model.velx_space, False),
                                      ("conv_bc", model.temp_space, True)):
            fc = model._convs[id(space)]
            args = [random_field(torch, rng, n, model.dtype, model.device),
                    random_field(torch, rng, n, model.dtype, model.device),
                    random_field(torch, rng, (k,) + space.shape_spectral, model.dtype,
                                 model.device, cplx)]
            if with_bc:
                args += [model._tempbc_dx, model._tempbc_dy]
            flops = fc.flops * k
            cases.append(("fused_conv", label, case_per_step(model, label),
                          lambda fc=fc, a=args: fc.apply(*a),
                          lambda fc=fc, a=args: [fc.apply(a[0][i], a[1][i], a[2][i], *a[3:])
                                                 for i in range(k)],
                          lambda fc=fc, a=args: fc.plain(*a),
                          lambda fc=fc, a=args: member_conv_library(torch, fc, *a),
                          flops, fc.bytes_moved(with_bc, k), False))
    else:
        solvers = banded_solvers(model)
        inverses = {}
        for key, (count, given) in sorted(logged_step_inputs(torch, ens).items(), key=str):
            if key[0] == "flip":
                _, shape, x_to_y, dtype = key
                ring = model.mesh.ring
                block = torch.empty_like(given).copy_(given)
                p = ring.nranks
                cases.append(("ring_transpose", f"{'x2y' if x_to_y else 'y2x'}_{list(shape)}",
                              count, lambda b=block, d=x_to_y: ring.apply(b, d),
                              lambda b=block, d=x_to_y: [ring.apply(b[i], d) for i in range(k)],
                              lambda b=block, d=x_to_y: ring.plain(b, d),
                              lambda b=block, d=x_to_y: member_ring_library(b, p, d),
                              0.0, ring.bytes_moved(block), True))
                continue
            _, label, shape, axis, stride, period = key
            solver = solvers[label]
            b = random_field(torch, rng, shape, model.dtype, model.device, given.is_complex())
            if label not in inverses:
                inverses[label] = banded_inverses(torch, solver.kernel)
            n = shape[axis]
            shape3 = (2 if b.is_complex() else 1, n, b.numel() // n)
            cases.append(("banded_solve", label, count,
                          lambda s=solver, b=b, a=axis, f=stride, q=period: s.solve(b, a, f, q),
                          lambda s=solver, b=b, a=axis, f=stride: [s.solve(b[i], a - 1, f)
                                                                   for i in range(k)],
                          lambda s=solver, b=b, a=axis, f=stride, q=period: s.plain(b, a, f, q),
                          lambda s=solver, b=b, a=axis, f=stride, q=period, inv=inverses[label]:
                          banded_member_library(torch, s, inv, b, a, f, q),
                          solver.kernel.flops(shape3), solver.kernel.bytes_moved(shape3), False))
    records = []
    for kernel, case, per_step, run, run_solo, run_plain, run_lib, flops, nbytes, exact \
            in cases:
        out = run()
        torch.cuda.synchronize()
        plain = run_plain()
        diff, rel = rel_err(torch, out, plain)
        solo_equal = all(torch.equal(out[i], s) for i, s in enumerate(run_solo()))
        t_op, t_mem = flops / peak * 1e3, nbytes / (HBM_TB_PER_S * 1e12) * 1e3
        queued, host = time_queued_ms(torch, run, 10)
        rec = {"kernel": kernel, "route": route_key, "case": case, "K": k, "n": model.nx,
               "per_step": per_step, "max_abs_err": diff, "max_rel_err": rel,
               "members_equal_solo_launches": solo_equal,
               "kernel_ms": queued, "kernel_enqueue_ms": host,
               "kernel_graph_ms": time_graph_ms(torch, run, 10),
               "solo_ms": time_graph_ms(torch, run_solo, 5),
               "plain_ms": time_queued_ms(torch, run_plain, 3)[0],
               "library_ms": time_queued_ms(torch, run_lib, 3)[0],
               "flops": flops, "bytes": nbytes, "bound_ms": max(t_op, t_mem),
               "bound_by": "operations" if t_op >= t_mem else "bytes"}
        rec["bound_share"] = rec["bound_ms"] / rec["kernel_ms"]
        print(f"{phase} " + json.dumps(rec))
        if not (rel <= (0.0 if exact else 1e-12)):
            raise AssertionError(f"{route_key} {kernel}/{case}: rel err {rel:.3e}")
        if kernel != "banded_solve" and not solo_equal:
            raise AssertionError(f"{route_key} {kernel}/{case}: a member differs from its "
                                 "one-member launch")
        records.append(rec)
    return records


def member_ring_library(block, p, x_to_y):
    """One ``.contiguous()`` of the permuted view of a member-stacked
    pencil (timed here only)."""
    k = block.shape[0]
    if x_to_y:
        c, w = block.shape[2] // p, block.shape[3]
        return block.view(k, p, p, c, w).permute(0, 2, 3, 1, 4).contiguous().view(k, p, c, p * w)
    c, w = block.shape[2], block.shape[3] // p
    return block.view(k, p, c, p, w).permute(0, 3, 1, 2, 4).contiguous().view(k, p, p * c, w)


def phase_ensemble1025(torch, pt, template, route, records, launches, bare_ms):
    """Phase 25 on one route: ``rbc1025`` with K = ``ENSEMBLE1025_K[route]``
    members on ``template`` (the route's main-path model, whose state is
    replaced): the member-axis kernel instances against their plain
    versions and timed (``ens1025_*`` rows); the capture, ``MAIN_STEPS``
    counted steps (launches exactly a solo step's per step) and
    ``MAIN_STEPS`` timed steps of bare ``update_n`` against K times the
    solo route's ms/step; member 0 against the solo model after 10 steps."""
    k = ENSEMBLE1025_K[route]
    key = f"ens1025_{route}"
    ens = pt.NavierEnsemble.from_seeds(template, range(k))
    records += member_kernel_records(torch, ens, key, "phase25")
    cap = prepare_ensemble(torch, ens, route, "rbc1025", "phase25")
    reset_counts(template)
    ens.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    counted = count_launches(template)
    if counted != {n: v * MAIN_STEPS for n, v in PER_STEP[route].items()}:
        raise AssertionError(f"rbc1025 K={k} {route}: launches {counted}")
    launches[key] = {n: v // MAIN_STEPS for n, v in counted.items()}
    t0 = time.perf_counter()
    ens.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    ms = wall / MAIN_STEPS * 1e3
    fresh = pt.NavierEnsemble.from_seeds(template, range(k))
    fresh.update_n(ENSEMBLE_STEPS)
    template.init_random(0.1, seed=0)
    start = template.state
    template.time = 0.0
    template.update_n(ENSEMBLE_STEPS)
    solo = template.state
    member = fresh.member_state(0)
    diffs = field_rel_diffs(torch, member, solo)
    bitwise = all(torch.equal(x, y) for x, y in zip(member, solo))
    # the route's own rounding sensitivity at this cell: the solo run from
    # its start state moved by one ulp (x (1 + 2^-52)), against the solo run
    template.state = type(start)(*(x * (1.0 + 2.0**-52) for x in start))
    template.update_n(ENSEMBLE_STEPS)
    ulp = field_rel_diffs(torch, template.state, solo)
    limits = {f: max(ENSEMBLE_LIMIT, ULP_STEPS_FACTOR * ulp[f]) for f in diffs}
    row = {"cell": "rbc1025", "route": route, "K": k, "ms_per_step": ms,
           "member_steps_per_s": k * MAIN_STEPS / wall, "solo_ms_per_step": bare_ms[route],
           "ratio_to_K_solo": ms / (k * bare_ms[route]),
           "launches_per_step": launches[key], "member0_vs_solo_rel": diffs,
           "solo_vs_one_ulp_rel": ulp, "member0_bit_for_bit": bitwise, **cap}
    print("phase25 " + json.dumps(row))
    if any(diffs[f] > limits[f] for f in diffs):
        raise AssertionError(f"rbc1025 K={k} {route}: member 0 differs from the solo model "
                             f"{diffs} beyond {limits}")
    print(f"phase25 {route} ok")


def phase_sweep(torch, pt):
    """Phase 26: ``geometry_sweep`` at ``SWEEP129`` on the fused, dense and
    meshed routes: four obstacles from the ``solid_*`` builders as one
    ensemble of a plain template, ``ENSEMBLE_STEPS`` steps, each member
    against a solo ``set_solid`` run of its obstacle (``ENSEMBLE_LIMIT`` of
    each field's scale; bit for bit expected on the fused route)."""
    for route in ("fused", "dense", "mesh"):
        template = route_model(pt, SWEEP129, route)
        template.init_random(0.1, seed=0)
        x, y = template.x
        geoms = [pt.solid_cylinder_inner(x, y, 0.0, 0.0, 0.3),
                 pt.solid_cylinder_inner(x, y, 0.4, -0.2, 0.2),
                 pt.solid_rectangle(x, y, 0.0, 0.6, 0.3, 0.1),
                 pt.solid_roughness_sinusoid(x, y, *ROUGHNESS)]
        reset_counts(template)
        final, obs = pt.geometry_sweep(template, geoms, ENSEMBLE_STEPS)
        counted = count_launches(template)
        worst, bitwise = 0.0, True
        state_cls = type(template.state)
        for i, (mask, value) in enumerate(geoms):
            solo = route_model(pt, SWEEP129, route)
            solo.init_random(0.1, seed=0)
            solo.set_solid(mask, value)
            solo.update_n(ENSEMBLE_STEPS)
            member = state_cls(*(f[i] for f in final))
            worst = max(worst, max_rel_diff(torch, member, solo.state))
            bitwise = bitwise and all(torch.equal(a, b) for a, b in zip(member, solo.state))
        print(f"phase26 geometry_sweep {route} route, 4 obstacles, {ENSEMBLE_STEPS} steps: "
              f"max rel diff against solo set_solid runs {worst:.3e} (limit "
              f"{ENSEMBLE_LIMIT:g}), bit for bit {bitwise}; Nu {obs[0].tolist()}; launches "
              f"{counted} (warm-up step and capture included)")
        if not worst <= ENSEMBLE_LIMIT or (route == "fused" and not bitwise):
            raise AssertionError(f"geometry_sweep {route}: a member differs from its solo run")
    print("phase26 ok")


# -- phase 27: checkpoints ----------------------------------------------------------------

#: phase 27's card-against-CPU cells: (cell, model configuration, routes)
CKPT_CELLS = (("rbc129", ENSEMBLE129, ("fused", "dense", "mesh")),
              ("hc129", HC_CELLS["hc129"], ("fused",)),
              ("periodic128", PERIODIC128, ("fused", "mesh")),
              ("scn129", SCN_CELLS["scn129"], ("fused",)))
#: phase 27's resolution change: a 129^2 snapshot restored at 257^2
CKPT_FINE = dict(ENSEMBLE129, nx=257, ny=257)
#: steps after a restore on the card and the CPU
CKPT_STEPS = 10
#: card against CPU after a restore and CKPT_STEPS steps (the limit of
#: phases 3 and 9), relative to each field's scale
CKPT_LIMIT = 1e-11
#: a staged backward transform ``v``, card against CPU (another summation
#: order on each side), relative to its scale
CKPT_V_LIMIT = 1e-12
#: ensemble129's members staged by phase 27, and the K of the ensemble they
#: are restored into
CKPT_K, CKPT_K_INTO = 8, 32
#: the parts of every save-window callback of phase_main's integrate, by
#: (cell, route) (read by phase 27)
CALLBACK_MS: dict = {}


class timed_callbacks:
    """Time each ``callback()`` of ``model`` (a ``Navier2D``) while the
    context is open, in parts, by wrapping the model's own methods: the
    whole callback; ``get_observables`` (the observables' device work
    through ``_observables``, synchronized, and the copy to the host);
    the builds of operator matrices the observables' transforms cache at
    first use (each space's ``_mat`` on a key not yet cached); the rest
    (the print, the ``data/info.txt`` row, the snapshot check).  Yields a
    list with one dict of ms per callback."""

    def __init__(self, torch, model):
        self.torch, self.model, self.rows = torch, model, []

    def __enter__(self):
        torch, model, rows = self.torch, self.model, self.rows
        acc = {"build": 0.0, "obs": 0.0, "get": 0.0}
        spaces = {id(sp): sp for sp in (model.field_space, model.temp_space, model.velx_space,
                                        model.vely_space, model.pres_space, model.pseu_space)}
        self.spaces = list(spaces.values())
        orig = {name: getattr(model, name) for name in ("callback", "get_observables",
                                                        "_observables")}

        def timed(key, fn):
            def run(*args):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                out = fn(*args)
                torch.cuda.synchronize()
                acc[key] += time.perf_counter() - t0
                return out
            return run

        for sp in self.spaces:
            mat = sp._mat

            def build(axis, key, _mat=mat, _sp=sp):
                if (axis, key) in _sp._mats:
                    return _mat(axis, key)
                return timed("build", _mat)(axis, key)

            sp._mat = build
        model._observables = timed("obs", orig["_observables"])
        model.get_observables = timed("get", orig["get_observables"])

        def callback():
            for k in acc:
                acc[k] = 0.0
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            orig["callback"]()
            torch.cuda.synchronize()
            total = time.perf_counter() - t0
            rows.append({"total_ms": total * 1e3, "operator_builds_ms": acc["build"] * 1e3,
                         "observables_ms": (acc["obs"] - acc["build"]) * 1e3,
                         "to_host_ms": (acc["get"] - acc["obs"]) * 1e3,
                         "print_info_txt_rest_ms": (total - acc["get"]) * 1e3})

        model.callback = callback
        return rows

    def __exit__(self, *exc):
        for name in ("callback", "get_observables", "_observables"):
            delattr(self.model, name)
        for sp in self.spaces:
            del sp._mat
        return False


def stage(torch, pt, ck, pde):
    """Stage ``pde``'s snapshot (a model's or an ensemble's) in host
    memory: ``(snapshot, staging ms, digest, digest ms)``.  The staging is
    timed from a synchronized card to the end of the host copies (the
    backward transforms, a mesh's pencil gathers, the copies); the digest
    is numpy and hashlib on the host."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    snap = (ck.ensemble_snapshot_to_host if isinstance(pde, pt.NavierEnsemble)
            else ck.snapshot_to_host)(pde)
    stage_ms = (time.perf_counter() - t0) * 1e3
    t0 = time.perf_counter()
    digest = ck.snapshot_digest(snap.datasets)
    return snap, stage_ms, digest, (time.perf_counter() - t0) * 1e3


def restore(torch, pt, ck, pde, snap) -> float:
    """Restore ``snap`` into ``pde`` through the file reader's group
    restore (its datasets as the file stores them); ms to a synchronized
    card."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    if isinstance(pde, pt.NavierEnsemble):
        ck._restore_ensemble_snapshot(pde, ck._host_group(snap))
    else:
        ck._restore_snapshot(pde, ck._host_group(snap))
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e3


def h5py_version():
    try:
        import h5py
    except ImportError:
        return None
    return h5py.__version__


def checkpoint_roundtrip(torch, pt, pde, fresh, label, card):
    """Phase 27 at full width: stage ``pde`` (a model, or an ensemble) and
    restore it into ``fresh`` (a model of the same configuration, or an
    ensemble of another K, its chunk graph captured); where ``h5py``
    imports, also through a file.  Every stored leaf must come back bit
    for bit, ``pseu`` zero, ``time`` exact (an ensemble's K, ``mask`` and
    ``steps_done`` too, its graphs dropped); then ``MAIN_STEPS`` steps of
    ``update_n`` (recaptured) with the route's launches a step and finite
    observables.  Prints one row of ms and MB."""
    import numpy as np

    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    ens = isinstance(pde, pt.NavierEnsemble)
    model = fresh.model if ens else fresh
    # the first staging builds the transform operators its spaces have not
    # used yet (as a first observables read does); the second is the
    # steady cost
    first_ms = stage(torch, pt, ck, pde)[1]
    snap, stage_ms, digest, digest_ms = stage(torch, pt, ck, pde)
    restore_ms = restore(torch, pt, ck, fresh, snap)
    row = {"cell": label, "route": route_of(model), "K": pde.k if ens else None,
           "first_stage_ms": first_ms, "stage_ms": stage_ms, "snapshot_mb": snap.nbytes / 1e6,
           "digest_ms": digest_ms, "restore_ms": restore_ms, "digest": digest[:16],
           "form": "in memory"}
    if h5py_version() is not None:
        import tempfile

        with tempfile.TemporaryDirectory() as work:
            path = os.path.join(work, "snapshot.h5")
            t0 = time.perf_counter()
            ck.write_host_snapshot(snap, path)
            row["file_write_ms"] = (time.perf_counter() - t0) * 1e3
            t0 = time.perf_counter()
            fresh.read(path)
            torch.cuda.synchronize()
            row["file_read_ms"] = (time.perf_counter() - t0) * 1e3
        row["form"] = "in memory, then through an HDF5 file"
    fields = [attr for _, attr in model.snapshot_vars]
    exact = all(torch.equal(getattr(fresh.state, f), getattr(pde.state, f)) for f in fields)
    same = fresh.time == pde.time and not bool(fresh.state.pseu.any())
    if ens:
        same = same and fresh.k == pde.k and torch.equal(fresh.mask, pde.mask) and \
            torch.equal(fresh.steps_done, pde.steps_done) and \
            fresh.steps_done.dtype == torch.int32 and not fresh._runners
    if not (exact and same):
        raise AssertionError(f"phase27 {label}: the restore is not exact (leaves {exact}, "
                             f"pseu/time/K/mask/steps_done {same})")
    route = route_of(model)
    if ens:
        row["capture"] = prepare_ensemble(torch, fresh, route, label, "phase27")
        before = fresh.steps_done.clone()
    else:
        prepare_chunks(torch, fresh, "phase27")
    reset_counts(model)
    fresh.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    counted = count_launches(model)
    want = {k: v * MAIN_STEPS for k, v in PER_STEP[route].items()}
    obs = [np.asarray(v, dtype=float) for v in fresh.get_observables()]
    row.update(launches=counted, nu=[float(v) for v in np.atleast_1d(obs[0])[:4]])
    if counted != want or not all(np.isfinite(v).all() for v in obs):
        raise AssertionError(f"phase27 {label}: {MAIN_STEPS} steps after the restore launched "
                             f"{counted} (want {want}), observables {obs}")
    if ens and fresh.steps_done.tolist() != [
            b + MAIN_STEPS * a for b, a in zip(before.tolist(), fresh.alive().tolist())]:
        raise AssertionError(f"phase27 {label}: steps_done {fresh.steps_done.tolist()}")
    print("phase27 roundtrip " + json.dumps(row) + f" ({card})")
    return row


def staged_diffs(a, b) -> dict:
    """Two staged snapshots against each other: the datasets whose stored
    arrays differ, each ``v`` by its relative difference, every other one
    as bit for bit or not."""
    import numpy as np

    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    def stored(snap):
        out = {}
        for path, data, kind in snap.datasets:
            out.update(ck._stored_arrays(path, data, kind))
        return out

    sa, sb = stored(a), stored(b)
    if sorted(sa) != sorted(sb):
        raise AssertionError(f"staged dataset paths differ: {sorted(set(sa) ^ set(sb))}")
    v_rel, unequal = 0.0, []
    for name, x in sb.items():
        y = sa[name]
        if x.dtype != y.dtype or x.shape != y.shape:
            unequal.append(name)
        elif name.rsplit("/", 1)[-1] == "v":
            v_rel = max(v_rel, float(np.abs(y - x).max() / max(np.abs(x).max(), 1e-300)))
        elif not np.array_equal(x, y):
            unequal.append(name)
    return {"v_max_rel": v_rel, "unequal": unequal}


def ckpt_model(pt, cell, cfg, route, device="cuda", method=None):
    """A model of one phase 27 cell on ``route`` (fused, dense, mesh) on
    ``device``; the scenario cell with its scalar and obstacle."""
    if cell.startswith("scn"):
        return scenario_model(pt, cfg, route, device=device, method=method)
    if route == "mesh":
        kw = dict(mesh=pt.make_mesh(MESH_RANKS, device), method=method)
    else:
        kw = dict(device=device, step_kernel=route, conv_kernel=route, method=method)
    model = pt.Navier2D(**cfg, **kw)
    model.init_random(0.1, seed=0)
    return model


def card_vs_cpu_restart(torch, pt, snap0, snap, make, label, equivalent=True):
    """Restore ``snap`` (taken ``CKPT_STEPS`` steps after ``snap0``, the
    initial state) into a card model and a CPU model (``make(device,
    method)``; the CPU model with the card's transform method), stage both
    and hold them against each other (``staged_diffs``), then step both
    ``CKPT_STEPS`` and compare.  The reference pair restores ``snap0`` on
    the card and the CPU and steps ``2 * CKPT_STEPS``: the same run without
    a restart, printed beside it.  Each field's card-vs-CPU difference
    after the restart must be within ``CKPT_LIMIT`` of its scale, ``pseu``
    within ``PSEU_ROUTES_LIMIT``: it is not stored and the step does not
    read it, and its scale shrinks as the flow settles, so 20 steps from
    ``init_random`` its card-vs-CPU difference passes 1e-11 with or
    without a restart (2.04e-11 without one on the fused route at 129^2,
    NVIDIA H100 80GB HBM3).  With ``equivalent`` (the snapshots' own
    grid), the card's restarted run must equal its run without a restart.
    Returns the card's model and staging."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    def rel_diffs(a, b):
        sa, sb = (pt.convert.state_to_numpy(m) for m in (a, b))
        return {name: float(abs(sa[name] - ref).max() / max(abs(ref).max(), 1e-300))
                for name, ref in sb.items()}

    ref_card, ref_cpu = make("cuda", None), make("cpu", pt.bases.CARD_METHOD)
    for m in (ref_card, ref_cpu):
        restore(torch, pt, ck, m, snap0)
        m.update_n(2 * CKPT_STEPS)
    ref = rel_diffs(ref_card, ref_cpu)
    card, cpu = make("cuda", None), make("cpu", pt.bases.CARD_METHOD)
    for m in (card, cpu):
        restore(torch, pt, ck, m, snap)
    s_card, stage_card_ms, d_card, _ = stage(torch, pt, ck, card)
    s_cpu, _, d_cpu, _ = stage(torch, pt, ck, cpu)
    diffs = staged_diffs(s_card, s_cpu)
    for m in (card, cpu):
        m.update_n(CKPT_STEPS)
    rel = rel_diffs(card, cpu)
    limits = {k: PSEU_ROUTES_LIMIT if k == "pseu" else CKPT_LIMIT for k in rel}
    over = {k: v for k, v in rel.items() if not v <= limits[k]}
    line = (f"phase27 {label}: staged on the card and on the CPU: every vhat, coordinate and "
            f"raw dataset bit for bit {not diffs['unequal']}, v max rel diff "
            f"{diffs['v_max_rel']:.3e} (limit {CKPT_V_LIMIT:g}), digests equal "
            f"{d_card == d_cpu} (they can differ only through v); card staging "
            f"{stage_card_ms:.3f} ms; after {CKPT_STEPS} steps card vs cpu rel diffs "
            + json.dumps({k: f"{v:.3e}" for k, v in rel.items()})
            + f" (limit {CKPT_LIMIT:g}, pseu {PSEU_ROUTES_LIMIT:g}; the same pair without a "
            "restart: " + json.dumps({k: f"{v:.3e}" for k, v in ref.items()}) + ")")
    if equivalent:
        again = rel_diffs(card, ref_card)
        line += ("; the card's restarted run against its run without a restart: bit for bit "
                 f"{all(v == 0.0 for v in again.values())}, max rel diff "
                 f"{max(again.values()):.3e} (limit 1e-12)")
        if not max(again.values()) <= 1e-12:
            raise AssertionError(f"phase27 {label}: a restart changed the card's run: {again}")
    print(line)
    if diffs["unequal"] or not diffs["v_max_rel"] <= CKPT_V_LIMIT or over:
        raise AssertionError(f"phase27 {label}: {diffs}, over the limit {over}")
    return card, s_card


def phase_checkpoints(torch, pt, card):
    """Phase 27 on the small cells and the ensemble: ``ensemble129`` K =
    ``CKPT_K`` (fused) staged and restored into an ensemble built at K =
    ``CKPT_K_INTO`` (:func:`checkpoint_roundtrip`); on each of
    ``CKPT_CELLS``' routes a 129^2 (128x129) snapshot, ``CKPT_STEPS``
    steps from ``init_random``, restored on the card and on the CPU
    (:func:`card_vs_cpu_restart`), a meshed staging's ``vhat`` against a
    serial model's holding the same state (bit for bit); the ``rbc129``
    fused snapshot restored at ``CKPT_FINE`` on the card and the CPU."""
    import numpy as np

    from rustpde_mpi_tpu_torch.utils import checkpoint as ck

    print(f"phase27 h5py: {h5py_version() or 'not importable'}; the snapshots are staged and "
          "restored in memory" + ("" if h5py_version() is None else " and through files"))
    model = route_model(pt, ENSEMBLE129, "fused")
    src = pt.NavierEnsemble.from_seeds(model, range(CKPT_K))
    src.update_n(CKPT_STEPS)
    src.mark_dead([5])
    src.update_n(CKPT_STEPS)
    into = pt.NavierEnsemble.from_seeds(model, range(CKPT_K_INTO))
    into.chunk_runner()
    checkpoint_roundtrip(torch, pt, src, into, "ensemble129", card)
    del src, into, model
    torch.cuda.empty_cache()
    for cell, cfg, routes in CKPT_CELLS:
        for route in routes:
            src = ckpt_model(pt, cell, cfg, route)
            snap0 = stage(torch, pt, ck, src)[0]
            src.update_n(CKPT_STEPS)
            snap = stage(torch, pt, ck, src)[0]

            def make(device, method, cell=cell, cfg=cfg, route=route):
                return ckpt_model(pt, cell, cfg, route, device, method)

            meshed, staged = card_vs_cpu_restart(torch, pt, snap0, snap, make,
                                                 f"{cell} {route} route")
            if route == "mesh":
                serial = ckpt_model(pt, cell, cfg, "dense")
                restore(torch, pt, ck, serial, snap)
                s_serial = stage(torch, pt, ck, serial)[0]
                vhat = {p: d for p, d, _ in s_serial.datasets if p.endswith("/vhat")}
                same = all(np.array_equal(d, vhat[p]) for p, d, _ in staged.datasets
                           if p.endswith("/vhat"))
                print(f"phase27 {cell} meshed staging: vhat datasets bit for bit a serial "
                      f"model's holding the same state {same}")
                if not same:
                    raise AssertionError(f"phase27 {cell}: meshed vhat differs from serial")
            if (cell, route) == ("rbc129", "fused"):
                def fine(device, method):
                    return pt.Navier2D(**CKPT_FINE, device=device, method=method)

                card_vs_cpu_restart(torch, pt, snap0, snap, fine, "rbc129 -> 257^2 fused route",
                                    equivalent=False)
            del src, meshed
    torch.cuda.empty_cache()
    print("phase27 ok")


def phase_callback_cost(torch, pt, model, card):
    """Phase 27's callback cost on ``model`` (fused ``rbc1025`` or
    ``periodic1024``), right after its phase_main run: ``integrate``
    again (``MAIN_STEPS`` steps, 2 callbacks, no snapshot), each callback
    timed in parts, beside the first run's (``CALLBACK_MS``); then a
    torch.profiler trace of one more callback, its ops by host time and
    its device time."""
    label, route = label_of(model), route_of(model)
    model.write_intervall = 1e9
    t0 = model.time
    with timed_callbacks(torch, model) as second:
        status = pt.integrate(model, t0 + MAIN_STEPS * model.dt, MAIN_STEPS // 2 * model.dt)
    first = CALLBACK_MS[label, route]
    if status != "time_limit" or len(second) != 2:
        raise AssertionError(f"phase27 callback cost: integrate {status!r}, {len(second)} "
                             "callbacks")
    print(f"phase27 callbacks {label} {route} route ({card}), ms each, the model's first "
          f"integrate: " + json.dumps(first) + "; its second: " + json.dumps(second))
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    model._obs_cache = None
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        model.callback()
        torch.cuda.synchronize()
    device_us = sum(ev.time_range.end - ev.time_range.start for ev in prof.events()
                    if ev.device_type == DeviceType.CUDA)
    top = sorted(prof.key_averages(), key=lambda e: e.self_cpu_time_total, reverse=True)[:8]
    print(f"phase27 callback profile {label} {route} route: device {device_us / 1e3:.4f} ms; "
          "ops by host ms: " + json.dumps({e.key: round(e.self_cpu_time_total / 1e3, 4)
                                           for e in top}))


# -- phase 28: the in-scan statistics, set_dt and the governor -------------------

#: the statistics' stride on the main path (the JAX package's default)
STATS_STRIDE = 16
#: the most the statistics may add to a step at that stride (the JAX
#: package's gate), held on the middle two of four timed runs
STATS_GATE = 0.05
#: the card-vs-CPU statistics check (129^2): stride and steps
STATS_SMALL = (2, 20)
#: the relative limit of the statistics' card-vs-CPU leaves and health
STATS_LIMIT = 1e-11


def grouped(model, delta) -> dict:
    """A runner's per-wrapper launches summed by kernel name."""
    out = {}
    for name, d in zip([n for n, ks in model.kernels().items() for _ in ks], delta):
        out[name] = out.get(name, 0) + d
    return out


def sample_device_ms(torch, model, reps=5) -> float:
    """One statistics sample's device ms (the sample and the fold, run
    eagerly), from the profiler's CUDA events over ``reps`` samples."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    eng = model.stats_engine
    eng.fold(model.stats_state, eng.sample(model.state))
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(reps):
            eng.fold(model.stats_state, eng.sample(model.state))
        torch.cuda.synchronize()
    by_name = {}
    for ev in prof.events():
        if ev.device_type == DeviceType.CUDA:
            by_name[ev.name] = by_name.get(ev.name, 0.0) + ev.time_range.end - ev.time_range.start
    top = sorted(by_name.items(), key=lambda kv: -kv[1])[:4]
    print("phase28 sample profile, ms a sample by kernel: " + "; ".join(
        f"{t / reps / 1e3:.4f} {name[:60]}" for name, t in top))
    return sum(by_name.values()) / reps / 1e3


def replays_ms(torch, runner, variant, reps=20) -> float:
    """Device ms of one replay of a runner's graph ``variant``, by CUDA
    events over ``reps`` replays queued back to back."""
    runner.run(1, variant)
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    start.record()
    runner.run(reps, variant)
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def stats_leaves_equal(torch, a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


def phase_stats_main(torch, pt, model, card, phase="phase28"):
    """Statistics on ``rbc1025`` (the route's main model): 50 steps of bare
    ``update_n`` with stride 16 against the same steps without, bit for
    bit; launches counted over the run; ms/step off, on, on, off; one
    sample's device ms; the staged snapshot's statistics restored bit for
    bit.  Returns ``{"on": [...], "off": [...]}`` ms/step."""
    from rustpde_mpi_tpu_torch.utils import checkpoint

    route = route_of(model)
    s0, t0 = model.state, model.time
    model.set_stats(None)
    model.update_n(MAIN_STEPS)
    off_state = model.state
    model.state, model.time = s0, t0
    model.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
    torch.cuda.synchronize()
    t = time.perf_counter()
    runner = model.chunk_runner()
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t
    step, sampled = grouped(model, runner.deltas[0]), grouped(model, runner.deltas[1])
    extra = {k: sampled[k] - step.get(k, 0) for k in sampled}
    print(f"{phase} {label_of(model)} {route} route: statistics chunk graphs (step; step + "
          f"sample) captured in {capture_s:.3f} s, pool {runner.pool_bytes / 2**20:.1f} MiB; "
          f"launches a replay {step} and {sampled} (the sample's own {extra})")
    if step != PER_STEP[route]:
        raise AssertionError(f"{route}: a statistics replay launches {step}, a step "
                             f"{PER_STEP[route]}")
    reset_counts(model)
    model.update_n(MAIN_STEPS)
    torch.cuda.synchronize()
    launches = count_launches(model)
    samples = MAIN_STEPS // STATS_STRIDE
    want = {k: v * MAIN_STEPS + extra.get(k, 0) * samples for k, v in PER_STEP[route].items()}
    if launches != want or not same_state(torch, model.state, off_state):
        raise AssertionError(f"{route}: statistics on: launches {launches} (want {want}), state "
                             f"{state_diffs(torch, model.state, off_state)}")
    if int(model._stats_tick[0]) != MAIN_STEPS or float(model.stats_state.samples[0]) != samples:
        raise AssertionError(f"{route}: tick {model._stats_tick.tolist()}, samples "
                             f"{model.stats_state.samples.tolist()}")
    # the sample inside the graph: replays of the step + sample graph
    # against replays of the step graph, by CUDA events (the carry is the
    # runner's scratch copy; the counters are read above)
    replay_ms = [replays_ms(torch, runner, variant) for variant in (0, 1)]
    health = model.stats_summary()
    if not all(math.isfinite(v) for v in health.values()):
        raise AssertionError(f"{route}: health {health}")
    # the staged snapshot carries the sums; restored, bit for bit
    sums, tick = model.stats_state, model._stats_tick
    snap = checkpoint.snapshot_to_host(model)
    model.reset_stats()
    checkpoint._restore_snapshot(model, checkpoint._host_group(snap))
    if not stats_leaves_equal(torch, model.stats_state, sums) or \
            not torch.equal(model._stats_tick, tick):
        raise AssertionError(f"{route}: the staged statistics did not restore bit for bit")
    model.state, model.time = s0, t0
    sample_ms = sample_device_ms(torch, model)
    ms = {"off": [], "on": []}
    device_ms = {"off": [], "on": []}
    for on in (False, True, True, False) * 2:
        model.set_stats(pt.StatsConfig(stride=STATS_STRIDE) if on else None)
        # a new graph's first replay uploads it: replay both graphs once first
        model.update_n(STATS_STRIDE)
        model.reset_stats()
        model.state, model.time = s0, t0
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        t = time.perf_counter()
        start.record()
        model.update_n(MAIN_STEPS)
        end.record()
        torch.cuda.synchronize()
        key = "on" if on else "off"
        ms[key].append((time.perf_counter() - t) / MAIN_STEPS * 1e3)
        device_ms[key].append(start.elapsed_time(end) / MAIN_STEPS)
    on, off = sorted(ms["on"])[1:3], sorted(ms["off"])[1:3]
    on, off = sum(on) / 2, sum(off) / 2
    print(f"{phase} {label_of(model)} f64 {route} route ({card}): {MAIN_STEPS} steps of bare "
          f"update_n, statistics stride {STATS_STRIDE}: on {ms['on']} off {ms['off']} ms/step "
          f"(CUDA events from the first launch to the last: on {device_ms['on']} off "
          f"{device_ms['off']}), overhead of the middle two {on / off - 1.0:+.4f}; one sample {sample_ms:.4f} ms device time "
          f"(profiler; {sample_ms / STATS_STRIDE:.4f} ms/step at the stride); a replay of the "
          f"step graph {replay_ms[0]:.4f} ms, of the step + sample graph {replay_ms[1]:.4f} ms "
          f"(CUDA events); launches in "
          f"the statistics run {launches}; states on/off bit for bit; staged snapshot "
          f"{snap.nbytes / 2**20:.2f} MB, statistics restored bit for bit; health "
          + json.dumps(health))
    model.state, model.time = s0, t0
    if on / off - 1.0 > STATS_GATE:
        raise AssertionError(f"{route}: the statistics add {on / off - 1.0:+.4f} to a step, over "
                             f"the {STATS_GATE:.0%} gate")
    return ms


def stage_checks(torch, model, rng) -> float:
    """Every fused stage of ``model`` against its plain version on random
    inputs; the largest error relative to max|plain|."""
    worst = 0.0
    for kernel, label, run_k, run_p, *_ in kernel_cases(torch, model, rng):
        if kernel != "fused_stage":
            continue
        out_k = run_k()
        torch.cuda.synchronize()
        worst = max(worst, rel_err(torch, out_k, run_p())[1])
    return worst


def phase_set_dt(torch, pt, model, card, phase="phase28"):
    """``set_dt`` dt -> dt/2 -> dt on the route's ``rbc1025`` model (with
    the statistics armed): each move's ms (``set_dt``, then the chunk
    graphs' capture, or the cached ones), the bytes the new rung holds;
    after each move every fused stage against its plain version on the new
    operators, one graph step against one eager step bit for bit, and 50
    steps finite."""
    import numpy as np

    route = route_of(model)
    s0, t0, dt0 = model.state, model.time, model.dt
    model.chunk_runner()  # the rung left behind holds its graphs
    rng = np.random.default_rng(28)
    rows = []
    for dt in (dt0 / 2, dt0):
        torch.cuda.synchronize()
        alloc = torch.cuda.memory_allocated()
        before = model.recompile_count
        t = time.perf_counter()
        model.set_dt(dt)
        torch.cuda.synchronize()
        set_ms = (time.perf_counter() - t) * 1e3
        t = time.perf_counter()
        model.chunk_runner()
        torch.cuda.synchronize()
        capture_ms = (time.perf_counter() - t) * 1e3
        pools = sum(r.pool_bytes for r in model._runners.values())
        row = {"dt": dt, "first_visit": model.recompile_count > before,
               "set_dt_ms": set_ms, "capture_ms": capture_ms,
               "allocated_mib": (torch.cuda.memory_allocated() - alloc) / 2**20,
               "graph_pools_mib": pools / 2**20,
               "rung_mib": ((torch.cuda.memory_allocated() - alloc) + pools) / 2**20}
        if model._stages is not None:
            row["stage_vs_plain"] = stage_checks(torch, model, rng)
            if not row["stage_vs_plain"] <= 1e-12:
                raise AssertionError(f"{route} dt={dt}: a fused stage is "
                                     f"{row['stage_vs_plain']:.3e} from its plain version")
        model.state = s0
        model.update_n(1)
        graph = model.state
        eager = model._step(s0)
        if not same_state(torch, graph, eager):
            raise AssertionError(f"{route} dt={dt}: graph step vs eager step "
                                 f"{state_diffs(torch, graph, eager)}")
        model.state = s0
        model.update_n(MAIN_STEPS)
        obs = model.get_observables()
        if not all(math.isfinite(v) for v in obs):
            raise AssertionError(f"{route} dt={dt}: observables {obs}")
        row["nu_after_50"] = obs[0]
        rows.append(row)
        print(f"{phase} set_dt {label_of(model)} {route} route ({card}): " + json.dumps(row))
    if rows[0]["first_visit"] is not True or rows[1]["first_visit"] is not False:
        raise AssertionError(f"{route}: rung visits {rows}")
    model.state, model.time = s0, t0
    return rows


def phase_governed(torch, pt, model, card, phase="phase28"):
    """A governed run on fused ``rbc1025``: phase 14's CFL spike (the
    velocities at 4x the ceiling), each chunk's ``ChunkStatus`` through
    ``StabilityGovernor.on_chunk`` and each ``retry``/``adjust`` applied by
    ``set_dt`` (the latch cleared), the spike passing once caught (the calm
    state put back); the run must end finite and back at the anchor
    after ``grow_after`` healthy chunks a rung."""
    route = route_of(model)
    s0, t0, dt0 = model.state, model.time, model.dt
    cfg = pt.StabilityConfig(grow_after=2)
    gov = pt.StabilityGovernor(cfg, dt0)
    model.set_stability(cfg)
    factor = 4.0 * cfg.max_cfl / model.update_n(1).cfl_max  # the CFL of the consumed s0
    model.state, model.time = s0._replace(velx=s0.velx * factor, vely=s0.vely * factor), t0
    chunks, t = [], time.perf_counter()
    for _ in range(16):
        status = model.update_n(10)
        decision = gov.on_chunk(status, step=len(chunks) * 10)
        if decision.action in ("retry", "adjust"):
            model.set_dt(decision.dt)
            model.clear_pre_divergence()
        if status.pre_divergence:
            model.state = s0  # the spike passes
        chunks.append((decision.action, status.cfl_max, model.dt))
        if model.dt == dt0 and gov.health.pre_divergence_catches and decision.action == "adjust":
            break
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    obs = model.get_observables()
    health = gov.health.asdict()
    print(f"{phase} governed {label_of(model)} {route} route ({card}): spike x{factor:.4g}; "
          f"{len(chunks)} chunks of 10 steps in {wall:.3f} s; (action, cfl_max, dt after) "
          + json.dumps(chunks) + "; RunHealth " + json.dumps(health))
    if chunks[0][0] != "retry" or model.dt != dt0 or not all(math.isfinite(v) for v in obs):
        raise AssertionError(f"{route}: governed run {chunks}, observables {obs}")
    model.set_stability(None)
    model.state, model.time = s0, t0
    return chunks, health


def phase_stats_small(pt, phase="phase28"):
    """At 129^2 (Ra=1e7, dt=2e-3), stride 2, 20 steps, every route: the
    statistics on the card against the CPU (each leaf within 1e-11 of its
    scale, each health entry within 1e-11 of max(1, |value|), its counts
    exactly)."""
    stride, steps = STATS_SMALL
    for route in ("fused", "dense", "mesh"):
        sums, health = {}, {}
        for dev in ("cuda", "cpu"):
            if route == "mesh":
                m = pt.Navier2D(**ENSEMBLE129, mesh=pt.make_mesh(MESH_RANKS, dev))
            else:
                m = pt.Navier2D(**ENSEMBLE129, device=dev, **(DENSE if route == "dense" else {}))
            m.init_random(0.1, seed=0)
            m.set_stats(pt.StatsConfig(stride=stride))
            m.update_n(steps)
            sums[dev] = [t.cpu() for t in m.stats_state]
            health[dev] = m.stats_health()
        worst = 0.0
        for name, a, b in zip(pt.StatsState._fields, sums["cuda"], sums["cpu"]):
            scale = max(float(b.abs().max()), 1e-300)
            rel = float((a - b).abs().max()) / scale
            worst = max(worst, rel)
            if not rel <= STATS_LIMIT:
                raise AssertionError(f"{route}: statistics leaf {name} card vs cpu {rel:.3e}")
        # the health entries are ratios and residuals of order one (the
        # budget residuals differences of nearly equal estimators): each
        # within the limit of max(1, |value|); the counts exactly
        hw = 0.0
        for name, a, b in zip(pt.models.stats.HEALTH_NAMES, health["cuda"], health["cpu"]):
            exact = name.startswith("bl_") or name == "samples"
            err = abs(a - b) / max(abs(b), 1.0)
            hw = hw if exact else max(hw, err)
            if (exact and a != b) or (not exact and not err <= STATS_LIMIT):
                raise AssertionError(f"{route}: health {name} card {a} cpu {b}")
        print(f"{phase} statistics 129^2 stride {stride} {steps} steps {route} route, card vs "
              f"cpu: leaves max rel {worst:.3e} of each leaf's scale, health max {hw:.3e} of "
              f"max(1, |value|) (limit {STATS_LIMIT:g}); counts exact")


def phase_stats_ensemble(torch, pt, card, phase="phase28"):
    """``ensemble129`` K = 32 fused: member-steps/s of 50 steps of bare
    ``update_n`` with statistics (stride 16) and without (off, on, on,
    off); members 0 and 31's sums against solo runs of their seeds (1e-12
    of each leaf's scale, and whether bit for bit); the staged snapshot's
    statistics restored bit for bit; ``set_dt`` to dt/2 on the ensemble,
    10 steps finite, member 0 against a solo run at dt/2."""
    from rustpde_mpi_tpu_torch.utils import checkpoint

    k = ENSEMBLE_TIMED_K
    model = route_model(pt, ENSEMBLE129, "fused")
    ens = pt.NavierEnsemble.from_seeds(model, range(k))
    s0 = ens.state
    rate = {"off": [], "on": []}
    for on in (False, True, True, False, True):
        ens.set_stats(pt.StatsConfig(stride=STATS_STRIDE) if on else None)
        ens.update_n(STATS_STRIDE)  # the new graphs' first replays
        ens.reset_stats()
        ens.state, ens.mask = s0, torch.ones(k, dtype=torch.bool, device=s0.temp.device)
        torch.cuda.synchronize()
        t = time.perf_counter()
        ens.update_n(MAIN_STEPS)
        torch.cuda.synchronize()
        if len(rate["off"]) + len(rate["on"]) < 4:  # the last run is the one held below
            rate["on" if on else "off"].append(k * MAIN_STEPS / (time.perf_counter() - t))
    worst, bitwise = 0.0, True
    for i in (0, k - 1):
        solo = route_model(pt, ENSEMBLE129, "fused")
        solo.init_random(0.1, seed=i)
        solo.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
        solo.update_n(MAIN_STEPS)
        for a, b in zip(ens.stats_state, solo.stats_state):
            scale = max(float(b.abs().max()), 1e-300)
            worst = max(worst, float((a[i] - b).abs().max()) / scale)
            bitwise = bitwise and bool(torch.equal(a[i], b))
    if not worst <= ENSEMBLE_LIMIT:
        raise AssertionError(f"ensemble statistics vs solo {worst:.3e}")
    sums, tick = ens.stats_state, ens._stats_tick
    snap = checkpoint.ensemble_snapshot_to_host(ens)
    ens.reset_stats()
    checkpoint._restore_ensemble_snapshot(ens, checkpoint._host_group(snap))
    if not stats_leaves_equal(torch, ens.stats_state, sums) or not torch.equal(ens._stats_tick, tick):
        raise AssertionError("the ensemble's staged statistics did not restore bit for bit")
    state = ens.state
    t = time.perf_counter()
    ens.set_dt(ENSEMBLE129["dt"] / 2)
    ens.update_n(10)
    torch.cuda.synchronize()
    set_dt_s = time.perf_counter() - t
    solo = route_model(pt, ENSEMBLE129, "fused")
    solo.state = type(state)(*(x[0].clone() for x in state))
    solo.set_dt(ENSEMBLE129["dt"] / 2)
    solo.update_n(10)
    diff = max_rel_diff(torch, ens.member_state(0), solo.state)
    finite = all(bool(torch.isfinite(x).all()) for x in ens.state)
    print(f"{phase} ensemble129 K={k} fused route ({card}): member-steps/s statistics on "
          f"{rate['on']} off {rate['off']}; members 0, {k - 1} sums vs solo runs max rel "
          f"{worst:.3e} (limit {ENSEMBLE_LIMIT:g}), bit for bit {bitwise}; staged snapshot "
          f"{snap.nbytes / 2**20:.2f} MB, statistics restored bit for bit; set_dt(dt/2) and "
          f"10 steps {set_dt_s:.3f} s, finite {finite}, member 0 vs solo at dt/2 {diff:.3e}")
    if not finite or not diff <= ENSEMBLE_LIMIT:
        raise AssertionError(f"ensemble after set_dt: finite {finite}, vs solo {diff:.3e}")
    return rate


# -- the kernels line --------------------------------------------------------------


# -- phase 29: the linearised models, the steady-state finder, the banded backward -------

#: the card the phase runs on (a rehearsal on the CPU sets "cpu")
CARD = "cuda"
#: the JAX benchmark's ``workloads129`` cell (``bench.py:2490-2530``): K
#: members a kind at 129^2, Ra 1e7, Pr 1; dt 2e-3 (the finder's descent
#: 5e-3), the lnse members ``init_random(1e-4, seed)``, the finder's
#: eigenmode shapes of amplitude ``0.3 + 0.05 seed``; the dense DNS ensemble
#: beside them as the per-member yardstick
WORKLOADS129 = dict(nx=129, ny=129, ra=1e7, pr=1.0, aspect=1.0, bc="rbc")
WORKLOAD_KINDS = {"dns": (2e-3, ("dense",)), "lnse": (2e-3, ("dense", "mesh")),
                  "adjoint": (5e-3, ("fused", "dense", "mesh"))}
WORKLOAD_K = 4
WORKLOAD_STEPS = 64
#: a member against its solo run (the JAX benchmark's gate)
WORKLOAD_LIMIT = 1e-9
#: card against CPU: 10 steps at 33^2, each leaf within 1e-11 of its scale;
#: the finder's ``pseu``, the descent's projection of a nearly
#: divergence-free field, whose scale is 1e4-1e5 times below the
#: velocities' (so its own relative error is theirs times that), within
#: 1e-9 of its scale (2.4e-10 measured on the dense route) and 1e-11
#: of the velocities' scale (``velx``'s)
SMALL29 = dict(nx=33, ny=33, pr=1.0, aspect=1.0, bc="rbc")
SMALL29_STEPS = 10
SMALL29_LIMIT = 1e-11
PSEU29_LIMIT = 1e-9
#: the gradients at 129^2 over 50 steps (the JAX package's gates: the
#: exact gradient against a central directional difference, rel 1e-5; the
#: hand adjoint's objective rel 1e-10 and its direction cosine > 0.7)
GRAD_STEPS = 50
GRAD_EPS = 1e-6
GRAD_FD_LIMIT = 1e-5
GRAD_VALUE_LIMIT = 1e-10
GRAD_COS = 0.7
#: the banded solves of a step that its checkpoint recomputes in the backward
GRAD_RECOMPUTED_SOLVES = 5
#: the onset sign (``bench.py:2539-2548``): 8x17 periodic at the critical
#: wavelength, dt 0.05, horizon 12 in 6 samples
ONSET = dict(nx=8, ny=17, dt=0.05)
ONSET_RAS = (800.0, 4000.0)
ONSET_HORIZON, ONSET_SAMPLES = 12.0, 6
#: the steady finder: K = 2 at 33^2, Ra 1e4, ``build_steady_ensemble``'s seeds; with
#: ``res_tol`` 4e-3 the random member converges near step 280 (on the CPU)
#: and the eigenmode-seeded one does not within the 600 steps
STEADY29 = dict(nx=33, ny=33, ra=1e4, k=2, res_tol=4e-3)
STEADY29_CHUNKS, STEADY29_CHUNK = 6, 100
#: the banded backward against its plain version: 1e-12 of max|plain|
BACKWARD_LIMIT = 1e-12


def phase29_place(pt, route, device):
    """Constructor arguments of a route on ``device``."""
    if route == "mesh":
        return {"mesh": pt.make_mesh(MESH_RANKS, device)}
    return {"device": device, **(DENSE if route == "dense" else {})}


def workload_model(pt, kind, route, device=None, cell=None, dt=None, ra=None):
    """A ``kind`` model of the workloads registry on ``route`` (the
    linearised model takes no step kernels: its dense route is its only
    serial one)."""
    cfg = dict(cell or WORKLOADS129)
    kw = phase29_place(pt, route, device or CARD)
    if kind == "lnse":
        kw = {k: v for k, v in kw.items() if not k.endswith("kernel")}
    return pt.build_model(kind, cfg["nx"], cfg["ny"], ra or cfg["ra"], cfg["pr"],
                          dt or WORKLOAD_KINDS[kind][0], cfg["aspect"], cfg["bc"], False, **kw)


def seed_workload(model, kind, seed):
    """``bench.py``'s initial conditions of member ``seed``."""
    if kind == "adjoint":
        model.set_temperature(0.3 + 0.05 * seed, 1.0, 1.0)
        model.set_velocity(0.3 + 0.05 * seed, 1.0, 1.0)
    else:
        model.init_random(1e-2 if kind == "dns" else 1e-4, seed=seed)


def phase_workloads129(torch, pt):
    """Phase 29a: ``workloads129``, K = 4 members a kind and route, each an
    ensemble: the capture, one counted chunk of ``WORKLOAD_STEPS`` steps
    (launches by kernel, a step's exactly the captured step's), one timed
    chunk (member-steps/s), then every member against its solo run."""
    import numpy as np

    rows = {}
    for kind, (_, routes) in WORKLOAD_KINDS.items():
        for route in routes:
            model = workload_model(pt, kind, route)
            members = []
            for seed in range(WORKLOAD_K):
                seed_workload(model, kind, seed)
                members.append(model.state)
            ens = pt.NavierEnsemble(model, members)
            t0 = time.perf_counter()
            runner = ens.chunk_runner()
            capture = time.perf_counter() - t0
            if not runner.captured and CARD == "cuda":
                raise AssertionError(f"workloads129 {kind} {route}: no captured graph")
            names = [name for name, ks in model.kernels().items() for _ in ks]
            per_replay = {}
            for name, d in zip(names, runner.delta):
                per_replay[name] = per_replay.get(name, 0) + d
            reset_counts(model)
            ens.update_n(WORKLOAD_STEPS)
            torch.cuda.synchronize()
            counted = count_launches(model)
            want = {name: v * WORKLOAD_STEPS for name, v in per_replay.items()}
            if CARD == "cuda" and counted != want:
                raise AssertionError(f"workloads129 {kind} {route}: launches {counted}, "
                                     f"want {want}")
            t0 = time.perf_counter()
            ens.update_n(WORKLOAD_STEPS)
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            worst = 0.0
            for seed in range(WORKLOAD_K):
                solo = workload_model(pt, kind, route)
                seed_workload(solo, kind, seed)
                solo.update_n(WORKLOAD_STEPS)
                solo.update_n(WORKLOAD_STEPS)
                worst = max(worst, max_rel_diff(torch, ens.member_state(seed), solo.state))
                del solo
            obs = ens.get_observables()
            row = {"kind": kind, "route": route, "K": WORKLOAD_K, "capture_s": capture,
                   "ms_per_step": wall / WORKLOAD_STEPS * 1e3,
                   "member_steps_per_s": WORKLOAD_K * WORKLOAD_STEPS / wall,
                   "launches_per_step": {n: v / WORKLOAD_STEPS for n, v in counted.items()},
                   "member_vs_solo_max_rel": worst, "alive": int(ens.alive().sum()),
                   model.observable_names[0]: [float(v) for v in obs[0]]}
            print("phase29 workloads129 " + json.dumps(row))
            if not worst <= WORKLOAD_LIMIT:
                raise AssertionError(f"workloads129 {kind} {route}: a member differs from its "
                                     f"solo run by {worst:.3e}")
            if not (ens.alive().all() and np.isfinite(obs[0]).all()):
                raise AssertionError(f"workloads129 {kind} {route}: a member died")
            rows[kind, route] = row
            del ens, model
            if CARD == "cuda":
                torch.cuda.empty_cache()
    dns = rows["dns", "dense"]["member_steps_per_s"]
    for (kind, route), row in rows.items():
        print(f"phase29 workloads129 {kind} {route}: {row['member_steps_per_s']:.1f} member-steps/s, "
              f"{dns / row['member_steps_per_s']:.3f} x a dense DNS member-step's time")
    return rows


def small29_models(pt, kind, route, device):
    """The phase's 33^2 model of ``kind`` ("lnse", "nonlin", "adjoint") on
    ``route``, from its seeded initial condition; a CPU model takes the
    card's Chebyshev transform method."""
    kw = phase29_place(pt, route, device)
    if device == "cpu":
        kw["method"] = pt.bases.CARD_METHOD
    nx, ny = SMALL29["nx"], SMALL29["ny"]
    if kind == "adjoint":
        model = pt.Navier2DAdjoint(nx, ny, 1e4, 1.0, 5e-3, 1.0, "rbc", **kw)
        seed_workload(model, "adjoint", 0)
        return model
    kw = {k: v for k, v in kw.items() if not k.endswith("kernel")}
    cls = pt.Navier2DNonLin if kind == "nonlin" else pt.Navier2DLnse
    mean = pt.MeanFields.new_rbc(nx, ny, device="cpu")
    model = cls(nx, ny, 1e5, 1.0, 1e-2, 1.0, "rbc", mean=mean, **kw)
    model.init_random(1e-3, seed=1)
    return model


def leaf_diffs(torch, model, a, b):
    """Each leaf's largest difference of two states of ``model`` (global
    arrays, a mesh's pencils gathered) relative to the leaf's scale in
    ``b``."""
    out = {}
    for name, x, y in zip(a._fields, a, b):
        if name != "res_norms":
            space = getattr(model, f"{'pres' if name == 'pres_adj' else name}_space")
            x, y = space.gather_spectral(x), space.gather_spectral(y)
        x, y = x.cpu(), y.cpu()
        scale = float(torch.max(torch.abs(y)))
        out[name] = float(torch.max(torch.abs(x - y))) / (scale or 1.0)
    return out


def phase_small29(torch, pt):
    """Phase 29b: card against CPU at 33^2, 10 steps of ``update_n``, for
    the linearised, the perturbation and the finder model on every route
    each has."""
    for kind, routes in (("lnse", ("dense", "mesh")), ("nonlin", ("dense", "mesh")),
                         ("adjoint", ("fused", "dense", "mesh"))):
        for route in routes:
            card, cpu = small29_models(pt, kind, route, CARD), small29_models(pt, kind, route, "cpu")
            card.update_n(SMALL29_STEPS)
            cpu.update_n(SMALL29_STEPS)
            diffs = leaf_diffs(torch, card, card.state, cpu.state)
            if kind == "adjoint":
                diffs["pseu_of_velx_scale"] = diffs["pseu"] * float(
                    cpu.state.pseu.abs().max() / cpu.state.velx.abs().max())
            print(f"phase29 card vs CPU {kind} {route} 33^2 after {SMALL29_STEPS} steps: "
                  + json.dumps(diffs))
            for name, d in diffs.items():
                limit = PSEU29_LIMIT if (kind, name) == ("adjoint", "pseu") else SMALL29_LIMIT
                if not d <= limit:
                    raise AssertionError(f"card vs CPU {kind} {route}: {name} {d:.3e} > {limit:g}")


def backward_cases(torch, pt):
    """``(cell, model)`` whose dense step's banded solves phase 29c holds
    backward: ``rbc1025`` (the kernels line's), the ``workloads129``
    linearised model's, HC's general path at 129^2, and the periodic
    cell's complex planes at 128x129."""
    yield "rbc1025", pt.Navier2D(**RBC1025, device=CARD, **DENSE)
    yield "workloads129", workload_model(pt, "lnse", "dense").navier
    yield "hc129", pt.Navier2D(**HC_CELLS["hc129"], device=CARD, **DENSE)
    yield "periodic128", pt.Navier2D(**PERIODIC128, device=CARD, **DENSE)


def phase_banded_backward(torch, pt):
    """Phase 29c: the banded solve's backward (autograd through
    ``BandedSolveFn``: one kernel launch on ``A^T``'s factors) against the
    plain recurrence on those factors, every solve of each case's dense
    step on random inputs; timed beside the forward launch (queued behind
    the GPU spin), with its plain version's time and its bound.  Returns
    the ``rbc1025`` sums a step (the forward's launch counts) for the
    kernels line.  ``backward_library_ms``: one ``torch.matmul`` by the
    transposed inverse ``A^-T`` (every lane's, for per-lane factors) on the
    same cotangent."""
    import numpy as np

    from rustpde_mpi_tpu_torch.ops.transforms import apply_along

    rng = np.random.default_rng(29)
    sums = {"backward_ms": 0.0, "backward_forward_ms": 0.0, "backward_plain_ms": 0.0,
            "backward_bound_ms": 0.0, "backward_library_ms": 0.0}
    for cell, model in backward_cases(torch, pt):
        timing = cell == "rbc1025"
        for label, solver, b, axis, per_step, _ in banded_cases(torch, pt, model, rng, False):
            kernel = solver.kernel
            back = kernel.transposed()
            inv_t = banded_inverses(torch, kernel).transpose(1, 2)  # A^-T, a view
            g = random_field(torch, rng, tuple(b.shape), model.dtype, model.device, b.is_complex())
            before = (kernel.launches, back.launches)
            bb = b.clone().requires_grad_(True)
            (grad,) = torch.autograd.grad(solver.solve(bb, axis), bb, g)
            plain = solver._along(lambda v: back.plain(v), g, axis)
            diff, rel = rel_err(torch, grad, plain)
            launched = (kernel.launches - before[0], back.launches - before[1])
            rec = {"cell": cell, "case": label, "path": back.path, "p_q": [back.p, back.q],
                   "per_lane": kernel.per_lane, "complex": b.is_complex(),
                   "max_abs_err": diff, "max_rel_err": rel, "launches_fwd_bwd": launched}
            n = b.shape[axis]
            shape3 = (2 if b.is_complex() else 1, n, b.numel() // n)
            fwd_ms = time_queued_ms(torch, lambda: solver.solve(b, axis), QUEUED_REPS)[0]
            bwd_ms = time_queued_ms(torch, lambda: solver._along(lambda v: back.apply(v), g, axis),
                                    QUEUED_REPS)[0]
            t_op = back.flops(shape3) / (F64_TFLOPS * 1e12) * 1e3
            t_mem = back.bytes_moved(shape3) / (HBM_TB_PER_S * 1e12) * 1e3
            if kernel.per_lane:
                lib = lambda: lane_matmul(torch, inv_t, g.movedim(axis, -1)).movedim(-1, axis)
            else:
                lib = lambda: apply_along(inv_t[0], g, axis)
            rec.update(forward_ms=fwd_ms, backward_ms=bwd_ms, backward_bound_ms=max(t_op, t_mem),
                       backward_bound_by="operations" if t_op >= t_mem else "bytes",
                       backward_library_ms=time_queued_ms(torch, lib, 10)[0],
                       backward_library_max_rel_err=lane_rel_err(torch, lib(), grad, axis)[1])
            if timing:
                rec["backward_plain_ms"] = time_ms(
                    torch, lambda: solver._along(lambda v: back.plain(v), g, axis), 2)
                if per_step:
                    for key, ms in (("backward_ms", bwd_ms), ("backward_forward_ms", fwd_ms),
                                    ("backward_plain_ms", rec["backward_plain_ms"]),
                                    ("backward_bound_ms", rec["backward_bound_ms"]),
                                    ("backward_library_ms", rec["backward_library_ms"])):
                        sums[key] += per_step * ms
            del inv_t, lib
            print("phase29 banded backward " + json.dumps(rec))
            if CARD == "cuda" and launched != (1, 1):
                raise AssertionError(f"banded backward {cell}/{label}: launches {launched}")
            if back.path != kernel.path or not rel <= BACKWARD_LIMIT:
                raise AssertionError(f"banded backward {cell}/{label}: rel err {rel:.3e}, path "
                                     f"{back.path} (forward {kernel.path})")
            if not rec["backward_library_max_rel_err"] <= LIBRARY_LIMIT:
                raise AssertionError(f"banded backward {cell}/{label}: the library yardstick "
                                     f"solves another system (rel err "
                                     f"{rec['backward_library_max_rel_err']:.3e})")
        del model
        if CARD == "cuda":
            torch.cuda.empty_cache()
    print("phase29 banded backward rbc1025 dense step sums: " + json.dumps(sums))
    return sums


def transposed_launches(model) -> int:
    return sum(k.transposed().launches for k in model.kernels()["banded_solve"]
               if k._transposed is not None)


def phase_gradients129(torch, pt):
    """Phase 29d: ``grad_autodiff`` (autograd through the eager forward
    loop, each step checkpointed; every banded solve and its backward a
    kernel launch) and ``grad_adjoint`` at 129^2 over ``GRAD_STEPS`` steps,
    for the linearised and the perturbation model on the dense route: the
    exact gradient against a central directional difference, the hand
    adjoint's objective against the exact one and their direction cosine;
    wall time and peak memory of each.  Returns the backward launches of
    the linearised model's gradient."""
    import numpy as np

    cfg = WORKLOADS129
    backward_launches = 0
    for cls in (pt.Navier2DLnse, pt.Navier2DNonLin):
        model = cls(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], 2e-3, cfg["aspect"], cfg["bc"],
                    mean=pt.MeanFields.new_rbc(cfg["nx"], cfg["ny"], device="cpu"), device=CARD)
        model.init_random(1e-3, seed=1)
        ic = model.state
        horizon = GRAD_STEPS * model.dt
        reset_counts(model)
        out = {"model": cls.__name__, "steps": GRAD_STEPS}
        # the first call of each also builds the transposed factors (host)
        # and warms up the backward's kernels: timed apart from a second
        for name, run in (("autodiff_first", lambda: model.grad_autodiff(horizon)),
                          ("autodiff", lambda: model.grad_autodiff(horizon)),
                          ("adjoint", lambda: model.grad_adjoint(horizon))):
            model.state = ic
            model.reset_time()
            torch.cuda.synchronize()
            if CARD == "cuda":
                torch.cuda.reset_peak_memory_stats()
                held = torch.cuda.memory_allocated()
            t0 = time.perf_counter()
            val, grads = run()
            torch.cuda.synchronize()
            out[f"{name}_s"] = time.perf_counter() - t0
            # the call's own peak, over what the card held before it
            out[f"{name}_peak_mib"] = ((torch.cuda.max_memory_allocated() - held) / 2**20
                                       if CARD == "cuda" else None)
            out[name] = (val, grads)
            if name == "autodiff_first":
                out["forward_launches"] = count_launches(model)["banded_solve"]
                out["backward_launches"] = transposed_launches(model)
        (va, ga), (vh, gh) = out.pop("autodiff"), out.pop("adjoint")
        if out.pop("autodiff_first")[0] != va:
            raise AssertionError(f"{cls.__name__}: two grad_autodiff calls disagree")
        model.state = ic
        base = model._host_phys(ic)
        objective = model._objective(GRAD_STEPS, 0.5, 0.5, None)
        rng = np.random.default_rng(0)
        dirs = [rng.standard_normal(a.shape) for a in base]

        def at(sign):
            with torch.no_grad():
                return float(objective(*(model._place_physical(a + sign * GRAD_EPS * d)
                                         for a, d in zip(base, dirs))))

        fd = (at(1.0) - at(-1.0)) / (2 * GRAD_EPS)
        ad = -sum(float(np.sum(g * d)) for g, d in zip(ga, dirs))
        dot = sum(float(np.sum(a * h)) for a, h in zip(ga, gh))
        norm = math.sqrt(sum(float(np.sum(a * a)) for a in ga) * sum(float(np.sum(h * h))
                                                                      for h in gh))
        out.update(objective=va, fd_directional=fd, ad_directional=ad,
                   fd_rel=abs(ad - fd) / abs(fd), adjoint_value_rel=abs(vh - va) / abs(va),
                   cosine=dot / norm)
        print("phase29 gradients129 " + json.dumps(out))
        if not out["fd_rel"] <= GRAD_FD_LIMIT:
            raise AssertionError(f"{cls.__name__}: grad_autodiff vs the directional difference "
                                 f"{out['fd_rel']:.3e}")
        if not (out["adjoint_value_rel"] <= GRAD_VALUE_LIMIT and out["cosine"] > GRAD_COS):
            raise AssertionError(f"{cls.__name__}: grad_adjoint objective rel "
                                 f"{out['adjoint_value_rel']:.3e}, cosine {out['cosine']:.3f}")
        # each solve of the forward loop (7 a dense step) has its backward
        # launch once; the forward count adds each step's recompute, which
        # the non-reentrant checkpoint stops once it has the tensors it
        # saved: those end at the pressure solve, so it re-runs the velocity
        # and pressure solves (5) and not the two temperature ones
        want = GRAD_STEPS * PER_STEP["dense"]["banded_solve"]
        want_fwd = GRAD_STEPS * (PER_STEP["dense"]["banded_solve"] + GRAD_RECOMPUTED_SOLVES)
        if CARD == "cuda" and not (out["backward_launches"] == want
                                   and out["forward_launches"] == want_fwd):
            raise AssertionError(f"{cls.__name__}: {out['backward_launches']} backward launches "
                                 f"(want {want}), {out['forward_launches']} forward ones "
                                 f"(want {want_fwd})")
        if cls is pt.Navier2DLnse:
            backward_launches = out["backward_launches"]
        del model
    return backward_launches


def phase_onset(torch, pt):
    """Phase 29e: the onset sign, ``build_eigenmode_ensemble`` at Ra 800
    and 4000 stepped by ``update_n`` over ``ONSET_HORIZON`` in
    ``ONSET_SAMPLES`` chunks; ``growth_rates`` of the sampled energies
    decays below onset and grows above it; the card's energies against
    the CPU's."""
    import numpy as np

    sigma = {}
    steps = max(ONSET_SAMPLES, round(ONSET_HORIZON / ONSET["dt"]))
    chunk = max(1, steps // ONSET_SAMPLES)
    for ra in ONSET_RAS:
        runs = {}
        for device in (CARD, "cpu"):
            ens = pt.build_eigenmode_ensemble(ra=ra, device=device, **ONSET)
            times, energies = [], []
            for _ in range(ONSET_SAMPLES):
                ens.update_n(chunk)
                times.append(ens.get_time())
                energies.append(ens.get_observables()[0])
            runs[device] = (times, np.stack(energies))
        times, energies = runs[CARD]
        rel = float(np.max(np.abs(energies - runs["cpu"][1]) / np.abs(runs["cpu"][1])))
        sigma[ra] = float(np.nanmax(pt.growth_rates(times, energies)))
        print(f"phase29 onset Ra={ra:g}: sigma_max {sigma[ra]!r}; energies card vs CPU max rel "
              f"{rel:.3e}; energies {energies[:, 0].tolist()}")
        if not rel <= 1e-9:
            raise AssertionError(f"onset Ra={ra:g}: card energies differ from the CPU's ({rel:.3e})")
    lo, hi = (sigma[ra] for ra in ONSET_RAS)
    if not (math.isfinite(lo) and math.isfinite(hi) and lo < 0.0 < hi):
        raise AssertionError(f"onset sign: sigma {lo!r} at Ra {ONSET_RAS[0]:g}, {hi!r} at "
                             f"{ONSET_RAS[1]:g}")


def phase_steady29(torch, pt):
    """Phase 29f: ``build_steady_ensemble`` (K = 2, 33^2, Ra 1e4) in chunks
    on the card's captured graph: the residual of every member still
    advancing falls chunk over chunk, and the member that converges
    freezes inside a chunk (``steps_done`` stalls below the chunk's end,
    ``done_ok_members`` set) while the other goes on."""
    ens = pt.build_steady_ensemble(device=CARD, **STEADY29)
    runner = ens.chunk_runner()
    if CARD == "cuda" and not runner.captured:
        raise AssertionError("steady finder: no captured graph")
    prev = None
    for c in range(STEADY29_CHUNKS):
        alive = ens.alive()
        ens.update_n(STEADY29_CHUNK)
        res = ens.get_observables()[0]
        done = ens.steps_done.tolist()
        print(f"phase29 steady chunk {c}: residuals {res.tolist()} steps_done {done} alive "
              f"{ens.alive().tolist()} done_ok {ens.done_ok_members().tolist()}")
        if prev is not None and not (res[alive] < prev[alive]).all():
            raise AssertionError("steady finder: an advancing member's residual did not fall")
        prev = res
    total = STEADY29_CHUNKS * STEADY29_CHUNK
    done_ok, steps = ens.done_ok_members(), ens.steps_done.cpu().numpy()
    if not (done_ok.any() and (steps[done_ok] < total).all() and ens.alive().any()
            and (steps[ens.alive()] == total).all()):
        raise AssertionError(f"steady finder: no member froze at convergence inside a chunk "
                             f"(done_ok {done_ok.tolist()}, steps_done {steps.tolist()})")


def phase29(torch, pt):
    """Phase 29: the linearised and perturbation models, the steady-state
    finder, and the banded solve's backward (29a-29f); prints its wall
    time.  Returns the banded backward's entries of the kernels line."""
    t0 = time.perf_counter()
    phase_workloads129(torch, pt)
    phase_small29(torch, pt)
    sums = phase_banded_backward(torch, pt)
    sums["backward_launches"] = phase_gradients129(torch, pt)
    phase_onset(torch, pt)
    phase_steady29(torch, pt)
    print(f"phase29 ok: {time.perf_counter() - t0:.1f} s wall")
    return sums


#: phase 30a: the JAX benchmark's ``sh2048`` (``bench.py:208-226``):
#: SwiftHohenberg2D at 2048^2, r 0.35, dt 0.02, length 20, timed as its
#: ``benchmark_steps`` times it (a warm-up window of L = 128 steps, the
#: windows L and 4L once, then three L/4L pairs; ms/step the median slope
#: ``(t_4L - t_L) / 3L``), and its gate: the pattern energy grew over the
#: run (``e_end > max(e_start, 1e-10)``) and the field is finite
SH2048 = dict(nx=2048, ny=2048, r=0.35, dt=0.02, length=20.0)
SH_STEPS = 128
SH_REPS = 3
#: card against CPU: 50 steps at 64^2 (2-D) and nx = 256 (1-D), the
#: spectrum within 1e-12 of its scale
SH_SMALL_STEPS = 50
SH_LIMIT = 1e-12
#: phase 30b: the flips of a meshed ``grad_autodiff`` of the linearised
#: model (confined cell), forward and backward: ``a + b * steps`` each.  The
#: forward flips are the objective's transforms, each step's 51 and its
#: checkpoint's recompute; every forward flip of the taped graph has one
#: backward flip (the inverse flip).  ``tests/test_torch_lnse.py`` counts
#: them on the CPU.
GRAD_FLIPS_FWD = (9, 101)
GRAD_FLIPS_BWD = (2, 51)
#: the meshed gradient against the dense route's on the card and against
#: the CPU's: rel 1e-9 of each field's gradient scale (the CPU tests' limit
#: against the JAX package)
GRAD_ROUTES_LIMIT = 1e-9
#: phase 30c/30d: chunks of ``OVERLAP_CHUNK`` steps through ``integrate``
#: (one save boundary each) on fused ``rbc1025``
OVERLAP_CHUNKS = 4
OVERLAP_CHUNK = 25
#: phase 30c: blocking and overlapped runs of ``OVERLAP_CHUNKS`` chunks,
#: timed as this many back-to-back pairs (the order alternating)
OVERLAP_PAIRS = 10
#: the integrity layer's contract (the JAX package's ``config.py:480-482``):
#: one state digest a chunk adds at most 2% to it
DIGEST_GATE = 0.02


def phase_sh(torch, pt, card):
    """Phase 30a: ``sh2048`` as the JAX benchmark runs it (``SH2048``), each
    ``update_n`` of L or 4L steps one replay of one captured CUDA graph;
    then the card against the CPU at 64^2 and 1-D nx = 256."""
    import numpy as np

    model = pt.SwiftHohenberg2D(SH2048["nx"], SH2048["ny"], SH2048["r"], SH2048["dt"],
                                SH2048["length"], device=CARD)
    e_start = model.pattern_energy()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for n in (SH_STEPS, 4 * SH_STEPS):
        model.chunk_runner(n)
    torch.cuda.synchronize()
    capture_s = time.perf_counter() - t0
    runners = {n: model.chunk_runner(n) for n in (SH_STEPS, 4 * SH_STEPS)}
    if CARD == "cuda" and not all(r.captured for r in runners.values()):
        raise AssertionError("sh2048: a chunk runner did not capture a CUDA graph")

    def timed(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        model.update_n(n)
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    executed = 0
    for n in (SH_STEPS, SH_STEPS, 4 * SH_STEPS):  # the benchmark's warm-up and both windows
        timed(n)
        executed += n
    slopes, fixed = [], []
    for _ in range(SH_REPS):
        t_l, t_4l = timed(SH_STEPS), timed(4 * SH_STEPS)
        executed += 5 * SH_STEPS
        slope = (t_4l - t_l) / (3 * SH_STEPS)
        slopes.append(slope * 1e3)
        fixed.append((t_l - slope * SH_STEPS) * 1e3)
    replay_ms = time_ms(torch, lambda: runners[SH_STEPS].run(1), 3) / SH_STEPS
    ms = float(np.median(slopes))
    e_end = model.pattern_energy()
    grew = e_end > max(e_start, 1e-10)
    finite = not model.exit()
    out = {"cell": "sh2048", **SH2048, "steps": SH_STEPS, "steps_total": executed,
           "ms_per_step": ms, "steps_per_s": 1e3 / ms, "slope_reps_ms": slopes,
           "fixed_overhead_ms": float(np.median(fixed)), "replay_ms_per_step": replay_ms,
           "capture_s": capture_s, "graph_replays_per_update_n": 1,
           "pool_mib": sum(r.pool_bytes for r in runners.values()) / 2**20,
           "pattern_energy_start": e_start, "pattern_energy": e_end, "pattern_grew": grew,
           "finite": finite}
    print(f"phase30a ({card}) " + json.dumps(out))
    if not (grew and finite):
        raise AssertionError(f"sh2048: pattern_grew {grew}, finite {finite}")
    del model, runners
    torch.cuda.empty_cache()
    for label, make in (("sh2d_64", lambda dev: pt.SwiftHohenberg2D(64, 64, 0.35, 0.02, 20.0,
                                                                    device=dev)),
                        ("sh1d_256", lambda dev: pt.SwiftHohenberg1D(256, 0.35, 0.02, 20.0,
                                                                     device=dev))):
        a, b = make(CARD), make("cpu")
        if label.startswith("sh1d"):
            for m in (a, b):
                m.init_random(0.1, 1)
        a.update_n(SH_SMALL_STEPS)
        b.update_n(SH_SMALL_STEPS)
        diff = float(torch.max(torch.abs(a.theta.cpu() - b.theta)))
        rel = diff / float(torch.max(torch.abs(b.theta)))
        print(f"phase30a {label} card vs CPU after {SH_SMALL_STEPS} steps: rel {rel:.3e}")
        if not rel <= SH_LIMIT:
            raise AssertionError(f"{label}: card vs CPU rel {rel:.3e}")


def grad_model(pt, route, device, mesh=None):
    """The linearised model of phase 29d's gradients on ``route`` (on
    ``mesh``, when given, for the meshed route)."""
    cfg = WORKLOADS129
    place = {"mesh": mesh or pt.make_mesh(MESH_RANKS, device)} if route == "mesh" else \
        {"device": device}
    model = pt.Navier2DLnse(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], 2e-3, cfg["aspect"],
                            cfg["bc"], mean=pt.MeanFields.new_rbc(cfg["nx"], cfg["ny"],
                                                                  device="cpu"), **place)
    model.init_random(1e-3, seed=1)
    return model


def phase_mesh_grad(torch, pt, flips, card):
    """Phase 30b: ``grad_autodiff`` of the linearised model on the meshed
    route at 129^2 over ``GRAD_STEPS`` steps (every flip of the forward
    loop differentiated by the inverse flip, one launch), against the dense
    route's on the card and the CPU's: the exact flip and banded launch
    counts, wall and peak memory.  Then the backward flip beside the
    forward one at every shape a meshed ``rbc1025`` step flips (``flips``
    of phase 12): bit for bit its plain ring, timed with the L2 flushed
    beside the forward launch and the ``.contiguous()`` yardstick.  Returns
    the ring kernel's backward entries of the kernels line."""
    import numpy as np

    model = grad_model(pt, "mesh", CARD)
    ring = model.mesh.ring
    horizon = GRAD_STEPS * model.dt
    reset_counts(model)
    ring.backward_launches = 0
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    held = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    val, grads = model.grad_autodiff(horizon)
    torch.cuda.synchronize()
    first_s = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated() - held) / 2**20
    flips_bwd = ring.backward_launches
    flips_fwd = ring.launches - flips_bwd
    banded_fwd = count_launches(model)["banded_solve"]
    banded_bwd = transposed_launches(model)
    t0 = time.perf_counter()
    val2, _ = model.grad_autodiff(horizon)
    torch.cuda.synchronize()
    second_s = time.perf_counter() - t0
    refs = {}
    for label, device in (("dense_card", CARD), ("dense_cpu", "cpu")):
        other = grad_model(pt, "dense", device)
        t0 = time.perf_counter()
        refs[label] = other.grad_autodiff(horizon)
        if device != "cpu":
            torch.cuda.synchronize()
        refs[label + "_s"] = time.perf_counter() - t0
        del other
    out = {"cell": "workloads129", "route": "mesh", "steps": GRAD_STEPS, "objective": val,
           "first_s": first_s, "second_s": second_s, "peak_mib": peak,
           "flips_forward": flips_fwd, "flips_backward": flips_bwd,
           "banded_forward": banded_fwd, "banded_backward": banded_bwd,
           "dense_card_s": refs["dense_card_s"], "dense_cpu_s": refs["dense_cpu_s"]}
    for label in ("dense_card", "dense_cpu"):
        rval, rgrads = refs[label]
        out[f"{label}_objective_rel"] = abs(val - rval) / abs(rval)
        out[f"{label}_grad_rel"] = max(float(np.max(np.abs(g - r)) / np.max(np.abs(r)))
                                       for g, r in zip(grads, rgrads))
    print(f"phase30b meshed grad_autodiff ({card}) " + json.dumps(out))
    want = {"flips_forward": GRAD_FLIPS_FWD[0] + GRAD_FLIPS_FWD[1] * GRAD_STEPS,
            "flips_backward": GRAD_FLIPS_BWD[0] + GRAD_FLIPS_BWD[1] * GRAD_STEPS,
            "banded_forward": GRAD_STEPS * (PER_STEP["dense"]["banded_solve"]
                                            + GRAD_RECOMPUTED_SOLVES),
            "banded_backward": GRAD_STEPS * PER_STEP["dense"]["banded_solve"]}
    got = {k: out[k] for k in want}
    if CARD == "cuda" and got != want:
        raise AssertionError(f"meshed grad_autodiff launches {got}, want {want}")
    if val2 != val:
        raise AssertionError("two meshed grad_autodiff calls disagree")
    for label in ("dense_card", "dense_cpu"):
        if not (out[f"{label}_grad_rel"] <= GRAD_ROUTES_LIMIT
                and out[f"{label}_objective_rel"] <= GRAD_ROUTES_LIMIT):
            raise AssertionError(f"meshed gradient against {label}: grad rel "
                                 f"{out[f'{label}_grad_rel']:.3e}, objective rel "
                                 f"{out[f'{label}_objective_rel']:.3e}")
    del model, grads, refs
    torch.cuda.empty_cache()

    from rustpde_mpi_tpu_torch.parallel import make_mesh

    mesh = make_mesh(MESH_RANKS, CARD)
    ring = mesh.ring
    rng = np.random.default_rng(30)
    sums = {"backward_ms": 0.0, "backward_forward_ms": 0.0, "backward_plain_ms": 0.0,
            "backward_bound_ms": 0.0, "backward_library_ms": 0.0,
            "backward_launches": flips_bwd}
    for (shape, x_to_y, dtype), count in sorted(flips.items()):
        block = ring_case(torch, pt, mesh, shape, x_to_y, getattr(torch, dtype), rng)
        x = block.clone().requires_grad_(True)
        y = ring.apply(x, x_to_y)
        g = torch.randn_like(y)
        before = (ring.launches, ring.backward_launches)
        (grad,) = torch.autograd.grad(y, x, g, retain_graph=True)
        torch.cuda.synchronize()
        plain = ring.plain(g, not x_to_y)
        launched = (ring.launches - before[0], ring.backward_launches - before[1])
        if not torch.equal(grad, plain) or (CARD == "cuda" and launched != (1, 1)):
            raise AssertionError(f"flip backward {shape} x_to_y={x_to_y}: differs from the plain "
                                 f"inverse ring or launched {launched}")
        p = mesh.nranks
        nbytes = ring.bytes_moved(g)
        rec = {"shape": list(shape), "x_to_y": x_to_y, "dtype": dtype, "per_step": count,
               "forward_ms": time_cold_ms(torch, lambda: ring.apply(block, x_to_y), 20,
                                         spin=SLEEP_CYCLES // 4),
               # the one launch the backward makes (FlipFn.backward), without
               # the autograd engine's host time inside the device window
               "backward_ms": time_cold_ms(
                   torch, lambda: ring.flip(g.contiguous(), not x_to_y), 20,
                   spin=SLEEP_CYCLES // 4),
               "backward_plain_ms": time_queued_ms(torch, lambda: ring.plain(g, not x_to_y), 5)[0],
               "backward_library_ms": time_cold_ms(
                   torch, lambda: ring_library(g, p, not x_to_y), 20),
               "backward_bound_ms": nbytes / (HBM_TB_PER_S * 1e12) * 1e3}
        print("phase30b flip backward " + json.dumps(rec))
        for key, src in (("backward_ms", "backward_ms"), ("backward_forward_ms", "forward_ms"),
                         ("backward_plain_ms", "backward_plain_ms"),
                         ("backward_bound_ms", "backward_bound_ms"),
                         ("backward_library_ms", "backward_library_ms")):
            sums[key] += count * rec[src]
        del x, y, g, grad, plain, block
    print("phase30b flip backward rbc1025 meshed step sums: " + json.dumps(sums))
    return sums


def seeded(model, seed=0):
    """``model`` from ``init_random(0.1, seed)``."""
    model.init_random(0.1, seed=seed)
    return model


def overlap_runs(torch, pt, make, chunks, chunk, poison_at=None):
    """``integrate`` of ``chunks`` save windows of ``chunk`` steps, blocking
    and with ``overlap=True`` (the latter with an ``IOPipeline`` attached,
    so the callback's lines ride futures): ``(blocking model, overlapped
    model, statuses, chunks dispatched)``; ``poison_at``: the chunk after
    which the whole state turns NaN."""
    models, statuses, counts = [], [], []
    for overlap in (False, True):
        model = make()
        if overlap:
            model.io_pipeline = pt.IOPipeline(diag_lag=1)
        done = []

        def dispatch(pde, n, done=done):
            pde.update_n(n)
            done.append(n)
            if poison_at is not None and len(done) == poison_at:
                pde.state = type(pde.state)(*(f * float("nan") for f in pde.state))

        dt = model.get_dt()
        statuses.append(pt.integrate(model, chunks * chunk * dt, chunk * dt, dispatch=dispatch,
                                     overlap=overlap))
        if overlap:
            model.io_pipeline.drain()
            model.io_pipeline.close()
        counts.append(len(done))
        models.append(model)
    return models[0], models[1], statuses, counts


def phase_overlap(torch, pt, card):
    """Phase 30c: the overlapped ``integrate``.  ``integrate(overlap=True)``
    against ``overlap=False`` over the same chunks: the same final state
    bit for bit on fused ``rbc1025``, on the dense and meshed routes at 129^2
    and on ``NavierEnsemble`` at ``workloads129`` K = 4; a state poisoned
    after chunk 2 breaks at most one chunk late.  On fused ``rbc1025``
    (``OVERLAP_CHUNKS`` windows of ``OVERLAP_CHUNK`` steps, each with its
    callback): ms/step of each mode over ``OVERLAP_PAIRS`` back-to-back
    pairs (the order alternating), their medians and spreads, the gain of
    each pair, and each mode's host-idle share (device busy from the
    profiler over the median wall); then the async writer's submit-to-done
    time for a staged snapshot against the synchronous staging and digest
    of phase 27."""
    from rustpde_mpi_tpu_torch.utils import checkpoint

    def fused():
        model = pt.Navier2D(**RBC1025, device=CARD)
        model.init_random(0.1, seed=0)
        model.write_intervall = 1e9  # no flow files: the card machine may lack h5py
        return model

    steps = OVERLAP_CHUNKS * OVERLAP_CHUNK
    models = {"blocking": fused(), "overlap": fused()}
    for model in models.values():
        prepare_chunks(torch, model, "phase30c")
        model.io_pipeline = None
    for mode, model in models.items():
        if mode == "overlap":
            model.io_pipeline = pt.IOPipeline(diag_lag=1)
        # the first callback of a model builds the observables' operators
        # (phase 27): one window each before the timed runs
        pt.integrate(model, model.time + OVERLAP_CHUNK * model.dt, OVERLAP_CHUNK * model.dt,
                     overlap=mode == "overlap")
    walls = {"blocking": [], "overlap": []}
    order = [("blocking", "overlap")[::1 if i % 2 == 0 else -1] for i in range(OVERLAP_PAIRS)]
    for mode in (m for pair in order for m in pair):
        model = models[mode]
        dt = model.dt
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        status = pt.integrate(model, model.time + steps * dt, OVERLAP_CHUNK * dt,
                              overlap=mode == "overlap")
        if model.io_pipeline is not None:
            model.io_pipeline.drain()
        torch.cuda.synchronize()
        walls[mode].append((time.perf_counter() - t0) / steps * 1e3)
        if status != "time_limit":
            raise AssertionError(f"fused rbc1025 integrate ({mode}) ended {status!r}")
    a, b = models["blocking"], models["overlap"]
    if not same_state(torch, a.state, b.state) or a.time != b.time:
        raise AssertionError("fused rbc1025: the overlapped integrate ended at another state")
    # pair i is the i-th reading of each mode, run back to back
    gains = [1.0 - o / b for b, o in zip(walls["blocking"], walls["overlap"])]
    out = {"cell": "rbc1025", "route": "fused", "chunks": OVERLAP_PAIRS * OVERLAP_CHUNKS + 1,
           "chunk_steps": OVERLAP_CHUNK, "pairs": OVERLAP_PAIRS,
           "blocking_ms_per_step": walls["blocking"], "overlap_ms_per_step": walls["overlap"],
           "same_state": True}
    for mode in ("blocking", "overlap"):
        out[f"{mode}_median_ms_per_step"] = statistics.median(walls[mode])
        out[f"{mode}_spread"] = (max(walls[mode]) - min(walls[mode])) / statistics.median(
            walls[mode])
    for mode, model in models.items():
        dt = model.dt

        def run(model=model, mode=mode, dt=dt):
            pt.integrate(model, model.time + steps * dt, OVERLAP_CHUNK * dt,
                         overlap=mode == "overlap")
            if model.io_pipeline is not None:
                model.io_pipeline.drain()

        got = device_busy(torch, run, steps, {})
        busy = None if got is None else got[0] / 1e3 / steps
        out[f"{mode}_busy_ms_per_step"] = busy
        bare = statistics.median(walls[mode])
        out[f"{mode}_host_idle_share"] = None if busy is None else 1.0 - busy / bare
    # the gain of each pair: resolved only when every pair shows it
    out["overlap_gain_median"] = statistics.median(gains)
    out["overlap_gain_min"], out["overlap_gain_max"] = min(gains), max(gains)
    out["overlap_gain_resolved"] = min(gains) > 0.0
    print(f"phase30c overlap ({card}) " + json.dumps(out))
    b.io_pipeline.close()

    # the async writer: a staged snapshot's host work on the worker
    model = a
    model.reset_time()
    try:
        import h5py  # noqa: F401

        target = os.path.join(os.getcwd(), "phase30_snapshot.h5")
    except ImportError:
        target = None
    sync = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = checkpoint.snapshot_to_host(model)
        t1 = time.perf_counter()
        checkpoint.snapshot_digest(snap.datasets) if target is None else \
            checkpoint.write_host_snapshot(snap, target)
        sync.append({"stage_ms": (t1 - t0) * 1e3,
                     "host_ms": (time.perf_counter() - t1) * 1e3})
    pipe = pt.IOPipeline(queue_depth=1)
    asyn = []
    for _ in range(3):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        snap = checkpoint.snapshot_to_host(model)
        t1 = time.perf_counter()
        work = (lambda s=snap: checkpoint.snapshot_digest(s.datasets)) if target is None else \
            (lambda s=snap: checkpoint.write_host_snapshot(s, target))
        ticket = pipe.submit_write(work, target or "in-memory", nbytes=snap.nbytes)
        t2 = time.perf_counter()
        model.update_n(OVERLAP_CHUNK)  # the next chunk, while the worker writes
        torch.cuda.synchronize()
        t3 = time.perf_counter()
        ticket.wait()
        t4 = time.perf_counter()
        asyn.append({"stage_ms": (t1 - t0) * 1e3, "submit_ms": (t2 - t1) * 1e3,
                     "chunk_ms": (t3 - t2) * 1e3, "submit_to_done_ms": (t4 - t1) * 1e3,
                     "caller_blocked_ms": (t1 - t0 + t2 - t1 + t4 - t3) * 1e3})
    pipe.close()
    print(f"phase30c async writer ({card}) " + json.dumps(
        {"snapshot_mb": snap.nbytes / 1e6, "work": "hdf5 file" if target else
         "in-memory digest (no h5py)", "sync": sync, "async": asyn,
         "pipeline": pipe.stats()}))
    del models, a, b, model, snap
    torch.cuda.empty_cache()

    # the other routes and the ensemble: the same state, a late break
    cells = (("dense129", lambda: seeded(route_model(pt, ENSEMBLE129, "dense"))),
             ("mesh129", lambda: seeded(route_model(pt, ENSEMBLE129, "mesh"))),
             ("ensemble129_k4", lambda: pt.NavierEnsemble.from_seeds(
                 route_model(pt, ENSEMBLE129, "fused"), range(WORKLOAD_K))),
             ("rbc1025_fused", fused))
    for label, make in cells:
        def build(make=make):
            pde = make()
            pde.write_intervall = 1e9
            return pde

        if label != "rbc1025_fused":
            a, b, statuses, counts = overlap_runs(torch, pt, build, 4, 10)
            if statuses != ["time_limit"] * 2 or not same_state(torch, a.state, b.state):
                raise AssertionError(f"{label}: overlapped integrate {statuses}, same state "
                                     f"{same_state(torch, a.state, b.state)}")
        a, b, statuses, counts = overlap_runs(torch, pt, build, 6, 10, poison_at=2)
        print(f"phase30c {label}: overlapped integrate bit for bit the blocking one; poisoned "
              f"after chunk 2: statuses {statuses}, chunks run {counts}")
        if statuses != ["break"] * 2 or not counts[0] <= counts[1] <= counts[0] + 1:
            raise AssertionError(f"{label}: the poisoned run broke {statuses} after {counts} "
                                 "chunks (blocking, overlapped)")
        del a, b
    torch.cuda.empty_cache()


def phase_integrity(torch, pt, card):
    """Phase 30d: the integrity layer on fused ``rbc1025``: a run with a
    digest after every chunk bit for bit a run without; one digest's device
    ms (and the host's time to enqueue it; the larger of the two) and its
    share of an ``OVERLAP_CHUNK``-step chunk (fails above ``DIGEST_GATE``); the shadow audit (the plain chunk replayed from the
    chunk-start snapshot) equal to the live digest after a plain, a
    sentinel and a statistics chunk; a flipped bit moves the digest and the
    audit flags it.  Then the shadow audit on the dense and meshed routes
    at 129^2 and on the ensemble (K = 4), and the card's digest of a
    state equal to the CPU's digest of its copy, bit for bit, before and
    after digests of 40 other shapes."""
    from rustpde_mpi_tpu_torch.integrity import digest as dg

    def fused():
        model = pt.Navier2D(**RBC1025, device=CARD)
        model.init_random(0.1, seed=0)
        return model

    on, off = fused(), fused()
    on.set_integrity(pt.IntegrityConfig())
    digests = []
    torch.cuda.synchronize()
    walls = {}
    for label, model in (("off", off), ("on", on), ("on", on), ("off", off)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(OVERLAP_CHUNKS):
            model.update_n(OVERLAP_CHUNK)
            if model is on:
                digests.append(on.state_digest_async())
        torch.cuda.synchronize()
        walls.setdefault(label, []).append((time.perf_counter() - t0)
                                           / (OVERLAP_CHUNKS * OVERLAP_CHUNK) * 1e3)
    values = [int(d.result()) for d in digests]
    if not same_state(torch, on.state, off.state):
        raise AssertionError("fused rbc1025: the run with digests differs from the run without")
    leaves, lead = on._digest_fields(on.state)
    # the digest as the model runs it (a copy into the digest graph's
    # buffers, one replay, the word's copy to the host), and eagerly
    digest_ms, enqueue_ms = time_queued_ms(torch, on.state_digest_async, 20)
    mixes = dg.position_mixes(leaves, lead)
    eager_ms, eager_enqueue_ms = time_queued_ms(
        torch, lambda: dg.digest_words(leaves, lead, mixes), 5)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    on.state_digest_async().result()
    result_ms = (time.perf_counter() - t0) * 1e3
    chunk_ms = min(walls["off"]) * OVERLAP_CHUNK
    share = max(digest_ms, enqueue_ms) / chunk_ms
    cpu = dg.digest_tree([t.cpu() for t in on.state])
    out = {"cell": "rbc1025", "route": "fused", "digest_ms": digest_ms,
           "digest_enqueue_ms": enqueue_ms, "digest_result_wall_ms": result_ms,
           "eager_digest_ms": eager_ms, "eager_digest_enqueue_ms": eager_enqueue_ms,
           "chunk_steps": OVERLAP_CHUNK, "chunk_ms": chunk_ms,
           "share_of_chunk": share, "on_ms_per_step": walls["on"],
           "off_ms_per_step": walls["off"], "same_state": True, "digests": values[-2:],
           "card_equals_cpu": int(on.state_digest_async().result()) == int(cpu)}
    # the digest graph keeps what it reads: digests of 40 other shapes and
    # device memory handed to other tensors leave its replay right
    for n in range(40):
        dg.digest_tree([torch.ones((3 + n, 5), dtype=torch.float64, device=CARD)])
    filler = [torch.full((1 << 20,), -1, dtype=torch.int64, device=CARD) for _ in range(16)]
    out["card_equals_cpu_after_other_shapes"] = int(on.state_digest_async().result()) == int(cpu)
    del filler
    # shadow audits: plain, sentinel and statistics chunks
    audits = {}
    for chunk in ("plain", "sentinels", "stats"):
        if chunk == "sentinels":
            on.set_stability(pt.StabilityConfig())
        if chunk == "stats":
            on.set_stability(None)
            on.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
        snap = on.integrity_snapshot()
        on.update_n(OVERLAP_CHUNK)
        live = int(on.state_digest_async().result())
        t0 = time.perf_counter()
        shadow = int(on.shadow_digest_async(snap, OVERLAP_CHUNK).result())
        audits[chunk] = {"equal": shadow == live, "audit_s": time.perf_counter() - t0}
        if chunk == "plain":
            bad, info = pt.integrity.flip_state_bit(snap["state"], 7)
            flagged = int(on.shadow_digest_async({"state": bad}, OVERLAP_CHUNK).result()) != live
            moved = int(on.digest_of_async(bad).result()) != \
                int(on.digest_of_async(snap["state"]).result())
            audits["bitflip"] = {"moved": moved, "flagged": flagged, "info": info}
    on.set_stats(None)
    out["audits"] = audits
    print(f"phase30d integrity ({card}) " + json.dumps(out, default=str))
    if not out["card_equals_cpu"]:
        raise AssertionError("the card's digest differs from the CPU's digest of the same state")
    if not out["card_equals_cpu_after_other_shapes"]:
        raise AssertionError("the digest graph's replay changed after digests of other shapes")
    if share > DIGEST_GATE:
        raise AssertionError(f"a digest is {share:.4f} of a chunk (gate {DIGEST_GATE})")
    if not all(a["equal"] for k, a in audits.items() if k != "bitflip"):
        raise AssertionError(f"fused rbc1025: a shadow audit differs from the live digest {audits}")
    if not (audits["bitflip"]["moved"] and audits["bitflip"]["flagged"]):
        raise AssertionError(f"a flipped bit went unseen: {audits['bitflip']}")
    del on, off, leaves
    torch.cuda.empty_cache()
    for label, make in (("dense129", lambda: seeded(route_model(pt, ENSEMBLE129, "dense"))),
                        ("mesh129", lambda: seeded(route_model(pt, ENSEMBLE129, "mesh"))),
                        ("ensemble129_k4", lambda: pt.NavierEnsemble.from_seeds(
                            route_model(pt, ENSEMBLE129, "mesh"), range(WORKLOAD_K)))):
        pde = make()
        pde.set_integrity(pt.IntegrityConfig())
        pde.set_stability(pt.StabilityConfig())
        snap = pde.integrity_snapshot()
        pde.update_n(20)
        live = pde.state_digest_async().result()
        shadow = pde.shadow_digest_async(snap, 20).result()
        bad, _ = pt.integrity.flip_state_bit(snap["state"], 3,
                                             member=1 if label.startswith("ens") else None)
        flagged = pde.shadow_digest_async({**snap, "state": bad}, 20).result()
        equal = bool((shadow == live).all())
        print(f"phase30d {label}: shadow audit equal to the live (sentinel) digest: {equal}; "
              f"a flipped bit flagged: {(flagged != live).tolist()}")
        if not equal or not bool((flagged != live).any()):
            raise AssertionError(f"{label}: shadow audit {shadow} against live {live}")
        del pde


def phase30(torch, pt, flips, card):
    """Phase 30: Swift-Hohenberg at ``sh2048`` (30a), the meshed gradient
    and the flip's backward (30b), the overlapped ``integrate`` and the async
    writer (30c), the integrity layer (30d); prints its wall time.  Returns
    the ring kernel's backward entries of the kernels line."""
    t0 = time.perf_counter()
    phase_sh(torch, pt, card)
    sums = phase_mesh_grad(torch, pt, flips, card)
    phase_overlap(torch, pt, card)
    phase_integrity(torch, pt, card)
    print(f"phase30 ok: {time.perf_counter() - t0:.1f} s wall")
    return sums


# -- phase 31: the resilient runner -------------------------------------------------------

#: 31a/31c/31d/31f: steps of a run, the NaN fault's step, the chunk
RES_STEPS = 200
RES_FAULT_AT = 100
RES_CHUNK = 25
#: 31a: the recovered run against a clean run at the backed-off dt (the
#: JAX benchmark's gates: fields 1e-11 of their scale, Nu rel 1e-10)
RES_FIELD_LIMIT = 1e-11
RES_NU_REL = 1e-10
#: events whose presence depends on the wall clock (the throughput monitor)
CLOCKED_EVENTS = ("perf_degraded", "profile_capture")
#: 31a's journal, as the JAX package's test of the same run has it
NAN_EVENTS = ["start", "checkpoint", "fault_injected", "divergence", "retry", "checkpoint",
              "io_overlap", "done"]
#: 31d: the dispatch deadline and the slack its raise may take
WATCHDOG_S = 5.0
WATCHDOG_SLACK_S = 2.0
#: 31f: back-to-back triples (bare, telemetry on, off) and the telemetry gate
PRICE_TRIPLES = 10
TELEMETRY_GATE = 0.02
#: 31g: examples/navier_lnse_eigenmodes.py at its full settings, its gate
EIG_SWEEP = dict(ras=(1500.0, 1600.0, 1700.0, 1800.0, 1900.0), nx=8, ny=33, dt=0.05,
                 horizon=60.0, samples=24)
RAC_REL = 0.05
#: 31e: the child process's own time limit
CHILD_TIMEOUT_S = 600


def checkpoint_store_kind() -> str:
    """Where phase 31's runners keep checkpoints: ``"hdf5"`` files when
    ``h5py`` imports, else ``"memory"`` (the runner's private in-memory
    store; the card's machine has no ``h5py``)."""
    try:
        import h5py  # noqa: F401

        return "hdf5"
    except ImportError:
        return "memory"


def res_runner(pt, pde, run_dir, store, **kw):
    """A ``ResilientRunner`` on ``run_dir`` with the store ``store``
    (:func:`checkpoint_store_kind`)."""
    from rustpde_mpi_tpu_torch.utils import resilience

    mem = resilience._MemoryStore(run_dir) if store == "memory" else None
    return pt.ResilientRunner(pde, run_dir=run_dir, _store=mem, **kw)


def journal_of(runner) -> list:
    """The runner's journal rows, the wall-clock ones left out."""
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    return [e for e in read_journal(runner.journal_path) if e["event"] not in CLOCKED_EVENTS]


def fresh_fused(model, dt=None):
    """``model`` (fused ``rbc1025``) back at a new model's state after
    ``init_random(0.1, 0)`` (every field zeroed first: ``init_random`` sets
    the velocities and the temperature only), time 0, its stability
    sentinels and integrity off, at ``dt`` (default the cell's); the
    captured graphs of every visited rung stay cached."""
    model.set_stability(None)
    model.set_integrity(None)
    model.set_dt(RBC1025["dt"] if dt is None else dt)
    model.state = type(model.state)(*(t.new_zeros(t.shape) for t in model.state))
    model.init_random(0.1, seed=0)
    model.reset_time()
    return model


def kernel_set(*models) -> dict:
    """``{name: [wrappers]}`` over ``models``' ``kernels()`` taken at
    different times, each wrapper once: a dt rung's stages and solvers are
    other objects than another rung's."""
    out, seen = {}, set()
    for kernels in models:
        for name, ks in kernels.items():
            for k in ks:
                if id(k) not in seen:
                    seen.add(id(k))
                    out.setdefault(name, []).append(k)
    return out


def launches_of(kernels) -> dict:
    return {name: sum(k.launches for k in ks) for name, ks in kernels.items()}


def dispatched_steps() -> int:
    """Steps the runner dispatched since the flight recorder was cleared
    (its ``dispatch`` spans' ``steps``): with the break check one chunk
    late (the default ``IOConfig``), a poisoned state is stepped for one
    more chunk before the divergence is seen."""
    from rustpde_mpi_tpu_torch.telemetry import RECORDER

    events = RECORDER.events()
    if len(events) >= RECORDER.capacity:
        raise AssertionError("the flight recorder's ring overflowed: enlarge it")
    return sum(e["args"]["steps"] for e in events if e["name"] == "dispatch")


def entry_captures(kind) -> int:
    from rustpde_mpi_tpu_torch.telemetry import compile_log

    return compile_log.entry_compile_counts().get(kind, 0)


def phase31_nan(torch, pt, model, work, store, card):
    """31a on fused ``rbc1025``: ``bench_resilience``'s run at the primary
    cell (200 steps, ``nan@100``, one retry, backoff 0.5, no wall-clock
    cadence), launches counted from 0 just before; the recovered state
    against a clean run at dt/2; walls.  Returns the run's launches."""
    from rustpde_mpi_tpu_torch.telemetry import RECORDER

    fresh_fused(model)
    dt = RBC1025["dt"]
    max_time = RES_STEPS * dt
    # the clean wall: plain integrate of the same horizon (graph captured)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pt.integrate(model, max_time, None)
    torch.cuda.synchronize()
    clean_s = time.perf_counter() - t0
    fresh_fused(model)
    runner = res_runner(pt, model, os.path.join(work, "31a"), store, max_time=max_time,
                        checkpoint_every_s=None, max_retries=1, dt_backoff=0.5,
                        fault=f"nan@{RES_FAULT_AT}")
    captures0 = entry_captures("dns")
    before = model.kernels()
    RECORDER.clear()
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = runner.run()
    torch.cuda.synchronize()
    faulted_s = time.perf_counter() - t0
    kernels = kernel_set(before, model.kernels())
    launches = launches_of(kernels)
    captures = entry_captures("dns") - captures0
    events = [e["event"] for e in journal_of(runner)]
    stepped = dispatched_steps()
    want = {k: v * (stepped + captures) for k, v in PER_STEP["fused"].items()}
    ref = pt.Navier2D(**dict(RBC1025, dt=dt * 0.5), device=CARD)
    ref.init_random(0.1, seed=0)
    ref.update_n(summary["step"])
    diffs = state_diffs(torch, model.state, ref.state)
    worst = {k: d / s if s else d for k, (d, s) in diffs.items()}
    nu_ref = ref.eval_nu()
    out = {"cell": "rbc1025", "route": "fused", "checkpoint_store": store,
           "outcome": summary["outcome"], "retries": summary["retries"], "dt": summary["dt"],
           "time": summary["time"], "steps_after_rollback": summary["step"],
           "stepped": stepped, "captures": captures, "launches": launches, "want": want,
           "events": events, "nu": summary["nu"], "clean_nu": nu_ref,
           "field_rel_diffs": worst, "bit_for_bit": same_state(torch, model.state, ref.state),
           "faulted_s": faulted_s, "clean_s": clean_s,
           "recovery_overhead_x": faulted_s / clean_s}
    print(f"phase31a nan recovery ({card}) " + json.dumps(out))
    if events != NAN_EVENTS:
        raise AssertionError(f"31a journal {events}, expected {NAN_EVENTS}")
    if summary["retries"] != 1 or summary["dt"] != dt * 0.5 or summary["outcome"] != "done":
        raise AssertionError(f"31a summary {summary}")
    if launches != want or captures != 1:
        raise AssertionError(f"31a launches {launches} ({captures} captures), expected {want}")
    if abs(summary["nu"] - nu_ref) > RES_NU_REL * abs(nu_ref):
        raise AssertionError(f"31a Nu {summary['nu']} against the clean run's {nu_ref}")
    if max(worst.values()) > RES_FIELD_LIMIT:
        raise AssertionError(f"31a fields against the clean run: {worst}")
    del ref
    return launches


def phase31_nan_mesh(torch, pt, work, store, card):
    """31a on the meshed route at 129^2 (``ENSEMBLE129``'s cell, 4 ranks):
    the same run; banded launches exact, flips at least a step's 37 per
    stepped step (the observables reads and the checkpoint staging flip
    too).  Returns the run's launches."""
    from rustpde_mpi_tpu_torch.telemetry import RECORDER

    cfg = ENSEMBLE129
    model = route_model(pt, cfg, "mesh")
    model.init_random(0.1, seed=0)
    model.write_intervall = 1e9
    prepare_chunks(torch, model, "phase31a")
    runner = res_runner(pt, model, os.path.join(work, "31a_mesh"), store,
                        max_time=RES_STEPS * cfg["dt"], checkpoint_every_s=None, max_retries=1,
                        dt_backoff=0.5, fault=f"nan@{RES_FAULT_AT}")
    captures0 = entry_captures("dns")
    before = model.kernels()
    RECORDER.clear()
    reset_counts(model)
    summary = runner.run()
    torch.cuda.synchronize()
    launches = launches_of(kernel_set(before, model.kernels()))
    captures = entry_captures("dns") - captures0
    stepped = dispatched_steps()
    ref = route_model(pt, dict(cfg, dt=cfg["dt"] * 0.5), "mesh")
    ref.init_random(0.1, seed=0)
    ref.update_n(summary["step"])
    bits = same_state(torch, model.state, ref.state)
    out = {"cell": "mesh129", "outcome": summary["outcome"], "retries": summary["retries"],
           "dt": summary["dt"], "stepped": stepped, "captures": captures,
           "launches": launches, "banded_want": 7 * (stepped + captures),
           "flips_outside_steps": launches["ring_transpose"] - 37 * (stepped + captures),
           "bit_for_bit_clean": bits, "events": [e["event"] for e in journal_of(runner)]}
    print(f"phase31a meshed nan recovery ({card}) " + json.dumps(out))
    if out["events"] != NAN_EVENTS or summary["retries"] != 1 or not bits:
        raise AssertionError(f"31a meshed: {out}")
    if launches["banded_solve"] != out["banded_want"] or out["flips_outside_steps"] < 0:
        raise AssertionError(f"31a meshed launches {launches}")
    del model, ref
    torch.cuda.empty_cache()
    return launches


#: 31b: multiples of ``governor129``'s spike (8 / the probe's CFL) tried in
#: turn until the ungoverned run diverges
SPIKE_MULTIPLES = (1, 8, 64, 512)


def phase31_governed(torch, pt, model, work, store, card):
    """31b: ``governor129``'s run at ``rbc1025``: a spike at step 16, sized
    from the CFL a probe has there (``governor129``'s 8 / that CFL) and
    caught within ``max_chunk_steps`` (half the spike step, 2..8) by the
    governed run.  The sentinels' CFL of this cell is set by the clustered
    wall points, where the implicit diffusion damps an explicit overshoot,
    so 8 / CFL may leave the ungoverned run stable: the spike grows by
    ``SPIKE_MULTIPLES`` until the ungoverned run diverges (a retry or
    ``DivergenceError``), as ``governor129`` sizes it to; the governed
    run then takes that spike."""
    from rustpde_mpi_tpu_torch.config import StabilityConfig

    dt = RBC1025["dt"]
    spike_steps = max(32, min(RES_STEPS, 64))
    spike_at = max(4, spike_steps // 4)
    catch = max(2, min(8, spike_at // 2))
    fresh_fused(model)
    model.set_stability(StabilityConfig())
    cfl_base = model.update_n(spike_at).cfl_max
    tries = []
    for mult in SPIKE_MULTIPLES:
        factor = mult * 8.0 / max(cfl_base, 1e-9)
        fresh_fused(model)
        ungov = res_runner(pt, model, os.path.join(work, f"31b_ungov{mult}"), store,
                           max_time=spike_steps * dt, checkpoint_every_s=None, max_retries=3,
                           fault=f"spike@{spike_at}", spike_factor=factor)
        t0 = time.perf_counter()
        try:
            u = ungov.run()
            u_retries, u_outcome = u["retries"], u["outcome"]
        except pt.DivergenceError:
            u_retries, u_outcome = ungov.attempt, "diverged"
        torch.cuda.synchronize()
        tries.append({"multiple": mult, "spike_factor": factor, "retries": u_retries,
                      "outcome": u_outcome, "wall_s": time.perf_counter() - t0})
        if u_retries >= 1 or u_outcome == "diverged":
            break
    fresh_fused(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    gov = res_runner(pt, model, os.path.join(work, "31b_gov"), store,
                     max_time=spike_steps * dt, checkpoint_every_s=None, max_retries=2,
                     fault=f"spike@{spike_at}", spike_factor=factor,
                     stability=StabilityConfig(), max_chunk_steps=catch)
    g = gov.run()
    torch.cuda.synchronize()
    gov_s = time.perf_counter() - t0
    health = g["health"]
    dts = [e["dt"] for e in journal_of(gov) if e["event"] == "dt_adjust"]
    out = {"cell": "rbc1025", "spike_at": spike_at, "probe_cfl": cfl_base,
           "spike_factor": factor, "catch_window": catch,
           "governed": {"outcome": g["outcome"], "nu": g["nu"], "retries": g["retries"],
                        "dt": g["dt"], "health": health, "dt_trajectory": dts,
                        "events": sorted({e["event"] for e in journal_of(gov)}),
                        "wall_s": gov_s},
           "ungoverned": tries}
    print(f"phase31b governed spike ({card}) " + json.dumps(out))
    if g["outcome"] != "done" or g["nu"] is None or not math.isfinite(g["nu"]):
        raise AssertionError(f"31b governed run: {g}")
    if health["pre_divergence_catches"] < 1:
        raise AssertionError(f"31b: no pre-divergence catch: {health}")
    if g["retries"] > u_retries or (u_retries < 1 and u_outcome != "diverged"):
        raise AssertionError(f"31b retries governed {g['retries']}, ungoverned {u_retries} "
                             f"({u_outcome})")


def phase31_integrity(torch, pt, model, work, store, card):
    """31c: ``bitflip@100`` under the integrity audits (cadence 2) on fused
    ``rbc1025`` in chunks of 25: the mismatch journaled, the in-memory
    rollback to the verified snapshot, the final state bit for bit a clean
    run's, the device's strike in the quarantine ledger."""
    from rustpde_mpi_tpu_torch.config import IntegrityConfig
    from rustpde_mpi_tpu_torch.integrity import QuarantineLedger

    dt = RBC1025["dt"]
    fresh_fused(model)
    model.update_n(RES_STEPS)
    clean = [t.clone() for t in model.state]
    fresh_fused(model)
    model.set_integrity(IntegrityConfig(cadence=2))
    run_dir = os.path.join(work, "31c")
    runner = res_runner(pt, model, run_dir, store, max_time=RES_STEPS * dt,
                        save_intervall=RES_CHUNK * dt, checkpoint_every_s=None,
                        fault=f"bitflip@{RES_FAULT_AT}")
    t0 = time.perf_counter()
    summary = runner.run()
    wall = time.perf_counter() - t0
    rows = journal_of(runner)
    mismatch = [e for e in rows if e["event"] == "integrity_mismatch"]
    rollback = [e for e in rows if e["event"] == "integrity_rollback"]
    dev = model.state[0].device
    device = f"{dev.type}:{dev.index or 0}@proc0"  # the ledger's key of the model's card
    strikes = QuarantineLedger(run_dir).strikes_for(device)
    bits = all(torch.equal(a, b) for a, b in zip(model.state, clean))
    out = {"cell": "rbc1025", "outcome": summary["outcome"], "mismatch": mismatch,
           "rollback": rollback, "ledger_strikes": strikes, "bit_for_bit_clean": bits,
           "audits": sum(1 for e in rows if e["event"] == "integrity_audit"), "wall_s": wall}
    print(f"phase31c integrity bitflip ({card}) " + json.dumps(out))
    model.set_integrity(None)
    if not mismatch or not rollback or not bits or strikes != 1:
        raise AssertionError(f"31c: {out}")
    if rollback[0]["to_step"] != RES_FAULT_AT or mismatch[0]["device"] != device:
        raise AssertionError(f"31c rollback {rollback}, mismatch {mismatch}")


def phase31_watchdog(torch, pt, model, work, store, card):
    """31d: the ``slow`` fault against a ``WATCHDOG_S`` dispatch deadline:
    ``DispatchHang`` raised within the deadline + ``WATCHDOG_SLACK_S`` of
    the stalled dispatch's start, a flight record with the ``dispatch``
    spans, the journal's ``dispatch_hang``."""
    dt = RBC1025["dt"]
    fresh_fused(model)
    run_dir = os.path.join(work, "31d")
    runner = res_runner(pt, model, run_dir, store, max_time=RES_STEPS * dt,
                        save_intervall=RES_CHUNK * dt, checkpoint_every_s=None,
                        fault=f"slow@{RES_FAULT_AT}", dispatch_timeout_s=WATCHDOG_S)
    t0 = time.perf_counter()
    try:
        runner.run()
        raise AssertionError("31d: the slow fault raised no DispatchHang")
    except pt.DispatchHang as exc:
        hang = str(exc)
    wall = time.perf_counter() - t0
    dumps = sorted(f for f in os.listdir(run_dir) if f.startswith("flight_dispatch_hang"))
    spans = []
    if dumps:
        with open(os.path.join(run_dir, dumps[0])) as fh:
            spans = [e for e in json.load(fh)["traceEvents"] if e["name"] == "dispatch"]
    hung = [e for e in spans if e.get("args", {}).get("error") == "DispatchHang"]
    events = [e["event"] for e in journal_of(runner)]
    out = {"hang": hang, "wall_s": wall, "flight_records": dumps, "dispatch_spans": len(spans),
           "hung_span_s": hung[0]["dur"] / 1e6 if hung else None,
           "last_events": events[-3:]}
    print(f"phase31d watchdog ({card}) " + json.dumps(out))
    torch.cuda.synchronize()
    if not hung or hung[0]["dur"] / 1e6 > WATCHDOG_S + WATCHDOG_SLACK_S:
        raise AssertionError(f"31d: the hung dispatch's span {hung}")
    if "dispatch_hang" not in events or len(spans) < 2:
        raise AssertionError(f"31d: journal {events}, {len(spans)} dispatch spans")


CHILD_31E = r"""
import json, os, sys
args = json.loads(sys.argv[1])
sys.path.insert(0, args["root"])
import torch
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.utils import checkpoint, resilience
from rustpde_mpi_tpu_torch.utils.journal import read_journal

_build.build()
cfg, run_dir = args["cfg"], args["run_dir"]
dt = cfg["dt"]
store = resilience._MemoryStore(run_dir) if args["store"] == "memory" else None

def make():
    m = pt.Navier2D(**cfg, device="cuda")
    m.init_random(0.1, seed=0)
    m.write_intervall = 1e9
    return m

run = dict(max_time=args["steps"] * dt / 2, save_intervall=args["chunk"] * dt / 2,
           checkpoint_every_s=None)
first = make()
first.set_dt(dt / 2)  # a backed-off run: its checkpoints carry dt / 2
s1 = pt.ResilientRunner(first, run_dir=run_dir, fault=f"kill@{args['kill']}", _store=store,
                        **run).run()
attrs = (store.attrs(s1["checkpoint"]) if store is not None
         else checkpoint.read_attrs(s1["checkpoint"]))
model = make()  # a new run at the cell's dt, on the same store
s2 = pt.ResilientRunner(model, run_dir=run_dir, _store=store, **run).run()
ref = make()
ref.set_dt(dt / 2)
ref.update_n(s2["step"])
torch.cuda.synchronize()
rows = read_journal(os.path.join(run_dir, "journal.jsonl"))
print(json.dumps({"first": s1["outcome"], "first_step": s1["step"],
                  "checkpoint_dt": attrs["dt"], "second": s2["outcome"],
                  "second_step": s2["step"], "second_dt": s2["dt"],
                  "dt_restored": [e["dt"] for e in rows if e["event"] == "dt_restored"],
                  "resumed": any(e["event"] == "resumed" for e in rows),
                  "bit_for_bit": all(torch.equal(a, b) for a, b in zip(model.state, ref.state))}))
"""


def phase31_resume(torch, pt, work, store, card):
    """31e: ``kill@100`` (SIGTERM to itself) then resume, in a child process
    (a mishandled signal cannot end this script) at 129^2 fused: a run at
    dt/2 preempted at step 100 checkpoints; a new runner on the same store,
    its model built at dt, resumes with the checkpoint's dt and ends bit
    for bit an uninterrupted run at dt/2."""
    args = {"root": ROOT, "cfg": ENSEMBLE129, "run_dir": os.path.join(work, "31e"),
            "store": store, "steps": RES_STEPS, "chunk": RES_CHUNK, "kill": RES_FAULT_AT}
    t0 = time.perf_counter()
    proc = subprocess.run([sys.executable, "-c", CHILD_31E, json.dumps(args)],
                          capture_output=True, text=True, timeout=CHILD_TIMEOUT_S)
    wall = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.startswith("{")]
    if proc.returncode != 0 or not lines:
        raise AssertionError(f"31e child failed (rc={proc.returncode}):\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    res = json.loads(lines[-1])
    res["wall_s"] = wall
    print(f"phase31e preempt and resume ({card}) " + json.dumps(res))
    half = ENSEMBLE129["dt"] / 2
    if (res["first"], res["second"]) != ("preempted", "done") or not res["resumed"] \
            or res["first_step"] != RES_FAULT_AT or res["second_step"] != RES_STEPS:
        raise AssertionError(f"31e: {res}")
    if res["checkpoint_dt"] != half or res["dt_restored"] != [half] \
            or res["second_dt"] != half or not res["bit_for_bit"]:
        raise AssertionError(f"31e: {res}")


def phase31_price(torch, pt, model, work, store, card):
    """31f: 200 steps of fused ``rbc1025`` in chunks of 25 under the runner
    (default ``IOConfig``: the anchor and final checkpoints staged and
    written on the worker) with telemetry on and off, and bare
    ``update_n`` of the same chunks, in ``PRICE_TRIPLES`` back-to-back
    triples (order rotating).  The states on and off bit for bit; the
    median of the triples' telemetry overheads at most ``TELEMETRY_GATE``;
    the runner's median overhead over bare stepping; each mode's host-idle
    share (profiler).  Returns the bare ms/step."""
    from rustpde_mpi_tpu_torch import telemetry

    dt = RBC1025["dt"]
    n = [0]

    def runner_run(on):
        fresh_fused(model)
        telemetry.set_enabled(on)
        try:
            n[0] += 1
            r = res_runner(pt, model, os.path.join(work, f"31f_{n[0]}"), store,
                           max_time=RES_STEPS * dt, checkpoint_every_s=None,
                           max_chunk_steps=RES_CHUNK)
            if r.run()["outcome"] != "done":
                raise AssertionError("31f: the runner did not finish")
        finally:
            telemetry.set_enabled(True)

    def bare():
        fresh_fused(model)
        for _ in range(RES_STEPS // RES_CHUNK):
            model.update_n(RES_CHUNK)

    modes = {"bare": bare, "on": lambda: runner_run(True), "off": lambda: runner_run(False)}
    walls = {k: [] for k in modes}
    states = {}
    order = ("bare", "on", "off")
    for i in range(PRICE_TRIPLES + 1):
        for mode in order[i % 3:] + order[:i % 3]:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            modes[mode]()
            torch.cuda.synchronize()
            if i:  # the first triple warms every path up
                walls[mode].append((time.perf_counter() - t0) / RES_STEPS * 1e3)
            states[mode] = [t.clone() for t in model.state]
    same = all(torch.equal(a, b) for a, b in zip(states["on"], states["off"]))
    same_bare = all(torch.equal(a, b) for a, b in zip(states["on"], states["bare"]))
    tele = [on / off - 1.0 for on, off in zip(walls["on"], walls["off"])]
    harness = [off / b - 1.0 for off, b in zip(walls["off"], walls["bare"])]
    out = {"cell": "rbc1025", "route": "fused", "steps": RES_STEPS, "chunk": RES_CHUNK,
           "triples": PRICE_TRIPLES, "checkpoint_store": store, "ms_per_step": walls,
           "median_ms_per_step": {k: statistics.median(v) for k, v in walls.items()},
           "telemetry_overheads": tele, "telemetry_overhead_median": statistics.median(tele),
           "runner_overheads": harness, "runner_overhead_median": statistics.median(harness),
           "on_equals_off": same, "on_equals_bare": same_bare}
    for mode, run in modes.items():
        got = device_busy(torch, run, RES_STEPS, PROFILE_LAUNCHES["fused"])
        busy = None if got is None else got[0] / 1e3 / RES_STEPS
        out[f"{mode}_busy_ms_per_step"] = busy
        out[f"{mode}_host_idle_share"] = (None if busy is None else
                                          1.0 - busy / statistics.median(walls[mode]))
    print(f"phase31f harness price ({card}) " + json.dumps(out))
    if not same or not same_bare:
        raise AssertionError(f"31f: telemetry on/off same state {same}, on/bare {same_bare}")
    if out["telemetry_overhead_median"] > TELEMETRY_GATE:
        raise AssertionError(f"31f: telemetry overhead {out['telemetry_overhead_median']:.4f} "
                             f"above {TELEMETRY_GATE}")
    return out["median_ms_per_step"]["bare"]


def phase31_workloads(torch, pt, work, store, card):
    """31g: ``eigenmode_sweep`` at ``examples/navier_lnse_eigenmodes.py``'s
    full settings (its Ra_c within 5% of 1707.76, the example's gate) and
    ``steady_state_find`` at its defaults (converged below ``res_tol``),
    their walls, and the banded launches of the models they built.
    Returns the launches by kernel."""
    from rustpde_mpi_tpu_torch.utils import resilience
    from rustpde_mpi_tpu_torch.workloads import eigenmodes, steady

    built = []

    def recording(orig):
        def build(**kw):
            ens = orig(**kw)
            built.append(ens)
            return ens
        return build

    def launches():
        out = {}
        for ens in built:
            for name, ks in ens.model.kernels().items():
                out[name] = out.get(name, 0) + sum(k.launches for k in ks)
        return out

    factory = (lambda d: resilience._MemoryStore(d)) if store == "memory" else None
    sweep = dict(EIG_SWEEP)
    ras = sweep.pop("ras")
    eigenmodes.build_eigenmode_ensemble, orig_eig = \
        recording(eigenmodes.build_eigenmode_ensemble), eigenmodes.build_eigenmode_ensemble
    captures0 = entry_captures("lnse")
    t0 = time.perf_counter()
    try:
        results = pt.eigenmode_sweep(ras, run_dir=os.path.join(work, "31g_eig"), _store=factory,
                                     **sweep)
    finally:
        eigenmodes.build_eigenmode_ensemble = orig_eig
    sweep_s = time.perf_counter() - t0
    sweep_launches = launches()
    rac = pt.critical_rayleigh(results)
    steps = sum(r["steps"] for r in results)
    # the periodic linearised step solves 4 banded systems; each Ra's chunk
    # runner makes one warm-up step when it captures
    sweep_want = 4 * (steps + entry_captures("lnse") - captures0)
    built.clear()
    steady.build_steady_ensemble, orig_find = \
        recording(steady.build_steady_ensemble), steady.build_steady_ensemble
    t0 = time.perf_counter()
    try:
        find = pt.steady_state_find(run_dir=os.path.join(work, "31g_find"), install_signals=False,
                                    _store=None if factory is None else factory(
                                        os.path.join(work, "31g_find")))
    finally:
        steady.build_steady_ensemble = orig_find
    find_s = time.perf_counter() - t0
    find_launches = launches()
    out = {"sweep": {"sigma_max": {r["ra"]: r["sigma_max"] for r in results}, "Ra_c": rac,
                     "rel_err": abs(rac - eigenmodes.RAC_RIGID) / eigenmodes.RAC_RIGID,
                     "steps": steps, "wall_s": sweep_s, "launches": sweep_launches,
                     "banded_want": sweep_want},
           "find": {**find, "wall_s": find_s, "launches": find_launches}}
    print(f"phase31g workloads ({card}) " + json.dumps(out))
    if out["sweep"]["rel_err"] > RAC_REL:
        raise AssertionError(f"31g: Ra_c {rac} not within {RAC_REL} of {eigenmodes.RAC_RIGID}")
    if sweep_launches.get("banded_solve", 0) != sweep_want:
        raise AssertionError(f"31g: the sweep launched {sweep_launches} over {steps} steps")
    if not all(find["converged"]) or not find_launches.get("banded_solve"):
        raise AssertionError(f"31g: the find {find}, launches {find_launches}")
    total = dict(sweep_launches)
    for k, v in find_launches.items():
        total[k] = total.get(k, 0) + v
    return total


def phase31_profiling(torch, pt, model, bare_ms, card):
    """31h: ``step_flops`` of fused ``rbc1025`` against the sum of its
    wrappers' flops over a step's applications (the velocity instance on
    velx and vely, the temperature's, the seven stages), ``mfu_estimate``
    from 31f's bare rate, and the device memory gauges."""
    from rustpde_mpi_tpu_torch.telemetry import compile_log, snapshot
    from rustpde_mpi_tpu_torch.utils import profiling

    fresh_fused(model)
    kernels = model.kernels()
    want = sum(st.flops for st in kernels["fused_stage"])
    want += sum(model._convs[id(getattr(model, f"{f}_space"))].flops
                for f in ("velx", "vely", "temp"))
    flops = profiling.step_flops(model)
    mfu = profiling.mfu_estimate(model, 1e3 / bare_ms)
    reported = compile_log.update_device_memory_gauges()
    gauges = {s["labels"]["device"]: s["value"]
              for s in snapshot().get("device_memory_bytes_in_use", {}).get("series", [])}
    out = {"step_gflop": flops / 1e9, "wrappers_gflop": want / 1e9, "mfu": mfu,
           "memory_devices_reported": reported, "device_memory_bytes_in_use": gauges}
    print(f"phase31h profiling ({card}) " + json.dumps(out))
    if abs(flops - want) > 1e-12 * want or ("H100" in card and mfu["peak_key"] != "h100_sxm_f64"):
        raise AssertionError(f"31h: step_flops {flops} against {want}, {mfu}")
    if reported < 1 or not any(v > 0 for v in gauges.values()):
        raise AssertionError(f"31h: device memory gauges {gauges}")


def phase31(torch, pt, card):
    """Phase 31: the resilient runner, the workloads under it and the
    profiling helpers on the card (module docstring); prints its wall time.
    Returns the runner runs' launches by kernel for the kernels line."""
    t0 = time.perf_counter()
    store = checkpoint_store_kind()
    print(f"phase31 checkpoint_store={store} ({card})")
    out = {}
    with tempfile.TemporaryDirectory(prefix="phase31_") as work:
        model = pt.Navier2D(**RBC1025, device=CARD)
        model.init_random(0.1, seed=0)
        model.write_intervall = 1e9
        prepare_chunks(torch, model, "phase31a")
        fused = phase31_nan(torch, pt, model, work, store, card)
        out.update(fused)
        mesh = phase31_nan_mesh(torch, pt, work, store, card)
        phase31_governed(torch, pt, model, work, store, card)
        phase31_integrity(torch, pt, model, work, store, card)
        phase31_watchdog(torch, pt, model, work, store, card)
        bare_ms = phase31_price(torch, pt, model, work, store, card)
        phase31_profiling(torch, pt, model, bare_ms, card)
        del model
        torch.cuda.empty_cache()
        phase31_resume(torch, pt, work, store, card)
        work_launches = phase31_workloads(torch, pt, work, store, card)
    out["banded_solve"] = mesh["banded_solve"] + work_launches.get("banded_solve", 0)
    out["ring_transpose"] = mesh["ring_transpose"]
    print(f"phase31 ok: {time.perf_counter() - t0:.1f} s wall")
    return out


# -- phase 32: sharded checkpoints on a mesh -------------------------------------------

SHARD_STEPS = 10
SHARD_STAGE_REPS = 5
SHARD_TARGETS = (("mesh2", dict(mesh=2)), ("serial_dense", DENSE), ("mesh4", dict(mesh=4)))


def global_leaves(model) -> dict:
    """The state's fields as global device tensors (pencils gathered)."""
    return {name: space.gather_spectral(getattr(model.state, name))
            for name, space in model._state_fields()}


def same_leaves(torch, a: dict, b: dict) -> bool:
    return a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a)


def shard_target(pt, spec):
    kw = dict(spec)
    if "mesh" in kw:
        kw["mesh"] = pt.make_mesh(kw["mesh"], CARD)
    else:
        kw["device"] = CARD
    model = pt.Navier2D(**RBC1025, **kw)
    model.write_intervall = 1e9
    model.set_integrity(pt.IntegrityConfig())
    return model


def phase32(torch, pt, card):
    """Phase 32: sharded two-phase checkpoints at full width.  Meshed
    ``rbc1025`` on ``make_mesh(4)`` with the integrity layer armed runs
    ``SHARD_STEPS`` steps under the resilient runner with
    ``IOConfig(sharded_checkpoints=True)`` and the in-memory store (the
    card's machine has no ``h5py``): its anchor and final checkpoints are
    staged sharded snapshots.  The final one restores, through the
    in-memory slab catalog, onto ``make_mesh(2)``, a serial dense model and
    a fresh ``make_mesh(4)``, each bit for bit the writer's state with the
    manifest's digest verified; each restored model then steps
    ``SHARD_STEPS`` steps and must equal bit for bit the same model run
    from the state placed as the gathered reader places it (and the
    ``make_mesh(4)`` one the writer's own continued run).  Prints the
    sharded staging time beside the gathered staging of the same state,
    and, where ``h5py`` imports, writes, commits and reads the files too.
    Launches counted from 0 over the whole path.  Returns them."""
    from rustpde_mpi_tpu_torch.utils import checkpoint as ck
    from rustpde_mpi_tpu_torch.utils import resilience

    t0 = time.perf_counter()
    dt = RBC1025["dt"]
    models = []
    with tempfile.TemporaryDirectory(prefix="phase32_") as work:
        model = shard_target(pt, dict(mesh=MESH_RANKS))
        model.init_random(0.1, seed=0)
        models.append(model)
        store = resilience._MemoryStore(work)
        runner = pt.ResilientRunner(model, max_time=SHARD_STEPS * dt, run_dir=work,
                                    checkpoint_every_s=None,
                                    io=pt.IOConfig(sharded_checkpoints=True), _store=store)
        reset_counts(model)
        summary = runner.run()
        path = summary["checkpoint"]
        snap = store._snaps[path][0]
        events = [e["event"] for e in journal_of(runner)]
        if summary["outcome"] != "done" or summary["step"] != SHARD_STEPS \
                or not isinstance(snap, ck.ShardSnapshot):
            raise AssertionError(f"32: runner {summary}, {type(snap).__name__}")
        # staging: the sharded slabs against the gathered snapshot, same state
        torch.cuda.synchronize()
        sharded_ms, gathered_ms = [], []
        for _ in range(SHARD_STAGE_REPS):
            t1 = time.perf_counter()
            staged = ck.sharded_snapshot_to_host(model, step=SHARD_STEPS)
            sharded_ms.append((time.perf_counter() - t1) * 1e3)
            t1 = time.perf_counter()
            gathered = ck.snapshot_to_host(model, step=SHARD_STEPS)
            gathered_ms.append((time.perf_counter() - t1) * 1e3)
        want = global_leaves(model)
        arrays = {k: v.cpu().numpy() for k, v in want.items()}
        model.update_n(SHARD_STEPS)  # the unrestored run goes on
        cont = global_leaves(model)
        rows = {}
        for label, spec in SHARD_TARGETS:
            target = shard_target(pt, spec)
            models.append(target)
            # the reference: the same model from the state as the gathered
            # reader places it, then the steps
            pt.convert.state_from_numpy(target, arrays)
            target.time = summary["time"]
            target.update_n(SHARD_STEPS)
            ref = global_leaves(target)
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            ck.restore_sharded_snapshots(target, [snap], label=path)  # verifies the digest
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t1) * 1e3
            restored = same_leaves(torch, global_leaves(target), want) \
                and target.time == summary["time"]
            target.update_n(SHARD_STEPS)
            stepped = same_leaves(torch, global_leaves(target), ref)
            equals_writer = same_leaves(torch, global_leaves(target), cont)
            # again, the digest's graph now captured: the restore alone
            t1 = time.perf_counter()
            ck.restore_sharded_snapshots(target, [snap], label=path)
            torch.cuda.synchronize()
            again_ms = (time.perf_counter() - t1) * 1e3
            rows[label] = {"restore_ms": restore_ms, "restore_again_ms": again_ms,
                           "restored_bit_for_bit": restored, "stepped_bit_for_bit": stepped,
                           "equals_writer_run": equals_writer}
        files = None
        if h5py_version() is not None:
            fpath = ck.checkpoint_path(os.path.join(work, "files"), SHARD_STEPS)
            ck.write_sharded_snapshot(model, fpath, step=SHARD_STEPS)
            reader = shard_target(pt, dict(mesh=2))
            models.append(reader)
            reader.read(fpath)
            files = same_leaves(torch, global_leaves(reader), global_leaves(model))
        launches = {}
        for m in models:
            for name, n in count_launches(m).items():
                launches[name] = launches.get(name, 0) + n
    out = {"cell": "rbc1025", "route": "mesh", "ranks": MESH_RANKS, "steps": SHARD_STEPS,
           "outcome": summary["outcome"], "events": events, "shards": snap.shard_count,
           "staged_mb": staged.nbytes / 1e6, "gathered_mb": gathered.nbytes / 1e6,
           "sharded_stage_ms": sharded_ms, "gathered_stage_ms": gathered_ms,
           "sharded_stage_ms_median": statistics.median(sharded_ms),
           "gathered_stage_ms_median": statistics.median(gathered_ms),
           "h5py": h5py_version(), "files_bit_for_bit": files, "targets": rows,
           "launches": launches, "wall_s": time.perf_counter() - t0}
    print(f"phase32 sharded checkpoints ({card}) " + json.dumps(out))
    for label, row in rows.items():
        if not (row["restored_bit_for_bit"] and row["stepped_bit_for_bit"]):
            raise AssertionError(f"32 {label}: {row}")
    if not rows["mesh4"]["equals_writer_run"] or files is False:
        raise AssertionError(f"32: the mesh4 restore against the writer's run {rows['mesh4']}, "
                             f"files {files}")
    if "checkpoint" not in events or not launches.get("ring_transpose") \
            or not launches.get("banded_solve"):
        raise AssertionError(f"32: events {events}, launches {launches}")
    del models, model, target
    torch.cuda.empty_cache()
    return launches


# -- phase 33: two controllers on the one card -----------------------------------------

CONTROLLERS = 2
CTRL_STEPS = 200
CTRL_CHUNK = 25
CTRL_STOP_AT = 100
CTRL_CADENCE = 8
CTRL_SKIP = "skip_broadcast@5:host1"
CTRL_HANDSHAKES = 200
CTRL_PAIRS = 3
CTRL_SYNC_S = 60.0
CTRL_TIMEOUT_S = 420

CHILD_33 = r"""
import hashlib, json, os, sys, time
args = json.loads(sys.argv[1])
sys.path.insert(0, args["root"])
import numpy as np
import torch
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.ops import _build
from rustpde_mpi_tpu_torch.parallel import multihost as mh
from rustpde_mpi_tpu_torch.parallel import sanitizer as san
from rustpde_mpi_tpu_torch.utils import resilience

rank = args["rank"]
if args["device"] == "cuda":
    _build.build()
mh.initialize_distributed(f"localhost:{args['port']}", args["nproc"], rank,
                          timeout_s=args["sync_s"])
mh.set_sync_timeout(args["sync_s"])
cfg = args["cfg"]
dt = cfg["dt"]
model = pt.Navier2D(**cfg, device=args["device"])
model.write_intervall = 1e9
out = {"rank": rank}
sync = torch.cuda.synchronize if args["device"] == "cuda" else (lambda: None)

def fresh():
    model.state = type(model.state)(*(t.new_zeros(t.shape) for t in model.state))
    model.init_random(0.1, seed=0)
    model.reset_time()

def run(tag, stop_rank=None, armed=True, inject=""):
    fresh()
    san.configure(enabled=armed, cadence=args["cadence"], inject=inject)
    run_dir = os.path.join(args["work"], f"{tag}_{rank}")
    runner = pt.ResilientRunner(model, max_time=args["steps"] * dt,
                                save_intervall=args["chunk"] * dt, run_dir=run_dir,
                                checkpoint_every_s=None,
                                _store=resilience._MemoryStore(run_dir))
    hook = runner._dispatch

    def dispatch(pde, n):  # the request arrives while the chunk runs
        hook(pde, n)
        if rank == stop_rank and runner.step >= args["stop_at"]:
            runner.request_drain()

    runner._dispatch = dispatch
    sync()
    t0 = time.perf_counter()
    try:
        summary = runner.run()
    finally:
        sync()
    return summary, time.perf_counter() - t0, runner

def digest():
    h = hashlib.sha256()
    for t in model.state:
        h.update(t.cpu().numpy().tobytes())
    return h.hexdigest()

kernels = model.kernels()
for ks in kernels.values():
    for k in ks:
        k.launches = 0
s, _, r = run("stop0", stop_rank=0)
out["stop0"] = [s["outcome"], s["step"], r.step]
s, _, _ = run("stop1", stop_rank=1)
out["stop1"] = [s["outcome"], s["step"]]
digests = [d.decode() for d in mh.allgather_bytes(digest().encode())]
out["replicas_equal"] = len(set(digests)) == 1
walls = {"armed": [], "disarmed": []}
states = {}
for i in range(args["pairs"] + 1):
    for armed in ((True, False) if i % 2 else (False, True)):
        key = "armed" if armed else "disarmed"
        summary, wall, _ = run(f"price{i}_{key}", armed=armed)
        if i:
            walls[key].append(wall / args["steps"] * 1e3)
        states[key] = digest()
out["ms_per_step"] = walls
out["armed_equals_disarmed"] = states["armed"] == states["disarmed"]
san.configure(enabled=False, inject="")
for tag, flag in (("disarmed", False), ("armed", True), ("one_thread", False)):
    if tag == "one_thread":  # the host's own thread pool out of the way
        torch.set_num_threads(1)
    san.configure(enabled=flag)
    mh.sync_hosts("handshake")
    t0 = time.perf_counter()
    for _ in range(args["handshakes"]):
        mh.root_decides(False)
    out["root_decides_us_" + tag] = (time.perf_counter() - t0) / args["handshakes"] * 1e6
out["launches"] = {name: sum(k.launches for k in ks) for name, ks in kernels.items()}
try:
    run("desync", armed=True, inject=args["skip"])
    out["desync"] = None
except san.CollectiveDesyncError as exc:
    out["desync"] = {"seq": exc.seq, "site": exc.site, "executed": san.stats()["executed"],
                     "message": str(exc)[:300]}
print(json.dumps(out), flush=True)
os._exit(0)
"""


def phase33(torch, pt, card):
    """Phase 33: two controllers on the one card.  Two processes joined by
    gloo over localhost, each its own fused ``rbc129`` replica under the
    resilient runner (sharded two-phase checkpoints kept in the in-memory
    store), the sanitizer armed at cadence ``CTRL_CADENCE``: a stop asked
    on rank 0 alone stops both at the same step; one asked on rank 1 alone
    is ignored; the replicas stay bit for bit equal; ``CTRL_PAIRS`` pairs
    of 200-step runs armed and disarmed (the sanitizer's overhead; the
    states equal); one ``root_decides`` handshake in µs; ``CTRL_SKIP``
    raises ``CollectiveDesyncError`` on both processes within one cadence.
    Each child's exit code is checked; a wedge ends at the phase's own
    timeout with the children killed.  Returns the children's launches."""
    t0 = time.perf_counter()
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    with tempfile.TemporaryDirectory(prefix="phase33_") as work:
        procs = []
        for rank in range(CONTROLLERS):
            args = {"root": ROOT, "rank": rank, "nproc": CONTROLLERS, "port": port,
                    "cfg": ENSEMBLE129, "work": work, "steps": CTRL_STEPS, "chunk": CTRL_CHUNK,
                    "stop_at": CTRL_STOP_AT, "cadence": CTRL_CADENCE, "skip": CTRL_SKIP,
                    "handshakes": CTRL_HANDSHAKES, "pairs": CTRL_PAIRS, "sync_s": CTRL_SYNC_S,
                    "device": CARD}
            procs.append(subprocess.Popen([sys.executable, "-c", CHILD_33, json.dumps(args)],
                                          stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                                          text=True))
        outs = []
        t_end = time.monotonic() + CTRL_TIMEOUT_S
        try:
            for p in procs:
                try:
                    out, err = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
                except subprocess.TimeoutExpired:
                    p.kill()
                    out, err = p.communicate()
                outs.append((p.returncode, out, err))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
    results = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            raise AssertionError(f"33: controller {rank} rc={rc}:\n{out[-2000:]}\n{err[-3000:]}")
        results.append(json.loads(lines[-1]))
    r0, r1 = results
    overhead = [a / d - 1.0 for a, d in zip(r0["ms_per_step"]["armed"],
                                          r0["ms_per_step"]["disarmed"])]
    launches = {}
    for r in results:
        for name, n in r["launches"].items():
            launches[name] = launches.get(name, 0) + n
    print(f"phase33 root_decides handshake ({card}): "
          f"{r0['root_decides_us_disarmed']:.1f} us disarmed, "
          f"{r0['root_decides_us_armed']:.1f} us armed, {r0['root_decides_us_one_thread']:.1f} us "
          f"disarmed with one intra-op thread a process (rank 0, mean of {CTRL_HANDSHAKES})")
    print(f"phase33 armed sanitizer on {CTRL_STEPS} steps ({card}): ms/step armed "
          f"{r0['ms_per_step']['armed']} disarmed {r0['ms_per_step']['disarmed']}; "
          f"overheads {overhead}, median {statistics.median(overhead):.4f}")
    summary = {"controllers": CONTROLLERS, "cell": "rbc129", "route": "fused",
               "stop0": [r0["stop0"], r1["stop0"]], "stop1": [r0["stop1"], r1["stop1"]],
               "replicas_equal": [r0["replicas_equal"], r1["replicas_equal"]],
               "armed_equals_disarmed": [r0["armed_equals_disarmed"], r1["armed_equals_disarmed"]],
               "desync": [r0["desync"], r1["desync"]], "launches": launches,
               "wall_s": time.perf_counter() - t0}
    print(f"phase33 two controllers ({card}) " + json.dumps(summary))
    for r in results:
        if r["stop0"][:2] != ["preempted", CTRL_STOP_AT] or r["stop1"] != ["done", CTRL_STEPS]:
            raise AssertionError(f"33: stops {r['stop0']}, {r['stop1']}")
        if not (r["replicas_equal"] and r["armed_equals_disarmed"]):
            raise AssertionError(f"33: replicas {r['replicas_equal']}, armed/disarmed "
                                 f"{r['armed_equals_disarmed']}")
        if r["desync"] is None:
            raise AssertionError(f"33: {CTRL_SKIP} raised no desync on rank {r['rank']}")
    if r0["desync"]["seq"] != r1["desync"]["seq"] \
            or r0["desync"]["executed"] != r1["desync"]["executed"]:
        raise AssertionError(f"33: the desync differs between the ranks {r0['desync']}, "
                             f"{r1['desync']}")
    if not launches.get("fused_conv") or not launches.get("fused_stage"):
        raise AssertionError(f"33: launches {launches}")
    return launches


# -- serving (phases 34-36) -------------------------------------------------------

#: phase 34: the served ``rbc1025`` campaign (K lanes, chunk length, the
#: requests' steps at dt = 1e-4: completions stagger and, after the
#: ``nan@16`` fault, two lanes refill from the queue)
SERVE_SLOTS = 4
SERVE_CHUNK = 8
SERVE_STEPS = (24, 32, 40, 48, 28, 36)
SERVE_FAULT = "nan@16"
#: the JAX serving benchmark's isolation gate (``bench.py:1958``): a served
#: result's Nu against a solo run of the same seed, dt and steps
SERVE_NU_REL = 1e-8
#: the cold campaign of phase 34 (no warm pool): one request of this many steps
SERVE_COLD_STEPS = 8
#: phase 35: the JAX package's ``serve129`` soak (``bench.py:1840-1958``)
SOAK_REQUESTS = 64
SOAK_SLOTS = 8
SOAK_STEPS = 8
SOAK_JITTER = 6  # + (seed % 6) steps
SOAK_DRAIN_AT = max(8, min(3 * SOAK_STEPS, (SOAK_REQUESTS * SOAK_STEPS) // 16))
SOAK_SAMPLES = 3
SOAK_BARE_STEPS = 64
#: phase 36: the fleet on one card
FLEET_REQUESTS = 16
FLEET_SLOTS = 4
FLEET_CHUNK = 32
FLEET_STEPS = 3000  # steps a request (dt 2e-3 and, for the second tenant, 1e-3)
FLEET_TTL_S = 3.0
FLEET_TIMEOUT_S = 300
#: the gang's cell: 258^2, the nearest grid to 257^2 that splits over 2
#: ranks by the carve's divisibility rule (``parallel.submesh.grid_fits``:
#: n or n - 2 a multiple of the shape; 257 and 255 are odd)
GANG_CELL = dict(nx=258, ny=258, ra=1e7, pr=1.0, dt=1e-3, aspect=1.0, bc="rbc")
GANG_SHARD_MIN = 257
GANG_STEPS = 16
GANG_LIMIT = 1e-11


def serve_request(cell, seed, steps, dt=None, **kw):
    dt = cell["dt"] if dt is None else dt
    return dict(ra=cell["ra"], pr=cell["pr"], nx=cell["nx"], ny=cell["ny"], dt=dt,
                aspect=cell["aspect"], bc=cell["bc"], horizon=steps * dt, seed=seed, **kw)


def nan_rel_err(torch, a, b) -> tuple[float, float]:
    """``rel_err`` where a NaN on both sides counts as equal (a dead lane's
    NaN state runs through the kernels with the live ones) and a NaN on
    one side only fails."""
    both = torch.isnan(a) & torch.isnan(b)
    a = torch.where(both, torch.zeros_like(a), a)
    b = torch.where(both, torch.zeros_like(b), b)
    return rel_err(torch, a, b)


def logged_fused_inputs(torch, model, state) -> list:
    """``[(kernel, case, wrapper, args)]``: the inputs one eager step of
    ``state`` gives every fused stage and convection launch of ``model``
    (the first of each case), the launch counters put back after it."""
    log, seen, wrapped = [], set(), []
    for tag, st in (model._stages or {}).items():
        def apply(*args, _st=st, _tag=tag, _inner=st.apply):
            if ("fused_stage", _tag) not in seen:
                seen.add(("fused_stage", _tag))
                log.append(("fused_stage", _tag, _st, [a.clone() for a in args]))
            return _inner(*args)
        wrapped.append((st, apply))
    for i, fc in enumerate((model._convs or {}).values()):
        def conv(*args, _fc=fc, _i=i, _inner=fc.apply):
            case = f"conv{_i}_{len(args)}args"
            if ("fused_conv", case) not in seen:
                seen.add(("fused_conv", case))
                log.append(("fused_conv", case, _fc,
                            [a.clone() if torch.is_tensor(a) else a for a in args]))
            return _inner(*args)
        wrapped.append((fc, conv))
    before = [(k, k.launches) for ks in model.kernels().values() for k in ks]
    for obj, fn in wrapped:
        obj.apply = fn
    try:
        model._step(state)
    finally:
        for obj, _ in wrapped:
            del obj.apply
        torch.cuda.synchronize()
        for k, n in before:
            k.launches = n
    return log


def served_kernel_records(torch, log, lanes, label, phase) -> list:
    """Each logged fused launch against its plain version on the same
    inputs (phase 25's limit, 1e-12 of max|plain|; a NaN lane equal on both
    sides), launches put back after; ``lanes`` names each member's lane
    state (``refilled``, ``dead``, ``retried``, ...)."""
    records = []
    for kernel, case, wrapper, args in log:
        before = wrapper.launches
        out = wrapper.apply(*args)
        torch.cuda.synchronize()
        wrapper.launches = before
        plain = wrapper.plain(*args)
        diff, rel = nan_rel_err(torch, out, plain)
        rec = {"kernel": kernel, "case": case, "cell": label, "lanes": lanes,
               "max_abs_err": diff, "max_rel_err": rel}
        print(f"{phase} served inputs " + json.dumps(rec))
        if not rel <= 1e-12:
            raise AssertionError(f"{phase} {kernel}/{case} on served inputs: rel err {rel:.3e}")
        records.append(rec)
    return records


def count_replays():
    """Patch ``ChunkRunner.run`` to count each runner's replayed steps;
    returns ``(counts by id(runner), restore())``."""
    from rustpde_mpi_tpu_torch.models import campaign

    orig = campaign.ChunkRunner.run
    counts = {}

    def run(self, n, variant=0):
        counts[id(self)] = counts.get(id(self), 0) + int(n)
        return orig(self, n, variant)

    campaign.ChunkRunner.run = run

    def restore():
        campaign.ChunkRunner.run = orig

    return counts, restore


def runner_steps(ens, replays) -> tuple[int, int]:
    """``(warm-up steps, replayed steps)`` of the chunk runners ``ens``
    built (each runner warms each of its variants up with one eager step)."""
    runners = list(ens._runners.values())
    return (sum(len(r._advances) for r in runners),
            sum(replays.get(id(r), 0) for r in runners))


def served_launches(srv, replays, route, phase) -> tuple[dict, int]:
    """The launches of every campaign ``srv`` served, read right after its
    ``serve()``: each campaign's model must have launched exactly a solo
    step's kernels (``PER_STEP[route]``) for each replayed step and each
    warm-up step of its runners, and nothing else.  Returns the launches
    summed over the campaigns and the replayed steps."""
    launches, steps = {}, 0
    for k, model, ens in srv.campaigns:
        warm, n = runner_steps(ens, replays)
        steps += n
        got = count_launches(model)
        want = {name: v * (warm + n) for name, v in PER_STEP[route].items()}
        print(f"{phase} campaign dt={k[5]}: {n} replayed steps, {warm} warm-up, launches {got}")
        if got != want:
            raise AssertionError(f"{phase}: launches {got}, want {want} ({n} replays + "
                                 f"{warm} warm-up)")
        for name, v in got.items():
            launches[name] = launches.get(name, 0) + v
    return launches, steps


def instrumented_server(torch):
    """A ``SimServer`` subclass that records what the phase reads: each
    campaign's model and ensemble, the runner's time in ``advance`` a
    campaign, the final member state of every request as its lane is
    released, and (``log_at``) the served fused inputs at chosen refills."""
    from rustpde_mpi_tpu_torch.serve import SimServer

    class Served(SimServer):
        def __init__(self, *a, log_at=None, **kw):
            super().__init__(*a, **kw)
            self.campaigns = []  # (key, model, ens)
            self.warm_models = []
            self.advance_s = 0.0
            self.advances = 0
            self.loop_s = 0.0
            self.final_states = {}  # request id -> member state at release
            self.log_at = log_at
            self.logged = []
            self.parts = {}  # host seconds of the boundary's parts
            self.instrument_s = 0.0  # this class's own logging, left out of them

        def _timed(self, part, fn, *a):
            t0 = time.perf_counter()
            try:
                return fn(*a)
            finally:
                self.parts[part] = self.parts.get(part, 0.0) + time.perf_counter() - t0

        def _settle_boundary(self, *a):
            return self._timed("settle", super()._settle_boundary, *a)

        def _flush_results(self, *a, **kw):
            return self._timed("flush_results", lambda: super(Served, self)._flush_results(
                *a, **kw))

        def _boundary_gauges(self):
            return self._timed("gauges", super()._boundary_gauges)

        def _refresh_slot_state(self, *a):
            return self._timed("slot_state", super()._refresh_slot_state, *a)

        def _warm_build(self, key, k):
            out = super()._warm_build(key, k)
            self.warm_models.append((tuple(key), out[0], out[1]))
            return out

        def _build_runner(self, key, k=None):
            runner, ens = super()._build_runner(key, k)
            self.campaigns.append((tuple(key), ens.model, ens))
            inner = runner.advance
            server = self

            def advance(n):
                # synchronized, so that the chunk's device time is the
                # advance's and not the next host read's
                t0 = time.perf_counter()
                try:
                    return inner(n)
                finally:
                    torch.cuda.synchronize()
                    server.advance_s += time.perf_counter() - t0
                    server.advances += 1

            runner.advance = advance
            on_boundary = runner.on_boundary
            runner.on_boundary = lambda: self._timed("runner_on_boundary", on_boundary)
            return runner, ens

        def _campaign_loop(self, runner, ens, slots, key):
            t0 = time.perf_counter()
            try:
                return super()._campaign_loop(runner, ens, slots, key)
            finally:
                self.loop_s += time.perf_counter() - t0

        def _release(self, ens, slot):
            t0 = time.perf_counter()
            if slot.req is not None:
                self.final_states[slot.req.id] = ens.member_state(slot.index)
            self.instrument_s += time.perf_counter() - t0
            return super()._release(ens, slot)

        def _fill_slots(self, runner, ens, slots, key):
            self._timed("fill_slots", super()._fill_slots, runner, ens, slots, key)
            if self.log_at is not None:
                t0 = time.perf_counter()
                lanes = self.log_at(self, runner, ens, slots, key)
                if lanes:
                    self.logged.append((tuple(key), lanes,
                                        logged_fused_inputs(torch, ens.model, ens.state)))
                self.instrument_s += time.perf_counter() - t0

        def host_row(self) -> dict:
            """The scheduler's host time outside ``runner.advance`` over the
            campaigns' boundaries (this class's logging left out), and its
            parts (settle: completions and deaths; fill_slots: refills with
            their fresh initial conditions; runner_on_boundary: the cadence
            checkpoint and drain check; the rest: queue, journal, gauges)."""
            host = self.loop_s - self.advance_s - self.instrument_s
            n = max(1, self.advances)
            return {"boundaries": self.advances, "advance_s": self.advance_s,
                    "campaign_loop_s": self.loop_s - self.instrument_s,
                    "scheduler_host_ms_a_boundary": host / n * 1e3,
                    "scheduler_host_share": host / (self.loop_s - self.instrument_s)
                    if self.loop_s else None,
                    "parts_ms_a_boundary": {k: v / n * 1e3 for k, v in self.parts.items()}}

    return Served


def journal_rows(run_dir, replica=None) -> list:
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    path = os.path.join(run_dir, "journal.jsonl") if replica is None else \
        os.path.join(run_dir, "replicas", replica, "journal.jsonl")
    return [e for e in read_journal(path, on_error="skip") if e["event"] not in CLOCKED_EVENTS]


def solo_final(torch, model, res):
    """``model`` (the request's cell) run solo from the request's initial
    condition for its steps at its dt: its final state and Nu."""
    model.set_stability(None)
    model.set_dt(res["dt"])
    model.state = type(model.state)(*(t.new_zeros(t.shape) for t in model.state))
    model.init_random(res["amp"] or 0.1, seed=res["seed"])
    model.reset_time()
    model.update_n(res["steps"])
    return model.state, float(model.eval_nu())


def phase34(torch, pt, card):
    """Phase 34: a served campaign at full width.  ``SimServer`` on the
    fused route, f64, ``rbc1025`` (1025^2, Ra=1e9, Pr=1, dt=1e-4), K =
    ``SERVE_SLOTS`` lanes, chunks of ``SERVE_CHUNK``, six requests (seeds
    0-5, ``SERVE_STEPS`` steps), ``SERVE_FAULT``: every in-flight request
    retries at dt = 5e-5 and two lanes are refilled from the queue.  The
    warm profile names both buckets, so each campaign comes from the warm
    pool, the dt/2 one captured on the pool's thread while the first bucket
    served.  Gates: every request done, none failed; each Nu within
    ``SERVE_NU_REL`` of a solo ``Navier2D`` run on the card; every replayed
    step of a served chunk launched exactly a solo step's kernels; the
    served fused inputs (a refilled and a dead lane; the retried requests
    at dt/2) against the plain versions.  Prints the time from admission
    to first chunk, cold and warm, served member-steps/s beside the same
    ensemble's bare ``update_n``, and the scheduler's host share a
    boundary.  Returns the served launches."""
    from rustpde_mpi_tpu_torch.config import ServeConfig

    t_phase = time.perf_counter()
    cell = RBC1025
    retry_dt = cell["dt"] * 0.5
    key = pt.SimRequest(**serve_request(cell, 0, 8)).compat_key
    key2 = pt.SimRequest(**serve_request(cell, 0, 8, dt=retry_dt)).compat_key
    Served = instrumented_server(torch)

    def log_at(srv, runner, ens, slots, k):
        alive = ens.alive()
        done = {e[0] for e in srv.logged}
        if tuple(k) in done:
            return None
        if k == key and runner.step > 0 and alive.any() and not alive.all():
            return ["refilled" if a else "dead" for a in alive]
        if k == key2 and alive.all():
            return ["retried"] * len(alive)
        return None

    with tempfile.TemporaryDirectory(prefix="phase34_") as work:
        cfg = ServeConfig(run_dir=os.path.join(work, "serve"), slots=SERVE_SLOTS,
                          chunk_steps=SERVE_CHUNK, checkpoint_every_s=None, http_port=0,
                          warm_profile=[{"key": list(key), "k": SERVE_SLOTS},
                                        {"key": list(key2), "k": SERVE_SLOTS}])
        replays, restore = count_replays()
        try:
            srv = Served(cfg, device=CARD, fault=SERVE_FAULT, log_at=log_at)
            ids = [srv.submit(serve_request(cell, seed, steps)).id
                   for seed, steps in enumerate(SERVE_STEPS)]
            t0 = time.perf_counter()
            summary = srv.serve()
            torch.cuda.synchronize()
            serve_wall = time.perf_counter() - t0
        finally:
            restore()
        rows = journal_rows(cfg.run_dir)
        events = [e["event"] for e in rows]
        print(f"phase34 journal ({card}): " + json.dumps(events))
        if summary["completed"] != len(SERVE_STEPS) or summary["failed"]:
            raise AssertionError(f"34: summary {summary}")
        results = [srv.result(i) for i in ids]
        retried = [r for r in results if r["retries"]]
        if len(retried) != SERVE_SLOTS or any(abs(r["dt"] - retry_dt) > 1e-18 for r in retried):
            raise AssertionError(f"34: retried {[(r['seed'], r['dt']) for r in retried]}")
        hits = [e for e in rows if e["event"] == "warm_pool_hit"]
        builds = [i for i, e in enumerate(rows) if e["event"] == "aot_build"]
        starts = [i for i, e in enumerate(rows) if e["event"] == "campaign_start"]
        if len(hits) != 2 or len(builds) != 2 or not starts or builds[1] < starts[0]:
            raise AssertionError(f"34: warm pool rows: hits {len(hits)}, builds at {builds}, "
                                 f"campaigns at {starts}")
        launches, steps = served_launches(srv, replays, "fused", "phase34")
        # the served fused inputs against the plain versions
        if {k for k, _, _ in srv.logged} != {key, key2}:
            raise AssertionError(f"34: logged inputs of {[k[5] for k, _, _ in srv.logged]}")
        for k, lanes, log in srv.logged:
            checked = served_kernel_records(torch, log, lanes, f"rbc1025 dt={k[5]}", "phase34")
            if {r["kernel"] for r in checked} != {"fused_conv", "fused_stage"}:
                raise AssertionError(f"34: logged kernels {checked}")
        # each request's Nu against a solo run on the card
        solo = srv.campaigns[0][1]
        rels = []
        for r in results:
            _, nu = solo_final(torch, solo, r)
            rels.append(abs(r["nu"] - nu) / abs(nu))
        print(f"phase34 Nu served vs solo, rel ({card}): {rels}")
        if max(rels) > SERVE_NU_REL:
            raise AssertionError(f"34: served Nu off its solo run by {max(rels):.3e}")
        warm_ttfc = [e["wall_s"] for e in rows if e["event"] == "first_chunk"]
        admitted = [e["wall_s"] for e in rows if e["event"] == "request_admitted"]
        first = next(e["wall_s"] for e in rows if e["event"] == "first_chunk")
        # the same ensemble's bare update_n (the served model, K lanes, dt)
        model = srv.campaigns[0][1]
        model.set_dt(cell["dt"])
        ens = pt.NavierEnsemble.from_seeds(model, range(SERVE_SLOTS))
        ens.chunk_runner()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        ens.update_n(sum(SERVE_STEPS) // len(SERVE_STEPS))
        torch.cuda.synchronize()
        bare = SERVE_SLOTS * (sum(SERVE_STEPS) // len(SERVE_STEPS)) / (time.perf_counter() - t0)
        del ens
        # a cold campaign: no warm pool, one request
        cold_cfg = ServeConfig(run_dir=os.path.join(work, "cold"), slots=SERVE_SLOTS,
                               chunk_steps=SERVE_CHUNK, checkpoint_every_s=None)
        cold = pt.SimServer(cold_cfg, device=CARD)
        cold.submit(serve_request(cell, 0, SERVE_COLD_STEPS))
        cold_summary = cold.serve()
        cold_rows = journal_rows(cold_cfg.run_dir)
        if cold_summary["completed"] != 1:
            raise AssertionError(f"34: cold summary {cold_summary}")
        cold_ttfc = next(e["wall_s"] for e in cold_rows if e["event"] == "first_chunk")
        cold_first = next(e["wall_s"] for e in cold_rows if e["event"] == "first_chunk") - \
            next(e["wall_s"] for e in cold_rows if e["event"] == "server_start")
    row = {"cell": "rbc1025", "route": "fused", "K": SERVE_SLOTS, "chunk_steps": SERVE_CHUNK,
           "requests": len(SERVE_STEPS), "retried": len(retried), "serve_wall_s": serve_wall,
           "member_steps": summary["member_steps"],
           "served_member_steps_per_s": summary["member_steps"] / serve_wall,
           "served_member_steps_per_s_in_campaigns":
           summary["member_steps"] / (srv.loop_s - srv.instrument_s),
           "warm_builds_s": [e["wall_s"] for e in rows if e["event"] == "aot_build"],
           "bare_update_n_member_steps_per_s": bare,
           "campaign_first_chunk_s_warm": warm_ttfc,
           "admission_to_first_chunk_s_warm": first - min(admitted),
           "campaign_first_chunk_s_cold": cold_ttfc,
           "server_start_to_first_chunk_s_cold": cold_first,
           **srv.host_row(), "replayed_steps": steps, "launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    print(f"phase34 served rbc1025 ({card}) " + json.dumps(row))
    if not launches.get("fused_conv") or not launches.get("fused_stage"):
        raise AssertionError(f"34: launches {launches}")
    print("phase34 ok")
    return launches


def soak_request(seed):
    steps = SOAK_STEPS + seed % SOAK_JITTER
    return serve_request(ENSEMBLE129, seed, steps)


def phase35(torch, pt, card):
    """Phase 35: the serving soak shape (the JAX package's ``serve129``):
    129^2, Ra=1e7, dt=2e-3, ``SOAK_STEPS`` steps a request plus a jitter of
    0-5, ``SOAK_SLOTS`` lanes, ``SOAK_REQUESTS`` requests, two incarnations
    on one run directory: the first drained mid-soak by
    ``kill@SOAK_DRAIN_AT`` (a real SIGTERM: the graceful drain), the second
    restoring the drained lanes mid-trajectory, taking ``nan@`` twice that
    step and draining the queue.  Gates: every request resolved once, none
    lost or failed; the drain, restore and retry rows in the journal;
    ``SOAK_SAMPLES`` results within ``SERVE_NU_REL`` of solo runs; a drained
    and restored request's final state bit for bit its solo run's.  Prints
    member-steps/s over the serve wall and the latency percentiles beside
    a bare ``ensemble129`` K = 8 ``update_n``.  Returns the launches."""
    from rustpde_mpi_tpu_torch.config import ServeConfig

    t_phase = time.perf_counter()
    Served = instrumented_server(torch)
    launches, replayed = {}, 0
    with tempfile.TemporaryDirectory(prefix="phase35_") as work:
        cfg = ServeConfig(run_dir=os.path.join(work, "serve"), slots=SOAK_SLOTS,
                          max_queue=2 * SOAK_REQUESTS, checkpoint_every_s=10.0)
        first = Served(cfg, device=CARD, fault=f"kill@{SOAK_DRAIN_AT}")
        ids = [first.submit(soak_request(seed)).id for seed in range(SOAK_REQUESTS)]
        second = Served(cfg, device=CARD, fault=f"nan@{2 * SOAK_DRAIN_AT}")
        walls = []
        for srv in (first, second):
            # each incarnation's campaigns are its own models, counted from
            # 0; their launches are read before any solo or bare run
            replays, restore = count_replays()
            try:
                t0 = time.perf_counter()
                srv.summary = srv.serve()
                torch.cuda.synchronize()
                walls.append(time.perf_counter() - t0)
            finally:
                restore()
            got, n = served_launches(srv, replays, "fused", "phase35")
            replayed += n
            for name, v in got.items():
                launches[name] = launches.get(name, 0) + v
        (s1, s2), (wall1, wall2) = (first.summary, second.summary), walls
        rows = journal_rows(cfg.run_dir)
        counts = second.queue.counts()
        results = {i: second.result(i) for i in ids}
    events = [e["event"] for e in rows]
    restored = {e["id"] for e in rows if e["event"] == "request_scheduled" and e.get("restored")}
    summary = {"incarnations": [s1["outcome"], s2["outcome"]], "queue": counts,
               "completed": [s1["completed"], s2["completed"]], "retried": s2["retried"],
               "drains": events.count("drain"), "restored": len(restored),
               "retries": events.count("request_retry")}
    print(f"phase35 soak ({card}) " + json.dumps(summary))
    if s1["outcome"] != "drained" or s2["outcome"] != "idle":
        raise AssertionError(f"35: outcomes {s1['outcome']}, {s2['outcome']}")
    if counts != {"queued": 0, "running": 0, "done": SOAK_REQUESTS, "failed": 0}:
        raise AssertionError(f"35: queue {counts}")
    done_rows = [e["id"] for e in rows if e["event"] == "request_done"]
    if sorted(done_rows) != sorted(ids):
        raise AssertionError("35: a request resolved other than once")
    if not (events.count("drain") and restored and "request_retry" in events):
        raise AssertionError(f"35: drain/restore/retry rows missing: {summary}")
    model = second.campaigns[0][1] if second.campaigns else first.campaigns[0][1]
    picks = sorted(results)[:: max(1, SOAK_REQUESTS // SOAK_SAMPLES)][:SOAK_SAMPLES]
    rels = []
    for rid in picks:
        _, nu = solo_final(torch, model, results[rid])
        rels.append(abs(results[rid]["nu"] - nu) / abs(nu))
    bit_id = next(i for i in ids if i in restored and results[i]["retries"] == 0)
    state, _ = solo_final(torch, model, results[bit_id])
    bitwise = all(torch.equal(a, b) for a, b in zip(second.final_states[bit_id], state))
    print(f"phase35 sampled Nu vs solo rel {rels}; drained and restored request "
          f"{bit_id} bit for bit its solo run: {bitwise}")
    if max(rels) > SERVE_NU_REL or not bitwise:
        raise AssertionError(f"35: isolation {rels}, restored bit for bit {bitwise}")
    lat = sorted(r["latency_s"] for r in results.values())
    member_steps = s1["member_steps"] + s2["member_steps"]
    # the bare ensemble129 K = SOAK_SLOTS update_n beside it
    model.set_dt(ENSEMBLE129["dt"])
    ens = pt.NavierEnsemble.from_seeds(model, range(SOAK_SLOTS))
    ens.chunk_runner()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens.update_n(SOAK_BARE_STEPS)
    torch.cuda.synchronize()
    bare = SOAK_SLOTS * SOAK_BARE_STEPS / (time.perf_counter() - t0)
    row = {"cell": "serve129", "route": "fused", "requests": SOAK_REQUESTS,
           "serve_wall_s": wall1 + wall2, "member_steps": member_steps,
           "member_steps_per_s": member_steps / (wall1 + wall2),
           "bare_ensemble129_K8_member_steps_per_s": bare,
           "latency_p50_s": lat[len(lat) // 2], "latency_p90_s": lat[int(0.9 * (len(lat) - 1))],
           "latency_p99_s": lat[int(0.99 * (len(lat) - 1))],
           "first_incarnation": first.host_row(), "second_incarnation": second.host_row(),
           "replayed_steps": replayed, "launches": launches,
           "wall_s": time.perf_counter() - t_phase}
    print(f"phase35 serve129 ({card}) " + json.dumps(row))
    if not launches.get("fused_conv") or not launches.get("fused_stage"):
        raise AssertionError(f"35: launches {launches}")
    print("phase35 ok")
    return launches


def http_json(url, payload=None, timeout=30):
    """``(status, body)`` of one GET (``payload`` None) or JSON POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, method="GET" if data is None else "POST",
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=timeout) as resp:
            return resp.status, json.loads(resp.read())
    except urllib.error.HTTPError as err:
        return err.code, json.loads(err.read())


def phase36_gang(torch, pt, work, card):
    """Phase 36's gang: one stamped ``GANG_CELL`` bucket served as a gang on
    a 2-rank sub-mesh of the card (``SubmeshConfig(shapes=(2,),
    shard_min_nx=257)``, a fleet lease group), the meshed dense route: the
    flips and banded solves one served step gives the kernels against
    their plain versions, their launches counted, and the result's final
    state against a solo ``make_mesh(2)`` run (``GANG_LIMIT`` of each
    field's scale).  Returns the gang's launches."""
    import numpy as np

    from rustpde_mpi_tpu_torch.config import FleetConfig, ServeConfig, SubmeshConfig

    Served = instrumented_server(torch)
    gang_logs = []

    def log_at(srv, runner, ens, slots, key):
        if not gang_logs and ens.alive().any():
            gang_logs.append(logged_step_inputs(torch, ens))
        return None

    cfg = ServeConfig(run_dir=os.path.join(work, "gang"), slots=2, chunk_steps=8,
                      checkpoint_every_s=None,
                      submesh=SubmeshConfig(shapes=(2,), shard_min_nx=GANG_SHARD_MIN),
                      fleet=FleetConfig(replica_id="gang0", lease_ttl_s=60.0))
    srv = Served(cfg, device=CARD, log_at=log_at)
    rid = srv.submit(serve_request(GANG_CELL, 3, GANG_STEPS)).id
    replays, restore = count_replays()
    try:
        summary = srv.serve()
    finally:
        restore()
    rows = journal_rows(cfg.run_dir, "gang0")
    events = [e["event"] for e in rows]
    if summary["completed"] != 1 or "gang_formed" not in events:
        raise AssertionError(f"36 gang: {summary}, events {events}")
    (_, model, ens), = srv.campaigns
    if model.mesh is None or model.mesh.nranks != 2:
        raise AssertionError(f"36 gang: campaign model on {model.mesh}")
    # the launches of the served campaign, read before the solo run: the
    # banded solves are a step's only, 7 each; a step flips 37 times, and
    # the eager observables reads and lane fills flip besides
    launches = count_launches(model)
    warm, served = runner_steps(ens, replays)
    per_step = PER_STEP["mesh"]
    step_flips = per_step["ring_transpose"] * (warm + served)
    if launches["banded_solve"] != per_step["banded_solve"] * (warm + served) \
            or launches["ring_transpose"] < step_flips:
        raise AssertionError(f"36 gang: launches {launches} for {served} replayed and {warm} "
                             f"warm-up steps")
    res = srv.result(rid)
    solo = pt.Navier2D(**GANG_CELL, mesh=pt.make_mesh(2, CARD))
    state, nu = solo_final(torch, solo, res)
    diffs = field_rel_diffs(torch, srv.final_states[rid], state)
    # the flips and the banded solves one served step gave the kernels
    (log,) = gang_logs
    checked = {"ring_transpose": 0, "banded_solve": 0}
    solvers = banded_solvers(model)
    pres = model.solver_pres._solver
    singular = np.flatnonzero(np.abs(pres.lam + pres.alpha) < 1e-8)
    for key, (count, given) in sorted(log.items(), key=str):
        if key[0] == "flip":
            _, shape, x_to_y, dtype = key
            ring = model.mesh.ring
            before = ring.launches
            out = ring.apply(given, x_to_y)
            torch.cuda.synchronize()
            ring.launches = before
            exact = torch.equal(out, ring.plain(given, x_to_y))
            if not exact:
                raise AssertionError(f"36 gang: flip {shape} differs from its plain version")
            checked["ring_transpose"] += 1
            continue
        _, label, shape, axis, stride, period = key
        solver = solvers[label]
        before = solver.kernel.launches
        out = solver.solve(given, axis, stride, period)
        torch.cuda.synchronize()
        solver.kernel.launches = before
        plain = solver.plain(given, axis, stride, period)
        # phase 12's rule on a step's own input: STEP_INPUT_LIMIT of the
        # solve's scale, the Poisson solve's nudged singular lane held apart
        err = torch.abs(out - plain)
        apart = torch.zeros(err.shape[:-1] + (1,), dtype=torch.bool, device=err.device)
        if label == "poisson":  # lanes: global lane i is rank i // stride's lane i % stride
            for i in singular:
                apart[..., i // stride, i % stride, :] = True
        kept = torch.where(apart, torch.zeros_like(plain), plain)
        rel = float(torch.max(torch.where(apart, torch.zeros_like(err), err))) / \
            float(torch.max(torch.abs(kept)))
        rel_apart = float(torch.max(torch.where(apart, err, torch.zeros_like(err)))) / \
            float(torch.max(torch.abs(plain)))
        rec = {"kernel": "banded_solve", "case": label, "shape": list(shape), "cell": "gang258",
               "axis": axis, "max_abs_err": float(torch.max(err)), "step_input_max_rel_err": rel,
               "step_input_singular_rel_err": rel_apart}
        print("phase36 served inputs " + json.dumps(rec))
        if not rel <= STEP_INPUT_LIMIT:
            raise AssertionError(f"36 gang: banded {label} rel err {rel:.3e}")
        checked["banded_solve"] += 1
    row = {"cell": "gang258", "mesh": 2, "route": "dense", "summary_completed":
           summary["completed"], "nu": res["nu"], "solo_nu": nu,
           "state_vs_solo_rel": diffs, "inputs_checked": checked, "launches": launches,
           "replayed_steps": served, "warm_up_steps": warm,
           "flips_outside_steps": launches["ring_transpose"] - step_flips}
    print(f"phase36 gang ({card}) " + json.dumps(row))
    if max(diffs.values()) > GANG_LIMIT:
        raise AssertionError(f"36 gang: state off the solo make_mesh(2) run: {diffs}")
    if not launches.get("ring_transpose") or not launches.get("banded_solve") \
            or not all(checked.values()):
        raise AssertionError(f"36 gang: launches {launches}, inputs checked {checked}")
    return launches


def phase36_drain(pt, work, card):
    """Phase 36's drain: one replica started by ``LocalProcessLauncher`` is
    retired (SIGTERM) mid-campaign.  It checkpoints its slot table and
    lanes through the runner's default store (``.npz`` files where ``h5py``
    does not import), requeues its requests and exits 0; started again
    under its id, it restores the drained lanes mid-trajectory and finishes
    them.  Gates: exit codes 0, the drain's checkpoint on disk, the
    restored lanes in the journal, every request done exactly once."""
    from rustpde_mpi_tpu_torch.serve.fleet import LocalProcessLauncher

    run_dir = os.path.join(work, "drain")
    queue = pt.serve.DurableQueue(os.path.join(run_dir, "queue"))
    ids = [queue.submit(pt.SimRequest(**serve_request(ENSEMBLE129, 100 + i, FLEET_STEPS))).id
           for i in range(FLEET_SLOTS)]
    launcher = LocalProcessLauncher(
        run_dir, device=CARD, env=dict(os.environ, PYTHONPATH=ROOT),
        log_dir=os.path.join(work, "logs"),
        serve_args=["--slots", str(FLEET_SLOTS), "--chunk-steps", str(FLEET_CHUNK),
                    "--lease-ttl-s", "60"])
    journal = os.path.join(run_dir, "replicas", "d0", "journal.jsonl")
    deadline = time.monotonic() + FLEET_TIMEOUT_S
    codes, files = [], []
    try:
        handle = launcher.spawn("d0")
        while time.monotonic() < deadline and launcher.alive(handle):
            if os.path.exists(journal) and '"first_chunk"' in open(journal).read():
                break
            time.sleep(0.02)
        launcher.retire(handle)
        codes.append(handle.proc.wait(timeout=max(1.0, deadline - time.monotonic())))
        files = sorted(f for _, _, fs in os.walk(os.path.join(run_dir, "replicas"))
                       for f in fs if f.startswith("ckpt_"))
        handle = launcher.spawn("d0")
        while time.monotonic() < deadline and launcher.alive(handle):
            queue.invalidate()
            if queue.counts()["done"] == len(ids):
                break
            time.sleep(0.2)
        launcher.retire(handle)
        codes.append(handle.proc.wait(timeout=max(1.0, deadline - time.monotonic())))
    finally:
        launcher.shutdown(timeout_s=10.0)
    rows = journal_rows(run_dir, "d0")
    events = [e["event"] for e in rows]
    requeued = {e["id"] for e in rows if e["event"] == "request_requeued" and e["checkpoint"]}
    restored = {e["id"] for e in rows if e["event"] == "request_scheduled" and e.get("restored")}
    done = [e["id"] for e in rows if e["event"] == "request_done"]
    summary = {"exit_codes": codes, "checkpoint_files": files, "drains": events.count("drain"),
               "requeued_with_checkpoint": len(requeued), "restored": len(restored),
               "done": len(done), "queue": queue.counts()}
    print(f"phase36 drain ({card}) " + json.dumps(summary))
    if codes != [0, 0] or not files or events.count("drain") != 2:
        log = os.path.join(work, "logs", "d0.log")
        if os.path.exists(log):
            print("phase36 d0 log tail:\n" + open(log).read()[-3000:])
        raise AssertionError(f"36 drain: {summary}")
    if not requeued or restored != requeued or sorted(done) != sorted(ids):
        raise AssertionError(f"36 drain: requests not restored or not done once: {summary}")


def phase36(torch, pt, card):
    """Phase 36: the fleet on one card.  A ``FleetProxy`` in this process;
    two replicas spawned by ``LocalProcessLauncher`` (``python -m
    rustpde_mpi_tpu_torch.serve.fleet.replica_main --device cuda``,
    ``FLEET_SLOTS`` lanes, 129^2, ``lease_ttl_s`` ``FLEET_TTL_S``);
    ``FLEET_REQUESTS`` requests POSTed through the proxy by two tenants (two
    buckets: dt 2e-3 and 1e-3; one interactive request with a deadline).
    The replica holding a lease is SIGKILLed right after it persisted its
    running lanes' continuations; a survivor breaks its lease after the TTL
    and resumes its requests from the parked continuations; an
    ``Autoscaler(min_replicas=2, max_replicas=2)`` repairs the capacity with
    one spawn.  Gates: every request done exactly once, none failed, the
    lease break and the continuation resumes in the journals, one spawn;
    each child has a deadline (``FLEET_TIMEOUT_S``) and its exit code is
    checked.  Then the gang (:func:`phase36_gang`).  Returns the gang's
    launches (the replicas' are in their own processes)."""
    from rustpde_mpi_tpu_torch.config import AutoscaleConfig, FleetConfig
    from rustpde_mpi_tpu_torch.serve.fleet import Autoscaler, FleetProxy, LocalProcessLauncher

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="phase36_") as work:
        run_dir = os.path.join(work, "fleet")
        fleet = FleetConfig(lease_ttl_s=FLEET_TTL_S)
        proxy = FleetProxy(run_dir, fleet=fleet)
        proxy.start()
        env = dict(os.environ, PYTHONPATH=ROOT)
        launcher = LocalProcessLauncher(
            run_dir, device=CARD, env=env, log_dir=os.path.join(work, "logs"),
            serve_args=["--slots", str(FLEET_SLOTS), "--chunk-steps", str(FLEET_CHUNK),
                        "--lease-ttl-s", str(FLEET_TTL_S)])
        scaler = Autoscaler(run_dir, launcher,
                            AutoscaleConfig(min_replicas=2, max_replicas=2, decide_s=0.5,
                                            spawn_grace_s=60.0),
                            fleet=fleet, controller_id="smoke-autoscaler")
        handles = {}
        deadline = time.monotonic() + FLEET_TIMEOUT_S
        try:
            for rid in ("r0", "r1"):
                handles[rid] = launcher.spawn(rid)
            host, port = proxy.address
            base = f"http://{host}:{port}"
            ids = []
            t_submit = time.perf_counter()
            for i in range(FLEET_REQUESTS):
                tenant = "a" if i % 2 == 0 else "b"
                dt = ENSEMBLE129["dt"] if tenant == "a" else ENSEMBLE129["dt"] / 2
                extra = dict(tenant=tenant)
                if i == 1:
                    extra.update(priority="interactive", deadline_s=float(FLEET_TIMEOUT_S))
                code, ack = http_json(base + "/requests",
                                      serve_request(ENSEMBLE129, i, FLEET_STEPS, dt=dt, **extra))
                if code != 202:
                    raise AssertionError(f"36: POST {code} {ack}")
                ids.append(ack["id"])
            scaler.start()
            # the victim: the first replica seen persisting continuations
            victim = None
            while victim is None and time.monotonic() < deadline:
                for rid in handles:
                    path = os.path.join(run_dir, "replicas", rid, "journal.jsonl")
                    try:
                        with open(path) as fh:
                            if '"continuation_persisted"' in fh.read():
                                victim = rid
                                break
                    except OSError:
                        pass
                time.sleep(0.02)
            if victim is None:
                raise AssertionError("36: no replica persisted a continuation")
            launcher.kill(handles[victim])
            t_kill = time.perf_counter()
            states = {}
            while time.monotonic() < deadline:
                states = {i: http_json(f"{base}/requests/{i}")[1].get("state") for i in ids}
                if all(s in ("done", "failed") for s in states.values()):
                    break
                time.sleep(0.5)
            t_done = time.perf_counter()
            code, stats = http_json(base + "/stats")
        finally:
            scaler.stop()
            launcher.shutdown(timeout_s=max(10.0, deadline - time.monotonic()))
            proxy.stop()
        codes = {h.replica_id: h.proc.returncode for h in handles.values()}
        scaled = scaler.stats()
        replicas = sorted(os.listdir(os.path.join(run_dir, "replicas")))
        rows = {}
        for rid in replicas:
            if os.path.isdir(os.path.join(run_dir, "replicas", rid)):
                rows[rid] = journal_rows(run_dir, rid)
        done = {}
        for rid, rs in rows.items():
            for e in rs:
                if e["event"] == "request_done":
                    done[e["id"]] = done.get(e["id"], 0) + 1
        reclaimed = [e for rs in rows.values() for e in rs if e["event"] == "requests_reclaimed"]
        # the victim's requests: those a survivor reclaimed from the victim's
        # broken lease and that the victim had parked before it died
        persisted = {e["id"] for e in rows.get(victim, [])
                     if e["event"] == "continuation_persisted"}
        from_victim = {i for e in reclaimed if e.get("owner") == victim for i in e["ids"]}
        resumed = {e["id"] for rid, rs in rows.items() if rid != victim for e in rs
                   if e["event"] == "continuation_resumed"}
        parked = persisted & from_victim
        summary = {"victim": victim, "states": sorted(set(states.values())),
                   "queue": stats.get("queue"), "exit_codes": codes, "autoscaler": scaled,
                   "reclaimed_from_victim": len(from_victim),
                   "victim_parked_and_resumed": [len(parked), len(parked & resumed)],
                   # a live replica's lease broken by a peer (its heartbeat
                   # late past the TTL): its requests reclaimed and finished
                   # elsewhere, counted apart from the victim's
                   "live_lease_reclaims": [(e.get("owner"), len(e["ids"])) for e in reclaimed
                                           if e.get("owner") != victim],
                   "continuations_resumed": len(resumed), "done_rows_max": max(done.values()),
                   "kill_to_all_done_s": t_done - t_kill, "submit_to_all_done_s":
                   t_done - t_submit}
        print(f"phase36 fleet ({card}) " + json.dumps(summary))
        if set(states.values()) != {"done"} or stats["queue"]["done"] != FLEET_REQUESTS:
            raise AssertionError(f"36: not every request done: {summary}")
        if max(done.values()) > 1:
            raise AssertionError(f"36: a request done twice: {done}")
        if not parked or not parked <= resumed or scaled["spawned"] != 1:
            raise AssertionError(f"36: the victim's lease break, its requests' resumes or the "
                                 f"repair spawn missing: {summary}")
        if codes[victim] != -9 or any(c != 0 for r, c in codes.items() if r != victim):
            for rid in handles:
                log = os.path.join(work, "logs", f"{rid}.log")
                if os.path.exists(log):
                    print(f"phase36 {rid} log tail:\n" + open(log).read()[-3000:])
            raise AssertionError(f"36: exit codes {codes}")
        phase36_drain(pt, work, card)
        launches = phase36_gang(torch, pt, work, card)
    print(f"phase36 wall {time.perf_counter() - t_phase:.1f} s")
    print("phase36 ok")
    return launches



# -- a mesh whose ranks span processes (phase 37) ------------------------------------

#: phase 37: the layouts of the 4 ranks on the one card (processes x ranks);
#: with two cards or more a third layout puts one process on each card
SPAN_LAYOUTS = (("2x2", 2), ("4x1", 4))
#: steps of bare ``update_n`` of each cell on a spanning mesh
SPAN_STEPS = {"rbc1025": MAIN_STEPS, "periodic1024": 10}
SPAN_CELLS = {"rbc1025": RBC1025, "periodic1024": PERIODIC1024}
#: the spanning state against the one-process ``make_mesh(4)`` run's, of
#: each field's scale, for a layout whose processes hold several ranks
#: each (2 x 2: a batched product there is the one-process mesh's, and
#: the run is bit for bit) and for every layout at 129^2.  A process of
#: one rank runs its products as lone cuBLAS GEMMs where the one-process
#: mesh batches four ranks, and at 1025^2 the two round apart (ROADMAP
#: Queue 3 item 4; the CPU run of the same layout is bit for bit), which
#: the Chebyshev operators amplify (9.2e-10 of temp after one step, 4 x 1
#: ``rbc1025``).  So only there each field is held, as phase 25 holds an
#: ensemble member to its solo run, to the larger of this limit and
#: ``ULP_STEPS_FACTOR`` (or the run's steps, if more) times the
#: one-process run's own sensitivity: its state from a start moved by one
#: ulp, after as many steps
SPAN_LIMIT = 1e-12
#: steps of the 129^2 spanning state against the one-process run (the
#: ``ensemble129`` cell)
SPAN_SMALL_STEPS = 10
#: timed calls of each remote flip, cold and warm (every process times
#: the same calls: they pair up across processes), and the windows of the
#: warm time, each ``SPAN_REPS`` calls of one graph
SPAN_REPS = 20
SPAN_WINDOWS = 3
#: a spawn's deadline (seconds) and its collectives' (every child: the
#: build of its models, the checks, the runs)
SPAN_TIMEOUT_S = 420
SPAN_SYNC_S = 240.0
#: NVLink between two cards of a host, bytes/s each way (the remote share
#: of a flip across cards)
NVLINK_BYTES_PER_S = 450e9

CHILD_37 = r"""
import json, os, sys
args = json.loads(sys.argv[1])
sys.path.insert(0, args["root"])
import torch
import chip_smoke as cs
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu_torch.parallel import multihost as mh

device = f"cuda:{args['rank'] if args['per_card'] else 0}"
torch.cuda.set_device(torch.device(device))
mh.initialize_distributed(f"localhost:{args['port']}", args["nproc"], args["rank"],
                          timeout_s=args["sync_s"])
mh.set_sync_timeout(args["sync_s"])
out = cs.spanning_child(torch, pt, mh, args, device)
print(json.dumps(out), flush=True)
os._exit(0)
"""


class _CudaArray:
    """A device buffer as ``__cuda_array_interface__`` describes it, for a
    tensor view of memory PyTorch did not allocate (a peer's IPC-mapped
    receive slab; the yardstick's ``copy_`` targets)."""

    TYPESTR = {"float64": "<f8", "float32": "<f4", "complex128": "<c16", "complex64": "<c8"}

    def __init__(self, ptr, shape, dtype):
        self.__cuda_array_interface__ = {"shape": tuple(shape), "typestr": self.TYPESTR[dtype],
                                         "data": (int(ptr), False), "version": 3,
                                         "strides": None}


def span_step_flips(torch, model) -> dict:
    """``{(local pencil shape, x_to_y, dtype): flips}`` of one eager step of
    a spanning-mesh model (its state and time put back after it)."""
    ring, flips = model.mesh.ring, {}

    def log(block, x_to_y, apply=ring.apply):
        key = (tuple(block.shape), bool(x_to_y), str(block.dtype).replace("torch.", ""))
        flips[key] = flips.get(key, 0) + 1
        return apply(block, x_to_y)

    state, t = model.state, model.time
    ring.apply = log
    try:
        model.update()
    finally:
        del ring.apply
        model.state, model.time = state, t
    torch.cuda.synchronize()
    return flips


def span_copy_views(torch, ring, block, x_to_y):
    """The library's ``copy_`` of one remote flip's chunks: for each local
    rank and destination rank, the chunk's view of ``block`` and its view
    in the destination's receive slab (IPC-mapped here)."""
    from rustpde_mpi_tpu_torch.ops.ring_transpose import transposed_shape

    p, pl, g0 = ring.nranks, ring.nlocal, ring.rank0
    shape = transposed_shape(block.shape, p, x_to_y)
    slab = ring._slabs[(tuple(shape), block.dtype, bool(x_to_y))]
    a, b = shape[-2:]
    dtype = str(block.dtype).replace("torch.", "")
    pairs = []
    for t in range(p):
        q, lt = divmod(t, pl)
        ptr = slab.peers[q] + lt * a * b * block.element_size()
        dst = torch.as_tensor(_CudaArray(ptr, (a, b), dtype))  # on the slab's own card
        for lr in range(pl):
            if x_to_y:
                c, w = block.shape[-2] // p, block.shape[-1]
                pairs.append((dst[:, (g0 + lr) * w:(g0 + lr + 1) * w],
                              block[lr, t * c:(t + 1) * c, :]))
            else:
                c, w = block.shape[-2], block.shape[-1] // p
                pairs.append((dst[(g0 + lr) * c:(g0 + lr + 1) * c, :],
                              block[lr, :, t * w:(t + 1) * w]))
    return pairs


def span_barrier(torch, mh, tag):
    torch.cuda.synchronize()
    mh.sync_hosts(tag)


def span_wall_ms(torch, fn, reps) -> float:
    """Host wall ms of ``fn()`` (a path through the host), synchronised."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / reps * 1e3


def span_cold_ms(torch, ring, fn, reps) -> float:
    """Mean device ms of ``fn()`` on a spanning mesh with the L2 flushed
    before each call, as :func:`time_cold_ms` times it, but with every
    process's flush and spin outside every window: each window opens after
    a rank gather (``ring.gather``), which ends only when every process has
    pushed its part, so after every peer's flush and spin.  On a shared
    card the window still holds the peers' own share of the same call
    (their contexts time-slice with this one)."""
    flush = torch.empty(FLUSH_BYTES // 4, dtype=torch.float32, device=ring.device)
    token = torch.zeros((ring.nlocal, 1), dtype=torch.float64, device=ring.device)
    fn()
    ring.gather(token)
    torch.cuda.synchronize()
    total = 0.0
    for _ in range(reps):
        flush.fill_(1.0)
        torch.cuda._sleep(SLEEP_CYCLES // 50)
        ring.gather(token)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        total += start.elapsed_time(end)
    return total / reps


def span_graph_ms(torch, mh, fn, reps, tag) -> float:
    """Device ms of one call of ``fn()`` on a spanning mesh, back to back
    (warm L2): ``reps`` calls captured as one CUDA graph, every process
    replaying its graph together after a host barrier, CUDA events around
    each replay and nothing else inside; the median of
    ``SPAN_WINDOWS`` windows.  On a shared card a window holds every
    process's share of the calls (their contexts time-slice)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    try:
        graph.replay()
        times = []
        for i in range(SPAN_WINDOWS):
            span_barrier(torch, mh, f"{tag} {i}")
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            graph.replay()
            end.record()
            end.synchronize()
            times.append(start.elapsed_time(end) / reps)
        return statistics.median(times)
    finally:
        torch.cuda.synchronize()
        graph.reset()


def span_flip_checks(torch, mh, mesh, flips, cell, timed, nccl) -> list:
    """Each flip a step of ``cell`` makes, on random values of its local
    shape: the remote kernel bit for bit against its plain version (one
    launch), and, when ``timed``, its times cold and warm, the plain
    version's, the ``copy_`` yardstick's and NCCL's (``nccl``: a group on
    a card a process, else None), and its bound."""
    import numpy as np

    rng = np.random.default_rng(37 + mh.process_index())
    ring = mesh.ring
    records = []
    for (shape, x_to_y, dtype), count in sorted(flips.items()):
        dt = getattr(torch, dtype)
        values = rng.uniform(-1.0, 1.0, size=shape)
        if dt.is_complex:
            values = values + 1j * rng.uniform(-1.0, 1.0, size=shape)
        block = torch.as_tensor(values, dtype=dt, device=mesh.device)
        before = ring.launches
        out = ring.apply(block, x_to_y)
        torch.cuda.synchronize()
        plain = ring.plain(block, x_to_y)
        diff = float(torch.max(torch.abs(out - plain)))
        rec = {"kernel": "ring_push", "cell": cell, "shape": list(shape), "x_to_y": x_to_y,
               "dtype": dtype, "per_step": count, "max_abs_err": diff,
               "max_rel_err": diff / float(torch.max(torch.abs(plain)))}
        if not torch.equal(out, plain) or ring.launches != before + 1:
            raise AssertionError(f"37: remote flip {cell} {shape} x_to_y={x_to_y} {dtype} "
                                 f"differs from its plain version (max {diff:.3e}) or did not "
                                 "launch once")
        if timed:
            nbytes = ring.bytes_moved(block)
            remote = block.numel() * block.element_size() * (ring.nranks - ring.nlocal) / ring.nranks
            bound_s = nbytes / (HBM_TB_PER_S * 1e12)
            if nccl is not None:
                bound_s = max(bound_s, remote / NVLINK_BYTES_PER_S)
            span_barrier(torch, mh, "37 time")
            rec["kernel_ms"] = span_cold_ms(torch, ring, lambda: ring.apply(block, x_to_y),
                                            SPAN_REPS)
            rec["kernel_warm_ms"] = span_graph_ms(torch, mh, lambda: ring.apply(block, x_to_y),
                                                  SPAN_REPS, "37 flips")
            rec["plain_ms"] = span_wall_ms(torch, lambda: ring.plain(block, x_to_y), 3)
            pairs = span_copy_views(torch, ring, block, x_to_y)

            def copies():
                for dst, src in pairs:
                    dst.copy_(src)

            span_barrier(torch, mh, "37 copy")
            rec["copy_ms"] = span_cold_ms(torch, ring, copies, SPAN_REPS)
            rec["copy_warm_ms"] = span_graph_ms(torch, mh, copies, SPAN_REPS, "37 copies")
            span_barrier(torch, mh, "37 copied")
            rec["library_ms"] = rec["copy_ms"]
            if nccl is not None:
                send = block.reshape(-1).clone()
                recv = torch.empty_like(send)
                real = torch.view_as_real if send.is_complex() else (lambda t: t)
                rec["nccl_ms"] = time_queued_ms(torch, lambda: torch.distributed.all_to_all_single(
                    real(recv), real(send), group=nccl), SPAN_REPS)[0]
                rec["library_ms"] = rec["nccl_ms"]
            rec.update(bytes=nbytes, remote_bytes=remote, bound_ms=bound_s * 1e3,
                       bound_by="bytes")
        records.append(rec)
    return records


def span_counted_run(torch, model, steps) -> tuple:
    """The chunk runner built (warm-up and capture), then ``steps`` steps
    of bare ``update_n`` with the launch counts set to 0 just before and
    read just after: ``(ms/step, launches)``."""
    runner = model.chunk_runner(armed=False)
    if not runner.captured:
        raise AssertionError("37: the spanning chunk runner did not capture a CUDA graph")
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.update_n(steps)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    return wall / steps * 1e3, count_launches(model)


def span_one_step(pt, model) -> dict:
    """The global state of ``model`` one eager step on (its own state and
    time put back)."""
    state, t = model.state, model.time
    model.update()
    try:
        return pt.state_to_numpy(model)
    finally:
        model.state, model.time = state, t


def span_golden(pt, mesh) -> float:
    """The head of the f64 golden Nusselt trajectory of ``PARITY.json``
    (129^2, 200 steps) on ``mesh``: the worst relative deviation."""
    with open(os.path.join(ROOT, "PARITY.json"), encoding="utf-8") as fh:
        gold = json.load(fh)
    cfg = gold["config"]
    model = pt.Navier2D(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], cfg["dt"], cfg["aspect"],
                        cfg["bc"], mesh=mesh)
    model.init_random(cfg["amp"], seed=0)
    worst = 0.0
    for row in gold["nu_f64"][:4]:
        model.update_n(cfg["sample_every"])
        vals = dict(zip(("nu", "nuvol", "re"), model.get_observables()[:3]))
        for key, val in vals.items():
            worst = max(worst, abs(val / row[key] - 1.0))
    if not worst <= 1e-6:
        raise AssertionError(f"37: the golden head on {mesh} strays {worst:.3e}")
    return worst


def spanning_child(torch, pt, mh, args, device) -> dict:
    """One process of phase 37 (:data:`CHILD_37`): its ranks of the
    spanning mesh, the flip checks of each cell (timed when
    ``args["timed"]``), each cell's counted run, the 129^2 state, the golden
    head and the NaN freeze; the global states go to ``args["work"]`` from
    rank 0.  Returns its records."""
    import numpy as np

    rank, nproc, work = args["rank"], args["nproc"], args["work"]
    mesh = mh.global_pencil_mesh(MESH_RANKS // nproc, device)
    nccl = torch.distributed.new_group(backend="nccl") if args["per_card"] else None
    out = {"rank": rank, "mesh": repr(mesh), "device": str(mesh.device)}
    for cell, cfg in SPAN_CELLS.items():
        t0 = time.perf_counter()
        model = pt.Navier2D(**cfg, mesh=mesh)
        model.init_random(0.1, seed=0)
        out[f"{cell}_build_s"] = time.perf_counter() - t0
        flips = span_step_flips(torch, model)
        out[f"{cell}_flips"] = span_flip_checks(torch, mh, mesh, flips, cell, args["timed"], nccl)
        state = span_one_step(pt, model)
        if rank == 0:
            np.savez(os.path.join(work, f"{args['label']}_{cell}_1.npz"), **state)
        out[f"{cell}_ms"], out[f"{cell}_launches"] = span_counted_run(torch, model,
                                                                      SPAN_STEPS[cell])
        state = pt.state_to_numpy(model)
        if rank == 0:
            np.savez(os.path.join(work, f"{args['label']}_{cell}.npz"), **state)
        del model, state
        torch.cuda.empty_cache()
    small = pt.Navier2D(**ENSEMBLE129, mesh=mesh)
    small.init_random(0.1, seed=0)
    small.update_n(SPAN_SMALL_STEPS)
    state = pt.state_to_numpy(small)
    if rank == 0:
        np.savez(os.path.join(work, f"{args['label']}_small.npz"), **state)
    out["golden_worst"] = span_golden(pt, mesh)
    # a NaN on the last process's ranks alone: every process freezes at
    # the same step (the freeze probe sums every rank's temperature)
    small.update_n(2)
    if rank == nproc - 1:
        temp = small.state.temp.clone()
        temp[0, 3, 1] = float("nan")
        small.state = small.state._replace(temp=temp)
    t0 = time.perf_counter()
    small.update_n(5)
    runner = small.chunk_runner(armed=False)
    nf = len(small.state)
    out["nan"] = [int(runner.carry[nf + 1]), bool(runner.carry[nf]),
                  time.perf_counter() - t0]
    del small, runner
    torch.cuda.synchronize()
    mesh.close()
    return out


def span_spawn(label, nproc, per_card, timed, work, child=None, phase="37") -> list:
    """Run ``nproc`` children of ``child`` (:data:`CHILD_37` by default) as
    one job under ``SPAN_TIMEOUT_S``; every child still alive then is
    killed.  Returns their records in rank order, raising on a child that
    failed."""
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    procs = []
    for rank in range(nproc):
        args = {"root": ROOT, "rank": rank, "nproc": nproc, "port": port, "work": work,
                "label": label, "per_card": per_card, "timed": timed, "sync_s": SPAN_SYNC_S}
        procs.append(subprocess.Popen([sys.executable, "-c", child or CHILD_37, json.dumps(args)],
                                      stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True))
    outs = []
    t_end = time.monotonic() + SPAN_TIMEOUT_S
    try:
        for p in procs:
            try:
                out, err = p.communicate(timeout=max(1.0, t_end - time.monotonic()))
            except subprocess.TimeoutExpired:
                p.kill()
                out, err = p.communicate()
            outs.append((p.returncode, out, err))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    results = []
    for rank, (rc, out, err) in enumerate(outs):
        lines = [ln for ln in out.splitlines() if ln.startswith("{")]
        if rc != 0 or not lines:
            raise AssertionError(f"{phase}: {label} child {rank} rc={rc}:\n{out[-2000:]}\n"
                                 f"{err[-4000:]}")
        results.append(json.loads(lines[-1]))
    return results


def span_one_process(torch, pt) -> dict:
    """The one-process ``make_mesh(4)`` runs phase 37 holds the spanning
    ones against: each cell's counted run (ms/step) and global state, and
    the 129^2 state."""
    out = {}
    for cell, cfg in SPAN_CELLS.items():
        model = pt.Navier2D(**cfg, mesh=pt.make_mesh(MESH_RANKS))
        model.init_random(0.1, seed=0)
        start = model.state
        out[f"{cell}_1"] = (None, span_one_step(pt, model))
        ms, _ = span_counted_run(torch, model, SPAN_STEPS[cell])
        out[cell] = (ms, pt.state_to_numpy(model))
        # the run's own rounding sensitivity: the same from a start moved
        # by one ulp (x (1 + 2^-52))
        model.state, model.time = type(start)(*(x * (1.0 + 2.0**-52) for x in start)), 0.0
        out[f"{cell}_ulp_1"] = (None, span_one_step(pt, model))
        model.update_n(SPAN_STEPS[cell])
        out[f"{cell}_ulp"] = (None, pt.state_to_numpy(model))
        del model
        torch.cuda.empty_cache()
    small = pt.Navier2D(**ENSEMBLE129, mesh=pt.make_mesh(MESH_RANKS))
    small.init_random(0.1, seed=0)
    small.update_n(SPAN_SMALL_STEPS)
    out["small"] = (None, pt.state_to_numpy(small))
    return out


def span_state_diff(ref: dict, got: dict) -> tuple:
    """The largest field difference over the field's scale, whether every
    field is bit for bit, and each field's difference over its scale."""
    import numpy as np

    fields = {name: float(np.max(np.abs(got[name] - want)))
              / max(float(np.max(np.abs(want))), 1e-300) for name, want in ref.items()}
    return (max(fields.values()), all(np.array_equal(got[name], want)
                                      for name, want in ref.items()), fields)


def phase37(torch, pt, card, one_flips) -> dict:
    """Phase 37: a mesh whose ranks span processes (see the module
    docstring).  ``one_flips``: phase 12's and 19's records of the
    one-process flips, printed beside the remote ones of the same global
    shape.  Returns ``{layout: {"records", "launches", "ms"}}``."""
    import numpy as np

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    print(f"phase37 cards: {cards} ({card}); layouts "
          + ", ".join(label for label, _ in SPAN_LAYOUTS)
          + (f", card_per_process ({min(cards, MESH_RANKS)} processes)" if cards >= 2 else
             "; one card: no layout with a card a process, no NCCL yardstick"))
    refs = span_one_process(torch, pt)
    layouts = [(label, nproc, False) for label, nproc in SPAN_LAYOUTS]
    if cards >= 2:
        layouts.append(("card_per_process", 4 if cards >= 4 else 2, True))
    one_ms = {(tuple(r["shape"][1:]), r["x_to_y"], r["dtype"]): r for r in one_flips}
    summary = {}
    with tempfile.TemporaryDirectory(prefix="phase37_") as work:
        for label, nproc, per_card in layouts:
            t1 = time.perf_counter()
            results = span_spawn(label, nproc, per_card, True, work)
            for cell, cfg in SPAN_CELLS.items():
                route = "periodic_mesh" if cfg.get("periodic") else "mesh"
                want = {k: v * SPAN_STEPS[cell] for k, v in PER_STEP[route].items()}
                want["ring_gather"] = SPAN_STEPS[cell]
                for r in results:
                    if r[f"{cell}_launches"] != want:
                        raise AssertionError(f"37: {label} {cell} rank {r['rank']} launched "
                                             f"{r[f'{cell}_launches']}, expected {want}")
                checks = {}
                lone = MESH_RANKS // nproc == 1  # lone GEMMs: the ulp-scaled rule
                for tag, steps in (("_1", 1), ("", SPAN_STEPS[cell])):
                    ref = refs[f"{cell}{tag}"][1]
                    got = dict(np.load(os.path.join(work, f"{label}_{cell}{tag}.npz")))
                    diff, exact, fields = span_state_diff(ref, got)
                    ulp = span_state_diff(ref, refs[f"{cell}_ulp{tag}"][1])[2]
                    factor = max(ULP_STEPS_FACTOR, steps)
                    limits = {f: max(SPAN_LIMIT, factor * ulp[f]) if lone else SPAN_LIMIT
                              for f in fields}
                    checks[steps] = (diff, exact)
                    rule = (f"one rank a process: the larger of {SPAN_LIMIT:g} and {factor} x "
                            "the one-ulp sensitivity" if lone else
                            f"several ranks a process: {SPAN_LIMIT:g}")
                    print(f"phase37 {label} {cell} state vs the one-process run after {steps} "
                          f"steps, each field over its scale: {json.dumps(fields)}; the "
                          f"one-process run from a start one ulp away: {json.dumps(ulp)}; "
                          f"rule ({rule}), limits {json.dumps(limits)}")
                    if any(fields[f] > limits[f] for f in fields):
                        raise AssertionError(f"37: {label} {cell} state after {steps} steps "
                                             f"{fields} beyond {limits}")
                (diff1, exact1), (diff, exact) = checks[1], checks[SPAN_STEPS[cell]]
                ms_one = refs[cell][0]
                print(f"phase37 {label} {cell} f64 ({results[0]['mesh']}): bare update_n "
                      f"{SPAN_STEPS[cell]} steps " + ", ".join(
                          f"rank {r['rank']} {r[f'{cell}_ms']:.4f}" for r in results)
                      + f" ms/step; one-process make_mesh({MESH_RANKS}) {ms_one:.4f} ms/step; "
                      f"launches a process {results[0][f'{cell}_launches']}; state vs the "
                      f"one-process run after one step {diff1:.3e} of the field's scale (bit "
                      f"for bit: {exact1}), after {SPAN_STEPS[cell]} steps {diff:.3e} (bit for "
                      f"bit: {exact}); "
                      f"model build {results[0][f'{cell}_build_s']:.2f} s ({card})")
                for rec in results[0][f"{cell}_flips"]:
                    one = one_ms.get((tuple(rec["shape"][1:]), rec["x_to_y"], rec["dtype"]))
                    rec["one_process_ms"] = one and one.get("kernel_ms")
                    rec["one_process_warm_ms"] = one and one.get("kernel_warm_ms")
                    print(f"phase37 {label} " + json.dumps(rec))
            _, ref = refs["small"]
            got = dict(np.load(os.path.join(work, f"{label}_small.npz")))
            diff, exact, _ = span_state_diff(ref, got)
            if not diff <= SPAN_LIMIT:
                raise AssertionError(f"37: {label} 129^2 state {diff:.3e} of the scale")
            nans = [r["nan"] for r in results]
            if len({tuple(n[:2]) for n in nans}) != 1 or nans[0][1]:
                raise AssertionError(f"37: {label} NaN freeze differs or did not freeze: {nans}")
            print(f"phase37 {label} 129^2 {SPAN_SMALL_STEPS} steps vs one process: "
                  f"{diff:.3e} of the scale (bit for bit: {exact}); golden head worst rel "
                  f"{max(r['golden_worst'] for r in results):.3e} (limit 1e-6); NaN on process "
                  f"{nproc - 1}: every process froze after {nans[0][0]} steps, "
                  f"{max(n[2] for n in nans):.3f} s; layout {time.perf_counter() - t1:.1f} s")
            summary[label] = {
                "records": [r for r in results[0]["rbc1025_flips"] if r["per_step"]],
                "periodic_records": results[0]["periodic1024_flips"],
                "launches": {k: sum(r["rbc1025_launches"][k] for r in results)
                             for k in results[0]["rbc1025_launches"]},
                "ms": [r["rbc1025_ms"] for r in results], "nproc": nproc}
    print(f"phase37 ok ({time.perf_counter() - t0:.1f} s)")
    return summary


# -- the paths of a mesh whose ranks span processes (phase 38) ---------------------------

#: phase 38 at meshed ``rbc1025`` on 2 processes x 2 ranks: the statistics'
#: steps (at ``STATS_STRIDE``), the ensemble's members and steps, the
#: runner's steps at dt and the step of its NaN (rank 1's process poisons
#: its ranks; the one-process run every rank); the gradient at 129^2 runs
#: ``GRAD_STEPS`` steps and is held to ``SPAN_LIMIT`` (relative)
SPAN38_STATS_STEPS = 100
SPAN38_MEMBERS = 2
SPAN38_ENS_STEPS = 50
SPAN38_RUN_STEPS = 200
SPAN38_NAN_STEP = 100
#: the paths' kernels: a logged banded input against its plain version on
#: random values, of each lane's scale
SPAN38_BANDED_LIMIT = 1e-12

CHILD_38 = CHILD_37.replace("cs.spanning_child", "cs.span_paths_child")


def span38_logged(torch, fn):
    """``fn()`` with every flip of a spanning ring it makes counted by
    ``(shape, x_to_y, dtype)`` (forward and backward) and the first input of
    every banded solve kept by kernel and view shape: ``(result, flips,
    solves)``, ``solves[key] = [kernel, input, stride, period, count]``."""
    from rustpde_mpi_tpu_torch.ops.banded_solve import BandedSolve
    from rustpde_mpi_tpu_torch.ops.ring_transpose import SpanningRing

    flips, solves = {}, {}
    flip, apply = SpanningRing.flip, BandedSolve.apply

    def log_flip(ring, block, x_to_y):
        key = (tuple(block.shape), bool(x_to_y), str(block.dtype).replace("torch.", ""))
        flips[key] = flips.get(key, 0) + 1
        return flip(ring, block, x_to_y)

    def log_apply(kernel, b, stride=0, period=0):
        key = (id(kernel), tuple(b.shape), int(stride), int(period))
        if key not in solves:
            solves[key] = [kernel, b.detach().clone(), int(stride), int(period), 0]
        solves[key][4] += 1
        return apply(kernel, b, stride, period)

    SpanningRing.flip, BandedSolve.apply = log_flip, log_apply
    try:
        return fn(), flips, solves
    finally:
        SpanningRing.flip, BandedSolve.apply = flip, apply


def span38_banded_checks(torch, solves, backward_of, what) -> list:
    """Each logged banded solve's kernel on random values of its input's
    shape against its plain version (``SPAN38_BANDED_LIMIT`` of each
    lane's scale, one launch); ``backward_of``: the kernels that are some
    forward kernel's transposed factors."""
    import numpy as np

    rng = np.random.default_rng(38)
    records = []
    for kernel, b, stride, period, count in solves.values():
        r = torch.as_tensor(rng.uniform(-1.0, 1.0, size=tuple(b.shape)), dtype=b.dtype,
                            device=b.device)
        before = kernel.launches
        out = kernel.apply(r, stride, period)
        torch.cuda.synchronize()
        diff, rel = lane_rel_err(torch, out, kernel.plain(r, stride, period), -2)
        rec = {"kernel": "banded_solve", "what": what, "shape": list(b.shape), "stride": stride,
               "period": period, "backward": any(kernel is k for k in backward_of),
               "per_run": count, "max_abs_err": diff, "max_rel_err": rel}
        if not rel <= SPAN38_BANDED_LIMIT or kernel.launches != before + 1:
            raise AssertionError(f"38: banded solve {what} {rec} beyond {SPAN38_BANDED_LIMIT:g} "
                                 "of a lane's scale, or it did not launch once")
        records.append(rec)
    return records


def span38_ensemble_arrays(ens) -> dict:
    """Every member's fields as global arrays (a collective on a spanning
    mesh)."""
    import numpy as np

    out = {}
    for name, space in ens.model._state_fields():
        leaf = getattr(ens.state, name)
        out[name] = np.stack([space.gather_spectral(leaf[i]).cpu().numpy()
                              for i in range(ens.k)])
    return out


def span38_paths(torch, pt, mh, mesh, run_dir, fault, check, nudge=False) -> tuple:
    """Phase 38's four paths on ``mesh`` (a spanning mesh in a child, the
    one-process ``make_mesh(4)`` in the parent): ``(records, arrays)``,
    the records each path's ms and launches, the arrays the global ones the
    parent compares.  ``check``: log every flip and banded solve the paths
    launch and hold each against its plain version (a spanning mesh).
    ``nudge``: the three ``rbc1025`` paths from starts moved by one ulp
    (x (1 + 2^-52)), the one-process run's own sensitivity, and no
    gradient."""
    import numpy as np

    from rustpde_mpi_tpu_torch.utils import resilience
    from rustpde_mpi_tpu_torch.utils.journal import read_journal

    def moved(state):
        return type(state)(*(x * (1.0 + 2.0**-52) for x in state)) if nudge else state

    rec, arrays, logs = {}, {}, []
    model = pt.Navier2D(**RBC1025, mesh=mesh)
    model.init_random(0.1, seed=0)
    model.write_intervall = 1e9
    model.state = start = moved(model.state)

    def logged(what, fn, pde):
        """``fn()``, its flips and banded solves logged for the checks,
        which run after every path's launches were read."""
        if not check:
            return fn()
        out, flips, solves = span38_logged(torch, fn)
        backs = [k._transposed for k in pde.kernels().get("banded_solve", [])
                 if k._transposed is not None]
        logs.append((what, flips, solves, backs))
        return out

    # the statistics at stride 16
    logged("stats_sample", lambda: model.set_stats(pt.StatsConfig(stride=STATS_STRIDE)), model)
    model.chunk_runner(armed=False, stats=True)
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    model.update_n(SPAN38_STATS_STEPS)
    torch.cuda.synchronize()
    rec["stats_ms"] = (time.perf_counter() - t0) / SPAN38_STATS_STEPS * 1e3
    rec["stats_launches"] = count_launches(model)
    arrays.update({f"stats_{n}": getattr(model.stats_state, n).cpu().numpy()
                   for n in model.stats_state._fields})
    model.set_stats(None)
    # the ensemble, with its digests
    model.state, model.time = start, 0.0
    ens = pt.NavierEnsemble.from_seeds(model, range(SPAN38_MEMBERS))
    ens.state = moved(ens.state)
    ens.set_integrity(pt.IntegrityConfig())
    with torch.no_grad():
        logged("ensemble_step", lambda: model._step(ens.state), model)
    logged("ensemble_digest", lambda: ens.state_digest_async().result(), model)
    ens.chunk_runner()
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ens.update_n(SPAN38_ENS_STEPS)
    torch.cuda.synchronize()
    rec["ensemble_ms"] = (time.perf_counter() - t0) / SPAN38_ENS_STEPS * 1e3
    rec["ensemble_launches"] = count_launches(model)
    arrays.update({f"ens_{k}": v for k, v in span38_ensemble_arrays(ens).items()})
    arrays["ens_digest"] = np.asarray(ens.state_digest_async().result()).astype(np.int64)
    rec["alive"] = ens.alive().tolist()
    model.set_integrity(None)  # the ensemble armed it on its template model
    del ens
    # the runner, a NaN at step SPAN38_NAN_STEP, checkpoints in memory; the
    # break check unlagged in both runs (a run of several processes never
    # lags it: one process would otherwise step a chunk past the NaN)
    model.state, model.time = type(start)(*(t.clone() for t in start)), 0.0
    runner = pt.ResilientRunner(model, max_time=SPAN38_RUN_STEPS * model.dt, run_dir=run_dir,
                                fault=fault, checkpoint_every_s=None,
                                io=pt.IOConfig(overlap_dispatch=False),
                                _store=resilience._MemoryStore(run_dir))
    reset_counts(model)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    summary = runner.run()
    torch.cuda.synchronize()
    rec["runner_s"] = time.perf_counter() - t0
    rec["runner_launches"] = count_launches(model)
    rec["runner"] = {k: summary[k] for k in ("outcome", "step", "dt", "retries")}
    rec["events"] = [e["event"] for e in read_journal(runner.journal_path)
                     if e["event"] not in CLOCKED_EVENTS] if mh is None or mh.is_root() else None
    arrays.update({f"run_{k}": v for k, v in pt.state_to_numpy(model).items()})
    del runner, model, start
    torch.cuda.empty_cache()
    if nudge:
        return rec, arrays
    # the linearised model's gradient at 129^2
    grad = grad_model(pt, "mesh", CARD, mesh=mesh)
    ring = mesh.ring
    reset_counts(grad)
    ring.backward_launches = 0
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    val, grads = logged("gradient", lambda: grad.grad_autodiff(GRAD_STEPS * grad.dt), grad)
    torch.cuda.synchronize()
    rec["grad_s"] = time.perf_counter() - t0
    rec["grad_launches"] = {"flips_forward": ring.launches - ring.backward_launches,
                            "flips_backward": ring.backward_launches,
                            "banded_forward": count_launches(grad)["banded_solve"],
                            "banded_backward": transposed_launches(grad)}
    arrays["grad_value"] = np.asarray(val)
    arrays.update({f"grad_{i}": g for i, g in enumerate(grads)})
    rec["kernels"] = []
    for what, flips, solves, backs in logs:
        rec["kernels"] += span_flip_checks(torch, mh, mesh, flips, what, False, None)
        rec["kernels"] += span38_banded_checks(torch, solves, backs, what)
    del grad, logs
    torch.cuda.empty_cache()
    return rec, arrays


def span_paths_child(torch, pt, mh, args, device) -> dict:
    """One process of phase 38 (:data:`CHILD_38`): the paths on its ranks of
    the spanning mesh, every new launch held against its plain version;
    rank 0 writes the global arrays to ``args["work"]``."""
    import numpy as np

    mesh = mh.global_pencil_mesh(MESH_RANKS // args["nproc"], device)
    rec, arrays = span38_paths(torch, pt, mh, mesh,
                               os.path.join(args["work"], f"{args['label']}_run"),
                               f"nan@{SPAN38_NAN_STEP}:host1", True)
    if args["rank"] == 0:
        np.savez(os.path.join(args["work"], f"{args['label']}_paths.npz"), **arrays)
    torch.cuda.synchronize()
    mesh.close()
    return dict(rec, rank=args["rank"])


#: the steps behind each path's arrays, which scale a lone-rank layout's
#: one-ulp limit (as phase 37's rule: at least ``ULP_STEPS_FACTOR``)
SPAN38_ULP_STEPS = {"stats_": SPAN38_STATS_STEPS, "ens_": SPAN38_ENS_STEPS,
                    "run_": 2 * SPAN38_RUN_STEPS}


def span38_rel(a, b) -> float:
    import numpy as np

    return float(np.max(np.abs(a - b))) / max(float(np.max(np.abs(b))), 1e-300)


def span38_limits(want, ulp) -> dict:
    """Each ``rbc1025`` array's limit where a process holds one rank (lone
    GEMMs round apart from the one-process mesh's batched ones, ROADMAP
    Queue 3 item 4): the larger of ``SPAN_LIMIT`` and the path's steps (at
    least ``ULP_STEPS_FACTOR``) times the one-process run's own one-ulp
    sensitivity (``ulp``, the paths from starts moved by one ulp)."""
    out = {}
    for k, w in want.items():
        prefix = next((p for p in SPAN38_ULP_STEPS if k.startswith(p)), None)
        if prefix is not None and k in ulp and k != "ens_digest":
            factor = max(ULP_STEPS_FACTOR, SPAN38_ULP_STEPS[prefix])
            out[k] = max(SPAN_LIMIT, factor * span38_rel(ulp[k], w))
    return out


def span38_layout(label, results, got, ref, want, clean, card, limits=None) -> None:
    """Phase 38's checks of one layout: its children's ``results``, rank
    0's global arrays ``got`` against the one-process paths' ``ref``/
    ``want`` and the clean run at dt/2 (``clean``): bit for bit, or, for a
    layout of one rank a process, within ``limits`` (:func:`span38_limits`;
    the digests then differ with the bits and are not compared)."""
    import numpy as np

    if limits is None:
        exact = {k: bool(np.array_equal(got[k], want[k])) for k in want}
        clean_exact = all(np.array_equal(got[f"run_{f}"], v) for f, v in clean.items())
    else:
        rels = {k: span38_rel(got[k], want[k]) for k in limits}
        print(f"phase38 {label} one rank a process, each array against the one-process run "
              f"over its scale: {json.dumps(rels)}; limits (the larger of {SPAN_LIMIT:g} and "
              f"the steps x the one-ulp sensitivity): {json.dumps(limits)}")
        exact = {k: (rels[k] <= limits[k] if k in limits else
                     k == "ens_digest" or bool(np.array_equal(got[k], want[k]))) for k in want}
        clean_exact = all(span38_rel(got[f"run_{f}"], v) <= limits[f"run_{f}"]
                          for f, v in clean.items())
    grad_rel = max(span38_rel(got[k], want[k]) for k in want if k.startswith("grad_"))
    for r in results:
        for kr in r["kernels"]:
            print(f"phase38 {label} rank {r['rank']} " + json.dumps(kr))
    per = {"stats": f"ms/step over {SPAN38_STATS_STEPS} steps with statistics (stride "
                    f"{STATS_STRIDE})",
           "ensemble": f"ms/step of K = {SPAN38_MEMBERS} over {SPAN38_ENS_STEPS} steps",
           "runner": f"s of the runner's {SPAN38_RUN_STEPS} steps with the NaN at step "
                     f"{SPAN38_NAN_STEP} and the rerun at dt/2",
           "grad": f"s of grad_autodiff at 129^2 over {GRAD_STEPS} steps"}
    for path, what in per.items():
        key = f"{path}_ms" if path in ("stats", "ensemble") else f"{path}_s"
        print(f"phase38 {label} {path}: " + ", ".join(f"rank {r['rank']} {r[key]:.4f}"
                                                      for r in results)
              + f" against the one-process make_mesh({MESH_RANKS}) {ref[key]:.4f} ({what}; "
              f"{card}); launches a process {results[0][f'{path}_launches']} (one process "
              f"{ref[f'{path}_launches']})")
    rule = "bit for bit" if limits is None else "within the limits"
    print(f"phase38 {label} {rule} against the one-process paths: "
          f"{json.dumps({k: v for k, v in exact.items() if not k.startswith('grad_')})}; "
          f"gradient rel {grad_rel:.3e} (limit {SPAN_LIMIT:g}); the recovered state against the "
          f"clean run at dt/2: {rule} {clean_exact}; runner {results[0]['runner']} events "
          f"{results[0]['events']}")
    samples = SPAN38_STATS_STEPS // STATS_STRIDE
    sample_flips = sum(k["per_step"] for k in results[0]["kernels"]
                       if k.get("cell") == "stats_sample")
    want_stats = {"ring_transpose": PER_STEP["mesh"]["ring_transpose"] * SPAN38_STATS_STEPS
                  + sample_flips * samples,
                  "ring_gather": SPAN38_STATS_STEPS,
                  "banded_solve": PER_STEP["mesh"]["banded_solve"] * SPAN38_STATS_STEPS}
    want_ens = {k: v * SPAN38_ENS_STEPS for k, v in PER_STEP["mesh"].items()}
    want_ens["ring_gather"] = SPAN38_ENS_STEPS
    want_grad = {"flips_forward": GRAD_FLIPS_FWD[0] + GRAD_FLIPS_FWD[1] * GRAD_STEPS,
                 "flips_backward": GRAD_FLIPS_BWD[0] + GRAD_FLIPS_BWD[1] * GRAD_STEPS,
                 "banded_forward": GRAD_STEPS * (PER_STEP["dense"]["banded_solve"]
                                                 + GRAD_RECOMPUTED_SOLVES),
                 "banded_backward": GRAD_STEPS * PER_STEP["dense"]["banded_solve"]}
    for r in results:
        for path, want_n in (("stats", want_stats), ("ensemble", want_ens), ("grad", want_grad)):
            if r[f"{path}_launches"] != want_n:
                raise AssertionError(f"38: {label} rank {r['rank']} {path} launched "
                                     f"{r[f'{path}_launches']}, expected {want_n}")
        if not all(r["runner_launches"].get(k, 0) > 0 for k in
                   ("ring_transpose", "ring_gather", "banded_solve")):
            raise AssertionError(f"38: {label} rank {r['rank']} runner launched "
                                 f"{r['runner_launches']}")
        if r["runner"] != ref["runner"] or r["alive"] != ref["alive"]:
            raise AssertionError(f"38: {label} rank {r['rank']} runner {r['runner']} alive "
                                 f"{r['alive']}, one process {ref['runner']} {ref['alive']}")
    if results[0]["events"] != ref["events"] or "divergence" not in ref["events"]:
        raise AssertionError(f"38: {label} journal {results[0]['events']}, one process "
                             f"{ref['events']}")
    if not all(v for k, v in exact.items() if not k.startswith("grad_")) or not clean_exact:
        raise AssertionError(f"38: {label} not bit for bit {exact}, clean run at dt/2 "
                             f"{clean_exact}")
    if not grad_rel <= SPAN_LIMIT:
        raise AssertionError(f"38: {label} gradient rel {grad_rel:.3e} beyond {SPAN_LIMIT:g}")


def phase38(torch, pt, card) -> dict:
    """Phase 38: the paths of a model whose mesh spans processes (see the
    module docstring): 2 processes x 2 ranks on card 0, and on a machine
    of several cards also a card a process (4 x 1 on four cards, whose
    lone ranks get phase 37's one-ulp-scaled rule; 2 x 2 on two or three,
    bit for bit).  Returns the launches of each path (a process's, on the
    first layout) for the kernels line."""
    import numpy as np

    t0 = time.perf_counter()
    cards = torch.cuda.device_count()
    layouts = [("2x2", 2, False)]
    if cards >= 2:
        layouts.append(("card_per_process", 4 if cards >= 4 else 2, True))
    print(f"phase38 cards: {cards} ({card}); layouts "
          + ", ".join(f"{label} ({n} processes)" for label, n, _ in layouts))
    with tempfile.TemporaryDirectory(prefix="phase38_") as work:
        ref, want = span38_paths(torch, pt, None, pt.make_mesh(MESH_RANKS),
                                 os.path.join(work, "one"), f"nan@{SPAN38_NAN_STEP}", False)
        ulp = None
        if any(MESH_RANKS // n == 1 for _, n, _ in layouts):
            ulp = span38_paths(torch, pt, None, pt.make_mesh(MESH_RANKS),
                               os.path.join(work, "one_ulp"), f"nan@{SPAN38_NAN_STEP}", False,
                               nudge=True)[1]
        # the recovered state is the clean run at dt/2 from the same start
        clean = pt.Navier2D(**RBC1025, mesh=pt.make_mesh(MESH_RANKS))
        clean.init_random(0.1, seed=0)
        clean.set_dt(RBC1025["dt"] / 2)
        clean.update_n(2 * SPAN38_RUN_STEPS)
        clean = pt.state_to_numpy(clean)
        torch.cuda.empty_cache()
        launches = None
        for label, nproc, per_card in layouts:
            t1 = time.perf_counter()
            results = span_spawn(label, nproc, per_card, False, work, child=CHILD_38, phase="38")
            got = dict(np.load(os.path.join(work, f"{label}_paths.npz")))
            lone = MESH_RANKS // nproc == 1
            span38_layout(label, results, got, ref, want, clean, card,
                          span38_limits(want, ulp) if lone else None)
            print(f"phase38 {label} ok ({time.perf_counter() - t1:.1f} s)")
            launches = launches or {path: results[0][f"{path}_launches"]
                                    for path in ("stats", "ensemble", "runner", "grad")}
    print(f"phase38 ok ({time.perf_counter() - t0:.1f} s)")
    return launches


def span_paths_launches(paths, kernel) -> dict:
    """Phase 38's launches of ``kernel`` (``banded_solve`` or the remote
    flip, ``ring_push``: its flips and rank gathers) on each path, a
    process's."""
    grad = paths["grad"]
    if kernel == "banded_solve":
        out = {p: paths[p].get("banded_solve", 0) for p in ("stats", "ensemble", "runner")}
        out.update(grad_forward=grad["banded_forward"], grad_backward=grad["banded_backward"])
    else:
        out = {p: paths[p].get("ring_transpose", 0) + paths[p].get("ring_gather", 0)
               for p in ("stats", "ensemble", "runner")}
        out.update(grad_forward=grad["flips_forward"], grad_backward=grad["flips_backward"])
    return out


def remote_flip_entry(span) -> dict:
    """The kernels line's entry of the remote flip: its times summed over
    one step's flips of meshed ``rbc1025`` on 2 processes x 2 ranks (rank
    0's), its launches those of phase 37's counted runs on that layout
    (flips and rank gathers of every process)."""
    main = span["2x2"]
    sums = route_sums(main["records"])
    entry = {"name": "ring_push", "route": "cuda",
             "source": KERNEL_META["ring_transpose"][0],
             "replaces": KERNEL_META["ring_transpose"][1],
             "launches": sum(main["launches"].get(k, 0) for k in ("ring_transpose", "ring_gather")),
             "flip_launches": main["launches"].get("ring_transpose", 0),
             "gather_launches": main["launches"].get("ring_gather", 0),
             "max_abs_err": max(r["max_abs_err"] for r in main["records"]),
             **sums, "per": "one step of rbc1025 f64 on 2 processes x 2 ranks (rank 0's flips)"}
    for label, part in span.items():
        if label != "2x2":
            for k, v in route_sums(part["records"]).items():
                if k != "bound_by":
                    entry[f"{label}_{k}"] = v
            entry[f"{label}_launches"] = sum(part["launches"].get(k, 0)
                                             for k in ("ring_transpose", "ring_gather"))
    return entry


KERNEL_META = {
    "fused_conv": ("rustpde_mpi_tpu_torch/csrc/fused_conv.cu",
                   "rustpde_mpi_tpu/ops/pallas_conv.py:64"),
    "fused_stage": ("rustpde_mpi_tpu_torch/csrc/fused_stage.cu",
                    "rustpde_mpi_tpu/ops/pallas_step.py:95"),
    "banded_solve": ("rustpde_mpi_tpu_torch/csrc/banded_solve.cu",
                     "rustpde_mpi_tpu/ops/pallas_banded.py:36"),
    "ring_transpose": ("rustpde_mpi_tpu_torch/csrc/ring_transpose.cu",
                       "rustpde_mpi_tpu/parallel/decomp.py:257"),
}
#: the route whose step each kernel's main numbers sum; a kernel that
#: another route runs too gets that route's sums beside them, prefixed with
#: the route's name
MAIN_ROUTE = {"fused_conv": "fused", "fused_stage": "fused", "banded_solve": "dense",
              "ring_transpose": "mesh"}
ROUTE_NAME = {"fused": "the fused route", "dense": "the dense route",
              "mesh": f"the meshed route ({MESH_RANKS} ranks on the card)"}


def route_sums(rows) -> dict:
    """Times of one step of a route: each record's numbers times its
    launches a step, summed (None where a record lacks one)."""

    def total(key):
        vals = [(r["per_step"], r.get(key)) for r in rows if r["per_step"]]
        if any(v is None for _, v in vals):
            return None
        return sum(k * v for k, v in vals)

    out = {"ms": total("kernel_ms"), "plain_ms": total("plain_ms"),
           "bound_ms": total("bound_ms"), "library_ms": total("library_ms"),
           "bound_by": "operations" if all(r["bound_by"] == "operations" for r in rows)
           else "bytes"}
    if all("kernel_warm_ms" in r for r in rows if r["per_step"]):  # a flip: ``ms`` is cold
        out["warm_ms"] = total("kernel_warm_ms")
    if any("solo_ms" in r for r in rows):  # a member-axis instance: K one-member launches
        out["solo_ms"] = total("solo_ms")
    return out


def kernels_line(records, launches, solver_times, ring_times, runner_launches,
                 phase_launches=None, span=None, paths=None):
    """One entry per kernel, its times summed over one step of its main
    route (fused: 3 conv chains, 2 without bc and 1 with, the 7 stages once
    each; dense: the 7 banded solves; meshed: the 37 pencil flips, each
    timed at its own shape, with the L2 flushed, and ``warm_ms`` back to
    back beside it, ``in_step_ms`` their device time inside the profiled
    replays of phase 13), and, for the banded
    kernel, the 7 solves of a meshed step beside them (``mesh_*``); the
    banded and the flip kernels' backward (``backward_*``: the same kernel
    launched as its own adjoint, summed over the same step's launches, and
    the launches of a 129^2 gradient).
    ``launches[route][kernel]`` is the count of that route's counted run;
    ``runner_launches[kernel]`` (``runner_launches`` in the entry) the
    count of phase 31's runs under the resilient runner, and
    ``phase_launches[label][kernel]`` (``<label>_launches``) that of a later
    phase's path (``sharded``: phase 32; ``controllers``: phase 33's two
    processes); ``paths`` phase 38's launches a process of each path
    (``span_paths_launches`` of the banded and the remote flip's entries)."""
    out = []
    for kernel, (source, replaces) in KERNEL_META.items():
        rows = [r for r in records if r["kernel"] == kernel]
        main = MAIN_ROUTE[kernel]
        entry = {
            "name": kernel, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches[main][kernel],
            "max_abs_err": max(r["max_abs_err"] for r in rows),
            "max_rel_err": max(r["max_rel_err"] for r in rows),
            **route_sums([r for r in rows if r["route"] == main]),
            "per": f"one step of rbc1025 f64 on {ROUTE_NAME[main]}",
        }
        for route in sorted({r["route"] for r in rows if r["per_step"]} - {main}):
            sums = route_sums([r for r in rows if r["route"] == route])
            entry.update({f"{route}_{k}": v for k, v in sums.items() if k != "bound_by"})
            entry[f"{route}_launches"] = launches[route][kernel]
        for route in sorted(set(launches) - {main}):
            entry.setdefault(f"{route}_launches", launches[route].get(kernel, 0))
        if kernel == "banded_solve":
            entry.update(solver_times)
        if kernel == "ring_transpose":
            entry.update(ring_times)
        entry["runner_launches"] = runner_launches.get(kernel, 0)
        for label, counts in (phase_launches or {}).items():
            entry[f"{label}_launches"] = counts.get(kernel, 0)
        if paths is not None and kernel == "banded_solve":
            entry["span_paths_launches"] = span_paths_launches(paths, kernel)
        out.append(entry)
    if span is not None:
        out.append(remote_flip_entry(span))
        if paths is not None:
            out[-1]["span_paths_launches"] = span_paths_launches(paths, "ring_push")
    return {"kernels": out}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "rustpde_mpi_tpu_torch")):
        print("chip_smoke: the rustpde_mpi_tpu_torch package is not beside this script", file=sys.stderr)
        return 2
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # the save-window callbacks write data/info.txt into the working directory
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as work:
        os.chdir(work)
        try:
            return run(torch)
        finally:
            os.chdir(ROOT)


def run(torch) -> int:
    import rustpde_mpi_tpu_torch as pt
    from rustpde_mpi_tpu_torch.ops import _build

    card = card_line()
    kind = torch.cuda.get_device_name(0)
    print(f"card: {card}")
    print(f"torch {torch.__version__} cuda {torch.version.cuda} python {sys.version.split()[0]}")
    try:  # information for the checkpoint writers (HDF5), not a gate
        import h5py

        print(f"h5py: importable, version {h5py.__version__}")
    except ImportError as exc:
        print(f"h5py: not importable ({exc})")
    t0 = time.perf_counter()
    built = _build.build()
    print(f"kernel build: {time.perf_counter() - t0:.2f} s wall "
          + " ".join(f"{k}={v['seconds']:.2f}s" for k, v in built.items()))
    for name, info in built.items():
        for kernel, regs, spills in ptxas_summary(info["log"]):
            print(f"  ptxas {name}: {kernel}: {regs}; {spills}")

    t0 = time.perf_counter()
    main_model = pt.Navier2D.new_confined(**RBC1025, device="cuda")
    print(f"rbc1025 model build: {time.perf_counter() - t0:.2f} s")
    small = {dt: pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device="cuda", dtype=dt)
             for dt in (torch.float64, torch.float32)}
    phase_kernels(torch, small[torch.float64], 1e-12, False)
    phase_kernels(torch, small[torch.float32], 1e-4, False)
    print("phase1 tiles: " + json.dumps(tile_config()))
    records = phase_kernels(torch, main_model, 1e-12, True)
    print("phase1 ok")
    phase_golden(pt)
    phase_card_vs_cpu(pt)
    launches, bare_ms = {}, {}
    launches["fused"], bare_ms["fused"] = phase_main(torch, pt, main_model)
    phase_callback_cost(torch, pt, main_model, card)
    phase_profile(torch, main_model, bare_ms["fused"])
    phase_chunks(torch, pt, main_model)
    phase_ensemble1025(torch, pt, main_model, "fused", records, launches, bare_ms)
    checkpoint_roundtrip(torch, pt, main_model, pt.Navier2D(**RBC1025, device="cuda"), "rbc1025",
                         card)
    phase_stats_main(torch, pt, main_model, card)
    main_model.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
    phase_set_dt(torch, pt, main_model, card)
    phase_governed(torch, pt, main_model, card)
    del main_model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dense_model = pt.Navier2D.new_confined(**RBC1025, device="cuda", **DENSE)
    print(f"rbc1025 dense-route model build: {time.perf_counter() - t0:.2f} s")
    for dt in (torch.float64, torch.float32):
        small = pt.Navier2D(129, 129, 1e7, 1.0, 2e-3, 1.0, "rbc", device="cuda", dtype=dt, **DENSE)
        phase_banded(torch, pt, small, 1e-12 if dt == torch.float64 else 1e-4, False)
    records += phase_banded(torch, pt, dense_model, 1e-12, True)
    print("phase6 ok")
    phase_mms(torch, pt)
    phase_golden(pt, "phase8", **DENSE)
    phase_card_vs_cpu(pt, "phase9", **DENSE)
    launches["dense"], bare_ms["dense"] = phase_main(torch, pt, dense_model, "phase10")
    phase_profile(torch, dense_model, bare_ms["dense"], phase="phase10")
    phase_chunks(torch, pt, dense_model)
    solver_times = phase_solvers(torch, pt, dense_model)
    phase_ensemble1025(torch, pt, dense_model, "dense", records, launches, bare_ms)
    phase_stats_main(torch, pt, dense_model, card)
    dense_model.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
    phase_set_dt(torch, pt, dense_model, card)
    del dense_model
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    mesh = pt.make_mesh(MESH_RANKS)
    mesh_model = pt.Navier2D.new_confined(**RBC1025, mesh=mesh)
    print(f"rbc1025 meshed-route model build ({mesh}): {time.perf_counter() - t0:.2f} s")
    mesh_flips, solves, inputs = phase_step_inputs(torch, mesh_model, "phase12")
    records += phase_ring(torch, pt, mesh, mesh_flips, square_ring_checks(torch, MESH_RANKS))
    records += phase_mesh_banded(torch, mesh_model, solves, inputs, 1e-12)
    del inputs
    print("phase12 ok")
    phase_golden(pt, "phase13", mesh=pt.make_mesh(MESH_RANKS))
    phase_meshed_vs_serial(pt)
    launches["mesh"], bare_ms["mesh"] = phase_main(torch, pt, mesh_model, "phase13")
    by_kernel = phase_profile(torch, mesh_model, bare_ms["mesh"], phase="phase13")
    # the flips' device time inside a replayed meshed step (the profile's
    # 37 launches a step), beside their cold and warm times alone (phase 12)
    flips_in_step = None if by_kernel is None else sum(
        t for name, t in by_kernel.items() if "ring_transpose_kernel" in name)
    print(f"phase13 flips in a replayed meshed rbc1025 step: {flips_in_step} ms/step")
    phase_chunks(torch, pt, mesh_model)
    phase_ensemble1025(torch, pt, mesh_model, "mesh", records, launches, bare_ms)
    checkpoint_roundtrip(torch, pt, mesh_model,
                         pt.Navier2D(**RBC1025, mesh=pt.make_mesh(MESH_RANKS)), "rbc1025", card)
    phase_stats_main(torch, pt, mesh_model, card)
    mesh_model.set_stats(pt.StatsConfig(stride=STATS_STRIDE))
    phase_set_dt(torch, pt, mesh_model, card)
    del mesh_model, mesh
    torch.cuda.empty_cache()

    # the periodic cell, fused route then dense route
    for route in ("fused", "dense"):
        t0 = time.perf_counter()
        model = pt.Navier2D(**PERIODIC1024, device="cuda", step_kernel=route, conv_kernel=route)
        model.init_random(0.1, seed=0)
        print(f"periodic1024 {route}-route model build: {time.perf_counter() - t0:.2f} s; "
              f"Chebyshev transform method {model.method!r}")
        for dt in (torch.float64, torch.float32):
            small = pt.Navier2D(**PERIODIC128, device="cuda", dtype=dt, step_kernel=route,
                                conv_kernel=route)
            limit = 1e-12 if dt == torch.float64 else 1e-4
            if route == "fused":
                phase_kernels(torch, small, limit, False, "phase15")
            else:
                phase_banded(torch, pt, small, limit, False, "phase15")
        if route == "fused":
            records += phase_kernels(torch, model, 1e-12, True, "phase15")
        else:
            records += phase_banded(torch, pt, model, 1e-12, True, "phase15")
        print(f"phase15 {route} ok")
        if route == "fused":
            phase_periodic_small(pt)
        key = f"periodic_{route}"
        launches[key], bare_ms[key] = phase_main(torch, pt, model, "phase18")
        if route == "fused":
            phase_callback_cost(torch, pt, model, card)
        phase_profile(torch, model, bare_ms[key], phase="phase18")
        phase_chunks(torch, pt, model)
        if route == "fused":
            fresh = pt.Navier2D(**PERIODIC1024, device="cuda", step_kernel=route,
                                conv_kernel=route)
            checkpoint_roundtrip(torch, pt, model, fresh, "periodic1024", card)
            del fresh
        del model
        torch.cuda.empty_cache()
    phase_periodic_mesh(torch, pt, records, launches, bare_ms)
    torch.cuda.empty_cache()
    phase_hc1025(torch, pt, records, launches, bare_ms)
    phase_hc_small(pt)
    phase_scn1025(torch, pt, records, launches, bare_ms)
    phase_scn_small(pt)
    phase_ensemble129(torch, pt, records, launches)
    phase_sweep(torch, pt)
    phase_checkpoints(torch, pt, card)
    phase_stats_small(pt)
    phase_stats_ensemble(torch, pt, card)
    print("phase28 ok")
    phase_methods(torch, pt)
    solver_times.update(phase29(torch, pt))
    ring_times = phase30(torch, pt, mesh_flips, card)
    ring_times["in_step_ms"] = flips_in_step
    runner_launches = phase31(torch, pt, card)
    phase_launches = {"sharded": phase32(torch, pt, card),
                      "controllers": phase33(torch, pt, card)}
    phase_launches["serve"] = phase34(torch, pt, card)
    phase_launches["soak"] = phase35(torch, pt, card)
    phase_launches["fleet"] = phase36(torch, pt, card)
    span = phase37(torch, pt, card, [r for r in records if r["kernel"] == "ring_transpose"
                                     and r["route"] in ("mesh", "periodic_mesh")])
    paths = phase38(torch, pt, card)
    print("phase38 launches a process of each path: " + json.dumps(
        {k: span_paths_launches(paths, k) for k in ("ring_push", "banded_solve")}))
    print(f"card: {card}")
    print(json.dumps(kernels_line(records, launches, solver_times, ring_times, runner_launches,
                                  phase_launches, span, paths)))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
