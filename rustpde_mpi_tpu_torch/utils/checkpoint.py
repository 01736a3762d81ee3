"""HDF5 checkpoint and restart in the reference's snapshot layout, the
gathered format (counterpart of the JAX package's ``utils/checkpoint.py``,
whose files this module writes and reads dataset for dataset):

* per-variable groups ``{var}/{x,dx,y,dy,v,vhat}`` with the variables
  ``ux, uy, temp, pres`` (``scal`` with a passive scalar) and ``tempbc``,
  the BC lift; complex spectral data as ``vhat_re``/``vhat_im`` pairs;
  fields stored in float64 whatever the working dtype;
* ``time`` and the physics parameters (``ra, pr, nu, ka``) as float64
  scalars at the file root; an ensemble's groups ``member{i}`` plus
  ``members`` and ``steps_done`` (int64) and ``alive`` (int8);
* with the statistics engine armed, its running sums and sample tick as
  ``stats_state/{leaf}`` and ``stats_state/tick``, raw in their exact
  dtypes (a restore is bit for bit; a file without them, or of another
  resolution, restarts the averaging window);
* a restart restores the spectral coefficients and ``time``, with
  truncation or zero-padding on a resolution change
  (:func:`interpolate_2d`).  ``pseu`` is not stored; a restart fills it,
  and any other leaf the file does not carry, through the model's
  ``restart_fill`` (zero), so a restarted run is restart-equivalent, not
  bit for bit the uninterrupted one.

A checkpoint is staged and written in two parts.  :func:`snapshot_to_host`
(:func:`ensemble_snapshot_to_host`) is the only part that touches the
model: it runs the backward transforms on the model's device, gathers a
meshed model's pencils, and copies everything to host numpy arrays, a
:class:`HostSnapshot`.  :func:`write_host_snapshot` serializes that with
``h5py``.  Reading is split the same way: :func:`read_snapshot` opens and
verifies a file, and the restore itself reads any h5-like group, so a
:class:`HostSnapshot` restores through the same code as the file
(:func:`_host_group`).  ``h5py`` is imported only inside the functions
that open files: staging, :func:`snapshot_digest` and the in-memory
restore run where it is not installed.

Durability, as the JAX package's: every write is atomic (a
``<name>.<pid>.tmp`` sibling, flushed and fsynced, ``os.replace``d over the
target, the directory fsynced); files carry the root attrs ``digest``
(SHA-256 over every dataset's path, dtype, shape and bytes, in sorted
path order), ``schema``, ``time``, ``dt`` and an optional ``step``; a
reader verifies the digest first, and a truncated or malformed file raises
:class:`CheckpointError` naming the file and what is missing.

Sharded two-phase checkpoints, the JAX package's layout file for file: each
process writes the slabs it owns of every logical state leaf (global
coordinates, complex leaves as ``_re``/``_im`` pairs, exact dtypes) to
``<manifest>.shard<p>`` (:func:`write_shard_file`), the processes exchange
digests, and the root writes the manifest whose presence commits the
checkpoint (:func:`commit_sharded_snapshot`).  A serial model's leaf is one
slab; on a :class:`..parallel.Mesh` each rank's owned region (its x-pencil
columns, the pencil padding cut off) is one; each distinct region is
written once, by the lowest process holding it (every process of the
port holds its whole model, so process 0 writes them all and the others
write empty shards).  The restore (:func:`read_sharded_snapshot`) is
topology-elastic: it assembles each leaf from a slab catalog, whatever
mesh, process count or member layout wrote it, and places it as the
target model holds it; a resolution, dtype or member-count mismatch is
refused, and a missing or corrupt shard fails the whole checkpoint.  The
catalog can also be filled from staged :class:`ShardSnapshot` objects in
memory (:func:`restore_sharded_snapshots`), which needs no ``h5py``.
Parked continuations (``parked/<id>/``, :func:`write_continuation`) ride
the same two phases.
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
import os
from contextlib import ExitStack, contextmanager

import numpy as np
import torch

from ..bases import BaseKind
from ..field import grid_deltas
from .fsutil import atomic_write_text, fsync_dir

_VARS = (("ux", "velx"), ("uy", "vely"), ("temp", "temp"), ("pres", "pres"))

#: bump when the on-disk layout changes incompatibly; readers accept files
#: without the attr unchanged
SCHEMA_VERSION = 1

_CKPT_PREFIX = "ckpt_"
_CKPT_SUFFIX = ".h5"

#: root dataset of a sharded checkpoint's manifest
_MANIFEST_DS = "sharded_manifest"


class CheckpointError(RuntimeError):
    """A checkpoint file is malformed, truncated or corrupt, or is in a
    form this package does not read.  Carries the offending ``filename``
    and a cause naming the missing group/dataset or the failed check."""

    def __init__(self, filename: str, message: str):
        super().__init__(f"{filename}: {message}")
        self.filename = filename


def _digest_update(digest, name: str, data: np.ndarray) -> None:
    digest.update(name.encode("utf-8") + b"\0")
    digest.update(str(data.dtype).encode() + b"\0")
    digest.update(str(data.shape).encode() + b"\0")
    digest.update(data.tobytes())


def content_digest(h5) -> str:
    """SHA-256 over every dataset of an open file (path, dtype, shape and
    raw bytes, in sorted path order).  Root attrs are left out, so the
    digest can be stored as one."""
    import h5py

    paths: list[str] = []

    def visit(name, obj):
        if isinstance(obj, h5py.Dataset):
            paths.append(name)

    h5.visititems(visit)
    digest = hashlib.sha256()
    for name in sorted(paths):
        _digest_update(digest, name, np.ascontiguousarray(h5[name][()]))
    return digest.hexdigest()


def _attrs_of(h5) -> dict:
    return {key: (val.decode() if isinstance(val, bytes) else val)
            for key, val in h5.attrs.items()}


def _verify_open_file(h5, filename: str) -> dict:
    """Digest-check an open file; returns its root attrs (a file without a
    digest passes unverified)."""
    attrs = _attrs_of(h5)
    stored = attrs.get("digest")
    if stored is not None and content_digest(h5) != stored:
        raise CheckpointError(filename,
                              "content digest mismatch (bit rot or a partially copied file)")
    return attrs


@contextmanager
def _open_checkpoint(filename: str):
    """Open a snapshot for reading: h5py's bare ``OSError`` (a truncated or
    partial file, not HDF5) and an unhandled ``KeyError`` (a missing root
    dataset) surface as :class:`CheckpointError` naming the file."""
    import h5py

    try:
        with h5py.File(filename, "r") as h5:
            yield h5
    except CheckpointError:
        raise
    except KeyError as exc:
        raise CheckpointError(filename, f"missing root dataset {exc.args[0]!r}") from exc
    except OSError as exc:
        raise CheckpointError(
            filename, f"unreadable HDF5 file (likely a truncated/partial write): {exc}") from exc


def read_attrs(filename: str) -> dict:
    """Root attrs of a snapshot without the digest pass."""
    with _open_checkpoint(filename) as h5:
        return _attrs_of(h5)


def is_sharded_checkpoint(filename: str) -> bool:
    """True when ``filename`` is a sharded checkpoint's manifest (an attr
    sniff, no digest pass)."""
    try:
        return bool(read_attrs(filename).get("sharded"))
    except CheckpointError:
        return False


def verify_snapshot(filename: str) -> dict:
    """Open and digest-verify a snapshot; returns its root attrs.  For a
    sharded checkpoint's manifest the check is end to end: the manifest's
    own digest, then every shard file of its shard map (present, readable,
    its content hashing to the digest both the manifest and the shard
    record), so any missing or corrupt shard rejects the whole checkpoint.
    Raises :class:`CheckpointError` when the file is unreadable or a hash
    does not match."""
    with _open_checkpoint(filename) as h5:
        attrs = _verify_open_file(h5, filename)
        meta = _read_manifest_meta(h5, filename) if attrs.get("sharded") else None
    if meta is not None:
        _verify_shard_set(filename, meta)
    return attrs


def read_root_data(filename: str) -> dict:
    """The root-level datasets of a snapshot as numpy arrays (``time``, the
    parameters, an ensemble's ``members``/``alive``/``steps_done``), with
    no state read."""
    out: dict[str, np.ndarray] = {}
    with _open_checkpoint(filename) as h5:
        for name, obj in h5.items():
            if name != _MANIFEST_DS and hasattr(obj, "shape"):
                out[name] = np.asarray(obj)
    return out


@dataclasses.dataclass
class HostSnapshot:
    """A snapshot fetched to host memory, not yet on disk.

    ``datasets`` is an ordered list of ``(h5path, array, kind)``: ``kind``
    ``"field"`` is stored in float64, a complex array split into
    ``_re``/``_im``; ``"raw"`` keeps the array's exact dtype (counters,
    masks, scalars).  The object holds no tensor: serializing it, hashing
    it or restoring from it needs no device."""

    datasets: list
    step: int | None = None
    time: float | None = None
    dt: float | None = None

    @property
    def nbytes(self) -> int:
        return sum(int(np.asarray(d).nbytes) for _, d, _ in self.datasets)


def _stored_arrays(path: str, data, kind: str) -> list:
    """The ``(name, array)`` pairs exactly as the writers lay them down on
    disk: the complex split and float64 cast for ``"field"`` entries, the
    identity for ``"raw"`` ones."""
    if kind != "field":
        return [(path, np.ascontiguousarray(data))]
    if np.iscomplexobj(data):
        return [
            (f"{path}_re", np.asarray(np.ascontiguousarray(data.real), dtype=np.float64)),
            (f"{path}_im", np.asarray(np.ascontiguousarray(data.imag), dtype=np.float64)),
        ]
    return [(path, np.asarray(data, dtype=np.float64))]


def snapshot_digest(datasets) -> str:
    """The :func:`content_digest` a file holding ``datasets`` will have,
    computed from the in-memory arrays (numpy and ``hashlib`` only): the
    stored forms (:func:`_stored_arrays`) hashed in sorted path order."""
    expanded = []
    for path, data, kind in datasets:
        expanded.extend(_stored_arrays(path, data, kind))
    digest = hashlib.sha256()
    for name, arr in sorted(expanded, key=lambda kv: kv[0]):
        _digest_update(digest, name, np.ascontiguousarray(arr))
    return digest.hexdigest()


def _atomic_h5_write(filename: str, body, step: int | None = None,
                     time: float | None = None, dt: float | None = None,
                     digest_items=None, digest: str | None = None) -> None:
    """Write an HDF5 file atomically: ``body(h5)`` fills a ``.tmp``
    sibling, the root attrs (schema, step, time, dt and the content digest:
    ``digest`` when given, else from ``digest_items``, else read back) are
    stamped, the file is flushed and fsynced, ``os.replace``d over the
    target, and the directory fsynced (strictly: a failed dirsync fails
    the write)."""
    import h5py

    dirname = os.path.dirname(filename) or "."
    os.makedirs(dirname, exist_ok=True)
    tmp = f"{filename}.{os.getpid()}.tmp"
    try:
        with h5py.File(tmp, "w") as h5:
            body(h5)
            h5.attrs["schema"] = SCHEMA_VERSION
            if step is not None:
                h5.attrs["step"] = int(step)
            if time is not None:
                h5.attrs["time"] = float(time)
            if dt is not None:
                h5.attrs["dt"] = float(dt)
            if digest is None:
                digest = (snapshot_digest(digest_items) if digest_items is not None
                          else content_digest(h5))
            h5.attrs["digest"] = digest
            h5.flush()
        fd = os.open(tmp, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)
        os.replace(tmp, filename)
        fsync_dir(dirname, strict=True)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


# -- the rolling window --------------------------------------------------------


def checkpoint_path(run_dir: str, step: int) -> str:
    """Canonical rolling-checkpoint name ``<run_dir>/ckpt_<step:010d>.h5``
    (name-sortable by step)."""
    return os.path.join(run_dir, f"{_CKPT_PREFIX}{int(step):010d}{_CKPT_SUFFIX}")


def checkpoint_files(run_dir: str) -> list[str]:
    """The rolling checkpoints in ``run_dir``, oldest first; ``.tmp``
    leftovers of interrupted writes are left out."""
    try:
        names = os.listdir(run_dir)
    except OSError:
        return []
    return [os.path.join(run_dir, n) for n in sorted(names)
            if n.startswith(_CKPT_PREFIX) and n.endswith(_CKPT_SUFFIX)]


def latest_checkpoint(run_dir: str) -> str | None:
    """The newest checkpoint in ``run_dir`` that passes
    :func:`verify_snapshot`; a corrupt or partial file is skipped with a
    message, so a resume falls back to the one before."""
    for path in reversed(checkpoint_files(run_dir)):
        try:
            verify_snapshot(path)
        except CheckpointError as exc:
            print(f"skipping corrupt checkpoint: {exc}")
            continue
        return path
    return None


def shard_path(manifest: str, index: int) -> str:
    """Process ``index``'s shard file of a sharded checkpoint,
    ``<manifest>.shard<p>`` (the suffix keeps it out of
    :func:`checkpoint_files`: only the manifest is a resume candidate)."""
    return f"{manifest}.shard{int(index)}"


def checkpoint_shard_files(manifest: str) -> list[str]:
    """Every shard file belonging to ``manifest`` (committed or orphaned)."""
    dirname = os.path.dirname(manifest) or "."
    base = os.path.basename(manifest) + ".shard"
    try:
        names = os.listdir(dirname)
    except OSError:
        return []
    return [os.path.join(dirname, n) for n in sorted(names) if n.startswith(base)]


def remove_checkpoint(manifest: str) -> None:
    """Remove one checkpoint: the file (a sharded manifest, the commit
    marker) first, then any shard files of it."""
    for path in [manifest, *checkpoint_shard_files(manifest)]:
        try:
            os.remove(path)
        except OSError:
            pass


def rotate_checkpoints(run_dir: str, keep: int) -> list[str]:
    """Prune the rolling window to the newest ``keep`` checkpoints; returns
    the removed paths (``keep <= 0`` keeps everything).  Orphan shard
    files, whose manifest never landed, are swept once their step falls
    below the oldest kept checkpoint (those at or above it may be a write
    in flight)."""
    removed = []
    if keep <= 0:
        return removed
    files = checkpoint_files(run_dir)
    for path in files[:-keep] if len(files) > keep else []:
        remove_checkpoint(path)
        removed.append(path)
    kept = checkpoint_files(run_dir)
    if kept:
        oldest_kept = os.path.basename(kept[0])
        try:
            names = os.listdir(run_dir)
        except OSError:
            names = []
        for name in names:
            stem, sep, _ = name.partition(_CKPT_SUFFIX + ".shard")
            if not sep:
                continue
            manifest = stem + _CKPT_SUFFIX
            if manifest < oldest_kept and manifest not in names:
                try:
                    os.remove(os.path.join(run_dir, name))
                except OSError:
                    pass
    return removed


# -- fields ----------------------------------------------------------------------


def _write_array(group, name: str, data: np.ndarray) -> None:
    if np.iscomplexobj(data):
        _write_array(group, f"{name}_re", np.ascontiguousarray(data.real))
        _write_array(group, f"{name}_im", np.ascontiguousarray(data.imag))
        return
    if name in group:
        del group[name]
    group.create_dataset(name, data=np.asarray(data, dtype=np.float64))


def _missing(group, name: str) -> CheckpointError:
    filename = getattr(getattr(group, "file", None), "filename", "<h5>")
    where = f"{group.name.rstrip('/')}/{name}"
    return CheckpointError(filename, f"missing group/dataset {where!r} — truncated write or a "
                           "file that is not a snapshot in this layout")


def _read_array(group, name: str, is_complex: bool) -> np.ndarray:
    try:
        if is_complex:
            return np.asarray(group[f"{name}_re"]) + 1j * np.asarray(group[f"{name}_im"])
        return np.asarray(group[name])
    except KeyError as exc:
        raise _missing(group, f"{name}_re/_im" if is_complex else name) from exc


def interpolate_2d(old: np.ndarray, new_shape: tuple[int, int], kind_x: BaseKind,
                   old_nx: int | None = None, new_nx: int | None = None) -> np.ndarray:
    """Spectral interpolation on a resolution change: truncate or zero-pad
    the coefficient array.

    The r2c forward is amplitude-normalized (rfft/n), so coefficients do
    not scale with the grid and need no renormalization.  The r2c axis
    needs the Nyquist bookkeeping (``old_nx``/``new_nx`` are the physical
    grid sizes): an even grid's Nyquist coefficient counts cos(Nx) once, so
    when it becomes a regular +k mode of the new grid it is halved, and
    when a regular +k/-k pair lands on the new grid's Nyquist it folds to
    twice its real part.  This covers a change that keeps the spectral
    shape and flips the grid's parity (nx 16 -> 17)."""
    new = np.zeros(new_shape, dtype=old.dtype)
    s0 = min(old.shape[0], new_shape[0])
    s1 = min(old.shape[1], new_shape[1])
    new[:s0, :s1] = old[:s0, :s1]
    if kind_x == BaseKind.FOURIER_R2C:
        if old_nx is None:
            import warnings

            warnings.warn("r2c restart interpolation without the source grid size (missing 'x' "
                          "dataset): assuming an even source grid for Nyquist-mode bookkeeping",
                          stacklevel=2)
            old_nx = 2 * (old.shape[0] - 1)
        old_nyq = old.shape[0] - 1 if old_nx % 2 == 0 else None
        new_nyq = new_shape[0] - 1 if new_nx is not None and new_nx % 2 == 0 else None
        if old_nyq is not None and old_nyq < s0 and old_nyq != new_nyq:
            new[old_nyq, :] *= 0.5  # old Nyquist -> regular +k mode
        if new_nyq is not None and new_nyq < s0 and new_nyq != old_nyq:
            new[new_nyq, :] = 2.0 * new[new_nyq, :].real  # +-k fold onto Nyquist
    return new


def _host(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def write_field(h5, varname: str, space, vhat: torch.Tensor, x, dx) -> None:
    """Write one field group in the reference layout (a meshed space's
    pencils gathered first)."""
    grp = h5.require_group(varname)
    _write_array(grp, "x", x[0])
    _write_array(grp, "dx", dx[0])
    _write_array(grp, "y", x[1])
    _write_array(grp, "dy", dx[1])
    _write_array(grp, "v", _host(space.gather_physical(space.backward(vhat))))
    _write_array(grp, "vhat", space.vhat_as_complex(vhat))


def read_field_vhat(h5, varname: str, space) -> np.ndarray:
    """One field's spectral coefficients from a snapshot group, as a host
    array in the complex convention, interpolated to ``space``'s spectral
    shape on a mismatch (or on an r2c grid-parity flip).  A missing group
    or dataset raises :class:`CheckpointError`."""
    try:
        grp = h5[varname]
    except KeyError as exc:
        raise _missing(h5, varname) from exc
    data = _read_array(grp, "vhat", space.spectral_is_complex)
    old_nx = grp["x"].shape[0] if "x" in grp else None
    kind_x = space.bases[0].kind
    target_shape = space.shape_spectral
    # interpolate on a shape mismatch, and when the shapes agree but the r2c
    # grid's parity changed (nx 16 -> 17 keeps m = 9, re-typing the Nyquist row)
    parity_flip = (kind_x == BaseKind.FOURIER_R2C and old_nx is not None
                   and old_nx % 2 != space.shape_physical[0] % 2)
    if data.shape != target_shape or parity_flip:
        data = interpolate_2d(data, target_shape, kind_x, old_nx=old_nx,
                              new_nx=space.shape_physical[0])
    return data


# -- staging ---------------------------------------------------------------------


def _model_coords(model):
    xs = model.x  # the scaled coordinates the model derived
    dxs = [grid_deltas(b.points, b.is_periodic) * s
           for b, s in zip(model.field_space.bases, model.scale)]
    return xs, dxs


def _field_host_datasets(path: str, space, vhat, v_phys, x, dx) -> list:
    """Host dataset list of one variable group, exactly the layout
    :func:`write_field` lays down (``v_phys`` the physical field as the
    space holds it; both are gathered and copied to the host here)."""
    return [
        (f"{path}/x", np.asarray(x[0]), "field"),
        (f"{path}/dx", np.asarray(dx[0]), "field"),
        (f"{path}/y", np.asarray(x[1]), "field"),
        (f"{path}/dy", np.asarray(dx[1]), "field"),
        (f"{path}/v", _host(space.gather_physical(v_phys)), "field"),
        (f"{path}/vhat", space.vhat_as_complex(vhat), "field"),
    ]


def _param_datasets(model) -> list:
    return [(key, np.asarray(float(value), dtype=np.float64), "raw")
            for key, value in model.params.items()]


def snapshot_to_host(model, step: int | None = None) -> HostSnapshot:
    """Stage a flow snapshot in host memory, touching no disk: every
    backward transform is queued on the model's device first, then the
    physical fields and the coefficients are gathered (a meshed model's
    pencils) and copied to the host."""
    xs, dxs = _model_coords(model)
    model_vars = getattr(model, "snapshot_vars", _VARS)
    phys = {attr: getattr(model, f"{attr}_space").backward(getattr(model.state, attr))
            for _, attr in model_vars}
    tempbc = getattr(model, "tempbc_ortho", None)
    phys_bc = model.field_space.backward(tempbc) if tempbc is not None else None
    datasets: list = []
    for varname, attr in model_vars:
        space = getattr(model, f"{attr}_space")
        datasets += _field_host_datasets(varname, space, getattr(model.state, attr),
                                         phys[attr], xs, dxs)
    if tempbc is not None:
        datasets += _field_host_datasets("tempbc", model.field_space, tempbc, phys_bc, xs, dxs)
    datasets.append(("time", np.asarray(float(model.time), dtype=np.float64), "raw"))
    datasets += _param_datasets(model)
    # the statistics engine's running sums and tick (raw, exact dtypes),
    # when it is armed
    stats_items = getattr(model, "stats_host_items", None)
    if stats_items is not None:
        datasets.extend(stats_items())
    return HostSnapshot(datasets=datasets, step=step, time=float(model.time),
                        dt=float(model.dt))


def ensemble_snapshot_to_host(ens, step: int | None = None) -> HostSnapshot:
    """The ensemble's :func:`snapshot_to_host`: per-member groups
    ``member{i}``, the shared ``tempbc`` once, and the root bookkeeping
    (``time``, ``members``, ``alive``, ``steps_done``, the parameters).
    Each field's backward transform runs once for all K members."""
    model = ens.model
    xs, dxs = _model_coords(model)
    model_vars = getattr(model, "snapshot_vars", _VARS)
    phys = {attr: getattr(model, f"{attr}_space").backward(getattr(ens.state, attr))
            for _, attr in model_vars}
    tempbc = getattr(model, "tempbc_ortho", None)
    phys_bc = model.field_space.backward(tempbc) if tempbc is not None else None
    datasets: list = []
    for i in range(ens.k):
        for varname, attr in model_vars:
            space = getattr(model, f"{attr}_space")
            datasets += _field_host_datasets(f"member{i}/{varname}", space,
                                             getattr(ens.state, attr)[i], phys[attr][i], xs, dxs)
    if tempbc is not None:
        datasets += _field_host_datasets("tempbc", model.field_space, tempbc, phys_bc, xs, dxs)
    datasets.append(("time", np.asarray(float(ens.time), dtype=np.float64), "raw"))
    datasets.append(("members", np.asarray(int(ens.k), dtype=np.int64), "raw"))
    datasets.append(("alive", _host(ens.mask).astype(np.int8), "raw"))
    datasets.append(("steps_done", _host(ens.steps_done).astype(np.int64), "raw"))
    datasets += _param_datasets(model)
    stats_items = getattr(ens, "stats_host_items", None)
    if stats_items is not None:
        datasets.extend(stats_items())
    return HostSnapshot(datasets=datasets, step=step, time=float(ens.time), dt=float(ens.dt))


# -- writing ---------------------------------------------------------------------


def write_host_snapshot(snap: HostSnapshot, filename: str) -> None:
    """Serialize a :class:`HostSnapshot` (needs ``h5py``): atomic, stamped
    with the digest of its in-memory arrays (no read-back pass)."""

    def body(h5):
        for path, data, kind in snap.datasets:
            gpath, _, name = path.rpartition("/")
            grp = h5.require_group(gpath) if gpath else h5
            if kind == "field":
                _write_array(grp, name, data)
            else:
                if name in grp:
                    del grp[name]
                grp.create_dataset(name, data=data)

    _atomic_h5_write(filename, body, step=snap.step, time=snap.time, dt=snap.dt,
                     digest_items=snap.datasets)


def write_snapshot(model, filename: str, step: int | None = None) -> None:
    """Write a flow snapshot: :func:`snapshot_to_host`, then
    :func:`write_host_snapshot`.  ``step``, an optional run-step counter,
    becomes a root attr.  On a mesh whose ranks span processes every
    process gathers (collective) and the root alone writes."""
    snap = snapshot_to_host(model, step=step)
    if writes_here(model):
        write_host_snapshot(snap, filename)


def writes_here(pde) -> bool:
    """Whether this process writes ``pde``'s gathered files: on a mesh whose
    ranks span processes every process gathers (collective) and the root
    alone writes; otherwise each process writes what it holds."""
    return not getattr(_pde_mesh(pde), "spanning", False) or _process_index() == 0


def write_ensemble_snapshot(ens, filename: str, step: int | None = None) -> None:
    """Write a K-member ensemble snapshot (:func:`ensemble_snapshot_to_host`,
    then :func:`write_host_snapshot`; the root's alone on a mesh whose ranks
    span processes)."""
    snap = ensemble_snapshot_to_host(ens, step=step)
    if writes_here(ens):
        write_host_snapshot(snap, filename)


# -- restoring -------------------------------------------------------------------


class _HostGroup:
    """A read-only h5-like group over stored arrays (``{path: array}``):
    ``group[name]`` gives a subgroup or an array, ``name in group`` tests
    for either."""

    def __init__(self, arrays: dict, name: str = "/"):
        self._arrays = arrays
        self.name = name

    def _path(self, key: str) -> str:
        prefix = self.name.strip("/")
        return f"{prefix}/{key}" if prefix else key

    def _is_group(self, path: str) -> bool:
        return any(k.startswith(path + "/") for k in self._arrays)

    def __contains__(self, key: str) -> bool:
        path = self._path(key)
        return path in self._arrays or self._is_group(path)

    def __getitem__(self, key: str):
        path = self._path(key)
        if path in self._arrays:
            return self._arrays[path]
        if self._is_group(path):
            return _HostGroup(self._arrays, "/" + path)
        raise KeyError(key)

    def __iter__(self):
        """The names of the group's members, as iterating an h5py group
        gives them."""
        prefix = self._path("")
        names = {k[len(prefix):].split("/", 1)[0] for k in self._arrays if k.startswith(prefix)}
        return iter(sorted(names))


def _host_group(snap: HostSnapshot) -> _HostGroup:
    """A :class:`HostSnapshot` as the root group of the file it writes:
    its datasets laid out by :func:`_stored_arrays` as the file stores
    them (a scalar 0-d, as its dataset reads back)."""
    arrays = {}
    for path, data, kind in snap.datasets:
        arrays.update((name, arr.reshape(np.shape(data)))
                      for name, arr in _stored_arrays(path, data, kind))
    return _HostGroup(arrays)


def _read_stats_group(group) -> dict | None:
    """The ``stats_state/`` raw datasets of a snapshot (None when absent)."""
    if "stats_state" not in group:
        return None
    grp = group["stats_state"]
    return {name: np.asarray(grp[name]) for name in grp}


def _restore_stats(pde, group) -> None:
    """Install a snapshot's statistics leaves on a model (or an ensemble)
    whose statistics engine is armed: a snapshot without them, or with
    leaves of another resolution or member count, restarts the window at
    zero (:meth:`..models.stats.StatsEngine.restore_state`)."""
    if not getattr(pde, "stats_armed", False):
        return
    pde.apply_restored_stats(_read_stats_group(group))


def _install_state(pde, state) -> None:
    """Replace ``pde.state`` (a model's or an ensemble's).  The captured
    chunks copy the state into their carry at each call, so they stay valid
    unless the state's fields, shapes or dtypes change; then they are
    dropped."""
    old = pde.state
    same = type(state) is type(old) and all(
        a.shape == b.shape and a.dtype == b.dtype for a, b in zip(state, old))
    if not same:
        pde._drop_chunks()
    pde.state = state
    pde._obs_cache = None


def _read_vars(model, group, base_vars: set) -> dict:
    """The state leaves of one snapshot group (the root, or an ensemble's
    ``member{i}``) as ``model`` holds them; a scenario leaf the group does
    not carry (``scal`` of an older snapshot) and every leaf the layout
    does not store (``pseu``) through ``model.restart_fill``."""
    updates = {}
    for varname, attr in getattr(model, "snapshot_vars", _VARS):
        space = getattr(model, f"{attr}_space")
        if varname not in group and attr not in base_vars:
            continue
        updates[attr] = space.vhat_from_complex(read_field_vhat(group, varname, space))
    for name in model.state._fields:
        if name not in updates:
            updates[name] = model.restart_fill(name, getattr(model.state, name))
    return updates


def _restore_snapshot(model, group) -> None:
    """Restore a model from a snapshot group (an open file's root, or
    :func:`_host_group` of a staged snapshot): the spectral coefficients,
    interpolated on a resolution change, and ``time``."""
    updates = _read_vars(model, group, {attr for _, attr in _VARS})
    time = float(np.asarray(group["time"]))
    _install_state(model, model.state._replace(**updates))
    model.time = time
    _restore_stats(model, group)


def _restore_ensemble_snapshot(ens, group) -> None:
    """Restore an ensemble from a snapshot group: the state, alive mask,
    step counts and time, at the group's member count (the captured chunks
    are dropped when it differs from the ensemble's).  Every member's
    variables are required."""
    model = ens.model
    k = int(np.asarray(group["members"]))
    state_cls = type(model.state)
    members = []
    for i in range(k):
        try:
            grp = group[f"member{i}"]
        except KeyError as exc:
            raise _missing(group, f"member{i}") from exc
        members.append(state_cls(**_read_vars(model, grp, set(state_cls._fields))))
    stacked = state_cls(*(torch.stack(xs) for xs in zip(*members)))
    dev = stacked.temp.device
    mask = torch.as_tensor(np.asarray(group["alive"], dtype=bool), device=dev)
    # the file stores int64 counts, the device int32 ones
    steps_done = torch.as_tensor(np.asarray(group["steps_done"]).astype(np.int32), device=dev)
    time = float(np.asarray(group["time"]))
    ens.k = k
    _install_state(ens, stacked)
    ens.mask, ens.steps_done, ens.time = mask, steps_done, time
    _restore_stats(ens, group)


def read_snapshot(model, filename: str) -> None:
    """Restore a flow snapshot (digest-verified when the file carries one;
    a malformed file raises :class:`CheckpointError`).  A sharded
    checkpoint's manifest goes to :func:`read_sharded_snapshot`."""
    if is_sharded_checkpoint(filename):
        read_sharded_snapshot(model, filename)
        return
    with _open_checkpoint(filename) as h5:
        _verify_open_file(h5, filename)
        _restore_snapshot(model, h5)
    print(f" <== {filename}")


def read_ensemble_snapshot(ens, filename: str) -> None:
    """Restore an ensemble snapshot written by :func:`write_ensemble_snapshot`
    (the member count may differ from the ensemble's: the state, mask and
    counts are rebuilt at the file's K; each member interpolates on a
    resolution change as a single restart does).  A sharded manifest goes to
    :func:`read_sharded_snapshot` (the same K, bit for bit)."""
    if is_sharded_checkpoint(filename):
        read_sharded_snapshot(ens, filename)
        return
    with _open_checkpoint(filename) as h5:
        _verify_open_file(h5, filename)
        _restore_ensemble_snapshot(ens, h5)
    print(f" <== {filename} ({ens.k} members)")


# -- sharded two-phase checkpoints --------------------------------------------------


def _process_index() -> int:
    from ..parallel.multihost import process_index

    return process_index()


def _process_count() -> int:
    from ..parallel.multihost import process_count

    return process_count()


def _shard_crash_hook(point: str, step, crash) -> None:
    """The deterministic crash inside the two-phase window: ``crash`` (a spec
    ``<after_shard|before_manifest>@<step>[:host<p>]``, the JAX package's
    ``RUSTPDE_SHARD_CRASH``, parsed strictly) hard-kills the matching
    process (``os._exit(9)``) when the writer reaches ``point`` for the
    checkpoint at ``step``:

    * ``after_shard``: this process's shard is fsynced and in place, the
      commit has not run;
    * ``before_manifest``: the root passed the barrier and the digest
      exchange but has not written the manifest (only the root reaches it)."""
    from .faults import parse_shard_crash_spec

    plan = parse_shard_crash_spec(crash)
    if plan is None or step is None:
        return
    want, at, host = plan
    if want != point or at != int(step):
        return
    if host is not None and _process_index() != host:
        return
    os._exit(9)


@dataclasses.dataclass
class StateLeaf:
    """One logical leaf of a sharded checkpoint as a model holds it:
    ``tensor`` (with ``lead`` member dims in front) is the global array, or,
    when ``space`` (a pencil space) is given, its rank-stacked x-pencils
    ``(..., P, n0p, n1p / P)`` with the pencil padding."""

    tensor: torch.Tensor
    space: object = None
    lead: int = 0

    @property
    def shape(self) -> tuple:
        if self.space is None:
            return tuple(int(s) for s in self.tensor.shape)
        return tuple(int(s) for s in self.tensor.shape[: self.lead]) + \
            tuple(int(s) for s in self.space.shape_spectral)

    @property
    def dtype(self) -> np.dtype:
        return torch.empty(0, dtype=self.tensor.dtype).numpy().dtype

    def slabs(self) -> list:
        """``[(offset, numpy_block), ...]``: the leaf's distinct regions in
        global coordinates (one device-to-host copy of the leaf, then
        views): the whole array, or each rank's owned columns (this
        process's ranks' on a mesh whose ranks span processes)."""
        host = self.tensor.detach().cpu().numpy()
        if self.space is None:
            return [((0,) * host.ndim, host)]
        n0, n1 = self.space.shape_spectral
        nranks, width = host.shape[-3], host.shape[-1]
        rank0 = self.space.mesh.rank0  # a spanning mesh's first rank here
        zeros = (0,) * self.lead
        out = []
        for r in range(nranks):
            c0, c1 = (rank0 + r) * width, min((rank0 + r + 1) * width, n1)
            if c1 <= c0:
                continue  # a rank that holds only padding
            block = host[..., r, :n0, : c1 - c0]
            out.append((zeros + (0, c0), np.ascontiguousarray(block)))
        return out


def _as_leaf(leaf) -> StateLeaf:
    return leaf if isinstance(leaf, StateLeaf) else StateLeaf(leaf)


def _storage_names(name: str, dtype) -> list[str]:
    """On-disk dataset names of one logical array: a complex one splits into
    a ``_re``/``_im`` float pair, a real one keeps its exact dtype."""
    if np.issubdtype(np.dtype(dtype), np.complexfloating):
        return [f"{name}_re", f"{name}_im"]
    return [name]


def _slab_ds_name(storage: str, offset: tuple) -> str:
    """A slab's dataset path in a shard file; the offset is in the NAME, so
    the shard's digest covers placement as well as bytes."""
    return f"{storage}/slab_" + "_".join(str(int(o)) for o in offset)


def _slab_offset_of(dsname: str) -> tuple | None:
    base = dsname.rsplit("/", 1)[-1]
    if not base.startswith("slab_"):
        return None
    try:
        return tuple(int(p) for p in base[len("slab_"):].split("_"))
    except ValueError:
        return None


@dataclasses.dataclass
class ShardSnapshot:
    """One process's share of a sharded checkpoint, fetched to the host.

    ``slabs`` is ``[(storage_path, offset, numpy_array), ...]`` (only the
    slabs this process owns), ``root_datasets`` the manifest's root data
    (:class:`HostSnapshot`-style tuples: time, parameters, an ensemble's
    bookkeeping, the integrity digest), ``meta`` the dataset catalog and the
    topology the root embeds in the manifest.  It holds no tensor: writing
    it (:func:`write_shard_file`) can run on a background worker."""

    shard_index: int
    shard_count: int
    slabs: list
    root_datasets: list
    meta: dict
    step: int | None = None
    time: float | None = None
    dt: float | None = None
    digest: str | None = None  # set once the shard is written (or staged)

    @property
    def nbytes(self) -> int:
        return sum(int(arr.nbytes) for _, _, arr in self.slabs)

    def items(self) -> list:
        """The shard file's datasets as ``(path, array, "raw")``."""
        return [(_slab_ds_name(storage, offset), arr, "raw")
                for storage, offset, arr in self.slabs]


def _pde_mesh(pde):
    mesh = getattr(pde, "mesh", None)
    if mesh is None and hasattr(pde, "model"):
        mesh = getattr(pde.model, "mesh", None)
    return mesh


def sharded_snapshot_to_host(pde, step: int | None = None) -> ShardSnapshot:
    """Fetch THIS process's shard of a model's or an ensemble's snapshot to
    the host (one device-to-host copy a leaf); no collective.  A model on a
    mesh whose ranks span processes gives each process its own ranks'
    slabs; a model every process holds whole, process 0 all of them."""
    proc = _process_index()
    mesh = _pde_mesh(pde)
    # a mesh whose ranks span processes: each writes its own ranks' slabs
    spanning = bool(getattr(mesh, "spanning", False))
    datasets_meta: dict[str, dict] = {}
    slabs: list = []
    for name, leaf in pde.snapshot_state_items():
        leaf = _as_leaf(leaf)
        dtype = leaf.dtype
        storage = _storage_names(name, dtype)
        datasets_meta[name] = {"shape": list(leaf.shape), "dtype": str(dtype),
                               "storage": storage}
        if proc != 0 and not (spanning and leaf.space is not None):
            # every process holds the whole leaf: the lowest owns it
            continue
        for offset, block in leaf.slabs():
            if len(storage) == 2:
                slabs.append((storage[0], offset, np.ascontiguousarray(block.real)))
                slabs.append((storage[1], offset, np.ascontiguousarray(block.imag)))
            else:
                slabs.append((storage[0], offset, block))
    meta = {"datasets": datasets_meta,
            "mesh": {"process_count": _process_count(),
                     "devices": int(mesh.nranks) if mesh is not None else 1,
                     "axes": ["p"] if mesh is not None else []}}
    return ShardSnapshot(shard_index=proc, shard_count=_process_count(), slabs=slabs,
                         root_datasets=pde.snapshot_root_items(), meta=meta, step=step,
                         time=float(pde.get_time()), dt=float(pde.get_dt()))


def write_shard_file(snap: ShardSnapshot, manifest: str, crash=None) -> str:
    """Phase one for one process: serialize ``snap``'s slabs to its shard
    file of ``manifest``, atomic and stamped with the digest of the
    in-memory slabs (no read-back); host work only.  Sets ``snap.digest``
    and returns the path.  ``crash``: the ``after_shard`` hook's spec."""
    filename = shard_path(manifest, snap.shard_index)
    items = snap.items()
    digest = snapshot_digest(items)

    def body(h5):
        for dspath, arr, _ in items:
            gpath, _, dname = dspath.rpartition("/")
            grp = h5.require_group(gpath) if gpath else h5
            grp.create_dataset(dname, data=arr)
        h5.attrs["shard_index"] = int(snap.shard_index)
        h5.attrs["shard_count"] = int(snap.shard_count)

    _atomic_h5_write(filename, body, step=snap.step, time=snap.time, dt=snap.dt, digest=digest)
    snap.digest = digest
    _shard_crash_hook("after_shard", snap.step, crash)
    return filename


def _pack_shard_report(snap: ShardSnapshot, ok: bool) -> np.ndarray:
    """(digest, nbytes, ok) as a fixed-size uint8 row for the allgather."""
    buf = np.zeros(41, np.uint8)
    if snap.digest is not None:
        buf[:32] = np.frombuffer(bytes.fromhex(snap.digest), np.uint8)
    buf[32:40] = np.frombuffer(np.int64(snap.nbytes).tobytes(), np.uint8)
    buf[40] = 1 if (ok and snap.digest is not None) else 0
    return buf


def exchange_shard_reports(snap: ShardSnapshot, local_ok: bool = True) -> dict:
    """The collective half of a commit before the manifest: the barrier
    (every shard durable), then one allgather of each process's digest,
    byte count and ok flag.  Returns ``{"ok", "digests", "nbytes",
    "barrier_s"}``; ``ok`` derives only from the gathered flags, so every
    process takes the same branch."""
    import time as _time

    from ..parallel import multihost

    t0 = _time.monotonic()
    multihost.sync_hosts("rustpde-ckpt-shards")
    barrier_s = _time.monotonic() - t0
    reports = np.atleast_2d(np.asarray(multihost.allgather_host(_pack_shard_report(snap, local_ok)),
                                       np.uint8))
    return {"ok": all(bool(row[40]) for row in reports),
            "digests": [bytes(row[:32]).hex() for row in reports],
            "nbytes": [int(np.frombuffer(bytes(row[32:40]), np.int64)[0]) for row in reports],
            "barrier_s": barrier_s}


def commit_sharded_snapshot(snap: ShardSnapshot, manifest: str, local_ok: bool = True,
                            crash=None, keep=None) -> dict:
    """Phase two (collective: every process calls it at the same point):
    :func:`exchange_shard_reports`, then the ROOT atomically writes the
    manifest, whose presence commits the checkpoint, and a second barrier
    keeps any process from acting on it before it exists.

    Returns ``{"ok", "shards", "bytes_host", "bytes_total", "barrier_s"}``;
    ``ok=False`` (a process failed its shard) means no manifest was written
    and the previous checkpoint is still the newest valid one.  ``crash``:
    the ``before_manifest`` hook's spec.  ``keep``: where the commit lands
    instead of the HDF5 manifest, called on every process after the root's
    ``before_manifest`` point (the in-memory store of
    :mod:`.resilience`)."""
    from ..parallel import multihost

    rep = exchange_shard_reports(snap, local_ok)
    stats = {"ok": rep["ok"], "shards": int(snap.shard_count), "bytes_host": int(snap.nbytes),
             "bytes_total": int(sum(rep["nbytes"])), "barrier_s": round(rep["barrier_s"], 3)}
    if not rep["ok"]:
        multihost.sync_hosts("rustpde-ckpt-abort")
        return stats
    root = _process_index() == 0
    if root:
        _shard_crash_hook("before_manifest", snap.step, crash)
    if keep is not None:
        keep()
    elif root:
        _write_manifest(snap, manifest, rep)
    multihost.sync_hosts("rustpde-ckpt-commit")
    return stats


def _write_manifest(snap: ShardSnapshot, manifest: str, rep: dict) -> None:
    """The root's manifest file: the root datasets, the shard list with
    each shard's digest and size, written atomically."""
    meta = dict(snap.meta)
    meta["shards"] = [{"file": os.path.basename(shard_path(manifest, i)), "process": i,
                       "digest": rep["digests"][i], "nbytes": rep["nbytes"][i]}
                      for i in range(snap.shard_count)]

    def body(h5):
        for path, data, kind in snap.root_datasets:
            gpath, _, name = path.rpartition("/")
            grp = h5.require_group(gpath) if gpath else h5
            if kind == "field":
                _write_array(grp, name, data)
            else:
                grp.create_dataset(name, data=data)
        h5.create_dataset(_MANIFEST_DS, data=np.bytes_(json.dumps(meta, sort_keys=True)))
        h5.attrs["sharded"] = int(snap.shard_count)

    _atomic_h5_write(manifest, body, step=snap.step, time=snap.time, dt=snap.dt)


def write_sharded_snapshot(pde, filename: str, step: int | None = None, crash=None) -> dict:
    """The blocking collective sharded checkpoint: stage this process's
    slabs, write and fsync its shard, then the two-phase commit.  Raises
    :class:`CheckpointError` on every process when ANY shard write failed
    (no manifest, the previous checkpoint intact); returns the commit
    stats."""
    snap = sharded_snapshot_to_host(pde, step=step)
    local_error: Exception | None = None
    try:
        write_shard_file(snap, filename, crash=crash)
    except Exception as exc:
        local_error = exc
    stats = commit_sharded_snapshot(snap, filename, local_ok=local_error is None, crash=crash)
    if not stats["ok"]:
        raise CheckpointError(
            filename, "sharded checkpoint aborted: a host failed its shard write "
            "(no manifest committed; the previous checkpoint is intact)"
            + (f"; local cause: {local_error}" if local_error else "")) from local_error
    return stats


def _read_manifest_meta(h5, filename: str) -> dict:
    try:
        raw = h5[_MANIFEST_DS][()]
    except KeyError as exc:
        raise _missing(h5, _MANIFEST_DS) from exc
    if isinstance(raw, np.ndarray):
        raw = raw.item()
    if isinstance(raw, bytes):
        raw = raw.decode("utf-8")
    try:
        return json.loads(raw)
    except ValueError as exc:
        raise CheckpointError(filename, f"unparseable manifest JSON: {exc}") from exc


def _verify_shard_set(manifest: str, meta: dict, full: bool = True) -> None:
    """Verify every shard ``meta`` names against its recorded digest;
    ``full=False`` checks presence and the shard's own digest stamp only
    (the non-root processes at a restore: the root's scan re-hashed the
    set already)."""
    dirname = os.path.dirname(manifest) or "."
    for entry in meta.get("shards", []):
        path = os.path.join(dirname, entry["file"])
        if not os.path.exists(path):
            raise CheckpointError(manifest, f"missing shard file {entry['file']!r} — the shard "
                                  "set is incomplete (partial copy or deleted shard)")
        with _open_checkpoint(path) as sh5:
            bad = _attrs_of(sh5).get("digest") != entry["digest"]
            if not bad and full:
                bad = content_digest(sh5) != entry["digest"]
            if bad:
                raise CheckpointError(manifest, f"shard {entry['file']!r} digest mismatch (bit "
                                      "rot or a partially copied shard)")


class _SlabCatalog:
    """Every slab of one shard set by storage path, each as ``(read,
    offset, shape)`` where ``read(selection)`` returns the selected part:
    the region reads of open shard files (:meth:`from_files`) or of staged
    :class:`ShardSnapshot` arrays (:meth:`from_snapshots`)."""

    def __init__(self):
        self.slabs: dict[str, list] = {}

    @classmethod
    def from_files(cls, stack: ExitStack, manifest: str, meta: dict) -> "_SlabCatalog":
        import h5py

        cat = cls()
        dirname = os.path.dirname(manifest) or "."
        for entry in meta.get("shards", []):
            path = os.path.join(dirname, entry["file"])
            try:
                h5 = stack.enter_context(h5py.File(path, "r"))
            except OSError as exc:
                raise CheckpointError(manifest, f"unreadable shard: {exc}") from exc

            def visit(name, obj, h5=h5):
                if not isinstance(obj, h5py.Dataset):
                    return
                offset = _slab_offset_of(name)
                if offset is None:
                    return
                cat.slabs.setdefault(name.rsplit("/", 1)[0], []).append(
                    (lambda sel, ds=name: h5[ds][sel], offset, tuple(obj.shape)))

            h5.visititems(visit)
        return cat

    @classmethod
    def from_snapshots(cls, snaps) -> "_SlabCatalog":
        cat = cls()
        for snap in snaps:
            for storage, offset, arr in snap.slabs:
                cat.slabs.setdefault(storage, []).append(
                    (lambda sel, a=arr: a[sel], tuple(offset), tuple(arr.shape)))
        return cat

    def read_region(self, manifest: str, storage: str, region, dtype):
        """Assemble the rectangular ``region`` (``((start, stop), ...)``) of
        ``storage`` from the slabs that intersect it; a region the set does
        not cover raises :class:`CheckpointError`."""
        sizes = [e - s for s, e in region]
        out = np.zeros(sizes, dtype=np.dtype(dtype))
        filled = np.zeros(sizes, dtype=bool)
        for read, offset, sshape in self.slabs.get(storage, []):
            src_sel, dst_sel = [], []
            for (rs, re_), so, sn in zip(region, offset, sshape):
                lo, hi = max(rs, so), min(re_, so + sn)
                if lo >= hi:
                    break
                src_sel.append(slice(lo - so, hi - so))
                dst_sel.append(slice(lo - rs, hi - rs))
            else:
                out[tuple(dst_sel)] = read(tuple(src_sel))
                filled[tuple(dst_sel)] = True
        if not filled.all():
            raise CheckpointError(manifest, f"shard set does not cover dataset {storage!r} region "
                                  f"{[tuple(r) for r in region]}")
        return out

    def read_logical(self, manifest: str, dmeta: dict, region):
        """One logical dataset's region, re/im merged back to its dtype."""
        dtype = np.dtype(dmeta["dtype"])
        storage = dmeta["storage"]
        if len(storage) == 2:
            fdt = np.zeros(0, dtype).real.dtype
            re_ = self.read_region(manifest, storage[0], region, fdt)
            im = self.read_region(manifest, storage[1], region, fdt)
            return (re_ + 1j * im).astype(dtype, copy=False)
        return self.read_region(manifest, storage[0], region, dtype)


def _restore_from_catalog(pde, filename: str, meta: dict, attrs: dict, root: dict,
                          catalog: _SlabCatalog) -> None:
    """Assemble every leaf the model holds from ``catalog`` and hand them,
    as global host arrays, to ``pde.apply_restored_state`` (which places
    them as the model holds them: pencils on a mesh)."""
    if hasattr(pde, "k") and "members" in root:
        k = int(np.asarray(root["members"]))
        if k != int(pde.k):
            raise CheckpointError(
                filename, f"checkpoint holds {k} members but the ensemble has {pde.k}; "
                "sharded restore is K-fixed (the gathered per-member format is the K-elastic one)")
    updates: dict[str, np.ndarray] = {}
    for name, leaf in pde.snapshot_state_items():
        leaf = _as_leaf(leaf)
        dmeta = meta.get("datasets", {}).get(name)
        if dmeta is None:
            if name.startswith("stats/"):
                print(f"sharded checkpoint lacks {name!r}; running averages restart from zero")
                continue
            raise CheckpointError(filename, f"manifest lacks dataset {name!r}")
        if tuple(dmeta["shape"]) != leaf.shape:
            raise CheckpointError(
                filename, f"{name}: checkpoint shape {tuple(dmeta['shape'])} != model shape "
                f"{leaf.shape} — sharded restore is topology-elastic but resolution-fixed (use "
                "the gathered format to interpolate)")
        if str(np.dtype(dmeta["dtype"])) != str(leaf.dtype):
            raise CheckpointError(filename, f"{name}: checkpoint dtype {dmeta['dtype']} != model "
                                  f"dtype {leaf.dtype} (precision mode mismatch)")
        updates[name.rsplit("/", 1)[-1]] = catalog.read_logical(
            filename, dmeta, tuple((0, n) for n in leaf.shape))
    pde.apply_restored_state(updates, attrs, root)


def read_sharded_snapshot(pde, filename: str) -> None:
    """Topology-elastic restore of a sharded checkpoint onto ``pde`` (a
    model on any route, serial or on a mesh of any rank count, or an
    ensemble of the same K): the writer's mesh, process count and slab
    layout do not matter, and the restored state is bit for bit the
    writer's.  Resolution and dtype changes are refused
    (:class:`CheckpointError`; the gathered format interpolates)."""
    with _open_checkpoint(filename) as h5:
        attrs = _verify_open_file(h5, filename)
        if not attrs.get("sharded"):
            raise CheckpointError(filename, "not a sharded-checkpoint manifest")
        meta = _read_manifest_meta(h5, filename)
        root = {name: np.asarray(obj) for name, obj in h5.items()
                if name != _MANIFEST_DS and hasattr(obj, "shape")}
    # the root re-hashes the whole shard set; the other processes check the
    # shards' digest stamps only (the root's scan chose this checkpoint)
    _verify_shard_set(filename, meta, full=_process_index() == 0)
    with ExitStack() as stack:
        catalog = _SlabCatalog.from_files(stack, filename, meta)
        _restore_from_catalog(pde, filename, meta, attrs, root, catalog)
    print(f" <== {filename} (sharded, {int(attrs['sharded'])} shard(s))")


def stage_shard_digest(snap: ShardSnapshot) -> str:
    """Stamp a staged shard with the digest its file would carry (the
    in-memory counterpart of :func:`write_shard_file`)."""
    snap.digest = snapshot_digest(snap.items())
    return snap.digest


def restore_sharded_snapshots(pde, snaps, label: str = "<memory>") -> None:
    """Restore from staged :class:`ShardSnapshot` objects (every process's,
    root's first among them) through the same catalog and placement as the
    files, with no ``h5py``: each shard stamped with a digest must still
    hash to it, and the root's ``root_datasets`` and ``meta`` stand for the
    manifest's."""
    snaps = sorted(snaps, key=lambda s: s.shard_index)
    for snap in snaps:
        if snap.digest is not None and snapshot_digest(snap.items()) != snap.digest:
            raise CheckpointError(label, f"shard {snap.shard_index} digest mismatch")
    head = snaps[0]
    root = {}
    for path, data, kind in head.root_datasets:
        for name, arr in _stored_arrays(path, data, kind):
            root[name] = arr.reshape(np.shape(data)) if kind == "raw" else arr
    attrs = {"schema": SCHEMA_VERSION, "sharded": int(head.shard_count), "time": head.time,
             "dt": head.dt}
    if head.step is not None:
        attrs["step"] = head.step
    _restore_from_catalog(pde, label, head.meta, attrs, root, _SlabCatalog.from_snapshots(snaps))


# -- parked continuations -------------------------------------------------------------
#
# A parked mid-flight member state persists as one directory a request,
# two-phase like every durable write here:
#
#     parked/<request-id>/shard_00000.h5   per-process state slabs,
#                                          digest-stamped, atomic
#     parked/<request-id>/manifest.json    the COMMIT MARKER (atomic
#                                          rename + dirsync)
#
# so any replica that later claims the request resumes it mid-flight.

CONTINUATION_MANIFEST = "manifest.json"


def continuation_dir(run_dir: str, request_id: str) -> str:
    """``<run_dir>/parked/<id>``: one continuation directory a request."""
    return os.path.join(run_dir, "parked", str(request_id))


def continuation_exists(cont_dir: str) -> bool:
    """Whether a COMMITTED continuation is present (the manifest is the
    marker)."""
    return os.path.exists(os.path.join(cont_dir, CONTINUATION_MANIFEST))


def continuation_meta(cont_dir: str) -> tuple[int, float] | None:
    """``(base_steps, time_base)`` of a committed continuation (host JSON
    only), None when there is none."""
    try:
        with open(os.path.join(cont_dir, CONTINUATION_MANIFEST), encoding="utf-8") as fh:
            record = json.load(fh)
        return int(record["base"]), float(record["time_base"])
    except (OSError, ValueError, KeyError):
        return None


def continuation_record(cont_dir: str) -> dict | None:
    """The whole committed-continuation manifest (progress, shard table, the
    writer's ``meta``), None when there is none."""
    try:
        with open(os.path.join(cont_dir, CONTINUATION_MANIFEST), encoding="utf-8") as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return None
    if "base" not in record or "time_base" not in record:
        return None
    return record


def _have_h5py() -> bool:
    try:
        import h5py  # noqa: F401
    except ImportError:
        return False
    return True


def _atomic_npz_write(filename: str, arrays: dict) -> None:
    """Write ``arrays`` as an uncompressed ``.npz`` atomically: a ``.tmp``
    sibling, fsynced, ``os.replace``d over the target, the directory
    fsynced (strictly)."""
    dirname = os.path.dirname(filename) or "."
    os.makedirs(dirname, exist_ok=True)
    tmp = f"{filename}.{os.getpid()}.tmp"
    try:
        with open(tmp, "wb") as fh:
            np.savez(fh, **arrays)
            fh.flush()
            os.fsync(fh.fileno())
        os.replace(tmp, filename)
        fsync_dir(dirname, strict=True)
    finally:
        if os.path.exists(tmp):
            try:
                os.remove(tmp)
            except OSError:
                pass


def write_continuation(cont_dir: str, state, *, base: int, time_base: float,
                       meta: dict | None = None) -> str:
    """Persist one parked member state, two-phase (collective on a
    multi-process runtime): each process writes its state to
    ``shard_<p>.h5`` (fsynced, digest-stamped), the digests are exchanged,
    and the ROOT writes the manifest whose presence commits it.  ``state``
    is a NamedTuple of tensors (or arrays) in the global layout.  Raises
    :class:`CheckpointError` when a shard write failed (no manifest).

    Where ``h5py`` does not import (the card's machine) the shard is an
    uncompressed ``shard_<p>.npz`` of the same arrays, named so in the
    manifest, with the same digest: any process of this package reads
    either (:func:`read_continuation`); only the ``.h5`` form is the JAX
    package's."""
    from ..parallel import multihost

    proc = _process_index()
    nproc = _process_count()
    fields = list(state._fields)
    slabs = {name: multihost.host_local_array(getattr(state, name)) for name in fields}
    items = [(f"state/{name}", arr, "raw") for name, arr in sorted(slabs.items())]
    digest = snapshot_digest(items)
    suffix = "h5" if _have_h5py() else "npz"
    shard_file = os.path.join(cont_dir, f"shard_{proc:05d}.{suffix}")

    def body(h5):
        grp = h5.require_group("state")
        for name in fields:
            grp.create_dataset(name, data=slabs[name])
        h5.attrs["shard_index"] = int(proc)
        h5.attrs["shard_count"] = int(nproc)

    local_error: Exception | None = None
    try:
        if suffix == "h5":
            _atomic_h5_write(shard_file, body, step=int(base), digest=digest)
        else:
            _atomic_npz_write(shard_file, slabs)
    except Exception as exc:  # the commit exchange decides
        local_error = exc
    if nproc == 1:
        digests, oks = [digest], [local_error is None]
    else:
        rows = multihost.allgather_bytes(
            json.dumps({"digest": digest, "ok": local_error is None}).encode("utf-8"))
        parsed = [json.loads(r.decode("utf-8")) for r in rows]
        digests = [p["digest"] for p in parsed]
        oks = [bool(p["ok"]) for p in parsed]
    manifest = os.path.join(cont_dir, CONTINUATION_MANIFEST)
    if not all(oks):
        if nproc > 1:
            multihost.sync_hosts("rustpde-continuation-abort")
        raise CheckpointError(manifest, "continuation persist aborted: a host failed its shard "
                              "write (no manifest committed)"
                              + (f"; local cause: {local_error}" if local_error else "")
                              ) from local_error
    if proc == 0:
        record = {"schema": SCHEMA_VERSION, "base": int(base), "time_base": float(time_base),
                  "fields": fields,
                  "shards": [{"file": f"shard_{i:05d}.{suffix}", "digest": d}
                             for i, d in enumerate(digests)],
                  "meta": dict(meta or {})}
        # the commit marker: a failed dirsync reports it NOT committed
        atomic_write_text(manifest, json.dumps(record, sort_keys=True), strict=True)
    if nproc > 1:
        multihost.sync_hosts("rustpde-continuation-commit")
    return manifest


def read_continuation(cont_dir: str, template_state):
    """Restore a committed continuation: ``(state, base, time_base)``.  Each
    process reads ITS shard (digest-verified end to end) and checks every
    leaf's shape and dtype against ``template_state`` (a donor state of the
    claiming bucket); the leaves come back as tensors on the template's
    device.  A missing, uncommitted or corrupt continuation raises
    :class:`CheckpointError`."""
    manifest = os.path.join(cont_dir, CONTINUATION_MANIFEST)
    try:
        with open(manifest, encoding="utf-8") as fh:
            record = json.load(fh)
    except (OSError, ValueError) as exc:
        raise CheckpointError(manifest, f"no committed continuation: {exc}") from exc
    fields = list(record.get("fields", ()))
    if fields != list(template_state._fields):
        raise CheckpointError(manifest, f"continuation fields {fields} != state fields "
                              f"{list(template_state._fields)} (model kind changed?)")
    proc = _process_index()
    shards = record.get("shards", [])
    if proc >= len(shards):
        raise CheckpointError(manifest, f"continuation holds {len(shards)} shard(s) but this is "
                              f"process {proc}: written under a different topology")
    path = os.path.join(cont_dir, shards[proc]["file"])
    if path.endswith(".npz"):
        try:
            with np.load(path, allow_pickle=False) as npz:
                slabs = {name: np.asarray(npz[name]) for name in fields}
        except (OSError, ValueError, KeyError) as exc:
            raise CheckpointError(manifest, f"shard {shards[proc]['file']!r} unreadable: "
                                  f"{exc}") from exc
        items = [(f"state/{name}", arr, "raw") for name, arr in sorted(slabs.items())]
        if snapshot_digest(items) != shards[proc]["digest"]:
            raise CheckpointError(manifest, f"shard {shards[proc]['file']!r} content mismatch")
    else:
        with _open_checkpoint(path) as h5:
            if _attrs_of(h5).get("digest") != shards[proc]["digest"]:
                raise CheckpointError(manifest, f"shard {shards[proc]['file']!r} digest mismatch")
            if content_digest(h5) != shards[proc]["digest"]:
                raise CheckpointError(manifest, f"shard {shards[proc]['file']!r} content mismatch")
            slabs = {name: np.asarray(h5["state"][name]) for name in fields}
    leaves = {}
    for name in fields:
        tmpl = getattr(template_state, name)
        slab = slabs[name]
        want_dtype = (torch.empty(0, dtype=tmpl.dtype).numpy().dtype if torch.is_tensor(tmpl)
                      else np.dtype(tmpl.dtype))
        if tuple(slab.shape) != tuple(tmpl.shape) or slab.dtype != want_dtype:
            raise CheckpointError(manifest, f"{name}: continuation {slab.shape}/{slab.dtype} != "
                                  f"state {tuple(tmpl.shape)}/{want_dtype}")
        leaves[name] = (torch.as_tensor(slab, device=tmpl.device) if torch.is_tensor(tmpl)
                        else slab)
    return (type(template_state)(**leaves), int(record.get("base", 0)),
            float(record.get("time_base", 0.0)))


def remove_continuation(cont_dir: str) -> None:
    """Retire a consumed continuation: the manifest first (an atomic
    uncommit: a crash mid-removal leaves shards with no marker, which reads
    as no continuation), then the shards and the directory."""
    manifest = os.path.join(cont_dir, CONTINUATION_MANIFEST)
    try:
        os.remove(manifest)
        fsync_dir(cont_dir)
    except OSError:
        pass
    try:
        for name in os.listdir(cont_dir):
            try:
                os.remove(os.path.join(cont_dir, name))
            except OSError:
                pass
        fsync_dir(cont_dir)
        os.rmdir(cont_dir)
        fsync_dir(os.path.dirname(cont_dir) or ".")
    except OSError:
        pass
