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
:class:`CheckpointError` naming the file and what is missing.  Sharded
two-phase checkpoints (a manifest plus per-host shard files) are not
ported: a manifest raises :class:`CheckpointError`, though
:func:`rotate_checkpoints` still sweeps orphan shard files.
"""

from __future__ import annotations

import dataclasses
import hashlib
import os
from contextlib import contextmanager

import numpy as np
import torch

from ..bases import BaseKind
from ..field import grid_deltas
from .fsutil import fsync_dir

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


def _sharded_error(filename: str) -> CheckpointError:
    return CheckpointError(
        filename, "a sharded checkpoint manifest: sharded two-phase checkpoints are not "
        "ported (ROADMAP.md, Queue 1 item 17.2); write a gathered snapshot instead")


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
    """Open and digest-verify a snapshot; returns its root attrs.  Raises
    :class:`CheckpointError` when the file is unreadable, its content hash
    does not match its digest, or it is a sharded manifest."""
    with _open_checkpoint(filename) as h5:
        attrs = _verify_open_file(h5, filename)
    if attrs.get("sharded"):
        raise _sharded_error(filename)
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
                     digest_items=None) -> None:
    """Write an HDF5 file atomically: ``body(h5)`` fills a ``.tmp``
    sibling, the root attrs (schema, step, time, dt and the content digest,
    from ``digest_items`` when given, else read back) are stamped, the file
    is flushed and fsynced, ``os.replace``d over the target, and the
    directory fsynced (strictly: a failed dirsync fails the write)."""
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
            h5.attrs["digest"] = (snapshot_digest(digest_items) if digest_items is not None
                                  else content_digest(h5))
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
    becomes a root attr."""
    write_host_snapshot(snapshot_to_host(model, step=step), filename)


def write_ensemble_snapshot(ens, filename: str, step: int | None = None) -> None:
    """Write a K-member ensemble snapshot (:func:`ensemble_snapshot_to_host`,
    then :func:`write_host_snapshot`)."""
    write_host_snapshot(ensemble_snapshot_to_host(ens, step=step), filename)


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
    a malformed file raises :class:`CheckpointError`)."""
    if is_sharded_checkpoint(filename):
        raise _sharded_error(filename)
    with _open_checkpoint(filename) as h5:
        _verify_open_file(h5, filename)
        _restore_snapshot(model, h5)
    print(f" <== {filename}")


def read_ensemble_snapshot(ens, filename: str) -> None:
    """Restore an ensemble snapshot written by :func:`write_ensemble_snapshot`
    (the member count may differ from the ensemble's: the state, mask and
    counts are rebuilt at the file's K; each member interpolates on a
    resolution change as a single restart does)."""
    if is_sharded_checkpoint(filename):
        raise _sharded_error(filename)
    with _open_checkpoint(filename) as h5:
        _verify_open_file(h5, filename)
        _restore_ensemble_snapshot(ens, h5)
    print(f" <== {filename} ({ens.k} members)")
