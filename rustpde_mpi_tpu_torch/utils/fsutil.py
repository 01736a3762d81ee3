"""Durability primitives of the port's on-disk writers (a copy of the JAX
package's ``utils/fsutil.py``, which imports only ``os``).

``os.replace``/``os.remove`` mutate the parent DIRECTORY: until the
directory inode itself is fsynced, the new dirent lives only in page
cache and a power loss can roll the rename back even though the file's
own bytes were fsynced.  :func:`fsync_dir` keeps that pattern in one
place; every ``os.replace`` of a durability-critical writer is paired
with it.
"""

from __future__ import annotations

import os


def atomic_write_text(path: str, text: str, strict: bool = False) -> None:
    """The one durable small-file write: tmp sibling (pid-suffixed), write
    + flush + fsync, ``os.replace`` over the target, parent dirsync.
    ``strict`` propagates a failed dirsync (commit-marker writers must
    report such a write FAILED, not committed)."""
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "w", encoding="utf-8") as fh:
        fh.write(text)
        fh.flush()
        os.fsync(fh.fileno())
    os.replace(tmp, path)
    fsync_dir(os.path.dirname(path) or ".", strict=strict)


def fsync_dir(path: str, strict: bool = False) -> None:
    """fsync a DIRECTORY so a just-renamed/removed dirent survives power
    loss.  Default is best-effort (filesystems that reject directory fsync
    — some network mounts — degrade quietly); ``strict=True`` propagates
    the OSError instead, for writers whose commit rides on the dirent
    being durable (a checkpoint must then be reported failed, not
    written)."""
    try:
        fd = os.open(path, os.O_RDONLY)
    except OSError:
        if strict:
            raise
        return
    try:
        os.fsync(fd)
    except OSError:
        if strict:
            raise
    finally:
        os.close(fd)
