"""A sampler loaded into every Python process started with this directory
first on ``PYTHONPATH`` and ``STALL_PROBE_DIR`` set (the fleet replicas of
``scripts/fleet_stall_probe.py``).  Every 50 ms a daemon thread writes to
``<STALL_PROBE_DIR>/<pid>.gaps``: ``gap`` lines when it woke more than
0.3 s late (no Python thread of the process ran it: the GIL held, or the
process off the CPU), with the main thread's innermost frames after the
gap, and ``hb_busy``/``hb_done`` lines while the ``fleet-heartbeat``
thread stays outside its wait, with both threads' frames.  It replaces
any site-wide ``sitecustomize`` in those processes."""

import os
import sys
import threading
import time
import traceback

_DIR = os.environ.get("STALL_PROBE_DIR")


def _top(frame, n=6):
    if frame is None:
        return None
    return " | ".join(f"{os.path.basename(f.filename)}:{f.lineno} {f.name}"
                      for f in traceback.extract_stack(frame)[-n:])


def _sample():
    with open(os.path.join(_DIR, f"{os.getpid()}.gaps"), "w", buffering=1) as fh:
        fh.write(f"start {time.monotonic():.3f} {' '.join(sys.argv[1:])}\n")
        main_id = threading.main_thread().ident
        last, busy_since, logged = time.monotonic(), None, 0.0
        while True:
            time.sleep(0.05)
            now = time.monotonic()
            frames = sys._current_frames()
            if now - last > 0.3:
                fh.write(f"gap {now:.3f} {now - last:.3f} main: {_top(frames.get(main_id))}\n")
            last = now
            hb = [t for t in threading.enumerate() if t.name == "fleet-heartbeat"]
            frame = frames.get(hb[0].ident) if hb else None
            if frame is None or frame.f_code.co_filename.endswith("threading.py"):
                if busy_since is not None and now - busy_since > 0.3:
                    fh.write(f"hb_done {now:.3f} busy {now - busy_since:.3f}\n")
                busy_since = None
                continue
            if busy_since is None:
                busy_since, logged = now, now
            elif now - logged > 0.25:
                logged = now
                fh.write(f"hb_busy {now:.3f} for {now - busy_since:.3f} hb: {_top(frame)} "
                         f"|| main: {_top(frames.get(main_id))}\n")


if _DIR:
    os.makedirs(_DIR, exist_ok=True)
    threading.Thread(target=_sample, name="stall-sampler", daemon=True).start()
