"""PyTorch port: the confined Rayleigh-Benard step against the JAX package.

The port's ``Navier2D`` runs the fused route of the step (three fused
convection chains and seven fused stages a step); on the CPU each wrapper
runs its plain PyTorch version.  The reference runs the same route with its
Pallas kernels in interpret mode (``RUSTPDE_CONV_KERNEL=pallas``,
``RUSTPDE_STEP_KERNEL=pallas``), in f64.  Tolerances: the initial states
come from the same numpy stream through transforms that differ only in
summation order (1e-13 of the field scale); five steps of the same linear
algebra agree to 1e-12 of each field's scale and the observables to rel
1e-10; the golden Nusselt head of PARITY.json holds at rel 1e-6, the
reference's own gate (tests/test_parity.py).
"""

import json
import math
import os

import numpy as np
import pytest
import torch

import rustpde_mpi_tpu as rp
import rustpde_mpi_tpu_torch as pt
from rustpde_mpi_tpu.utils import integrate as jintegrate
from rustpde_mpi_tpu_torch import convert
from rustpde_mpi_tpu_torch.utils import integrate as tintegrate

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIELDS = ("temp", "velx", "vely", "pres", "pseu")


@pytest.fixture(autouse=True, scope="module")
def _one_torch_thread():
    """The grids are tiny: one intra-op thread keeps torch from competing
    with the other test workers for the cores."""
    before = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(before)


def _ref_model(n, fused):
    with pytest.MonkeyPatch.context() as mp:
        if fused:
            mp.setenv("RUSTPDE_CONV_KERNEL", "pallas")
            mp.setenv("RUSTPDE_STEP_KERNEL", "pallas")
        model = rp.Navier2D(n, n, 1e4, 1.0, 5e-3, 1.0, "rbc", periodic=False)
    assert (model._step_impl is not None) == fused
    return model


def _launches(model):
    return sum(k.launches for k in list(model._stages.values()) + list(model._convs.values()))


def _assert_state_close(got, ref, tol):
    for name in FIELDS:
        want = np.asarray(getattr(ref.state, name))
        scale = max(float(np.max(np.abs(want))), 1e-300)
        diff = float(np.max(np.abs(got[name] - want)))
        assert diff <= tol * scale, (name, diff, scale)


# -- (c) the random initial state -----------------------------------------------


@pytest.mark.parametrize("n", [17, 33])
def test_init_random_matches_reference(n):
    ref = _ref_model(n, fused=False)
    ref.init_random(0.1, seed=3)
    port = pt.Navier2D(n, n, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu")
    port.init_random(0.1, seed=3)
    got = convert.state_to_numpy(port)
    for name in ("temp", "velx", "vely"):
        want = np.asarray(getattr(ref.state, name))
        assert float(np.max(np.abs(got[name] - want))) <= 1e-13 * float(np.max(np.abs(want)))
    for name in ("pres", "pseu"):
        assert not got[name].any()
    for name in ("temp", "velx", "vely"):
        np.testing.assert_allclose(port.get_field(name), ref.get_field(name), rtol=0, atol=1e-14)


# -- (d) state carried across, then five steps in both packages -----------------


@pytest.mark.parametrize("n", [17, 33])
def test_five_steps_match_fused_reference(n):
    ref = _ref_model(n, fused=True)
    ref.init_random(0.1, seed=0)
    ref.update_n(2)  # a state with pressure, so every leaf is carried
    port = pt.Navier2D(n, n, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu")
    convert.state_from_numpy(port, {f: np.asarray(getattr(ref.state, f)) for f in FIELDS})
    _assert_state_close(convert.state_to_numpy(port), ref, 0.0)
    ref.update_n(5)
    port.update_n(5)
    _assert_state_close(convert.state_to_numpy(port), ref, 1e-12)
    got, want = port.get_observables(), ref.get_observables()
    assert len(got) == 4
    for g, w in zip(got, want):
        assert g == pytest.approx(float(w), rel=1e-10)
    # (h) on the CPU every wrapper took its plain version
    assert _launches(port) == 0


def test_update_is_one_step_of_update_n():
    a = pt.Navier2D(17, 17, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu")
    b = pt.Navier2D(17, 17, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu")
    a.init_random(0.1)
    b.init_random(0.1)
    for _ in range(3):
        a.update()
    b.update_n(3)
    assert a.get_time() == pytest.approx(b.get_time())
    for name in FIELDS:
        torch.testing.assert_close(getattr(a.state, name), getattr(b.state, name), rtol=0, atol=0)
    assert a.eval_nu() == b.eval_nu() and a.eval_nuvol() == b.eval_nuvol()
    assert a.eval_re() == b.eval_re()


def test_float32_tracks_float64():
    models = {}
    for dtype in (torch.float64, torch.float32):
        m = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 5e-3, 1.0, "rbc", device="cpu", dtype=dtype)
        m.update_n(10)
        assert m.state.temp.dtype == dtype
        models[dtype] = m.get_observables()
    for a, b in zip(models[torch.float32][:3], models[torch.float64][:3]):
        assert a == pytest.approx(b, rel=1e-4)


def test_rejects_unported_options():
    with pytest.raises(ValueError, match="not ported"):
        pt.Navier2D(9, 9, 1e4, 1.0, 1e-2, 1.0, "hc", device="cpu")
    with pytest.raises(ValueError, match="unsupported dtype"):
        pt.Navier2D(9, 9, 1e4, 1.0, 1e-2, 1.0, "rbc", device="cpu", dtype=torch.float16)


# -- (e) the golden Nusselt trajectory --------------------------------------------


def test_parity_golden_head():
    with open(os.path.join(REPO, "PARITY.json"), encoding="utf-8") as fh:
        gold = json.load(fh)
    cfg = gold["config"]
    model = pt.Navier2D(cfg["nx"], cfg["ny"], cfg["ra"], cfg["pr"], cfg["dt"],
                        cfg["aspect"], cfg["bc"], device="cpu")
    model.init_random(cfg["amp"], seed=0)
    for row in gold["nu_f64"][:4]:
        model.update_n(cfg["sample_every"])
        nu, nuvol, re, _ = model.get_observables()
        assert model.get_time() == pytest.approx(row["time"], abs=1e-9)
        assert nu == pytest.approx(row["nu"], rel=1e-6)
        assert nuvol == pytest.approx(row["nuvol"], rel=1e-6)
        assert re == pytest.approx(row["re"], rel=1e-6)
    assert _launches(model) == 0


# -- the integrate driver -----------------------------------------------------------


class _Recorder:
    """A stand-in model that records what a driver asks of it."""

    def __init__(self, dt, nan_after=None):
        self.dt, self.t, self.calls, self.nan_after = dt, 0.0, [], nan_after

    def get_time(self):
        return self.t

    def get_dt(self):
        return self.dt

    def update_n(self, n):
        self.calls.append(("update_n", n))
        self.t += n * self.dt

    def callback(self):
        self.calls.append(("callback", round(self.t, 9)))

    def exit(self):
        return self.nan_after is not None and self.t >= self.nan_after


@pytest.mark.parametrize("case", [(0.01, 1.0, 0.25, None), (0.03, 0.5, 0.1, None),
                                  (0.01, 1.0, None, None), (0.01, 1.0, 0.2, 0.4)])
def test_integrate_matches_reference_driver(case, capsys):
    dt, max_time, save, nan_after = case
    a, b = _Recorder(dt, nan_after), _Recorder(dt, nan_after)
    sa = tintegrate.integrate(a, max_time, save)
    sb = jintegrate.integrate(b, max_time, save)
    assert sa == sb and a.calls == b.calls
    assert sa == ("break" if nan_after else "time_limit")
    capsys.readouterr()


def test_integrate_model_records_diagnostics(capsys):
    model = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc", device="cpu")
    assert tintegrate.integrate(model, 0.1, 0.05) == "time_limit"
    assert model.diagnostics["time"] == pytest.approx([0.05, 0.1])
    assert all(math.isfinite(v) for v in model.diagnostics["nu"])
    assert "Nu =" in capsys.readouterr().out


def test_exit_fires_on_non_finite_state(capsys):
    model = pt.Navier2D.new_confined(17, 17, 1e4, 1.0, 1e-2, 1.0, "rbc", device="cpu")
    assert not model.exit()
    model.state = model.state._replace(velx=model.state.velx * float("nan"))
    assert model.exit()
    assert tintegrate.integrate(model, 1.0, 0.05) == "break"
    capsys.readouterr()
