"""The six examples of the port (``examples/torch/``) against the
reference's scripts (``examples/``), on the CPU.

Each reference script is loaded by its path and run beside its twin with
the reference's draws carried across (``tests/_torch_draws.py``): the
hidden parameters, reading noise, §5 offsets, ADC noise, the
characterisation's draws and the scenario shapes, or the weights through
``convert.lm_params``.  The two must print the same lines on stdout, the
wall-clock figures (seconds, ms, rates, the checkpoint's path and the
energy ledger of a training run, which is driven by step times) aside,
and the numbers each returns must agree with the reference's within the
bar of its path:

* the §5 and audit figures 1e-12 relative (energies plus 1e-9 J
  absolute, ``tests/test_torch_audit.py``); the characterisation's
  Nelder–Mead outputs (the boxcar window, the sampled fraction) and the
  good-practice figures built on them 1e-9 relative
  (``tests/test_torch_microbench.py``);
* counters, sample counts and the checkpoint checks bitwise;
* the streamed energies against the offline ``integrate_polled`` 1e-11
  relative (``tests/test_torch_faults.py``);
* greedy tokens equal; training losses 1e-5 relative
  (``tests/test_torch_train.py::test_train_step_metrics_match_the_reference``).

The reference's quickstart writes its calibration store to a fixed path:
its ``CalibrationStore`` is pointed at ``tmp_path``.  The two monitor
scripts read ``sys.argv[1]`` when they load, so ``sys.argv`` is set first;
they run at 200 devices here (``chip_smoke.py`` phase 17 runs the twins
at their defaults on the card).
"""
import contextlib
import importlib.util
import io
import pathlib
import re
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")
jax = pytest.importorskip("jax")

import _torch_draws  # noqa: E402
from _torch_jax_ref import ref  # noqa: E402
from test_torch_audit import (E_ATOL, E_RTOL, _carry_fleet,  # noqa: E402
                              reference_draws)  # noqa: F401
from test_torch_scenarios import substitute_scenarios  # noqa: E402

from repro.configs import registry as rreg  # noqa: E402
from repro.core import calibrate as rcal  # noqa: E402
from repro.core import fleet_engine as rfe  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core import sensor as rsensor  # noqa: E402
from repro.models import api as rapi  # noqa: E402
from repro_torch import convert  # noqa: E402
from repro_torch.models import api  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ROOT / "examples"
CPU = "cpu"
#: everything not fitted by Nelder–Mead, and the §5 and audit figures
RTOL = 1e-12
#: the characterisation's Nelder–Mead outputs and what is built on them
RTOL_NM = 1e-9
#: the stream against the offline integral on the same schedules
PARITY_RTOL = 1e-11
#: a training step's loss (test_train_step_metrics_match_the_reference)
LOSS_REL = 1e-5
#: the monitors' fleet size here
N_MONITOR = 200


def _load(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _reference(name, monkeypatch, argv=()):
    """The reference script ``examples/<name>.py``, loaded with
    ``sys.argv`` set to ``argv`` (the monitors read it at load)."""
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    return _load(EXAMPLES / f"{name}.py", f"_reference_example_{name}")


def _twin(name):
    return _load(EXAMPLES / "torch" / f"{name}.py", f"_torch_example_{name}")


def _stdout(fn, *args, **kwargs):
    """(what ``fn`` returns, the lines it printed on stdout)."""
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        out = fn(*args, **kwargs)
    return out, buf.getvalue().splitlines()


def _masked(lines, patterns):
    """The lines with every match of ``patterns`` (wall-clock figures)
    replaced."""
    out = []
    for line in lines:
        for p in patterns:
            line = re.sub(p, "<wall>", line)
        out.append(line)
    return out


def _recorder(monkeypatch, mod, name):
    """Wrap ``mod.name`` so that each call's result is kept; returns the
    list of results."""
    seen = []
    fn = getattr(mod, name)

    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        seen.append(out)
        return out
    monkeypatch.setattr(mod, name, wrapped)
    return seen


def _np(x):
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else x


def _close(got, want, rtol=RTOL, atol=0.0, what=""):
    np.testing.assert_allclose(_np(got), _np(want), rtol=rtol, atol=atol,
                               err_msg=what)


# ---------------------------------------------------------------------------
# quickstart
# ---------------------------------------------------------------------------

def test_quickstart_matches_the_reference(monkeypatch, tmp_path):
    refmod = _reference("quickstart", monkeypatch)
    monkeypatch.setattr(refmod, "CalibrationStore",
                        lambda root: rcal.CalibrationStore(
                            str(tmp_path / "reference")))
    calibs = _recorder(monkeypatch, rcal.CalibrationStore,
                       "get_or_characterise")
    naive = _recorder(monkeypatch, refmod, "measure_naive")
    gp = _recorder(monkeypatch, refmod, "measure_good_practice")
    _, want = _stdout(ref, refmod.main)

    twin = _twin("quickstart")
    _torch_draws.substitute_microbench(monkeypatch)
    # the reference sensor's hidden parameters, seed by seed
    monkeypatch.setattr(twin, "OnboardSensor", lambda profile, seed, device:
                        convert.onboard_sensor(rsensor.OnboardSensor(
                            rprofiles.get(profile.name), seed=seed), device))
    got, lines = _stdout(twin.run, str(tmp_path / "port"), CPU)

    assert lines == want
    c = calibs[0]
    _close(got["update_period_s"], c.update_period_s)
    _close(got["window_s"], c.window_s, RTOL_NM)
    _close(got["sampled_fraction"], c.sampled_fraction, RTOL_NM)
    _close(got["gain"], c.gain)
    _close(got["offset_w"], c.offset_w)
    _close(got["naive_j"], naive[0])
    _close(got["good_practice_j"], gp[0].joules_per_rep, RTOL_NM)
    _close(got["std_j"], gp[0].std_j, RTOL_NM)
    assert abs(got["good_practice_err"]) < abs(got["naive_err"])
    # a second run reads the stored calibration back
    again, _ = _stdout(twin.run, str(tmp_path / "port"), CPU)
    assert again["window_s"] == got["window_s"]


# ---------------------------------------------------------------------------
# fleet_energy_audit
# ---------------------------------------------------------------------------

def test_fleet_energy_audit_matches_the_reference(monkeypatch,
                                                  reference_draws):
    refmod = _reference("fleet_energy_audit", monkeypatch)
    audits = _recorder(monkeypatch, refmod, "fleet_audit")
    _, want = _stdout(refmod.main)
    res = audits[0]

    twin = _twin("fleet_energy_audit")
    substitute_scenarios(monkeypatch)
    _carry_fleet(monkeypatch, reference_draws)
    got, lines = _stdout(twin.run, 4096, CPU)

    wall = [r"\([\d.]+s batched"]
    assert _masked(lines, wall) == _masked(want, wall)
    assert got["n_devices"] == res.n_devices == 4096
    _close(got["truth_j"], np.sum(res.true_j))
    _close(got["naive_j"], np.sum(res.naive_j), E_RTOL, E_ATOL)
    _close(got["good_practice_j"], np.sum(res.gp_j), E_RTOL, E_ATOL)
    for errs, key in ((None, "naive_mean_abs_err"),
                      (res.gp_err, "gp_mean_abs_err")):
        by = res.by_scenario(errs)
        assert sorted(got["scenarios"]) == sorted(by)
        for label, row in by.items():
            assert got["scenarios"][label]["n_devices"] == row["n_devices"]
            _close(got["scenarios"][label][key], row["mean_abs_err"],
                   what=f"{label} {key}")
    assert abs(got["good_practice_err"]) < abs(got["naive_err"])


# ---------------------------------------------------------------------------
# live_fleet_monitor
# ---------------------------------------------------------------------------

def test_live_fleet_monitor_matches_the_reference(monkeypatch,
                                                  reference_draws):
    refmod = _reference("live_fleet_monitor", monkeypatch,
                        [str(N_MONITOR)])
    streams = _recorder(monkeypatch, refmod, "stream_fleet")
    _, want = _stdout(refmod.main)
    res = streams[0]

    twin = _twin("live_fleet_monitor")
    substitute_scenarios(monkeypatch)
    _carry_fleet(monkeypatch, reference_draws)
    got, lines = _stdout(twin.run, N_MONITOR, CPU)

    # the stream's wall and rate, and the parity line's rounding noise
    wall = [r"in [\d.]+ s \([\d.]+ M samples/s\)",
            r"naive \S+e-\d+, corrected \S+e-\d+"]
    assert _masked(lines, wall) == _masked(want, wall)
    assert got["n_samples"] == res.n_samples
    assert got["nbytes"] == res.monitor.nbytes()
    assert got["parity_naive"] < PARITY_RTOL
    assert got["parity_corrected"] < PARITY_RTOL
    truth = np.asarray(refmod.loads.mixed_fleet_workloads(
        N_MONITOR, seed=7, as_bank=True).true_energies_j)
    _close(got["naive_err"],
           np.mean(np.abs(res.naive_stream_j - truth) / truth))
    _close(got["corrected_err"],
           np.mean(np.abs(res.corrected_stream_j - truth) / truth))
    by = res.monitor.by_label()
    assert list(got["by_label"]) == list(by)
    for label, row in by.items():
        assert got["by_label"][label]["n_devices"] == row["n_devices"]
        _close(got["by_label"][label]["total_j"], row["total_j"], E_RTOL,
               E_ATOL, label)
    flags = res.monitor.flags()
    assert got["flags"] == {k: int(np.sum(v)) for k, v in flags.items()}


# ---------------------------------------------------------------------------
# monitor_checkpoint_resume
# ---------------------------------------------------------------------------

def test_monitor_checkpoint_resume_matches_the_reference(monkeypatch,
                                                         reference_draws,
                                                         tmp_path):
    refmod = _reference("monitor_checkpoint_resume", monkeypatch,
                        [str(N_MONITOR)])
    monkeypatch.setattr(refmod.tempfile, "mkdtemp",
                        lambda prefix: str(tmp_path / "reference"))
    restored = _recorder(monkeypatch, refmod, "restore_monitor")
    _, want = _stdout(refmod.main)
    resumed = restored[0]

    twin = _twin("monitor_checkpoint_resume")
    substitute_scenarios(monkeypatch)

    class CarriedBank:
        """The reference's bank of ``seeds=np.arange(n)``: hidden
        parameters across, reading noise through ``reference_draws``."""

        @staticmethod
        def from_catalog(names, seed, device):
            rb = rfe.SensorBank.from_catalog(list(names),
                                             seeds=np.arange(len(names)))
            reference_draws(rb)
            return convert.sensor_bank(names, rb.true_gain, rb.true_offset,
                                       rb.true_phase,
                                       model_gain=rb._model_gain,
                                       device=device)
    monkeypatch.setattr(twin, "SensorBank", CarriedBank)
    got, lines = _stdout(twin.run, N_MONITOR, CPU,
                         str(tmp_path / "port"))

    wall = [r"-> \S+ \(\d+ ms\)"]
    assert _masked(lines, wall) == _masked(want, wall)
    assert got["bitwise_equal"] == dict.fromkeys(
        ("fleet_energy", "energy_between", "window_energy",
         "update_period_s"), True)
    assert got["counters"] == resumed.counters
    _close(got["per_device_j"], resumed.fleet_energy().per_device_j,
           E_RTOL, E_ATOL)
    _close(got["final_j"], resumed.fleet_energy().total_j, E_RTOL, E_ATOL)


# ---------------------------------------------------------------------------
# serve_batch
# ---------------------------------------------------------------------------

def _float32(monkeypatch, mod, get_config):
    """Make ``mod`` build its config in float32 (see ``test_serve_batch``)."""
    monkeypatch.setattr(mod, "get_config", lambda *a, **k: get_config(
        *a, **k).replace(param_dtype="float32"))


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_serve_batch_matches_the_reference(monkeypatch, dtype):
    """The example's own model is bfloat16.  There XLA's and PyTorch's CPU
    products round differently: the first forward's logits differ by up to
    7.0e-3 (logits up to 0.59), above the smallest top-2 gap (2.0e-3), and
    a greedy decode follows the first flip.  So the tokens are held equal
    in float32 (both scripts' config switched), and in bfloat16 the
    request count and token count."""
    refmod = _reference("serve_batch", monkeypatch)
    twin = _twin("serve_batch")
    if dtype == "float32":
        _float32(monkeypatch, refmod, rreg.get_config)
        _float32(monkeypatch, twin, twin.get_config)
    engines = _recorder(monkeypatch, refmod, "ServingEngine")
    _, want = _stdout(ref, refmod.main)
    rp = jax.tree_util.tree_map(np.asarray, engines[0].params)

    monkeypatch.setattr(api, "init_params", lambda seed, cfg, device:
                        convert.lm_params(rp, cfg, device))
    done, lines = _stdout(twin.run, CPU)

    wall = [r"in [\d.]+s \([\d.]+ tok/s\)"]
    if dtype == "float32":
        assert _masked(lines, wall) == _masked(want, wall)
    else:
        assert _masked(lines[:1], wall) == _masked(want[:1], wall)
        assert len(lines) == len(want)
    assert len(done) == 10 and all(r.done for r in done)
    assert [r.request_id for r in done] == sorted(r.request_id
                                                  for r in done)


# ---------------------------------------------------------------------------
# train_mini_lm
# ---------------------------------------------------------------------------

def test_train_mini_lm_matches_the_reference(monkeypatch, tmp_path):
    """In float32, both scripts' config switched: the loss bar is the
    float32 one (bfloat16 products round differently in the two
    libraries, ``test_serve_batch_matches_the_reference``)."""
    refmod = _reference("train_mini_lm", monkeypatch,
                        ["--steps", "4", "--ckpt-dir",
                         str(tmp_path / "reference")])
    twin = _twin("train_mini_lm")
    _float32(monkeypatch, refmod, rreg.get_config)
    _float32(monkeypatch, twin, twin.get_config)
    runs = _recorder(monkeypatch, refmod, "run_training")
    _, want = _stdout(ref, refmod.main)
    want_losses = [float(x) for x in runs[0]["losses"]]
    rcfg = rreg.get_config("olmo-1b", reduced=True).replace(
        n_layers=4, d_model=128, d_ff=512, param_dtype="float32")
    rp = ref(lambda: rapi.init_params(jax.random.PRNGKey(0), rcfg))

    monkeypatch.setattr(api, "init_params", lambda seed, cfg, device:
                        convert.lm_params(rp, cfg, device))
    got, lines = _stdout(twin.run, 4, str(tmp_path / "port"), CPU)

    wall = [r"energy summary: .*"]
    assert _masked(lines, wall) == _masked(want, wall)
    assert len(got["losses"]) == len(want_losses) == 4
    for a, b in zip(got["losses"], want_losses):
        assert a == pytest.approx(b, rel=LOSS_REL)
    assert got["final_loss"] < got["losses"][0]


# ---------------------------------------------------------------------------
# the command line
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("name", sorted(p.stem for p in EXAMPLES.glob("*.py")))
def test_twin_needs_the_card_unless_asked_for_the_cpu(name, monkeypatch):
    """Each twin's ``main`` runs on ``cuda`` by default, and without a card
    it raises the port's missing-card error before any work."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    twin = _twin(name)
    with pytest.raises(RuntimeError, match='device="cpu"'):
        twin.main([])
