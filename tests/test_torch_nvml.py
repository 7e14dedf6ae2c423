"""The port's ``NvmlSampler`` (NVML through ``ctypes``,
``repro_torch.collect._nvml``) against the reference's
(``repro.collect.sampler.NvmlSampler`` over ``pynvml``), with no NVML on
the host.

* A fake NVML library: one Python function for each entry of
  ``_nvml.PROTOTYPES``, each behind a real C function pointer
  (``ctypes.CFUNCTYPE`` built from the same prototype), so the binding's
  marshalling runs: the uuid buffer, the milliwatts, the utilisation
  struct, the return codes and ``nvmlErrorString``.
* The reference's sampler over a fake ``pynvml`` module answering the
  same scripted readings, ``time.time`` patched in both: batches bitwise,
  NaN in the same places where NVML answers ``NOT_SUPPORTED``.
* Both samplers' batches through the port's
  ``CollectorPipeline(device="cpu", rebase=True)`` and the reference's
  numpy pipeline: summaries and counters equal, ``fleet_energy`` within
  1e-12 relative.
"""
import ast
import collections
import ctypes
import pathlib
import sys
import time
import types

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.collect import CollectorPipeline as RPipeline  # noqa: E402
from repro.collect.sampler import NvmlSampler as RNvmlSampler  # noqa: E402
from repro.core import profiles as rprofiles  # noqa: E402
from repro.core.calibrate import nominal_record as rnominal  # noqa: E402
from repro_torch.collect import CollectorPipeline, NvmlSampler  # noqa: E402
from repro_torch.collect import _nvml  # noqa: E402
from repro_torch.core import profiles  # noqa: E402
from repro_torch.core.calibrate import nominal_record  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
J_RTOL = 1e-12
NOT_SUPPORTED = _nvml.NVML_ERROR_NOT_SUPPORTED
ERROR_TEXT = {1: b"Uninitialized", 3: b"Not Supported",
              9: b"Driver Not Loaded", 999: b"Unknown Error"}


class Script:
    """What NVML answers over ``polls`` polls of ``n`` devices: power in
    mW held for runs of polls as a sensor holds it, utilisation in
    percent, each with a return code (``NOT_SUPPORTED`` on a seeded share
    of the calls), and the poll times."""

    def __init__(self, n, polls=400, seed=0, na_share=0.0, uuid_len=40):
        rng = np.random.default_rng(seed)
        self.n = n
        self.uuids = [("GPU-%08x-" % rng.integers(2 ** 32)).ljust(
            uuid_len, "abcdef0123456789"[i % 16]) for i in range(n)]
        hold = rng.integers(1, 60, size=(polls, n))
        level = rng.integers(60_000, 700_000, size=(polls, n))
        step = np.cumsum(np.ones((polls, n), dtype=np.int64), axis=0) // hold
        self.mw = np.take_along_axis(level, np.minimum(step, polls - 1),
                                     axis=0)
        self.util = rng.integers(0, 101, size=(polls, n))
        self.power_rc = np.where(rng.random((polls, n)) < na_share,
                                 NOT_SUPPORTED, 0)
        self.util_rc = np.where(rng.random((polls, n)) < na_share,
                                NOT_SUPPORTED, 0)
        self.t = 1.7e9 + np.cumsum(rng.uniform(0.0009, 0.0013, polls))

    def clock(self):
        """A ``time.time`` that returns the poll times in turn."""
        return iter(self.t.tolist()).__next__


class Cursor:
    """One reader's place in a script: the next poll of each device."""

    def __init__(self, script):
        self.script = script
        self.k_power = [0] * script.n
        self.k_util = [0] * script.n

    def power(self, i):
        k, self.k_power[i] = self.k_power[i], self.k_power[i] + 1
        return int(self.script.power_rc[k, i]), int(self.script.mw[k, i])

    def util(self, i):
        k, self.k_util[i] = self.k_util[i], self.k_util[i] + 1
        return (int(self.script.util_rc[k, i]),
                int(self.script.util[k, i]), 100 - int(self.script.util[k, i]))


class FakeNvml:
    """A loaded "library": an attribute for each name of
    ``_nvml.PROTOTYPES``, a C function pointer (as ``ctypes.CDLL`` gives)
    to a Python function built on the same prototype.  A ``char *``
    result comes back as the address of a buffer kept here."""

    HANDLE0 = 0x7000

    def __init__(self, script, init_rc=0, count_rc=0, missing=()):
        self.cursor = Cursor(script)
        self.script = script
        self.init_rc, self.count_rc = init_rc, count_rc
        self.calls = collections.Counter()
        self.uuid_lengths = []
        self.errors = []
        self._text = {code: ctypes.create_string_buffer(text)
                      for code, text in ERROR_TEXT.items()}
        self._keep = []
        fns = {"nvmlInit_v2": self._init, "nvmlShutdown": self._shutdown,
               "nvmlDeviceGetCount_v2": self._count,
               "nvmlDeviceGetHandleByIndex_v2": self._handle,
               "nvmlDeviceGetUUID": self._uuid,
               "nvmlDeviceGetPowerUsage": self._power,
               "nvmlDeviceGetUtilizationRates": self._util,
               "nvmlErrorString": self._error_string}
        assert set(fns) == set(_nvml.PROTOTYPES)
        for name, (restype, argtypes) in _nvml.PROTOTYPES.items():
            if name in missing:
                continue
            fn = fns[name]
            if restype is ctypes.c_char_p:
                restype = ctypes.c_void_p
            else:
                fn = self._guarded(fn)
            cb = ctypes.CFUNCTYPE(restype, *argtypes)(fn)
            self._keep.append(cb)
            setattr(self, name, ctypes.CFUNCTYPE(ctypes.c_int)(
                ctypes.cast(cb, ctypes.c_void_p).value))

    def _guarded(self, fn):
        """``fn``, its exceptions kept in ``errors`` (a callback's would
        only be printed) and answered with NVML_ERROR_UNKNOWN."""
        def call(*args):
            try:
                return fn(*args)
            except Exception as e:        # noqa: BLE001 (kept for the test)
                self.errors.append(e)
                return 999
        return call

    def _device(self, handle):
        i = (handle - self.HANDLE0) // 16
        assert 0 <= i < self.script.n and handle == self.HANDLE0 + 16 * i
        return i

    def _init(self):
        self.calls["init"] += 1
        return self.init_rc

    def _shutdown(self):
        self.calls["shutdown"] += 1
        return 0

    def _count(self, p):
        if self.count_rc:
            return self.count_rc
        p[0] = self.script.n
        return 0

    def _handle(self, i, p):
        p[0] = self.HANDLE0 + 16 * i
        return 0

    def _uuid(self, handle, buf, length):
        self.uuid_lengths.append(length)
        text = self.script.uuids[self._device(handle)].encode() + b"\0"
        assert len(text) <= length
        ctypes.memmove(buf, text, len(text))
        return 0

    def _power(self, handle, p):
        rc, mw = self.cursor.power(self._device(handle))
        if rc == 0:
            p[0] = mw
        return rc

    def _util(self, handle, p):
        rc, gpu, memory = self.cursor.util(self._device(handle))
        if rc == 0:
            p[0].gpu, p[0].memory = gpu, memory
        return rc

    def _error_string(self, code):
        return ctypes.addressof(self._text.get(code, self._text[999]))


def fake_pynvml(script):
    """A ``pynvml`` module answering ``script`` as the fake library does."""
    mod = types.ModuleType("pynvml")
    cursor = Cursor(script)
    mod.calls = collections.Counter()

    class NVMLError(Exception):
        def __init__(self, value):
            super().__init__(value)
            self.value = value

    def power(h):
        rc, mw = cursor.power(h)
        if rc:
            raise NVMLError(rc)
        return mw

    def util(h):
        rc, gpu, memory = cursor.util(h)
        if rc:
            raise NVMLError(rc)
        return types.SimpleNamespace(gpu=gpu, memory=memory)

    mod.NVMLError = NVMLError
    mod.nvmlInit = lambda: mod.calls.update(["init"])
    mod.nvmlShutdown = lambda: mod.calls.update(["shutdown"])
    mod.nvmlDeviceGetCount = lambda: script.n
    mod.nvmlDeviceGetHandleByIndex = lambda i: i
    mod.nvmlDeviceGetUUID = lambda h: script.uuids[h]
    mod.nvmlDeviceGetPowerUsage = power
    mod.nvmlDeviceGetUtilizationRates = util
    return mod


def _both_batches(monkeypatch, script, polls):
    """``polls`` batches of the port's sampler over the fake library and
    of the reference's over the fake ``pynvml``, each with the script's
    clock as ``time.time``."""
    out = []
    for who in ("port", "ref"):
        with monkeypatch.context() as m:
            if who == "port":
                m.setitem(sys.modules, "pynvml", None)   # never imported
                lib = FakeNvml(script)
                sampler = NvmlSampler(lib)
            else:
                m.setitem(sys.modules, "pynvml", fake_pynvml(script))
                sampler = RNvmlSampler()
            m.setattr(time, "time", script.clock())
            batches = [sampler.sample() for _ in range(polls)]
        sampler.close()
        out.append((sampler, batches))
    assert not lib.errors
    return out


def _assert_batch_equal(got, want):
    np.testing.assert_array_equal(got.uuid, want.uuid)
    assert got.uuid.dtype == want.uuid.dtype == object
    for f in ("t", "power_w", "util"):
        a, b = getattr(got, f), getattr(want, f)
        assert a.dtype == b.dtype == np.float64, f
        np.testing.assert_array_equal(a, b, err_msg=f)


# ---------------------------------------------------------------------------
# the binding
# ---------------------------------------------------------------------------

def test_prototypes_are_nvml_h():
    """The eight calls with ``nvml.h``'s types: ``nvmlReturn_t`` an int,
    ``nvmlDevice_t`` an opaque pointer."""
    p = _nvml.PROTOTYPES
    c = ctypes
    assert p == {
        "nvmlInit_v2": (c.c_int, ()),
        "nvmlShutdown": (c.c_int, ()),
        "nvmlDeviceGetCount_v2": (c.c_int, (c.POINTER(c.c_uint),)),
        "nvmlDeviceGetHandleByIndex_v2": (
            c.c_int, (c.c_uint, c.POINTER(c.c_void_p))),
        "nvmlDeviceGetUUID": (
            c.c_int, (c.c_void_p, c.POINTER(c.c_char), c.c_uint)),
        "nvmlDeviceGetPowerUsage": (c.c_int,
                                    (c.c_void_p, c.POINTER(c.c_uint))),
        "nvmlDeviceGetUtilizationRates": (
            c.c_int, (c.c_void_p, c.POINTER(_nvml.Utilization))),
        "nvmlErrorString": (c.c_char_p, (c.c_int,)),
    }
    assert [f[:2] for f in _nvml.Utilization._fields_] == [
        ("gpu", c.c_uint), ("memory", c.c_uint)]
    assert _nvml.NVML_DEVICE_UUID_V2_BUFFER_SIZE == 96
    assert _nvml.LIBRARY == "libnvidia-ml.so.1"


@pytest.mark.parametrize("uuid_len", [40, 95])
def test_binding_marshals_each_call(uuid_len):
    """Counts, handles, the uuid buffer (up to 95 characters and its
    terminator), mW, the utilisation struct, and an error's code and
    text, each through a real C call."""
    script = Script(3, polls=4, seed=1, uuid_len=uuid_len)
    script.power_rc[1, 2] = NOT_SUPPORTED
    script.util_rc[2, 0] = 999
    lib = FakeNvml(script)
    nvml = _nvml.load(lib)
    nvml.init()
    assert nvml.device_count() == 3
    handles = [nvml.handle_by_index(i) for i in range(3)]
    assert [h.value for h in handles] == [FakeNvml.HANDLE0 + 16 * i
                                          for i in range(3)]
    assert [nvml.uuid(h) for h in handles] == script.uuids
    assert lib.uuid_lengths == [96] * 3
    for k in range(2):
        for i, h in enumerate(handles):
            if script.power_rc[k, i]:
                with pytest.raises(_nvml.NVMLError) as e:
                    nvml.power_usage(h)
                assert (e.value.code, e.value.text) == (3, "Not Supported")
            else:
                assert nvml.power_usage(h) == script.mw[k, i]
    for k in range(3):
        for i, h in enumerate(handles):
            if script.util_rc[k, i]:
                with pytest.raises(_nvml.NVMLError, match=r"Unknown Error "
                                   r"\(999\)"):
                    nvml.utilization_rates(h)
            else:
                u = nvml.utilization_rates(h)
                assert (u.gpu, u.memory) == (script.util[k, i],
                                             100 - script.util[k, i])
    assert nvml.error_string(9) == "Driver Not Loaded"
    nvml.shutdown()
    assert lib.calls == {"init": 1, "shutdown": 1}
    assert not lib.errors


def test_missing_library_and_missing_call_raise():
    with pytest.raises(OSError):
        _nvml.load("/nonexistent/libnvidia-ml.so.1")
    with pytest.raises(AttributeError):
        _nvml.load(FakeNvml(Script(1), missing=("nvmlDeviceGetCount_v2",)))
    with pytest.raises(RuntimeError, match=r"libnvidia-ml\.so\.1"):
        NvmlSampler(FakeNvml(Script(1), missing=("nvmlInit_v2",)))


def test_port_never_imports_pynvml():
    bad = []
    for path in sorted((ROOT / "src" / "repro_torch").rglob("*.py")) + [
            ROOT / "chip_smoke.py"]:
        for node in ast.walk(ast.parse(path.read_text())):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            bad += [(path.name, n) for n in names
                    if n.split(".")[0] == "pynvml"]
    assert not bad


# ---------------------------------------------------------------------------
# the sampler against the reference's
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,na_share,seed", [(1, 0.0, 0), (1, 0.1, 1),
                                              (3, 0.0, 2), (4, 0.2, 3)])
def test_sampler_batches_are_the_references(monkeypatch, n, na_share, seed):
    script = Script(n, polls=300, seed=seed, na_share=na_share)
    (port, got), (ref, want) = _both_batches(monkeypatch, script, 300)
    assert isinstance(port.uuids, np.ndarray) and port.uuids.dtype == object
    np.testing.assert_array_equal(port.uuids, ref.uuids)
    assert port.uuids.tolist() == script.uuids
    for g, w in zip(got, want):
        _assert_batch_equal(g, w)
    power = np.stack([b.power_w for b in got])
    util = np.stack([b.util for b in got])
    np.testing.assert_array_equal(np.isnan(power), script.power_rc != 0)
    np.testing.assert_array_equal(np.isnan(util), script.util_rc != 0)
    ok = script.power_rc == 0
    np.testing.assert_array_equal(power[ok], script.mw[ok] * 1e-3)
    np.testing.assert_array_equal(np.stack([b.t for b in got]),
                                  np.repeat(script.t[:, None], n, axis=1))


@pytest.mark.parametrize("profile,slab_samples,na_share", [
    (None, 65536, 0.0), ("h100_average", 65536, 0.05),
    ("h100_instant", 64, 0.05), ("h100_average", 97, 0.0)])
def test_sampler_through_the_pipelines(monkeypatch, profile, slab_samples,
                                       na_share):
    """NvmlSampler → CollectorPipeline(device="cpu", rebase=True) against
    the reference's sampler → numpy pipeline."""
    script = Script(3, polls=600, seed=7, na_share=na_share)
    (_, got), (_, want) = _both_batches(monkeypatch, script, 600)
    pipe = CollectorPipeline(
        device="cpu", rebase=True, now=0.0, slab_samples=slab_samples,
        default_record=(None if profile is None else
                        nominal_record("*", profiles.get(profile))))
    rpipe = RPipeline(
        backend="numpy", rebase=True, now=0.0, slab_samples=slab_samples,
        default_record=(None if profile is None else
                        rnominal("*", rprofiles.get(profile))))
    for b in got:
        pipe.feed(b)
    for b in want:
        rpipe.feed(b)
    mon, rmon = pipe.finish(), rpipe.finish()
    assert pipe.summary() == rpipe.summary()
    assert mon.counters == rmon.counters
    assert pipe.registry.summary() == rpipe.registry.summary()
    assert (mon.counters["invalid"] > 0) == (na_share > 0)
    for corrected in (True, False):
        e, re_ = mon.fleet_energy(corrected=corrected), rmon.fleet_energy(
            corrected=corrected)
        assert e.total_j > 0.0
        assert e.total_j == pytest.approx(re_.total_j, rel=J_RTOL, abs=0.0)
        np.testing.assert_allclose(e.per_device_j.numpy(), re_.per_device_j,
                                   rtol=J_RTOL, atol=0.0)


# ---------------------------------------------------------------------------
# lifetime
# ---------------------------------------------------------------------------

def test_close_shuts_nvml_down_and_a_second_sampler_starts():
    lib = FakeNvml(Script(2, polls=4))
    s = NvmlSampler(lib)
    assert lib.calls == {"init": 1}
    s.sample()
    s.close()
    assert lib.calls == {"init": 1, "shutdown": 1}
    s2 = NvmlSampler(lib)
    s2.sample()
    s2.close()
    assert lib.calls == {"init": 2, "shutdown": 2}


@pytest.mark.parametrize("code,text", [(9, "Driver Not Loaded"),
                                       (999, "Unknown Error")])
def test_failing_init_raises_runtime_error_with_nvml_text(code, text):
    lib = FakeNvml(Script(1), init_rc=code)
    with pytest.raises(RuntimeError) as e:
        NvmlSampler(lib)
    msg = str(e.value)
    assert text in msg and "nvmlInit_v2" in msg
    assert "libnvidia-ml.so.1" in msg and "SimulatedSampler" in msg
    assert lib.calls == {"init": 1}


def test_failure_after_init_shuts_nvml_down():
    lib = FakeNvml(Script(2), count_rc=1)
    with pytest.raises(_nvml.NVMLError, match="Uninitialized"):
        NvmlSampler(lib)
    assert lib.calls == {"init": 1, "shutdown": 1}
