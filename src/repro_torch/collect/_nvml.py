"""NVML, the NVIDIA management library behind nvidia-smi, through ctypes.

The eight calls :class:`~repro_torch.collect.sampler.NvmlSampler` makes,
typed from one table of prototypes (``nvml.h``), over the driver's
``libnvidia-ml.so.1``: no Python package.  The versioned soname is the
one to open: the unversioned ``libnvidia-ml.so`` is a development link
that a driver-only host often lacks.  A call that returns anything but
``NVML_SUCCESS`` raises :class:`NVMLError` with the code and
``nvmlErrorString``'s text.

:func:`load` takes the library as an argument (a name or path, or a
loaded library whose attributes are the functions), so that tests can
hand it a library of their own.
"""
from __future__ import annotations

import ctypes
from typing import Union

#: the driver's library, by its versioned soname
LIBRARY = "libnvidia-ml.so.1"
NVML_SUCCESS = 0
NVML_ERROR_NOT_SUPPORTED = 3
NVML_DEVICE_UUID_V2_BUFFER_SIZE = 96

#: ``nvmlDevice_t``: an opaque pointer
Device = ctypes.c_void_p
#: ``nvmlReturn_t``
Return = ctypes.c_int


class Utilization(ctypes.Structure):
    """``nvmlUtilization_t``: percent of the last sample period."""
    _fields_ = [("gpu", ctypes.c_uint), ("memory", ctypes.c_uint)]


#: name -> (restype, argtypes), as ``nvml.h`` declares them
PROTOTYPES = {
    "nvmlInit_v2": (Return, ()),
    "nvmlShutdown": (Return, ()),
    "nvmlDeviceGetCount_v2": (Return, (ctypes.POINTER(ctypes.c_uint),)),
    "nvmlDeviceGetHandleByIndex_v2": (Return, (ctypes.c_uint,
                                               ctypes.POINTER(Device))),
    "nvmlDeviceGetUUID": (Return, (Device, ctypes.POINTER(ctypes.c_char),
                                   ctypes.c_uint)),
    "nvmlDeviceGetPowerUsage": (Return, (Device,
                                         ctypes.POINTER(ctypes.c_uint))),
    "nvmlDeviceGetUtilizationRates": (Return, (Device,
                                               ctypes.POINTER(Utilization))),
    "nvmlErrorString": (ctypes.c_char_p, (Return,)),
}


class NVMLError(Exception):
    """A call returned ``code`` (an ``nvmlReturn_t``) other than
    ``NVML_SUCCESS``; ``text`` is ``nvmlErrorString(code)``."""

    def __init__(self, code: int, text: str):
        super().__init__(f"{text} ({code})")
        self.code = int(code)
        self.text = text


class Nvml:
    """The typed calls over one loaded library (see :func:`load`)."""

    def __init__(self, lib):
        self.lib = lib
        self._fn = {}
        for name, (restype, argtypes) in PROTOTYPES.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
            self._fn[name] = fn

    def _call(self, name: str, *args) -> None:
        rc = self._fn[name](*args)
        if rc != NVML_SUCCESS:
            raise NVMLError(rc, self.error_string(rc))

    def error_string(self, code: int) -> str:
        text = self._fn["nvmlErrorString"](code)
        return (text or b"unknown error").decode(errors="replace")

    def init(self) -> None:
        self._call("nvmlInit_v2")

    def shutdown(self) -> None:
        self._call("nvmlShutdown")

    def device_count(self) -> int:
        n = ctypes.c_uint()
        self._call("nvmlDeviceGetCount_v2", ctypes.byref(n))
        return n.value

    def handle_by_index(self, index: int) -> Device:
        h = Device()
        self._call("nvmlDeviceGetHandleByIndex_v2", index, ctypes.byref(h))
        return h

    def uuid(self, handle: Device) -> str:
        buf = ctypes.create_string_buffer(NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        self._call("nvmlDeviceGetUUID", handle, buf,
                   NVML_DEVICE_UUID_V2_BUFFER_SIZE)
        return buf.value.decode()

    def power_usage(self, handle: Device) -> int:
        """The board's power draw in milliwatts."""
        mw = ctypes.c_uint()
        self._call("nvmlDeviceGetPowerUsage", handle, ctypes.byref(mw))
        return mw.value

    def utilization_rates(self, handle: Device) -> Utilization:
        u = Utilization()
        self._call("nvmlDeviceGetUtilizationRates", handle, ctypes.byref(u))
        return u


def load(library: Union[str, object] = LIBRARY) -> Nvml:
    """Bind NVML's calls in ``library``: a name or path that
    ``ctypes.CDLL`` opens (the driver's soname by default), or a loaded
    library.  Raises ``OSError`` where it cannot be opened and
    ``AttributeError`` where a call is missing."""
    lib = ctypes.CDLL(library) if isinstance(library, str) else library
    return Nvml(lib)
