"""Argument checks and the ctypes call shared by the kernel wrappers."""
from __future__ import annotations

import ctypes
from typing import Optional, Sequence, Tuple

import torch

from repro_torch.kernels import _build

_configured = set()


def check(name: str, device: torch.device,
          specs: Sequence[Tuple[str, torch.Tensor, torch.dtype, tuple]]
          ) -> list:
    """Validate ``(arg, tensor, dtype, shape)`` specs for a launch on
    ``device``; returns the tensors made contiguous, in order."""
    out = []
    for arg, x, dtype, shape in specs:
        if not isinstance(x, torch.Tensor):
            raise TypeError(f"{name}: {arg} must be a tensor")
        if x.device != device:
            raise ValueError(f"{name}: {arg} is on {x.device}, "
                             f"expected {device}")
        if x.dtype != dtype:
            raise TypeError(f"{name}: {arg} is {x.dtype}, expected {dtype}")
        if tuple(x.shape) != tuple(shape):
            raise ValueError(f"{name}: {arg} has shape {tuple(x.shape)}, "
                             f"expected {tuple(shape)}")
        out.append(x.contiguous())
    return out


def launch(name: str, device: torch.device,
           tensors: Sequence[Optional[torch.Tensor]], *scalars,
           entry: Optional[str] = None) -> None:
    """Call ``<name>_launch(ptrs, *scalars, stream)`` (or the library's
    function ``entry``, with the same arguments) from the kernel's library
    on the current stream of ``device``; raises on a non-zero
    ``cudaGetLastError()``.  ``scalars`` are ctypes values; a ``None``
    among ``tensors`` passes a null pointer."""
    lib = _build.load(name)
    symbol = entry or f"{name}_launch"
    fn = getattr(lib, symbol)
    if symbol not in _configured:
        fn.argtypes = ([ctypes.POINTER(ctypes.c_void_p)]
                       + [type(s) for s in scalars] + [ctypes.c_void_p])
        fn.restype = ctypes.c_int
        getattr(lib, f"{name}_error_string").restype = ctypes.c_char_p
        getattr(lib, f"{name}_error_string").argtypes = [ctypes.c_int]
        want = getattr(lib, f"{name}_num_pointers")()
        if want != len(tensors):
            raise RuntimeError(f"{name}: library takes {want} pointers, "
                               f"wrapper passes {len(tensors)}")
        _configured.add(symbol)
    ptrs = (ctypes.c_void_p * len(tensors))(
        *[None if x is None else x.data_ptr() for x in tensors])
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        rc = fn(ptrs, *scalars, ctypes.c_void_p(stream))
    if rc != 0:
        msg = getattr(lib, f"{name}_error_string")(rc).decode()
        raise RuntimeError(f"{name}: kernel launch failed: {msg} ({rc})")
