"""Run the JAX package as the port's reference: on JAX's CPU backend, at
"highest" matmul precision, whatever the environment says.

A machine with a card may give JAX its GPU backend by default (its
environment may set ``JAX_PLATFORMS``, which ``tests/conftest.py`` only
sets where it is unset), and JAX's float32 matrix products on a GPU run
at reduced precision by default: the reference would then disagree with
the port by ~1e-3.  ``ref(fn, *args)`` calls ``fn`` with JAX's default
device set to the CPU and its default matmul precision to "highest", and
returns the result as numpy.  Inputs go in as numpy arrays, so JAX places
them on the CPU.  Where ``JAX_PLATFORMS`` names no CPU backend, this
module adds ``cpu`` to JAX's platforms on import, before JAX's first use.
"""
import os

import jax
import numpy as np

_platforms = os.environ.get("JAX_PLATFORMS", "")
if _platforms and "cpu" not in _platforms.split(","):
    jax.config.update("jax_platforms", _platforms + ",cpu")

CPU = jax.devices("cpu")[0]


def to_numpy(tree):
    """Every JAX array leaf of ``tree`` as a numpy array; other leaves
    (shape specs, numbers) as they are."""
    return jax.tree_util.tree_map(
        lambda x: np.asarray(x) if isinstance(x, jax.Array) else x, tree)


def ref(fn, *args, **kwargs):
    """``fn(*args, **kwargs)`` on JAX's CPU device at "highest" matmul
    precision; array leaves of the result come back as numpy."""
    with jax.default_device(CPU), jax.default_matmul_precision("highest"):
        return to_numpy(fn(*args, **kwargs))
