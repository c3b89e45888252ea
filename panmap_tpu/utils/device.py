"""Where the device stages run: the one decision every router consumes.

The short-read DP scoring stage (align/batch.py), the long-read DP
(align/longread.py) and ``--device-pileup auto`` (genotype/caller.py) all ask
``device_mode()``.  It answers from the platform of the first JAX device: a
GPU runs the device path, anything else stays on the host.  The placement
and meta scorers are jitted JAX programs that run on whatever backend JAX
has, and are steered by their own CLI flags (``--host-place``,
``--host-score``, ``--em-f64``).

``PANMAP_DEVICE`` is the one internal switch over the decision: ``0`` keeps
every routed stage on the host (forked batch workers set it, so a child
never opens its own device client; host-reference comparisons set it), ``1``
forces the device path on any platform (the CPU tests run the device code
through XLA:CPU this way), unset lets the platform decide.
"""

from __future__ import annotations

import os

ENV = "PANMAP_DEVICE"
DEVICE = "device"


def device_mode() -> str | None:
    """"device" when the routed stages should run on the accelerator,
    None for the host path."""
    env = os.environ.get(ENV, "")
    if env == "0":
        return None
    if env == "1":
        return DEVICE
    if env:
        raise ValueError(f"{ENV} must be 0, 1 or unset, not {env!r}")
    import jax

    return DEVICE if jax.devices()[0].platform == "gpu" else None


def disable_device() -> None:
    """Keep every routed stage on the host for the rest of this process
    (and of any child it forks)."""
    os.environ[ENV] = "0"
