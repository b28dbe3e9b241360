"""Per-backend choices, made in one module.

The program runs on an NVIDIA GPU (JAX platform ``gpu``) and, for tests and
small rehearsals, on the CPU.  Everything that differs between the two is
decided here from the platform JAX reports — never by catching a failed
compile, and never by an environment knob of the program's own:

- :func:`require_gpu` — measurement entry points refuse any other platform
  (there is no CPU fallback);
- :func:`resolve_chunked_ce` — the default of the chunked training loss
  (``ops/chunked_loss.py``);
- :func:`enable_compile_cache` — XLA's persistent compile cache.

No hand-written kernel is kept (each lost its A/B to XLA on the H100,
docs/KERNELS.md), so nothing here picks one, and nothing picks Pallas's
interpret mode.
"""

from __future__ import annotations

import os
import sys
from typing import Mapping, Optional

GPU = "gpu"
CPU = "cpu"

# Chunked training CE by platform.  On the GPU the faster side of the
# on/off A/B at the flagship train step (H100, PERF.md: on wins at B=64,
# B=512 and the attention step at B=64); on the CPU off, which keeps the
# CPU test baselines on the materialized loss.
CHUNKED_CE_DEFAULT = {GPU: True, CPU: False}

_CHECKOUT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def platform() -> str:
    """The platform of JAX's default backend (``"gpu"``, ``"cpu"``, ...)."""
    import jax

    return jax.default_backend()


def require_gpu():
    """Return ``jax.devices()`` if they are GPUs; raise otherwise."""
    import jax

    devices = jax.devices()
    if devices[0].platform != GPU:
        raise RuntimeError(
            f"needs an NVIDIA GPU; JAX found {devices[0].platform!r} "
            f"({devices[0].device_kind}) and there is no CPU fallback")
    return devices


def resolve_chunked_ce(flag: Optional[bool],
                       plat: Optional[str] = None) -> bool:
    """An explicit ``--chunked_ce on|off`` wins; ``None`` takes the
    platform's default."""
    if flag is not None:
        return bool(flag)
    return CHUNKED_CE_DEFAULT.get(plat or platform(), False)


def compile_cache_dir(env: Mapping[str, str] = os.environ) -> str:
    """``$JAX_COMPILATION_CACHE_DIR`` where set, else ``.jax_cache/`` in the
    checkout.  A fixed path: the cache is keyed by it."""
    return env.get("JAX_COMPILATION_CACHE_DIR") or os.path.join(
        _CHECKOUT, ".jax_cache")


def enable_compile_cache(env: Mapping[str, str] = os.environ,
                         plat: Optional[str] = None) -> Optional[str]:
    """Turn on XLA's persistent compile cache on the GPU and return its
    directory (``None`` on the CPU, whose compiles are cheap).

    Where ``JAX_COMPILATION_CACHE_DIR`` is set JAX already reads it, and no
    other directory is set here."""
    if env.get("JAX_COMPILATION_CACHE_DIR"):
        return env["JAX_COMPILATION_CACHE_DIR"]
    if (plat or platform()) != GPU:
        return None
    import jax

    path = compile_cache_dir(env)
    jax.config.update("jax_compilation_cache_dir", path)
    return path


def device_line() -> str:
    """One line naming the platform, device kind and device count."""
    import jax

    devices = jax.devices()
    return (f"platform={devices[0].platform} "
            f"device_kind={devices[0].device_kind} count={len(devices)}")


def start_entry_point() -> None:
    """What every entry point does first: turn on the compile cache and log
    the platform, device kind and device count once (to stderr)."""
    enable_compile_cache()
    print("# " + device_line(), file=sys.stderr, flush=True)
