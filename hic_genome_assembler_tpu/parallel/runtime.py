"""Production mesh / distributed bring-up for the CLI pipeline.

The reference is strictly single-process (SURVEY.md §2b); this module is
the single place where a production run acquires its parallel substrate:

* ``jax.distributed.initialize`` (multi-process runs; no-op for one process),
  via :func:`parallel.distributed.init_distributed`;
* a 2-D (data, model) :class:`jax.sharding.Mesh` over the local devices
  (``parallel.mesh.make_mesh``) when more than one device is visible;
* the process's chromosome shard for part-2 EP runs
  (``parallel.distributed.shard_chromosomes``).

Selection is env-or-flag (VERDICT r1 item 1): the CLI ``-mesh`` flag,
falling back to the ``HIC_MESH`` env var, falling back to ``auto``:

    auto   mesh over all visible devices when >1, else no mesh
    off    never build a mesh (single-device semantics)
    RxC    explicit (data, model) mesh shape, e.g. ``4x2``
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional


@dataclass
class RuntimeContext:
    """What a pipeline part needs to know about the parallel substrate."""

    mesh: Optional[object]  # jax.sharding.Mesh or None
    process_index: int
    process_count: int

    @property
    def is_primary(self) -> bool:
        return self.process_index == 0


def resolve_mesh_spec(mesh_spec: Optional[str] = None) -> str:
    if mesh_spec:
        return mesh_spec
    return os.environ.get("HIC_MESH", "auto")


# the checkout root: parallel/ -> package -> checkout
_CHECKOUT = os.path.dirname(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def compile_cache_dir() -> Optional[str]:
    """Where this program puts XLA's persistent compilation cache:
    None when ``JAX_COMPILATION_CACHE_DIR`` is set (JAX then reads that
    directory itself), else ``<checkout>/.jax_cache``."""
    if os.environ.get("JAX_COMPILATION_CACHE_DIR"):
        return None
    return os.path.join(_CHECKOUT, ".jax_cache")


def enable_compile_cache() -> None:
    """Turn on the persistent compilation cache (see
    :func:`compile_cache_dir`) so reruns skip recompiling the count and
    scoring kernels."""
    import jax

    loc = compile_cache_dir()
    if loc is not None:
        jax.config.update("jax_compilation_cache_dir", loc)
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 1.0)


def device_summary() -> str:
    """One line naming the device the process computes on, as JAX
    reports it."""
    import jax

    devices = jax.devices()
    return "platform={} kind={} count={}".format(
        devices[0].platform, devices[0].device_kind, len(devices)
    )


def nvidia_smi_identity() -> str:
    """Each visible card's name and power limit, one line per card, as
    ``nvidia-smi --query-gpu=name,power.limit`` reports them (a card set
    below its maximum power runs slower under load, so every timing is
    reported beside this)."""
    import subprocess

    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        )
    except (OSError, subprocess.SubprocessError) as exc:
        return f"nvidia-smi unavailable ({exc})"
    return out.stdout.strip()


def bring_up(mesh_spec: Optional[str] = None) -> RuntimeContext:
    """Initialize jax.distributed (when configured via env) and build the
    device mesh per ``mesh_spec`` (see module docstring).

    Never raises on a single-device machine with spec ``auto``: the
    pipeline then runs exactly as the single-device path.
    """
    from hic_genome_assembler_tpu.parallel import distributed

    enable_compile_cache()
    spec = resolve_mesh_spec(mesh_spec)
    process_index, process_count = distributed.init_distributed()
    print("- Device: " + device_summary())

    if spec == "off":
        return RuntimeContext(None, process_index, process_count)

    import jax

    from hic_genome_assembler_tpu.parallel import mesh as pm

    # Multi-process runs shard work at the chromosome level (part-2 EP):
    # each process issues DIFFERENT jitted computations, which is only
    # sound on a mesh of devices this process owns.  jax.devices() is
    # GLOBAL on a multi-host pod — a cross-host mesh would have every
    # process device_put-ing to non-addressable devices and deadlocking
    # on divergent collectives.  EP therefore composes with a PER-HOST
    # mesh only (DP/TP inside the host, EP across hosts).
    devices = jax.local_devices() if process_count > 1 else jax.devices()
    if spec == "auto":
        if len(devices) <= 1:
            return RuntimeContext(None, process_index, process_count)
        mesh = pm.make_mesh((len(devices), 1), devices=devices)
    else:
        try:
            rows, cols = (int(x) for x in spec.lower().split("x"))
        except ValueError:
            raise ValueError(
                f"mesh spec {spec!r} is not 'auto', 'off' or 'RxC'"
            ) from None
        mesh = pm.make_mesh((rows, cols), devices=devices[: rows * cols])
    print(
        "- Parallel runtime: {} devices, mesh {}, process {}/{}".format(
            len(devices), dict(zip(mesh.axis_names, mesh.devices.shape)),
            process_index, process_count,
        )
    )
    return RuntimeContext(mesh, process_index, process_count)
