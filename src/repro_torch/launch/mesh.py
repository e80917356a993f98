"""Production mesh construction.

The counterpart of ``repro/launch/mesh.py``.  One pod: 256 ranks as
``(data=16, model=16)``.  Two pods: 512 ranks as ``(pod=2, data=16,
model=16)``; the ``pod`` dim composes with ``data`` for batch sharding
and carries the (slower, compressible) inter-pod gradient reduction.
The meshes are :class:`~torch.distributed.device_mesh.DeviceMesh` es
over the first ranks of the default process group, which must be
initialized first with a rank for each mesh position: a real group
(NCCL on cards, gloo on the CPU) or, for the dry run, the ``fake``
backend, whose ranks need no device (build the mesh outside the dry
run's fake mode).  ``device`` is ``"cuda"`` unless the caller asks for
the CPU.

``offload_devices``/``make_offload_mesh`` give the BLAS-offload
runtime's view: the devices behind its logical device tiers.
"""
from __future__ import annotations

import math
from typing import List

import torch

from repro_torch.core import memspace


def _device_type(device: str) -> str:
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a CUDA mesh was requested but CUDA is not "
                           "available; pass device='cpu'")
    return dev.type


def _mesh(device: str, shape, names):
    """A mesh over the group's first ``prod(shape)`` ranks (a dry run's
    512-rank group holds the one-pod mesh of 256)."""
    from torch.distributed.device_mesh import DeviceMesh
    ranks = torch.arange(math.prod(shape)).view(*shape)
    return DeviceMesh(_device_type(device), ranks,
                      mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False, device: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device, shape, axes)


def make_debug_mesh(n_devices: int = 8, model: int = 2,
                    device: str = "cuda"):
    """Small ``(data, model)`` mesh over however many ranks the group
    has."""
    return _mesh(device, (n_devices // model, model), ("data", "model"))


def batch_axes(mesh) -> tuple:
    return ("pod", "data") if "pod" in mesh.mesh_dim_names else ("data",)


# --------------------------------------------------------------------- #
# BLAS-offload device set (the multi-device tile scheduler's view)       #
# --------------------------------------------------------------------- #
def offload_devices() -> List[torch.device]:
    """Real devices backing the offload runtime's logical device tiers.

    The active mapping has N device tiers (``OffloadConfig.devices``,
    see :mod:`repro_torch.core.memspace`); tier *i* maps to card
    ``i % cards`` when there are several cards, else to the mapping's
    one device.  With more tiers than hardware (one card, or the CPU's
    simulated layout) tiers wrap onto the same device, exactly as
    :func:`memspace.put_block` places them."""
    space = memspace.active()
    cards = torch.cuda.device_count() if not space.simulated else 0
    real = ([torch.device("cuda", i) for i in range(cards)] if cards > 1
            else [space.device])
    return [real[i % len(real)] for i in range(space.n_devices)]


def make_offload_mesh():
    """1-D ``('blas',)`` mesh over the distinct devices of
    :func:`offload_devices`, for model code that wants its collectives
    co-located with the BLAS tiles the offload runtime schedules.  The
    process group needs one rank per distinct device."""
    unique = list(dict.fromkeys(offload_devices()))
    from torch.distributed.device_mesh import DeviceMesh
    return DeviceMesh(unique[0].type, list(range(len(unique))),
                      mesh_dim_names=("blas",))
