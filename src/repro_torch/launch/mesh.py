"""Production mesh construction.  Port of `repro/launch/mesh.py`.

The meshes are the port's abstract stand-ins (`parallel.sharding.Mesh`:
axis names and sizes, no devices), so building one touches no device.
The port runs on one card: `make_local_mesh` is (1, 1), and a production
mesh, which needs 256 or 512 devices, is refused by `check_devices`, as
`jax.make_mesh` refuses it on a host with fewer devices.
"""

from __future__ import annotations

import torch

from ..parallel.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(axes, shape)


def make_local_mesh() -> Mesh:
    """The one card (tests, examples)."""
    return Mesh(("data", "model"), (1, 1))


def check_devices(mesh: Mesh, device) -> None:
    """Raise unless `mesh` fits the one device the port runs on."""
    if mesh.size > 1:
        dev = torch.device(device)
        have = (torch.cuda.get_device_name(dev) if dev.type == "cuda"
                else "the CPU")
        raise ValueError(
            f"mesh {'x'.join(map(str, mesh.sizes))} "
            f"{mesh.axis_names} needs {mesh.size} devices; the port runs "
            f"on one device ({have}): use --mesh local")
