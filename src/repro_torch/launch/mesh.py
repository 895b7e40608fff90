"""Device meshes: the production shapes and a small debug mesh.

Counterpart of ``repro/launch/mesh.py``.  Single pod: ``(16, 16)``, axes
``("data", "model")``; multi-pod: ``(2, 16, 16)``, axes ``("pod", "data",
"model")``, the reference's shapes, so that a dry run of the port compares
like with like.  The ``"pod"`` axis is the paper's cloud axis: it runs
across processes, each rank holding its own pods' rows of the stacked train
state, and is crossed only by the sync round (``repro_torch.core.sync``);
``"data"`` and ``"model"`` are in-pod axes on which the state's leaves are
DTensors.

Functions, not module-level meshes: importing this module starts no process
group.  A mesh needs an initialized default group
(``torch.distributed.init_process_group``) of ``prod(shape)`` ranks.
"""
from __future__ import annotations

from typing import Dict

# the card the port's roofline uses: NVIDIA H100 80GB HBM3 at its 700 W
# limit, dense rates from NVIDIA's data sheet (SXM part)
PEAK_FLOPS_BF16 = 989e12          # per card, dense bf16
HBM_BW = 3.35e12                  # bytes/s per card
NVLINK_BW = 450e9                 # bytes/s per card and direction, in-pod
# the WAN between pods: an assumption of the model (the reference's value,
# a conservative data-centre interconnect), not a property of any card
INTER_POD_BW = 12.5e9             # bytes/s per card


def _mesh(device_type: str, shape, names):
    from torch.distributed.device_mesh import init_device_mesh
    return init_device_mesh(device_type, tuple(shape),
                            mesh_dim_names=tuple(names))


def make_production_mesh(*, multi_pod: bool = False,
                         device_type: str = "cuda"):
    """The production mesh: ``(2, 16, 16)`` over ``("pod", "data",
    "model")`` with ``multi_pod``, else ``(16, 16)`` over ``("data",
    "model")``; on CUDA, or over ``"cpu"`` for the dry run's fake group
    (``launch/dryrun.py``)."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _mesh(device_type, shape, names)


def make_debug_mesh(n_pods: int = 2, data: int = 2, model: int = 2,
                    device_type: str = "cpu"):
    """A small mesh: ``(n_pods, data, model)`` over ``("pod", "data",
    "model")``, or ``(data, model)`` over ``("data", "model")`` for one
    pod, as in the reference."""
    if n_pods > 1:
        return _mesh(device_type, (n_pods, data, model),
                     ("pod", "data", "model"))
    return _mesh(device_type, (data, model), ("data", "model"))


def mesh_info(mesh) -> Dict[str, int]:
    sizes = dict(zip(mesh.mesh_dim_names, tuple(mesh.shape)))
    n = 1
    for s in sizes.values():
        n *= s
    return {"n_devices": n, "n_pods": sizes.get("pod", 1),
            "data": sizes.get("data", 1), "model": sizes.get("model", 1)}
