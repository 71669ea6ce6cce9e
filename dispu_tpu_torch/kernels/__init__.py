"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain versions.

Each module holds one kernel's wrapper, its plain PyTorch version and the
count of its launches.  A wrapper called with ``impl="auto"`` launches the
kernel for a CUDA tensor and takes the plain version for a CPU tensor;
``impl="cuda"`` insists on the kernel and ``impl="torch"`` on the plain
version.  Nothing here falls back: a CUDA tensor that the kernel does not
take raises.
"""

from __future__ import annotations

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: a wrapper adds one exactly where it launches its kernel
LAUNCHES = {"knn": 0, "knn_split": 0, "knn_packed": 0, "knn_group": 0,
            "fps": 0,
            "fps_lite": 0, "fps_chunked": 0, "fps_bucketed": 0,
            "attention": 0, "query_ball": 0, "gather_rows": 0,
            "scatter_rows": 0, "refine_local": 0, "refine_block": 0}

IMPLS = ("auto", "cuda", "torch")


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def use_kernel(impl: str, tensor) -> bool:
    """Whether a wrapper launches its kernel (True) or its plain version.

    ``auto`` goes by the device of ``tensor``; ``cuda`` on a CPU tensor
    raises rather than running the plain version under the kernel's name.
    """
    if impl not in IMPLS:
        raise ValueError(f"impl must be one of {IMPLS}, got {impl!r}")
    if impl == "torch":
        return False
    if impl == "cuda" and not tensor.is_cuda:
        raise ValueError("impl='cuda' needs CUDA tensors")
    return tensor.is_cuda
