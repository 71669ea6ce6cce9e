"""Hand-written CUDA kernels for Hopper (``sm_90a``) and their plain versions.

Each module holds one kernel's wrapper, its plain PyTorch version and the
count of its launches.  A wrapper called with ``impl="auto"`` launches the
kernel for a CUDA tensor and takes the plain version for a CPU tensor;
``impl="cuda"`` insists on the kernel and ``impl="torch"`` on the plain
version.  Nothing here falls back: a CUDA tensor that the kernel does not
take raises.

The kernels of the serving path (:data:`OPS`) are ``torch.library`` custom
ops in the namespace ``dispu_tpu_torch``, each with the kernel for CUDA
tensors, the plain version for CPU tensors and a fake form for shapes, so
that ``torch.export`` keeps each as one node of the graph and a loaded
program launches the kernel itself.  A wrapper calls the op wherever the
op runs what it asks for (:func:`forward_of`): ``impl="torch"`` on a CUDA
tensor calls the plain version directly.  The other kernels
(``fps_lite``, ``query_ball``, ``gather_rows``, ``scatter_rows``) stay
plain ``ctypes`` calls.
"""

from __future__ import annotations

#: launches of each kernel since the last :func:`reset_launch_counts`;
#: a wrapper adds one exactly where it launches its kernel
LAUNCHES = {"knn": 0, "knn_split": 0, "knn_packed": 0, "knn_group": 0,
            "fps": 0,
            "fps_lite": 0, "fps_chunked": 0, "fps_bucketed": 0,
            "attention": 0, "attention_bf16": 0, "query_ball": 0,
            "gather_rows": 0,
            "scatter_rows": 0, "refine_local": 0, "refine_block": 0}

IMPLS = ("auto", "cuda", "torch")

#: the custom ops, each with the module under ``kernels/`` that registers
#: it, which is also the ``csrc/`` library its CUDA form loads
OPS = {"knn": "knn", "knn_packed": "knn", "knn_group": "knn_group",
       "fps": "fps", "fps_chunked": "fps_chunked",
       "fps_bucketed": "fps_bucketed", "attention": "attention",
       "refine_local": "refine_local", "refine_block": "refine_block"}


def reset_launch_counts() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def launch_counts() -> dict:
    return dict(LAUNCHES)


def pin_f32() -> None:
    """Keep f32 products in f32 on the card.

    PyTorch may run f32 matmuls and convolutions in TF32 (about three
    decimal digits); the distances behind kNN selection and the network's
    f32 compute need full f32, as the JAX package asks for with
    ``precision=HIGHEST``.  At bf16 compute, cuBLAS's bf16 products keep
    f32 sums to the end (PyTorch lets them reduce partly in bf16 by
    default).  Live and served requests both set it.
    """
    import torch

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    # bf16 compute: cuBLAS's bf16 products sum in f32 to the end, as XLA's
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


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


def forward_of(use_cuda: bool, tensor, op, kernel, plain):
    """The function a wrapper runs for :func:`use_kernel`'s ``use_cuda``:
    the custom op, which launches ``kernel`` for a CUDA tensor and runs
    ``plain`` for a CPU one, wherever that is what ``use_cuda`` asks for;
    otherwise the asked-for function itself: ``plain`` for a CUDA tensor
    (``impl="torch"`` on the card), ``kernel`` for a CPU tensor (which
    raises, unless a test stands in for it)."""
    if use_cuda == tensor.is_cuda:
        return op
    return kernel if use_cuda else plain


def custom_op(name: str, plain, kernel, fake):
    """Register ``dispu_tpu_torch::<name>``, its schema from ``plain``'s
    annotations: ``plain`` for CPU tensors, ``kernel`` (which counts its
    launch) for CUDA tensors, ``fake`` for shapes and types only."""
    import torch

    op = torch.library.custom_op(f"dispu_tpu_torch::{name}", plain,
                                 mutates_args=(), device_types="cpu")
    op.register_kernel("cuda")(kernel)
    op.register_fake(fake)
    return op


def register_ops() -> None:
    """Import the modules that register :data:`OPS`, as a process that
    loads an exported program must before it calls it."""
    import importlib

    for module in sorted(set(OPS.values())):
        importlib.import_module(f"dispu_tpu_torch.kernels.{module}")
