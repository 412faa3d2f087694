"""PipeEdge on PyTorch and CUDA: the H100 port of the `pipeedge_tpu` package.

The package mirrors `pipeedge_tpu`'s layout module for module, so each
piece has a counterpart a reader can find. It imports `torch` and never
`jax`, and nothing of `pipeedge_tpu`: what it needs from there it keeps
as its own copy. The hand-written Hopper kernels live in `csrc/`, are
built at first use by `ops/_build.py`, and each has a plain PyTorch
version beside its wrapper, which runs only for tensors on the CPU.

Entry points run on `cuda` unless the caller passes `device="cpu"`; a
request for `cuda` on a host without a GPU raises (`resolve_device`).
Importing the package itself does not import `torch`, so a tool that
only launches or watches ranks (`chaos_dcn`) starts without it.
"""
from __future__ import annotations

from typing import Union

DeviceLike = Union[str, "torch.device", None]


def resolve_device(device: DeviceLike = None) -> "torch.device":
    """The device an entry point runs on: `cuda` unless told otherwise,
    with its index filled in (`cuda` -> `cuda:<current>`), so it compares
    equal to the device of the tensors made on it.

    Raises instead of moving to the CPU when CUDA is asked for and no GPU
    is present, so a run never reports CPU numbers as the card's."""
    import torch

    dev = torch.device("cuda" if device is None else device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                "device 'cuda' requested but torch.cuda.is_available() is "
                "False; pass device='cpu' to run the plain versions on the "
                "CPU")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
