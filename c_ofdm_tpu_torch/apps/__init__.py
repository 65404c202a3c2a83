"""The modem's command-line apps (counterparts of ``c_ofdm_tpu/apps/``).

Each app's ``main(argv)`` is also reachable through the dispatcher,
``python -m c_ofdm_tpu_torch <app>``.  The apps that compute take
``--device`` (default ``cuda``); without a card they raise, and run on the
CPU only when asked (``--device cpu``).
"""

from __future__ import annotations


def add_device_arg(parser) -> None:
    parser.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; 'cpu' "
                             "runs the plain PyTorch versions of the kernels)")


def resolve_device(name: str):
    """``torch.device(name)``; a CUDA device without a card raises
    RuntimeError naming the flag (the app never carries on on the CPU)."""
    import torch
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(f"--device {name}: no CUDA device is available "
                               f"(pass --device cpu to run on the CPU)")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    return dev
