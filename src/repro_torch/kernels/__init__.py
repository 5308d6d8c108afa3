"""Hand-written CUDA kernels of the port and their plain versions.

``launch_counts()`` reads every wrapper's launch counter (a counter
moves only where its wrapper launches its CUDA kernel); the plain
versions run on CPU tensors and count nothing.
"""

from __future__ import annotations


def launch_counts() -> dict:
    from repro_torch.kernels import crossbar_permute, plan_program_kernel
    return {**crossbar_permute.LAUNCHES, **plan_program_kernel.LAUNCHES}


def reset_launch_counts() -> None:
    from repro_torch.kernels import crossbar_permute, plan_program_kernel
    for table, lock in ((crossbar_permute.LAUNCHES, crossbar_permute._LOCK),
                        (plan_program_kernel.LAUNCHES,
                         plan_program_kernel._LOCK)):
        with lock:
            for key in table:
                table[key] = 0
