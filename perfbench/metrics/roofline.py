"""The card's published peaks and the arithmetic of kernel B2's bound.

Peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense, at 700 W): a
configuration's dtype maps to the fastest rate at which the card
multiplies inputs of that type, so that no implementation can exceed it
(float32 -> TF32 tensor cores, 495 TFLOP/s; bfloat16 989 TFLOP/s), and
HBM3 moves 3.35 TB/s.
"""
from __future__ import annotations

PEAK_FLOPS = {"float32": 495e12, "bfloat16": 989e12}
PEAK_BYTES = 3.35e12


def b2_flops(M: int, D: int, H: int) -> float:
    """The two products of LN(x) -> [M, D] x [D, H] -> act -> [M, H] x
    [H, D], 2 M D H operations each, counted once however B2 computes
    them."""
    return 4.0 * M * D * H


def b2_bytes(M: int, D: int, H: int, esize: int, same_residual: bool,
             gamma: bool) -> float:
    """x and the residual read once (once in all when they are one tensor),
    both weights and the vectors (LN scale and bias, b1, b2, gamma) read
    once, the output written once."""
    rows = M * D * (1 if same_residual else 2) + M * D
    vectors = 3 * D + H + (D if gamma else 0)
    return esize * (rows + 2 * D * H + vectors)


def b2_bound_s(call: dict) -> float:
    """The least time the card could take for one B2 call: the larger of
    its operations at the dtype's peak and its bytes at the HBM peak."""
    M, D, H = call["M"], call["D"], call["H"]
    return max(b2_flops(M, D, H) / PEAK_FLOPS[call["dtype"]],
               b2_bytes(M, D, H, call["esize"], call["same_residual"],
                        call["gamma"]) / PEAK_BYTES)
