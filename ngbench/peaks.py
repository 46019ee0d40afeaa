"""Published peaks of one NVIDIA H100 SXM card: the yardstick of every
roofline share and every ``mfu`` metric of the benchmark.

Frozen copy of ``src/repro_torch/launch/roofline.py``'s ``H100_SXM``
(NVIDIA's data sheet, SXM part, dense rates without sparsity, at the full
700 W power limit). A run states its card's ``power.limit`` beside the
shares; the peaks do not move with it.
"""

H100_SXM = {
    "peak_flops_tf32": 495e12,     # TF32 on the tensor cores
    "peak_flops_f32": 67e12,       # f32 outside the tensor cores
    "hbm_bw": 3.35e12,             # bytes/s, HBM3
}


def least_time_s(work: dict, hw: dict = H100_SXM) -> float:
    """The least time the card could take for ``work`` (``mma_flops``:
    matrix-product FLOPs, each product counted once; ``flops``: the other
    f32 FLOPs; ``bytes``: each input byte read once, each output byte
    written once): the largest of the three terms. The tensor cores, the
    f32 units and the memory can all work at once, so only the largest
    term bounds the time from below."""
    return max(work.get("mma_flops", 0) / hw["peak_flops_tf32"],
               work.get("flops", 0) / hw["peak_flops_f32"],
               work.get("bytes", 0) / hw["hbm_bw"])


def compute_time_s(work: dict, hw: dict = H100_SXM) -> float:
    """The least time of ``work``'s FLOPs alone: the larger of its
    matrix-product term and its f32 term (the ``mfu`` metrics' yardstick)."""
    return max(work.get("mma_flops", 0) / hw["peak_flops_tf32"],
               work.get("flops", 0) / hw["peak_flops_f32"])
