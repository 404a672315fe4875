"""Published peaks of one NVIDIA H100 SXM (NVIDIA's data sheet, dense
rates, at the full 700 W): 989 TFLOP/s bf16 on the tensor cores, 67
TFLOP/s f32 outside them, 3.35 TB/s of HBM."""

FLOPS = {"bfloat16": 989e12, "float32": 67e12}
HBM_BYTES_PER_S = 3.35e12


def bound_s(nbytes: float, ops: float, peak_flops: float) -> float:
    """The least time a kernel can take: the larger of its bytes over the
    memory's rate and its operations over the peak."""
    return max(nbytes / HBM_BYTES_PER_S, ops / peak_flops)
