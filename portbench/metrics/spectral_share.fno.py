"""Percent of the device's busy time in the window spent in operations on
complex values: the union of the intervals of the kernels whose names
mark them complex over the union of all. In the FNO's step only the
spectral convolutions touch complex tensors.

The rule, from the kernel names of the H100's traced step (torch 2.11,
CUDA 12.8): a name that holds any of ``COMPLEX``, case aside. It takes
cuBLAS's complex GEMMs (``sm80_xmma_gemm_cf32cf32_...``,
``cgemm_largek``, ``scal_64addr_kernel<float2, ...>``), PyTorch's kernels
instantiated for ``c10::complex<float>`` (the casts and copies of
``direct_copy_kernel_cuda``, adds, fills, ``conj``, ``torch.complex``)
and cuFFT's (the FFT form). The real passes that read a spectral
convolution's output (``.real``'s strided add, its GELU) are not
complex and are left out.
"""

from portbench.trace import _union

COMPLEX = ("complex", "cf32", "cgemm", "float2", "fft")


def read(run):
    if run.trace is None or run.trace.busy_s <= 0:
        return None
    spectral = _union((s, e) for s, e, n in run.trace.device
                      if any(p in n.lower() for p in COMPLEX))
    return 100.0 * sum(e - s for s, e in spectral) / 1e9 / run.trace.busy_s
