"""FFT: cuFFT's device time an evaluation (ms): every kernel whose name
holds 'fft' (cuFFT's regular_fft, vector_fft, ... ; no kernel of the port's
own has it)."""

UNIT = 'ms'
KERNELS = ('fft',)


def read(trace):
    s = trace.device_seconds(KERNELS)
    return None if s <= 0 or not trace.evals else 1e3 * s / trace.evals
