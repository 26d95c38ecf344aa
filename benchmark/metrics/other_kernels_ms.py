"""Populate and elementwise: device time an evaluation (ms) of every device
operation outside the classes that other metrics read: K1 (tsc_deposit),
K3 (mode_bin), K4 and K5 (pair_count), cuFFT (fft) and the host copies
(Memcpy HtoD / DtoH). Mostly the populate's elementwise kernels, its
compaction and the stages' sorts."""

UNIT = 'ms'
NAMED = ('tsc_deposit', 'mode_bin', 'pair_count', 'fft', 'Memcpy HtoD', 'Memcpy DtoH')


def read(trace):
    s = trace.device_seconds(None) - trace.device_seconds(NAMED)
    return None if s <= 0 or not trace.evals else 1e3 * s / trace.evals
