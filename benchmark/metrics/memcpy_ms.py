"""Host transfers: device time of the copies between host and card an
evaluation (ms): run_hod's download of the kept galaxies, the uploads of
compute_xirppi and compute_power. The profiler names them 'Memcpy HtoD
...' and 'Memcpy DtoH ...'."""

UNIT = 'ms'
KERNELS = ('Memcpy HtoD', 'Memcpy DtoH')


def read(trace):
    s = trace.device_seconds(KERNELS)
    return None if s <= 0 or not trace.evals else 1e3 * s / trace.evals
