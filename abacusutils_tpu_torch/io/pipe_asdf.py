#!/usr/bin/env python3
r"""Stream raw ASDF columns over stdout for non-Python clients (the
counterpart of abacusutils_tpu/io/pipe_asdf.py, on this package's reader).

Wire format, the JAX package's: per field, an int64 element count, an int32
item width, then count * width bytes of raw data; each field is written
across all input files before the next field.

Usage: ``python -m abacusutils_tpu_torch.io.pipe_asdf -f FIELD [-f FIELD ...]
file.asdf [file2.asdf ...] | ./client`` (``native/pipe_client`` is such a
client).
"""

import argparse
import sys
from os.path import isfile
from timeit import default_timer as timer

import numpy as np

from .asdf_file import open_asdf, set_nthreads

DEFAULT_DATA_KEY = 'data'
DEFAULT_HEADER_KEY = 'header'

__all__ = ['unpack_to_pipe', 'main']


def unpack_to_pipe(asdf_fns, fields, data_key=DEFAULT_DATA_KEY, header_key=DEFAULT_HEADER_KEY,
                   pipe=None, nthread=4, verbose=True):
    """Write `fields` of the ``data_key`` tables of `asdf_fns` to `pipe`
    (stdout's byte stream when None) in the wire format above, then close
    it. A column is decoded (Blosc, `nthread` threads) when it is written.
    Refuses a terminal, a missing file and a missing field."""
    if pipe is None:
        pipe = sys.stdout.buffer
    if hasattr(pipe, 'isatty') and pipe.isatty():
        raise RuntimeError('Output pipe appears to be a terminal! Did you mean to pipe or '
                           'redirect stdout?')

    set_nthreads(nthread)
    for fn in asdf_fns:
        if not isfile(fn):
            raise FileNotFoundError(fn)
    afs = [open_asdf(fn) for fn in asdf_fns]
    for fn, af in zip(asdf_fns, afs):
        for field in fields:
            if field not in af.tree[data_key]:
                raise ValueError(f'Field "{field}" not found in "{fn}"')

    nbytes_tot = 0
    start_time = timer()
    read_time = 0.0
    for field in fields:
        N = np.int64(0)
        field_width = np.int32(0)
        for af in afs:
            col = af.tree[data_key][field]
            N += np.int64(np.prod(col.shape))
            field_width = np.int32(np.dtype(col.dtype).itemsize)
        pipe.write(N.tobytes())
        pipe.write(field_width.tobytes())
        for af in afs:
            t0 = timer()
            arr = np.asarray(af.tree[data_key][field])  # read + decompress
            read_time += timer() - t0
            pipe.write(np.ascontiguousarray(arr).tobytes())
        nbytes_tot += int(N) * int(field_width)
    pipe.close()  # signal EOF
    tot_time = timer() - start_time
    if verbose:
        print(f'[pipe_asdf] Read + decompressed {nbytes_tot / 1e6:.3g} MB in {read_time:.3g} s '
              f'at {nbytes_tot / 1e6 / max(read_time, 1e-9):.3g} MB/s', file=sys.stderr)
        print(f'[pipe_asdf] Processed {nbytes_tot / 1e6:.3g} MB in {tot_time:.3g} s at '
              f'{nbytes_tot / 1e6 / max(tot_time, 1e-9):.3g} MB/s', file=sys.stderr)


def main(argv=None):
    parser = argparse.ArgumentParser(
        description='Unpack Abacus ASDF files and write the raw data to stdout.')
    parser.add_argument('asdf-file', help='An ASDF file; multiple allowed.', nargs='+')
    parser.add_argument('-f', '--field', action='append',
                        help='A field/column to pipe; multiple -f flags allowed.')
    parser.add_argument('--nthread', type=int, default=4,
                        help='Number of blosc decompression threads.')
    args = vars(parser.parse_args(argv))
    args['asdf_fns'] = args.pop('asdf-file')
    args['fields'] = args.pop('field')
    unpack_to_pipe(**args)


if __name__ == '__main__':
    main()
