"""CompaSO halo catalogs (the counterpart of
abacusutils_tpu/io/compaso.py:CompaSOHaloCatalog): periodic boxes and halo
light cones.

- Halo fields: the halo_info columns prepare_sim reads (``N``, ``id``,
  ``npstartA``, ``npoutA``, ``x_L2com``, ``v_L2com``, ``sigmav3d_L2com``
  and the radii ``r25_L2com``, ``r90_L2com``, ``r98_L2com``, int16 ratios
  of ``r100_L2com``), ``npstartB`` / ``npoutB``, the cleaning files'
  ``N_total`` and the A and B ``npstart*_merge`` / ``npout*_merge``, and
  the light cone's columns (``halo_lc_dt``: ``N_interp``, ``index_halo``,
  ``pos_avg``, ``vel_avg``, ``redshift_interp`` as stored, ``origin``
  modulo 3, and ``pos_interp`` / ``vel_interp``, which take the averaged
  value of every halo whose ``pos_avg`` is not zero). The unit conversions
  are the JAX package's loaders' (compaso.py:_build_loaders), in the same
  float32 arithmetic, so each column is bit-equal to it.
- ``cleaned=True`` (the cleaning files found as compaso.py:_locate_cleaning_files
  finds them; ``N_total`` takes the place of ``N``, halos merged away keep
  N = 0) and ``cleaned=False``. A light cone is cleaned already: it reads
  no cleaning files and warns on ``cleaned=False``.
- ``subsamples``: True or a dict of A, B, pos, vel, rv, pid, rvint and
  packedpid. A box's particles come from its ``halo_rv_{A,B}`` and
  ``halo_pid_{A,B}`` files, each surviving halo's own particles followed by
  those of the halos it absorbed (the "zipper"), every halo's A particles
  before every halo's B; ``npstart*`` / ``npout*`` then index the loaded
  particles. A light cone reads the A set from ``lc_pid_rv.asdf`` as
  stored (its PIDs stay packed).
- ``unpack_bits`` (True, a PID field name or a list of them): the fields
  of the packed PIDs (io/bitpacked.py); ``passthrough``: the columns as
  stored, and raw ``rvint`` / ``packedpid`` particles.
- ``filter_func`` (a function of a slab's halo Table returning a mask) and
  ``header``.

The other halo fields (``DEFAULT_FIELDS``, ``'all'``, the other radii, the
euler16 eigenvectors, the SO and progenitor columns) and
``convert_units=False`` raise NotImplementedError: they are queued in
ROADMAP.md (queue 1, item 3c).
"""

import warnings
from pathlib import Path, PurePath

import numpy as np

from . import bitpacked
from .asdf_file import open_asdf
from .table import Table

__all__ = ['CompaSOHaloCatalog', 'clean_dt', 'halo_lc_dt']

INT16SCALE = 32000.0

# the cleaning files' columns (AbacusSummit data model; compaso.py:111)
clean_dt = np.dtype(
    [
        ('npstartA_merge', np.int64),
        ('npstartB_merge', np.int64),
        ('npoutA_merge', np.uint32),
        ('npoutB_merge', np.uint32),
        ('N_total', np.uint32),
        ('N_merge', np.uint32),
        ('haloindex', np.uint64),
        ('is_merged_to', np.int64),
        ('haloindex_mainprog', np.int64),
        ('v_L2com_mainprog', np.float32, 3),
    ],
    align=True,
)

# the light cones' own columns (compaso.py:146)
halo_lc_dt = np.dtype(
    [
        ('N', np.uint32),
        ('N_interp', np.uint32),
        ('npstartA', np.uint64),
        ('npoutA', np.uint32),
        ('index_halo', np.int64),
        ('origin', np.int8),
        ('pos_avg', np.float32, 3),
        ('pos_interp', np.float32, 3),
        ('vel_avg', np.float32, 3),
        ('vel_interp', np.float32, 3),
        ('redshift_interp', np.float32),
    ],
    align=True,
)

_LATER = 'ROADMAP.md, queue 1'


def _column(name):
    return lambda raw, box, kms: raw(name)


def _radius(name):
    # an int16 ratio of r100, in box units
    return lambda raw, box, kms: raw(name + '_i16') * raw('r100_L2com') / INT16SCALE * box


def _lc_interp(pv):
    # the averaged position or velocity where the halo has one (pos_avg not
    # zero), else the interpolated one (compaso.py:574)
    def load(raw, box, kms):
        have_avg = np.any(np.atleast_2d(raw('pos_avg')), axis=1)[:, None]
        return np.where(have_avg, raw(f'{pv}_avg'), raw(f'{pv}_interp'))
    return load


# field -> (dtype of the loaded column, its value from the slab's raw columns
# `raw`, the box size and the velocity scale): the JAX package's loaders
# (compaso.py:_build_loaders) and the dtypes of its user_dt / clean_dt /
# halo_lc_dt, for the fields ported so far
_LOADERS = {
    'N': (np.uint32, _column('N')),
    'npoutA': (np.uint32, _column('npoutA')),
    'npoutB': (np.uint32, _column('npoutB')),
    'id': (np.uint64, _column('id')),
    'npstartA': (np.uint64, _column('npstartA')),
    'npstartB': (np.uint64, _column('npstartB')),
    'x_L2com': ((np.float32, 3), lambda raw, box, kms: raw('x_L2com') * box),
    'v_L2com': ((np.float32, 3), lambda raw, box, kms: raw('v_L2com') * kms),
    'sigmav3d_L2com': (np.float32, lambda raw, box, kms: raw('sigmav3d_L2com') * kms),
    'r25_L2com': (np.float32, _radius('r25_L2com')),
    'r90_L2com': (np.float32, _radius('r90_L2com')),
    'r98_L2com': (np.float32, _radius('r98_L2com')),
    'N_total': (np.uint32, _column('N_total')),
    'npoutA_merge': (np.uint32, _column('npoutA_merge')),
    'npoutB_merge': (np.uint32, _column('npoutB_merge')),
    'npstartA_merge': (np.int64, _column('npstartA_merge')),
    'npstartB_merge': (np.int64, _column('npstartB_merge')),
    'N_interp': (np.uint32, _column('N_interp')),
    'index_halo': (np.int64, _column('index_halo')),
    'pos_avg': ((np.float32, 3), _column('pos_avg')),
    'vel_avg': ((np.float32, 3), _column('vel_avg')),
    'redshift_interp': (np.float32, _column('redshift_interp')),
    'origin': (np.int8, lambda raw, box, kms: raw('origin') % 3),
    'pos_interp': ((np.float32, 3), _lc_interp('pos')),
    'vel_interp': ((np.float32, 3), _lc_interp('vel')),
}
_CLEAN_FIELDS = ('N_total', 'npstartA_merge', 'npoutA_merge', 'npstartB_merge', 'npoutB_merge')


def _field_loader(field):
    """(dtype, loader) of a halo field; NotImplementedError for a field the
    port does not load yet."""
    if field not in _LOADERS:
        raise NotImplementedError(
            f'halo field {field!r} is not ported yet (the rest of CompaSOHaloCatalog\'s '
            f'fields, {_LATER})')
    dt, loader = _LOADERS[field]
    return np.dtype(dt), loader


def _slab_id(fn):
    """Superslab index encoded as the trailing _NNN of a halo_info filename."""
    return int(Path(fn).stem.rsplit('_', 1)[-1])


def _resolve_halo_info_files(path, halo_lc):
    """(group directory, sorted halo_info files) of a redshift directory, a
    halo_info directory, a halo_info file or a list of them; a light cone's
    are its directory's ``lc_halo_info*.asdf``
    (compaso.py:_resolve_halo_info_files)."""
    paths = [Path(path)] if isinstance(path, (PurePath, str)) else [Path(p) for p in path]
    if not paths:
        raise ValueError('Empty path list passed to CompaSOHaloCatalog')
    missing = [p for p in paths if not p.exists()]
    if missing:
        raise FileNotFoundError(f'No such catalog path: "{missing[0]}"')
    if len(paths) > 1 and any(not p.is_file() for p in paths):
        bad = next(p for p in paths if not p.is_file())
        raise ValueError(f'A multi-path argument must consist of halo_info files only; '
                         f'"{bad}" is a directory.')
    paths = [p.absolute().parent if p.name == 'halo_info' else p.absolute() for p in paths]
    if paths[0].is_dir():
        groupdir = paths[0]
        pattern = 'lc_halo_info*.asdf' if halo_lc else 'halo_info/halo_info_*.asdf'
        halo_fns = sorted(groupdir.glob(pattern))
        if not halo_fns:
            raise FileNotFoundError(f'Found no halo_info files under "{groupdir}" '
                                    f'(pattern "{pattern}")')
        return groupdir, halo_fns
    groupdir = paths[0].parent if halo_lc else paths[0].parents[1]
    if not halo_lc:
        strays = [p for p in paths if p.parents[1] != groupdir]
        if strays:
            raise ValueError(f'halo_info files belong to different catalogs: '
                             f'"{strays[0]}" is not under "{groupdir}"')
    if len(set(paths)) != len(paths):
        raise ValueError('a halo_info file was passed more than once')
    return groupdir, paths


def _sim_tail(groupdir, cleaning_root):
    """SimName/.../zX.Y with the 'halos' level dropped, relative to the
    cleaning root's parent (compaso.py:_sim_tail)."""
    parts = groupdir.relative_to(Path(cleaning_root).parent).parts
    if len(parts) >= 2:
        parts = parts[:-2] + parts[-1:]
    return Path(*parts) if parts else Path('.')


def _locate_cleaning_files(groupdir, cleandir, slab_ids):
    """(cleaned halo_info dir, cleaned rvpid dir, cleaned halo_info files)
    (compaso.py:_locate_cleaning_files)."""
    if cleandir is None:
        cleandir = next((a / 'cleaning' for a in groupdir.parents if (a / 'cleaning').is_dir()),
                        None)
        if cleandir is None:
            raise FileNotFoundError(f'No "cleaning" directory found above "{groupdir}". '
                                    f'Pass cleandir= explicitly, or use cleaned=False.')
    cleandir = Path(cleandir)
    base = cleandir / _sim_tail(groupdir, cleandir)
    if (base / 'cleaned_halo_info').is_dir():
        info_dir, rvpid_dir = base / 'cleaned_halo_info', base / 'cleaned_rvpid'
    else:
        info_dir = rvpid_dir = base
    fns = [info_dir / f'cleaned_halo_info_{i:03d}.asdf' for i in slab_ids]
    for fn in fns:
        if not fn.is_file():
            raise FileNotFoundError(f'Missing cleaned halo info "{fn}"; use cleaned=False to '
                                    f'load the catalog without cleaning.')
    return info_dir, rvpid_dir, fns


_DATA_TOKENS = ('pid', 'pos', 'vel', 'rv', 'rvint', 'packedpid')
_ALL_TOKENS = ('A', 'B', 'unpack', 'field') + _DATA_TOKENS


def _parse_subsample_request(request, passthrough=False):
    """(subsample sets, particle quantities) of the `subsamples` argument
    (compaso.py:_parse_subsample_request): True for both sets' positions,
    velocities and PIDs (raw words with `passthrough`), or a dict of
    tokens; rv is pos + vel."""
    if request is False:
        return [], []
    if request is True:
        keys = ('A', 'B', 'rvint', 'packedpid') if passthrough else ('A', 'B', 'rv', 'pid')
        request = dict.fromkeys(keys, True)
    if not isinstance(request, dict):
        raise TypeError(f'`subsamples` must be a bool or a dict of selection tokens '
                        f'({_ALL_TOKENS}), got {request!r}')
    if request.get('field', False):
        raise ValueError('Field particles are not accessible via CompaSOHaloCatalog; use '
                         'read_abacus.read_asdf() on the field files.')
    unknown = [k for k in request if k not in _ALL_TOKENS]
    if unknown:
        raise ValueError(f'Unrecognized keys in `load_subsamples`: {unknown}')
    if 'rv' in request and ('pos' in request or 'vel' in request):
        raise ValueError('Cannot pass `rv` and `pos` or `vel` in `load_subsamples`.')
    sets = [ab for ab in 'AB' if request.get(ab)]
    quantities = [k for k in request if k in _DATA_TOKENS and request.get(k)]
    if quantities and not sets:
        warnings.warn(f'{quantities} requested without subsample A or B; defaulting to A.')
        sets = ['A']
    elif sets and not quantities:
        quantities = [q for q in ('pos', 'vel') if request.get(q) is not False]
        if not quantities:
            warnings.warn(f'Subsample {sets} requested with no particle quantity; '
                          f'defaulting to `rv`.')
            quantities = ['rv']
    if 'rv' in quantities:
        quantities = [q for q in quantities if q != 'rv'] + ['pos', 'vel']
    return sets, quantities


def _ragged_gather(starts, lens):
    """Indices starts[i] .. starts[i] + lens[i] of every segment i, in order."""
    starts = np.asarray(starts, dtype=np.int64)
    lens = np.asarray(lens, dtype=np.int64)
    total = int(lens.sum())
    if total == 0:
        return np.empty(0, dtype=np.int64)
    seg_start = np.cumsum(lens) - lens
    within = np.arange(total, dtype=np.int64) - np.repeat(seg_start, lens)
    return np.repeat(starts, lens) + within


class CompaSOHaloCatalog:
    """A CompaSO halo catalog: ``halos`` (a Table of the requested fields,
    ``meta`` the header), ``subsamples`` (a Table of the particles),
    ``header``, ``halo_lc``. The constructor takes the JAX package's
    arguments; see the module docstring for what is ported."""

    data_key = 'data'

    def __init__(self, path, cleaned=True, subsamples=False, convert_units=True, unpack_bits=False,
                 fields='DEFAULT_FIELDS', verbose=False, cleandir=None, filter_func=None,
                 halo_lc=None, passthrough=False, **kwargs):
        if kwargs:
            raise ValueError(f'CompaSOHaloCatalog got unexpected keyword arguments: '
                             f'{sorted(kwargs)}')
        if convert_units is not True:
            raise NotImplementedError(f'convert_units=False is not ported yet ({_LATER})')
        self.cleaned = bool(cleaned)
        if halo_lc is None:
            halo_lc = self._is_path_halo_lc(path if isinstance(path, (PurePath, str)) else path[0])
            if halo_lc and verbose:
                print('Light-cone catalog layout detected.')
        self.halo_lc = bool(halo_lc)
        if self.halo_lc:
            if not self.cleaned:
                warnings.warn('halo light cones always incorporate cleaning; '
                              'ignoring `cleaned=False`')
            # no cleaning files exist for a light cone, which is cleaned
            cleaned, unpack_bits = False, False
            self.cleaned = True
        self._read_clean = bool(cleaned)  # read the cleaning files
        self.passthrough = bool(passthrough)
        self.filter_func = filter_func
        self.verbose = verbose
        self.groupdir, self.halo_fns = _resolve_halo_info_files(path, self.halo_lc)
        self.superslab_inds = (np.array([0]) if self.halo_lc
                               else np.array([_slab_id(fn) for fn in self.halo_fns]))
        if cleaned:
            self.clean_halo_info_dir, self.clean_rvpid_dir, self.cleaned_halo_fns = (
                _locate_cleaning_files(self.groupdir, cleandir, self.superslab_inds))
        else:
            self.clean_halo_info_dir = self.clean_rvpid_dir = None
            self.cleaned_halo_fns = []
        self.load_AB, self.load_pidrv = _parse_subsample_request(subsamples, self.passthrough)
        if self.halo_lc:
            self.load_AB = self.load_AB and ['A']  # a light cone holds the A set only
        unpack_bits = self._check_unpack_bits_arg(unpack_bits)

        with open_asdf(self.halo_fns[0]) as af:
            self.header = dict(af['header'])
            self.fields, self.cleaned_fields = self._select_fields(fields, af)
        self.header['cleaned_halos'] = self.cleaned
        if cleaned:
            with open_asdf(self.cleaned_halo_fns[0]) as af:
                zprev = af['header']['TimeSliceRedshiftsPrev']
            self.header['TimeSliceRedshiftsPrev'] = zprev
            self.header['NumTimeSliceRedshiftsPrev'] = len(zprev)

        halos_per_slab = self._read_halo_info()
        self.subsamples = Table()
        if self.halo_lc:
            self._load_halo_lc_subsamples()
        elif self.load_AB:
            edges = self._plan_zipper_layout()
            self._load_subsamples(halos_per_slab, edges, unpack_bits)
            self._install_zipper_indices(edges)
        if cleaned and not self.passthrough:
            self.halos.rename_column('N_total', 'N')
        if verbose:
            print(self)

    @staticmethod
    def _is_path_halo_lc(path):
        """A light cone: the catalog lies under a halo_light_cones tree, or
        its directory holds lc_*.asdf files (compaso.py:_is_path_halo_lc)."""
        p = Path(path)
        return 'halo_light_cones' in str(p) or next(iter(p.glob('lc_*.asdf')), None) is not None

    @staticmethod
    def _check_unpack_bits_arg(unpack_bits):
        """unpack_bits: a bool, a PID field name or a list of them
        (compaso.py:_check_unpack_bits_arg)."""
        if unpack_bits is True or unpack_bits is False:
            return unpack_bits
        try:
            requested = [unpack_bits] if isinstance(unpack_bits, str) else list(unpack_bits)
            bad = [f for f in requested if f not in bitpacked.PID_FIELDS]
        except TypeError:
            bad = [unpack_bits]
        if bad:
            raise ValueError(f'`unpack_bits` must be True, False, or drawn from '
                             f'{bitpacked.PID_FIELDS}; got {bad}')
        return requested

    def _select_fields(self, fields, af):
        """(halo_info columns, cleaning-file columns) of the `fields` request
        (compaso.py:_select_fields); `af` the first halo_info file."""
        if self.passthrough:
            # the stored columns, those the request names ('all': every one)
            on_disk = list(af[self.data_key])
            on_disk_clean = []
            if self._read_clean:
                with open_asdf(self.cleaned_halo_fns[0]) as caf:
                    on_disk_clean = list(caf[self.data_key])
            if fields == 'all':
                return on_disk, on_disk_clean
            wanted = {fields} if isinstance(fields, str) else set(fields)
            return [c for c in on_disk if c in wanted], [c for c in on_disk_clean if c in wanted]
        if isinstance(fields, str) and fields in ('DEFAULT_FIELDS', 'all'):
            raise NotImplementedError(
                f'fields={fields!r}: list the fields; the rest of CompaSOHaloCatalog\'s fields '
                f'is not ported yet ({_LATER})')
        wanted = [fields] if isinstance(fields, str) else list(fields)
        from_clean = []
        if self._read_clean:
            wanted = [f for f in wanted if f != 'N']
            if 'N_total' not in wanted:
                wanted.append('N_total')
            from_clean = [n for n in clean_dt.names if n in set(wanted)]
            wanted = [f for f in wanted if f not in from_clean]
        if self.halo_lc:
            # a light cone holds the L2 halo stats and its own columns
            wanted = [f for f in wanted if 'L2' in f or f in halo_lc_dt.names]
        if self._read_clean:
            for ab in self.load_AB:
                wanted += [c for c in (f'npstart{ab}', f'npout{ab}') if c not in wanted]
                from_clean += [c for c in (f'npstart{ab}_merge', f'npout{ab}_merge')
                               if c not in from_clean]
        for f in from_clean:
            if f not in _CLEAN_FIELDS:
                raise NotImplementedError(f'cleaning field {f!r} is not ported yet ({_LATER})')
        for f in wanted:
            _field_loader(f)
        return wanted, from_clean

    def _read_halo_info(self):
        """Read and convert the requested columns of every slab into
        ``self.halos``, each slab filtered by ``filter_func``; returns the
        halos kept per slab."""
        box, kms = self.header['BoxSize'], self.header['VelZSpace_to_kms']
        per_slab, counts = [], []
        cleaned_fns = self.cleaned_halo_fns or [None] * len(self.halo_fns)
        for fn, cfn in zip(self.halo_fns, cleaned_fns):
            with open_asdf(fn) as af:
                caf = open_asdf(cfn) if cfn is not None else None
                try:
                    raw = {}

                    def read(name, af=af, caf=caf, raw=raw):
                        if name not in raw:
                            holder = caf if name in self.cleaned_fields else af
                            raw[name] = np.asarray(holder[self.data_key][name])
                        return raw[name]

                    cols = {}
                    for field in self.fields + self.cleaned_fields:
                        if self.passthrough:
                            cols[field] = np.array(read(field))
                            continue
                        dt, loader = _field_loader(field)
                        value = loader(read, box, kms)
                        cols[field] = np.empty(len(value), dtype=dt)
                        cols[field][...] = value
                finally:
                    if caf is not None:
                        caf.close()
            if self.filter_func:
                view = Table(cols, meta=self.header, copy=False)
                if self.cleaned and not self.passthrough:
                    view.rename_column('N_total', 'N')
                mask = np.asarray(self.filter_func(view))
                cols = {k: v[mask] for k, v in cols.items()}
            per_slab.append(cols)
            counts.append(len(next(iter(cols.values()))) if cols else 0)
        self.halos = Table(
            {k: np.concatenate([c[k] for c in per_slab]) for k in per_slab[0]},
            meta=self.header, copy=False)
        return np.array(counts)

    def _plan_zipper_layout(self):
        """{AB: uint64 edges (len(halos) + 1)}: where each surviving halo's
        zippered particles (its own, then those it absorbed) start, every
        halo's A before every halo's B (compaso.py:_plan_zipper_layout).
        Halos merged away (N_total = 0) contribute nothing; their npout is
        zeroed for the read."""
        edges_by_set, base = {}, 0
        n = len(self.halos)
        for AB in self.load_AB:
            counts = self.halos[f'npout{AB}']
            if self._read_clean:
                counts[self.halos['N_total'] == 0] = 0
                widths = counts.astype(np.int64) + self.halos[f'npout{AB}_merge']
            else:
                widths = counts.astype(np.int64)
            edges = np.empty(n + 1, dtype=np.uint64)
            edges[0] = base
            np.cumsum(widths, dtype=np.int64, out=edges[1:].view(np.int64))
            edges[1:] += np.uint64(base)
            base = int(edges[-1])
            edges_by_set[AB] = edges
        return edges_by_set

    def _load_subsamples(self, halos_per_slab, edges_by_set, unpack_bits):
        """Read each slab's RVint and packed-PID subsample files of each set,
        write each halo's own and absorbed words at its zippered span
        (compaso.py:_load_subsamples), then decode all of them at once: the
        decoders act word by word, so the columns equal those of a decode
        segment by segment."""
        which = self.load_pidrv
        n_total = int(edges_by_set[self.load_AB[-1]][-1])
        want_rv = any(w in which for w in ('pos', 'vel', 'rvint'))
        want_pid = 'pid' in which or 'packedpid' in which
        vec_dtypes = {'pos': np.float32, 'vel': np.float32, 'rvint': np.int32}
        for w in which:
            if w in vec_dtypes:
                self.subsamples.add_column(np.empty((n_total, 3), vec_dtypes[w]), name=w,
                                           copy=False)
        if want_pid:
            if unpack_bits is False:
                # the raw flavour of PID that was asked for
                unpack_bits = 'packedpid' if 'packedpid' in which else 'pid'
            for k, v in bitpacked.empty_bitpacked_arrays(n_total, unpack_bits).items():
                self.subsamples.add_column(v, name=k, copy=False)
        words = {}
        if want_rv:
            words['rvint'] = (self.subsamples['rvint'] if 'rvint' in self.subsamples
                              else np.empty((n_total, 3), np.int32))
        if want_pid:
            words['packedpid'] = (self.subsamples['packedpid'] if 'packedpid' in self.subsamples
                                  else np.empty(n_total, np.uint64))

        slab_edges = np.concatenate([[0], np.cumsum(halos_per_slab)]).astype(np.int64)
        for colname, out in words.items():
            kind = 'rv' if colname == 'rvint' else 'pid'
            for AB in self.load_AB:
                for i, slab in enumerate(self.superslab_inds):
                    stem = f'halo_{kind}_{AB}'
                    with open_asdf(Path(self.groupdir) / stem / f'{stem}_{slab:03d}.asdf') as af:
                        slab_particles = np.asarray(af[self.data_key][colname])
                    lo, hi = int(slab_edges[i]), int(slab_edges[i + 1])
                    rd_lens = self.halos[f'npout{AB}'][lo:hi]
                    w_starts = edges_by_set[AB][lo:hi].astype(np.int64)
                    out[_ragged_gather(w_starts, rd_lens)] = slab_particles[
                        _ragged_gather(self.halos[f'npstart{AB}'][lo:hi], rd_lens)]
                    if self._read_clean:
                        fn = self.clean_rvpid_dir / f'cleaned_rvpid_{slab:03d}.asdf'
                        with open_asdf(fn) as cl:
                            clean_particles = np.asarray(cl[self.data_key][f'{colname}_{AB}'])
                        c_lens = self.halos[f'npout{AB}_merge'][lo:hi]
                        out[_ragged_gather(w_starts + rd_lens.astype(np.int64), c_lens)] = (
                            clean_particles[_ragged_gather(
                                self.halos[f'npstart{AB}_merge'][lo:hi], c_lens)])

        boxsize = self.header['BoxSize']
        if want_rv and ('pos' in self.subsamples or 'vel' in self.subsamples):
            bitpacked.unpack_rvint(
                words['rvint'], boxsize,
                posout=self.subsamples['pos'] if 'pos' in self.subsamples else False,
                velout=self.subsamples['vel'] if 'vel' in self.subsamples else False)
        if want_pid:
            pid_out = {k: self.subsamples[k] for k in bitpacked.PID_FIELDS
                       if k in self.subsamples}
            bitpacked.unpack_pids_into(words['packedpid'], boxsize, self.header['ppd'], pid_out)

    def _install_zipper_indices(self, edges_by_set):
        """Replace the on-disk npstart / npout (and _merge) columns by the
        zippered layout's (compaso.py:_install_zipper_indices)."""
        for AB in self.load_AB:
            stale = [f'npstart{AB}', f'npout{AB}']
            if self._read_clean:
                stale += [f'npstart{AB}_merge', f'npout{AB}_merge']
            for name in stale:
                self.halos.remove_column(name)
            edges = edges_by_set[AB]
            self.halos.add_column(edges[:-1], name=f'npstart{AB}', copy=False)
            self.halos.add_column(np.diff(edges).astype(np.uint32), name=f'npout{AB}',
                                  copy=False)

    def _load_halo_lc_subsamples(self):
        """A light cone's particles: the requested columns of
        ``lc_pid_rv.asdf`` as stored (compaso.py:_load_halo_lc_subsamples).
        The constructor forces unpack_bits off for a light cone, as the JAX
        package does, so its PIDs stay packed."""
        with open_asdf(Path(self.groupdir) / 'lc_pid_rv.asdf') as af:
            data = af[self.data_key]
            for name in self.load_pidrv:
                self.subsamples.add_column(np.asarray(data[name]), name=name, copy=False)

    def __repr__(self):
        title = f'{self.header["SimName"]} @ z={self.header["Redshift"]:.5g}'
        return '\n'.join([
            'CompaSO Halo Catalog', '=' * 20, title, '-' * len(title),
            f'     Halos: {len(self.halos):8.3g} halos, {len(self.halos.colnames):3d} fields',
            f'Subsamples: {len(self.subsamples):8.3g} particles',
            f'Cleaned halos: {self.cleaned}', f'Halo light cone: {self.halo_lc}',
        ])
