"""CompaSO halo catalogs of a periodic box (the counterpart of
abacusutils_tpu/io/compaso.py:CompaSOHaloCatalog), limited to what
prepare_sim reads: ``prepare_slab``, ``load_env_halos`` and
``calc_shearmark``.

- Fields: the halo_info columns prepare_sim reads (``N``, ``id``,
  ``npstartA``, ``npoutA``, ``x_L2com``, ``v_L2com``, ``sigmav3d_L2com``
  and the radii ``r25_L2com``, ``r90_L2com``, ``r98_L2com``, int16 ratios
  of ``r100_L2com``) and the cleaning files' ``N_total``,
  ``npstartA_merge`` and ``npoutA_merge``. The unit conversions are those
  of the JAX package's loaders (compaso.py:_build_loaders), in the same
  float32 arithmetic, so each column is bit-equal to it.
- ``cleaned=True`` (the cleaning files found as compaso.py:_locate_cleaning_files
  finds them; ``N_total`` takes the place of ``N``, halos merged away keep
  N = 0) and ``cleaned=False``.
- ``subsamples=dict(A=True, rv=True)`` (or ``dict(A=True)``, or ``pos`` /
  ``vel`` alone): the A subsample's positions and velocities, each surviving
  halo's own particles followed by those of the halos it absorbed (the
  "zipper"); ``npstartA`` / ``npoutA`` then index the loaded particles.
- ``filter_func`` (a function of a slab's halo Table returning a mask) and
  ``header``.

The light-cone catalogs, the B subsample, the PID columns, every other halo
field, ``passthrough`` and ``unpack_bits`` raise NotImplementedError: they
are queued in ROADMAP.md (queue 1, items 3a-3c).
"""

import warnings
from pathlib import Path, PurePath

import numpy as np

from .asdf_file import open_asdf
from .bitpacked import unpack_rvint
from .table import Table

__all__ = ['CompaSOHaloCatalog', 'clean_dt']

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

_LATER = 'ROADMAP.md, queue 1'


def _column(name):
    return lambda raw, box, kms: raw(name)


def _radius(name):
    # an int16 ratio of r100, in box units
    return lambda raw, box, kms: raw(name + '_i16') * raw('r100_L2com') / INT16SCALE * box


# field -> (dtype of the loaded column, its value from the slab's raw columns
# `raw`, the box size and the velocity scale): the JAX package's loaders
# (compaso.py:_build_loaders) and the dtypes of its user_dt / clean_dt, for
# the fields prepare_sim reads
_LOADERS = {
    'N': (np.uint32, _column('N')),
    'npoutA': (np.uint32, _column('npoutA')),
    'id': (np.uint64, _column('id')),
    'npstartA': (np.uint64, _column('npstartA')),
    'x_L2com': ((np.float32, 3), lambda raw, box, kms: raw('x_L2com') * box),
    'v_L2com': ((np.float32, 3), lambda raw, box, kms: raw('v_L2com') * kms),
    'sigmav3d_L2com': (np.float32, lambda raw, box, kms: raw('sigmav3d_L2com') * kms),
    'r25_L2com': (np.float32, _radius('r25_L2com')),
    'r90_L2com': (np.float32, _radius('r90_L2com')),
    'r98_L2com': (np.float32, _radius('r98_L2com')),
    'N_total': (np.uint32, _column('N_total')),
    'npoutA_merge': (np.uint32, _column('npoutA_merge')),
    'npstartA_merge': (np.int64, _column('npstartA_merge')),
}
_CLEAN_FIELDS = ('N_total', 'npstartA_merge', 'npoutA_merge')


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


def _is_path_halo_lc(path):
    p = Path(path)
    return 'halo_light_cones' in str(p) or next(iter(p.glob('lc_*.asdf')), None) is not None


def _resolve_halo_info_files(path):
    """(group directory, sorted halo_info files) of a redshift directory, a
    halo_info directory, a halo_info file or a list of them
    (compaso.py:_resolve_halo_info_files, for a box)."""
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
        halo_fns = sorted(groupdir.glob('halo_info/halo_info_*.asdf'))
        if not halo_fns:
            raise FileNotFoundError(f'Found no halo_info files under "{groupdir}"')
        return groupdir, halo_fns
    groupdir = paths[0].parents[1]
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


def _parse_subsample_request(request):
    """The subsample sets and quantities of the `subsamples` argument
    (compaso.py:_parse_subsample_request), limited to the A set's positions
    and velocities."""
    if request is False:
        return [], []
    if request is True or not isinstance(request, dict):
        raise NotImplementedError(
            f'subsamples={request!r}: only dict(A=True, rv=True) (or pos / vel) is ported '
            f'(the B subsample and the PIDs: {_LATER})')
    tokens = ('A', 'B', 'unpack', 'field', 'pid', 'pos', 'vel', 'rv', 'rvint', 'packedpid')
    unknown = [k for k in request if k not in tokens]
    if unknown:
        raise ValueError(f'Unrecognized keys in `load_subsamples`: {unknown}')
    if 'rv' in request and ('pos' in request or 'vel' in request):
        raise ValueError('Cannot pass `rv` and `pos` or `vel` in `load_subsamples`.')
    sets = [ab for ab in 'AB' if request.get(ab)]
    quantities = [k for k in ('pid', 'pos', 'vel', 'rv', 'rvint', 'packedpid')
                  if request.get(k)]
    if quantities and not sets:
        warnings.warn(f'{quantities} requested without subsample A or B; defaulting to A.')
        sets = ['A']
    elif sets and not quantities:
        quantities = [q for q in ('pos', 'vel') if request.get(q) is not False]
    if 'rv' in quantities:
        quantities = [q for q in quantities if q != 'rv'] + ['pos', 'vel']
    if sets != ['A'] or not quantities or any(q not in ('pos', 'vel') for q in quantities):
        raise NotImplementedError(
            f'subsamples={request!r}: only the A subsample\'s pos and vel are ported '
            f'(the B subsample and the PIDs: {_LATER})')
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
    """A CompaSO halo catalog of a periodic box: ``halos`` (a Table of the
    requested fields, ``meta`` the header), ``subsamples`` (a Table of the
    A particles' ``pos`` and ``vel``), ``header``. The constructor takes the
    JAX package's arguments; see the module docstring for what is ported."""

    data_key = 'data'

    def __init__(self, path, cleaned=True, subsamples=False, unpack_bits=False, fields='DEFAULT_FIELDS', verbose=False, cleandir=None,
                 filter_func=None, halo_lc=None, passthrough=False, **kwargs):
        if kwargs:
            raise ValueError(f'CompaSOHaloCatalog got unexpected keyword arguments: '
                             f'{sorted(kwargs)}')
        probe = path if isinstance(path, (PurePath, str)) else path[0]
        if halo_lc or (halo_lc is None and _is_path_halo_lc(probe)):
            raise NotImplementedError(f'halo light-cone catalogs are not ported yet ({_LATER})')
        if passthrough or unpack_bits is not False:
            raise NotImplementedError(f'passthrough and unpack_bits are not ported yet ({_LATER})')
        self.halo_lc = False
        self.cleaned = bool(cleaned)
        self.filter_func = filter_func
        self.verbose = verbose
        self.groupdir, self.halo_fns = _resolve_halo_info_files(path)
        self.superslab_inds = np.array([_slab_id(fn) for fn in self.halo_fns])
        if cleaned:
            self.clean_halo_info_dir, self.clean_rvpid_dir, self.cleaned_halo_fns = (
                _locate_cleaning_files(self.groupdir, cleandir, self.superslab_inds))
        else:
            self.clean_halo_info_dir = self.clean_rvpid_dir = None
            self.cleaned_halo_fns = []
        self.load_AB, self.load_pidrv = _parse_subsample_request(subsamples)

        with open_asdf(self.halo_fns[0]) as af:
            self.header = dict(af['header'])
        self.header['cleaned_halos'] = self.cleaned
        if cleaned:
            with open_asdf(self.cleaned_halo_fns[0]) as af:
                zprev = af['header']['TimeSliceRedshiftsPrev']
            self.header['TimeSliceRedshiftsPrev'] = zprev
            self.header['NumTimeSliceRedshiftsPrev'] = len(zprev)

        self.fields, self.cleaned_fields = self._select_fields(fields)
        halos_per_slab = self._read_halo_info()
        self.subsamples = Table()
        if self.load_AB:
            edges = self._plan_zipper_layout()
            self._load_subsamples(halos_per_slab, edges)
            self._install_zipper_indices(edges)
        if cleaned:
            self.halos.rename_column('N_total', 'N')
        if verbose:
            print(self)

    def _select_fields(self, fields):
        """(halo_info columns, cleaning-file columns) of the `fields` request
        (compaso.py:_select_fields for a box)."""
        if isinstance(fields, str) and fields in ('DEFAULT_FIELDS', 'all'):
            raise NotImplementedError(
                f'fields={fields!r}: list the fields; the rest of CompaSOHaloCatalog\'s fields '
                f'is not ported yet ({_LATER})')
        wanted = [fields] if isinstance(fields, str) else list(fields)
        from_clean = []
        if self.cleaned:
            wanted = [f for f in wanted if f != 'N']
            if 'N_total' not in wanted:
                wanted.append('N_total')
            from_clean = [n for n in clean_dt.names if n in set(wanted)]
            wanted = [f for f in wanted if f not in from_clean]
        for ab in self.load_AB:
            if self.cleaned:
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
                            holder = caf if name in clean_dt.names else af
                            raw[name] = np.asarray(holder[self.data_key][name])
                        return raw[name]

                    cols = {}
                    for field in self.fields + self.cleaned_fields:
                        dt, loader = _field_loader(field)
                        value = loader(read, box, kms)
                        cols[field] = np.empty(len(value), dtype=dt)
                        cols[field][...] = value
                finally:
                    if caf is not None:
                        caf.close()
            if self.filter_func:
                view = Table(cols, meta=self.header, copy=False)
                if self.cleaned:
                    view.rename_column('N_total', 'N')
                mask = np.asarray(self.filter_func(view))
                cols = {k: v[mask] for k, v in cols.items()}
            per_slab.append(cols)
            counts.append(len(next(iter(cols.values()))))
        self.halos = Table(
            {k: np.concatenate([c[k] for c in per_slab]) for k in per_slab[0]},
            meta=self.header, copy=False)
        return np.array(counts)

    def _plan_zipper_layout(self):
        """{AB: uint64 edges (len(halos) + 1)}: where each surviving halo's
        zippered particles (its own, then those it absorbed) start
        (compaso.py:_plan_zipper_layout). Halos merged away (N_total = 0)
        contribute nothing; their npout is zeroed for the read."""
        edges_by_set, base = {}, 0
        n = len(self.halos)
        for AB in self.load_AB:
            counts = self.halos[f'npout{AB}']
            if self.cleaned:
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

    def _load_subsamples(self, halos_per_slab, edges_by_set):
        """Read each slab's RVint subsample files and write each halo's own
        and absorbed particles at its zippered span
        (compaso.py:_load_subsamples)."""
        n_total = int(edges_by_set[self.load_AB[-1]][-1])
        for w in self.load_pidrv:
            self.subsamples.add_column(np.empty((n_total, 3), np.float32), name=w, copy=False)
        slab_edges = np.concatenate([[0], np.cumsum(halos_per_slab)]).astype(np.int64)
        boxsize = self.header['BoxSize']
        for AB in self.load_AB:
            kind = f'halo_rv_{AB}'
            for i, slab in enumerate(self.superslab_inds):
                with open_asdf(Path(self.groupdir) / kind / f'{kind}_{slab:03d}.asdf') as af:
                    slab_particles = np.asarray(af[self.data_key]['rvint'])
                lo, hi = int(slab_edges[i]), int(slab_edges[i + 1])
                rd_lens = self.halos[f'npout{AB}'][lo:hi]
                w_starts = edges_by_set[AB][lo:hi].astype(np.int64)
                segments = [(_ragged_gather(self.halos[f'npstart{AB}'][lo:hi], rd_lens),
                             _ragged_gather(w_starts, rd_lens), slab_particles)]
                if self.cleaned:
                    fn = self.clean_rvpid_dir / f'cleaned_rvpid_{slab:03d}.asdf'
                    with open_asdf(fn) as cl:
                        clean_particles = np.asarray(cl[self.data_key][f'rvint_{AB}'])
                    c_lens = self.halos[f'npout{AB}_merge'][lo:hi]
                    segments.append((
                        _ragged_gather(self.halos[f'npstart{AB}_merge'][lo:hi], c_lens),
                        _ragged_gather(w_starts + rd_lens.astype(np.int64), c_lens),
                        clean_particles))
                for ridx, widx, particles in segments:
                    if not len(ridx):
                        continue
                    p, v = unpack_rvint(
                        particles[ridx], boxsize,
                        posout=None if 'pos' in self.subsamples else False,
                        velout=None if 'vel' in self.subsamples else False)
                    if 'pos' in self.subsamples:
                        self.subsamples['pos'][widx] = p
                    if 'vel' in self.subsamples:
                        self.subsamples['vel'][widx] = v

    def _install_zipper_indices(self, edges_by_set):
        """Replace the on-disk npstart / npout (and _merge) columns by the
        zippered layout's (compaso.py:_install_zipper_indices)."""
        for AB in self.load_AB:
            stale = [f'npstart{AB}', f'npout{AB}']
            if self.cleaned:
                stale += [f'npstart{AB}_merge', f'npout{AB}_merge']
            for name in stale:
                self.halos.remove_column(name)
            edges = edges_by_set[AB]
            self.halos.add_column(edges[:-1], name=f'npstart{AB}', copy=False)
            self.halos.add_column(np.diff(edges).astype(np.uint32), name=f'npout{AB}',
                                  copy=False)

    def __repr__(self):
        title = f'{self.header["SimName"]} @ z={self.header["Redshift"]:.5g}'
        return '\n'.join([
            'CompaSO Halo Catalog', '=' * 20, title, '-' * len(title),
            f'     Halos: {len(self.halos):8.3g} halos, {len(self.halos.colnames):3d} fields',
            f'Subsamples: {len(self.subsamples):8.3g} particles',
            f'Cleaned halos: {self.cleaned}', 'Halo light cone: False',
        ])
