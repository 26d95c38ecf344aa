"""CompaSO halo catalogs (the counterpart of
abacusutils_tpu/io/compaso.py:CompaSOHaloCatalog): periodic boxes and halo
light cones.

- Halo fields: every field of the JAX package's loaders
  (compaso.py:_build_loaders), in the same float32 arithmetic, so each
  column is bit-equal to it: the int16 radius ratios of ``r100{suf}``
  (``r10`` ... ``r98``, ``rvcirc_max``), the velocity dispersions
  (``sigmav{Min,Maj,rad,tan}{suf}`` as int16 ratios of ``sigmav3d{suf}``,
  ``Maj`` stored as ``Max``; ``sigmavMid{suf}`` derived from the loaded
  ``sigmav3d``, ``sigmavMaj`` and ``sigmavMin``), ``sigmar{suf}`` and
  ``sigman{suf}``, positions and radii times the box, velocities times
  VelZSpace_to_kms, the integer and SO columns, the euler16 eigenvectors
  (:func:`unpack_euler16`), the cleaning files' columns (progenitor columns
  ``NumTimeSliceRedshiftsPrev`` wide) and the light cone's columns
  (``origin`` modulo 3; ``pos_interp`` / ``vel_interp`` take the averaged
  value of every halo whose ``pos_avg`` is not zero). {suf} is ``_com`` or
  ``_L2com``. ``fields`` takes a list, a name, ``'DEFAULT_FIELDS'``
  (user_dt, plus clean_dt when cleaned, halo_lc_dt on a light cone) or
  ``'all'`` (clean_dt_progen in place of clean_dt). A field derived from
  other halo fields loads them into the slab's working set only: they
  reach ``halos`` when asked for.
- ``convert_units=False``: the box and the velocity scale are 1.0.
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
- ``filter_func`` (a function of a slab's halo Table returning a mask),
  ``header`` and ``nbytes``.
"""

import re
import warnings
from pathlib import Path, PurePath

import numpy as np

from . import bitpacked
from .asdf_file import open_asdf
from .table import Table

__all__ = ['CompaSOHaloCatalog', 'unpack_euler16', 'user_dt', 'clean_dt', 'clean_dt_progen',
           'halo_lc_dt']

INT16SCALE = 32000.0

# euler16 eigenvector compression constants (Abacus HaloStat format)
EULER_ABIN = 45
EULER_TBIN = 11
EULER_NORM = 1.8477590650225735122  # 1/sqrt(1-1/sqrt(2))


def unpack_euler16(packed):
    """Decode euler16-compressed orthonormal eigenvector triples
    (compaso.py:unpack_euler16): the 16-bit code is az-bin + 45 * (t-r bin
    + 121 * cap), cap in 0..11 selecting the major axis' dominant
    coordinate and the signs and order of the other two, the minor axis
    rebuilt from its azimuth bin by orthogonality. Returns (minor, middle,
    major), each (N, 3) float64."""
    packed = np.asarray(packed)
    N = len(packed)

    rest, iaz = np.divmod(packed, EULER_ABIN)
    cap, tr = np.divmod(rest, EULER_TBIN * EULER_TBIN)
    it = np.floor(np.sqrt(tr)).astype(int)
    ir = tr - it * it

    t = (it + 0.5) / EULER_TBIN
    r = (ir + 0.5) / (it + 0.5) - 1.0

    t = t / EULER_NORM
    t = t * np.sqrt(2.0 - t * t) / (1.0 - t * t)  # back to yy/zz

    yy = t
    xx = r * t
    norm = 1.0 / np.sqrt(1.0 + xx * xx + yy * yy)
    zz = norm
    yy = yy * norm
    xx = xx * norm

    major = np.zeros((N, 3))
    sgn = np.where((cap % 4) % 2 == 0, 1.0, -1.0)
    swap = (cap % 4) >= 2  # whether xx and yy are swapped
    a = np.where(swap, xx, sgn * yy)
    b = np.where(swap, sgn * yy, xx)
    axis = cap // 4  # the coordinate that carries zz
    for ax in range(3):
        m = axis == ax
        major[m, ax] = zz[m]
        major[m, (ax + 1) % 3] = a[m]
        major[m, (ax + 2) % 3] = b[m]

    az = (iaz + 0.5) * (np.pi / EULER_ABIN)
    cx = np.cos(az)
    cy = np.sin(az)

    minor = np.zeros((N, 3))
    for ax, (i, j, k) in zip(range(3), [(1, 2, 0), (2, 0, 1), (0, 1, 2)]):
        m = axis == ax
        minor[m, i] = cx[m]
        minor[m, j] = cy[m]
        minor[m, k] = (minor[m, i] * major[m, i] + minor[m, j] * major[m, j]) / (-major[m, k])
    minor /= np.linalg.norm(minor, axis=1)[:, None]

    middle = np.cross(minor, major)
    middle /= np.linalg.norm(middle, axis=1)[:, None]
    return minor, middle, major


# the AbacusSummit data model's tables (compaso.py:111-250)
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

clean_dt_progen = np.dtype(
    [
        ('npstartA_merge', np.int64),
        ('npstartB_merge', np.int64),
        ('npoutA_merge', np.uint32),
        ('npoutB_merge', np.uint32),
        ('N_total', np.uint32),
        ('N_merge', np.uint32),
        ('haloindex', np.uint64),
        ('is_merged_to', np.int64),
        ('N_mainprog', np.uint32),
        ('vcirc_max_L2com_mainprog', np.float32),
        ('sigmav3d_L2com_mainprog', np.float32),
        ('haloindex_mainprog', np.int64),
        ('v_L2com_mainprog', np.float32, 3),
    ],
    align=True,
)

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


def _so(com):
    return 'SO_L2max' if com == '_L2com' else 'SO'


user_dt = np.dtype(
    [('id', np.uint64), ('npstartA', np.uint64), ('npstartB', np.uint64), ('npoutA', np.uint32),
     ('npoutB', np.uint32), ('ntaggedA', np.uint32), ('ntaggedB', np.uint32), ('N', np.uint32),
     ('L2_N', np.uint32, 5), ('L0_N', np.uint32)]
    + [f for com in ('_com', '_L2com') for f in (
        [(f'x{com}', np.float32, 3), (f'v{com}', np.float32, 3)]
        + [(f'{n}{com}', np.float32) for n in ('sigmav3d', 'meanSpeed', 'sigmav3d_r50',
                                               'meanSpeed_r50', 'r100', 'vcirc_max')]
        + [(f'{_so(com)}_central_particle', np.float32, 3),
           (f'{_so(com)}_central_density', np.float32), (f'{_so(com)}_radius', np.float32)])]
    + [f for com in ('_com', '_L2com') for f in (
        [(f'sigmav{w}{com}', np.float32) for w in ('Min', 'Mid', 'Maj')]
        + [(f'r{p}{com}', np.float32) for p in (10, 25, 33, 50, 67, 75, 90, 95, 98)]
        + [(f'sigmar{com}', np.float32, 3), (f'sigman{com}', np.float32, 3)]
        + [(f'sigma{rnv}_eigenvecs{w}{com}', np.float32, 3)
           for rnv in 'rvn' for w in ('Min', 'Mid', 'Maj')]
        + [(f'sigmavrad{com}', np.float32), (f'sigmavtan{com}', np.float32),
           (f'rvcirc_max{com}', np.float32)])],
    align=True,
)

_SUF = r'(?P<suf>_(?:L2)?com)'


def _sigmav(m, raw, halos, box, kms):
    stem = m['kind'].replace('Maj', 'Max')
    return raw(stem + '_to_sigmav3d' + m['suf'] + '_i16') * raw('sigmav3d' + m['suf']) \
        / INT16SCALE * kms


def _sigmav_mid(m, raw, halos, box, kms):
    suf = m['suf']
    return np.sqrt(halos('sigmav3d' + suf) ** 2 - halos('sigmavMaj' + suf) ** 2
                   - halos('sigmavMin' + suf) ** 2)


def _lc_interp(m, raw, halos, box, kms):
    # the averaged position or velocity where the halo has one (pos_avg not
    # zero), else the interpolated one; both columns decode together
    have_avg = np.any(np.atleast_2d(raw('pos_avg')), axis=1)[:, None]
    return {f'{pv}_interp': np.where(have_avg, raw(f'{pv}_avg'), raw(f'{pv}_interp'))
            for pv in ('pos', 'vel')}


def _eigvecs(m, raw, halos, box, kms):
    # one euler16 word a halo holds the three eigenvectors
    vecs = unpack_euler16(raw(m['base'] + m['suf'] + '_u16'))
    return {m['base'] + w + m['suf']: v for w, v in zip(('Min', 'Mid', 'Maj'), vecs)}


_STORED = ('id|npstartA|npstartB|npoutA|npoutB|ntaggedA|ntaggedB|N|L2_N|L0_N|N_total|N_merge'
           '|npstartA_merge|npstartB_merge|npoutA_merge|npoutB_merge|npoutA_L0L1|npoutB_L0L1'
           '|is_merged_to|N_mainprog|vcirc_max_L2com_mainprog|sigmav3d_L2com_mainprog|haloindex'
           '|haloindex_mainprog|v_L2com_mainprog')

# (pattern, loader(match, raw, halos, box, kms), the halo fields it derives
# from): compaso.py:_build_loaders, pattern for pattern. raw(name) reads a
# stored column of the slab, halos(name) a loaded halo field; a loader
# returns the column, or a dict of the columns one read decodes together.
# The JAX package finds sigmavMid's halo fields by probing its loader
# (_ColumnProbe); here they are listed.
_LOADERS = [
    (re.compile(r'(?:r\d{1,2}|rvcirc_max)' + _SUF),
     lambda m, raw, halos, box, kms: raw(m[0] + '_i16') * raw('r100' + m['suf']) / INT16SCALE
     * box, ()),
    (re.compile(r'(?P<kind>sigmav(?:Min|Maj|rad|tan))' + _SUF), _sigmav, ()),
    (re.compile(r'sigmavMid' + _SUF), _sigmav_mid,
     ('sigmav3d{suf}', 'sigmavMaj{suf}', 'sigmavMin{suf}')),
    (re.compile(r'sigmar' + _SUF),
     lambda m, raw, halos, box, kms: raw(m[0] + '_i16') * np.reshape(raw('r100' + m['suf']),
                                                                     (-1, 1)) / INT16SCALE * box,
     ()),
    (re.compile(r'sigman' + _SUF),
     lambda m, raw, halos, box, kms: raw(m[0] + '_i16') / INT16SCALE, ()),
    (re.compile(r'(x|r100)' + _SUF), lambda m, raw, halos, box, kms: raw(m[0]) * box, ()),
    (re.compile(r'(v|sigmav3d|meanSpeed|sigmav3d_r50|meanSpeed_r50|vcirc_max)' + _SUF),
     lambda m, raw, halos, box, kms: raw(m[0]) * kms, ()),
    (re.compile(_STORED), lambda m, raw, halos, box, kms: raw(m[0]), ()),
    (re.compile(r'SO(?:_L2max)?(?:_central_particle|_radius)'),
     lambda m, raw, halos, box, kms: raw(m[0]) * box, ()),
    (re.compile(r'SO(?:_L2max)?(?:_central_density)'),
     lambda m, raw, halos, box, kms: raw(m[0]), ()),
    (re.compile(r'N_interp|index_halo|pos_avg|vel_avg|redshift_interp'),
     lambda m, raw, halos, box, kms: raw(m[0]), ()),
    (re.compile(r'origin'), lambda m, raw, halos, box, kms: raw(m[0]) % 3, ()),
    (re.compile(r'(?P<pv>pos|vel)_interp'), _lc_interp, ()),
    (re.compile(r'(?P<base>sigma(?:r|n|v)_eigenvecs)(?P<which>Min|Mid|Maj)' + _SUF), _eigvecs,
     ()),
]

# the progenitor columns, one value a previous time slice
# (compaso.py:968-977)
_PROGEN_WIDE = ('N_mainprog', 'vcirc_max_L2com_mainprog', 'sigmav3d_L2com_mainprog')


def _match_loader(field):
    """(match, loader, the halo fields it derives from) of a halo field;
    KeyError for a field no pattern matches (compaso.py:_match_loader)."""
    found = [(m, fn, deps) for pat, fn, deps in _LOADERS for m in [pat.fullmatch(field)] if m]
    if not found:
        raise KeyError(f'No loader pattern matches halo field "{field}"')
    if len(found) > 1:
        raise KeyError(f'Field "{field}" matches multiple loader patterns')
    m, fn, deps = found[0]
    return m, fn, [d.format(suf=m['suf']) for d in deps]


def _plan_field_loads(fields):
    """(load order, the fields loaded only as dependencies): each field after
    the halo fields it derives from (compaso.py:_plan_field_loads)."""
    order, placed = [], set()

    def visit(field, stack=()):
        if field in placed:
            return
        if field in stack:
            raise KeyError(f'Circular dependency while loading "{field}"')
        for dep in _match_loader(field)[2]:
            visit(dep, stack + (field,))
        placed.add(field)
        order.append(field)

    for f in fields:
        visit(f)
    requested = set(fields)
    return order, [f for f in order if f not in requested]


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
        self.convert_units = convert_units
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
        presets = {'DEFAULT_FIELDS': clean_dt, 'all': clean_dt_progen}
        if isinstance(fields, str) and fields in presets:
            wanted = list(user_dt.names)
            if self._read_clean:
                wanted += list(presets[fields].names)
            if self.halo_lc:
                wanted += list(halo_lc_dt.names)
        else:
            wanted = [fields] if isinstance(fields, str) else list(fields)
        from_clean = []
        if self._read_clean:
            wanted = [f for f in wanted if f != 'N']
            if 'N_total' not in wanted:
                wanted.append('N_total')
            from_clean = [n for n in clean_dt_progen.names if n in set(wanted)]
            wanted = [f for f in wanted if f not in from_clean]
        if self.halo_lc:
            # a light cone holds the L2 halo stats and its own columns
            wanted = [f for f in wanted if 'L2' in f or f in halo_lc_dt.names]
        if self._read_clean:
            for ab in self.load_AB:
                wanted += [c for c in (f'npstart{ab}', f'npout{ab}') if c not in wanted]
                from_clean += [c for c in (f'npstart{ab}_merge', f'npout{ab}_merge')
                               if c not in from_clean]
        _plan_field_loads(wanted + from_clean)  # KeyError for a field without a loader
        return wanted, from_clean

    def _field_dtype(self, field, af):
        """The loaded column's dtype (compaso.py:_field_dt): clean_dt_progen's
        for a cleaning column, halo_lc_dt's or user_dt's for the rest, the
        progenitor columns NumTimeSliceRedshiftsPrev wide; a field outside
        the tables (npoutA_L0L1, npoutB_L0L1) keeps its stored dtype."""
        if field in clean_dt_progen.names:
            dt = clean_dt_progen[field]
            if field in _PROGEN_WIDE and 'NumTimeSliceRedshiftsPrev' in self.header:
                dt = np.dtype((dt, self.header['NumTimeSliceRedshiftsPrev']))
            return dt
        for table in (halo_lc_dt, user_dt):
            if field in table.names:
                return table[field]
        return np.asarray(af[self.data_key][field]).dtype

    def _read_halo_info(self):
        """Read and convert the requested columns of every slab into
        ``self.halos``, each slab filtered by ``filter_func``; returns the
        halos kept per slab. The halo fields a requested field derives from
        are loaded into the slab's working set (and the filter's view) and
        dropped after it."""
        if self.convert_units:
            box, kms = self.header['BoxSize'], self.header['VelZSpace_to_kms']
        else:
            box, kms = 1.0, 1.0
        requested = self.fields + self.cleaned_fields
        order, extra = ([], []) if self.passthrough else _plan_field_loads(requested)
        needed = set(order)
        per_slab, counts = [], []
        cleaned_fns = self.cleaned_halo_fns or [None] * len(self.halo_fns)
        for fn, cfn in zip(self.halo_fns, cleaned_fns):
            with open_asdf(fn) as af:
                caf = open_asdf(cfn) if cfn is not None else None
                try:
                    raw = {}

                    def read(name, af=af, caf=caf, raw=raw):
                        if name not in raw:
                            if self.passthrough:
                                holder = caf if name in self.cleaned_fields else af
                            else:
                                holder = (caf if caf is not None and name in clean_dt_progen.names
                                          else af)
                            raw[name] = np.asarray(holder[self.data_key][name])
                        return raw[name]

                    cols = {}
                    if self.passthrough:
                        cols = {field: np.array(read(field)) for field in requested}
                    for field in order:
                        if field in cols:
                            continue
                        m, loader, _ = _match_loader(field)
                        value = loader(m, read, cols.__getitem__, box, kms)
                        for name, v in (value.items() if isinstance(value, dict)
                                        else [(field, value)]):
                            if name in needed:
                                cols[name] = np.empty(len(v), dtype=self._field_dtype(name, af))
                                cols[name][...] = v
                finally:
                    if caf is not None:
                        caf.close()
            if self.filter_func:
                view = Table(cols, meta=self.header, copy=False)
                if self.cleaned and not self.passthrough:
                    view.rename_column('N_total', 'N')
                mask = np.asarray(self.filter_func(view))
                cols = {k: v[mask] for k, v in cols.items()}
            per_slab.append({k: cols[k] for k in requested})
            counts.append(len(cols[requested[0]]) if requested else 0)
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

    def nbytes(self, halos=True, subsamples=True):
        """The bytes of the halo and / or subsample columns
        (compaso.py:nbytes)."""
        tables = [t for t, keep in ((self.halos, halos), (self.subsamples, subsamples)) if keep]
        return sum(t[c].nbytes for t in tables for c in t.columns)

    def __repr__(self):
        title = f'{self.header["SimName"]} @ z={self.header["Redshift"]:.5g}'
        return '\n'.join([
            'CompaSO Halo Catalog', '=' * 20, title, '-' * len(title),
            f'     Halos: {len(self.halos):8.3g} halos, {len(self.halos.colnames):3d} fields',
            f'Subsamples: {len(self.subsamples):8.3g} particles',
            f'Cleaned halos: {self.cleaned}', f'Halo light cone: {self.halo_lc}',
        ])
