r"""AbacusHOD on PyTorch + CUDA: the fused P(k) route and the two-step route.

Counterpart of abacusutils_tpu/models/hod/abacus_hod.py limited to:

- ``run_hod_pk_fused`` (the HOD-inference inner loop: one call per
  likelihood evaluation, LRG + ELG + QSO populated together, every auto and
  cross P(k) returned in the ``compute_power`` key schema), its light-cone
  leg ``_run_hod_pk_fused_lc`` and ``_reseed_randoms``;
- the two-step route ``run_hod`` (galaxy catalogs on the host) ->
  ``compute_power`` (P(k, mu) and Legendre poles of every tracer pair), and
  the host mass-function integrals ``compute_ngal``;
- NFW satellites (``run_hod(want_nfw=True)``, the only satellites of a
  secondary redshift), the ECSV catalogs of ``run_hod(write_to_disk=True)``
  and their reader ``gal_reader`` (``io/table.py``);
- the configuration-space statistics of a ``run_hod`` mock,
  ``compute_xirppi``, ``compute_wp`` and ``compute_multipole`` (and
  ``compute_clustering``, which picks one by ``clustering_type``), through
  the pair counts of ``ops/tpcf.py``;
- the control variates of a mock: ``apply_zcv`` (P_ell(k)) and
  ``apply_zcv_xi`` (xi_ell(r) at the field level), on the in-memory
  products of ``models/zcv/precompute.py``.

The object is built from a simulation on disk with
:meth:`AbacusHOD.from_config` (the JAX constructor's arguments: the tables
the port's ``prepare_sim.main`` wrote, staged by ``staging.py``), or from a
staged state (``convert.staged_state_from_numpy`` carries a JAX object's
state over). Columns may be numpy arrays or tensors: the first call moves
the columns it needs to the device once, stages them, and caches the stage.
"""

import logging
import time
from pathlib import Path

import numpy as np
import torch

from ...convert import params_to_tensors
from ...ops.grid import _f32
from ...ops.power import (
    _binned_spectra,
    _field_fft,
    _spectrum,
    get_k_mu_edges,
    get_W_compensated,
)
from ...ops.tpcf import calc_multipole_fast, calc_wp_fast, calc_xirppi_fast
from ..pipeline import (
    RSD_MARGIN,
    group_inputs2d_linked_device,
    hod_pk_fused_multi,
    make_bin_plan_arrays,
    pk_grouped_multi,
    populate_lc_multi,
)
from . import shapes_np
from .population import (
    _RANK_COLUMNS,
    TRACER_ORDER,
    _column,
    _index,
    _or_zeros,
    flat_catalogs,
    halo_catalog,
    populate_flat,
    populate_nfw,
    prepare_tracer_params,
    write_catalogs,
)

__all__ = ['AbacusHOD']

_log = logging.getLogger('AbacusHOD')


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class AbacusHOD:
    """The fused HOD -> P(k) route over a staged AbacusSummit catalog.

    halo_data / particle_data: the column dicts of the JAX ``staging()``
    (``hpos``, ``hvel``, ``hveldev`` (N, 3); ``hmass``, ``hmultis``,
    ``hrandoms``, ``hsigma3d``, optional ``hdeltac``/``hfenv``/``hshear``;
    ``ppos``, ``pvel``, ``phvel`` (P, 3); ``phmass``, ``pweights``,
    ``prandoms``, ``pinds``, optional ``pdeltac``/``pfenv``/``pshear`` and
    the ``pranks*`` columns; NFW satellites read the halos' ``hc`` (the
    concentration r98 / r25), ``hrvir`` (r98) and ``hsigma3d``, and no
    particle: a secondary redshift's particle columns are empty). params:
    ``z``, ``Lbox``, ``velz2kms``, ``origin`` (light cone) and ``chunk``
    (-1, the default, for the whole box). tracers: tracer -> HOD parameter
    dict. mock_dir: the catalog directory of the simulation and redshift
    (the JAX ``staging()``'s ``mock_dir``, ``output_dir/sim_name/z{z:.3f}``),
    which ``run_hod(write_to_disk=True)`` writes into and ``gal_reader``
    reads; None refuses both.
    """

    def __init__(
        self, halo_data, particle_data, params, tracers, device, *,
        want_ranks=False, want_shear=False, want_expvel=False, halo_lc=False,
        z_type='primary', clustering_type=None, mock_dir=None, want_rsd=True,
    ):
        self.halo_data = dict(halo_data)
        self.particle_data = dict(particle_data)
        self.params = dict(params)
        self.tracers = tracers
        self.device = torch.device(device)
        self.want_ranks = want_ranks
        self.want_shear = want_shear
        self.want_expvel = want_expvel
        self.halo_lc = halo_lc
        self.z_type = z_type
        self.clustering_type = clustering_type
        self.want_rsd = want_rsd
        self.mock_dir = None if mock_dir is None else Path(mock_dir)
        self.lbox = float(self.params['Lbox'])
        self.z_mock = self.params['z']
        self._fused_stage = None  # (key, brick stage of the box or light-cone leg)
        self._flat_stage_cache = None  # (key, flat catalogs of run_hod)
        hmass = _host(self.halo_data['hmass'])
        self.logMbins = np.linspace(np.log10(np.min(hmass)), np.log10(np.max(hmass)), 101)
        self.deltacbins = np.linspace(-0.5, 0.5, 101)
        self.fenvbins = np.linspace(-0.5, 0.5, 101)
        self.shearbins = np.linspace(-0.5, 0.5, 101)
        # K1's overflow word of the last call: the galaxies whose stencil
        # left their brick's tile (RSD moved them further than the margin),
        # deposited straight into the grid
        self.deposit_overflow = torch.zeros(1, dtype=torch.int32, device=self.device)

    @classmethod
    def from_config(cls, sim_params, HOD_params, clustering_params=None, chunk=-1, n_chunks=1,
                    device=None):
        """The object the JAX constructor builds from a config
        (abacus_hod.py:33-117, with staging): `sim_params` (``sim_name``,
        ``sim_dir``, ``subsample_dir``, ``z_mock``, ``output_dir``,
        ``force_mt``, ``local_env``) and `HOD_params` (``tracer_flags``, each
        traced tracer's ``<tracer>_params``, ``want_ranks``, ``want_AB``,
        ``want_shear``, ``want_expvel``), staged from prepare_sim's tables
        on disk (``staging.py``); ``want_rsd`` becomes the attribute the
        samplers' lnprob reads. clustering_params, where given, sets ``pimax``,
        ``pi_bin_size``, ``rpbins`` (logspace of its ``bin_params``) and
        ``clustering_type``, as JAX's constructor does (abacus_hod.py:73-82).
        device: where the columns go (None: the card)."""
        from ...convert import resolve_device
        from .prepare_sim import z_type_of
        from .staging import staging

        if chunk >= n_chunks:
            raise ValueError('Total number of chunks needs to be larger than current chunk index')
        flags = HOD_params['tracer_flags']
        tracers = {k: HOD_params[k + '_params'] for k in flags if flags[k]}
        device = resolve_device(device)
        halo_data, particle_data, params, mock_dir = staging(sim_params, HOD_params, chunk,
                                                             n_chunks)
        if HOD_params.get('want_AB', False):
            assert 'hfenv' in halo_data and 'hdeltac' in halo_data
        hod = cls(
            halo_data, particle_data, params, tracers, device,
            want_ranks=HOD_params.get('want_ranks', False),
            want_shear=HOD_params.get('want_shear', False),
            want_expvel=HOD_params.get('want_expvel', False),
            halo_lc=sim_params.get('halo_lc', False),
            z_type=z_type_of(sim_params['z_mock'], sim_params.get('halo_lc', False)),
            mock_dir=mock_dir, want_rsd=HOD_params['want_rsd'],
        )
        if clustering_params is not None:
            hod.pimax = clustering_params.get('pimax', None)
            hod.pi_bin_size = clustering_params.get('pi_bin_size', None)
            bin_params = clustering_params['bin_params']
            hod.rpbins = np.logspace(bin_params['logmin'], bin_params['logmax'],
                                     bin_params['nbins'] + 1)
            hod.clustering_type = clustering_params.get('clustering_type', None)
        return hod

    # ------------------------------------------------------------------
    def _reseed_randoms(self, reseed):
        """Regenerate the pre-attached halo/particle randoms in place
        (reference run_hod:706-760 contract: same PCG64 stream order).
        Invalidates both cached device stages."""
        start = time.time()
        rng = np.random.default_rng(np.random.PCG64(reseed))
        H = len(self.halo_data['hrandoms'])
        r1 = rng.random(H, dtype=np.float32)
        if self.want_expvel:
            rt = rng.random((3, H), dtype=np.float32).T
            r2 = np.zeros((H, 3), dtype=np.float32)
            hi = rt >= 0.5
            r2[hi] = -np.log(2 * (1 - rt[hi]))
            r2[~hi] = np.log(2 * rt[~hi])
        else:
            r2 = np.stack(
                [rng.standard_normal(H, dtype=np.float32) for _ in range(3)], axis=1
            )
        r3 = rng.random(len(self.particle_data['prandoms']), dtype=np.float32)
        self.halo_data['hrandoms'] = r1.astype(np.float64)
        self.halo_data['hveldev'] = (
            r2.astype(np.float64) * _host(self.halo_data['hsigma3d'])[:, None] / np.sqrt(3)
        )
        self.particle_data['prandoms'] = r3.astype(np.float64)
        self._fused_stage = None
        self._flat_stage_cache = None
        _log.info(f'Randoms generated in elapsed time {time.time() - start:.2f} s.')

    def _tracer_tensors(self, tracers, want):
        tp = prepare_tracer_params({t: tracers[t] for t in want}, self.params['z'])
        return {t: params_to_tensors(tp[t], self.device) for t in want}

    def _box_stage(self, nmesh, yb):
        """(halo_g, part_g, plan_h, plan_p) of the box leg, staged by the
        bricks of the objects' cells before RSD (with a z margin) and cached
        by (nmesh, yb, want_shear, want_ranks, device): the staged column
        set depends on the flags, so toggling one restages."""
        key = (int(nmesh), yb, bool(self.want_shear), bool(self.want_ranks), self.device)
        if self._fused_stage is not None and self._fused_stage[0] == key:
            return self._fused_stage[1]
        self._fused_stage = None  # free the old stage before building the new one
        hd, pd, dev = self.halo_data, self.particle_data, self.device

        def c(a, k=None):
            return _column(a, dev, k)

        halo = {
            'x': c(hd['hpos'], 0), 'y': c(hd['hpos'], 1), 'z': c(hd['hpos'], 2),
            'vz': c(hd['hvel'], 2), 'vdevz': c(hd['hveldev'], 2), 'mass': c(hd['hmass']),
            'multis': c(hd['hmultis']), 'randoms': c(hd['hrandoms']),
            'deltac': _or_zeros(hd, 'hdeltac', 'hmass', dev),
            'fenv': _or_zeros(hd, 'hfenv', 'hmass', dev),
        }
        part = {
            'x': c(pd['ppos'], 0), 'y': c(pd['ppos'], 1), 'z': c(pd['ppos'], 2),
            'vz': c(pd['pvel'], 2), 'hvelz': c(pd['phvel'], 2), 'hmass': c(pd['phmass']),
            'weights': c(pd['pweights']), 'randoms': c(pd['prandoms']),
            'deltac': _or_zeros(pd, 'pdeltac', 'phmass', dev),
            'fenv': _or_zeros(pd, 'pfenv', 'phmass', dev),
            'hidx': _index(pd['pinds'], dev),
        }
        if self.want_shear:
            halo['shear'] = c(hd['hshear'])
            part['shear'] = c(pd['pshear'])
        if self.want_ranks:
            for k, col in _RANK_COLUMNS:
                part[k] = c(pd[col])
        stage = group_inputs2d_linked_device(halo, part, nmesh, self.lbox, yb)
        self._fused_stage = (key, stage)
        return stage

    def _lc_stage(self, nmesh, yb):
        """(halo_g, part_g, plan_h, plan_p) of the light-cone leg: the flat
        catalogs (population.flat_catalogs, without the catalog mass and id)
        staged by the bricks of the objects' raw positions before RSD, with a
        margin of RSD_MARGIN cells on every axis (the line of sight moves all
        three coordinates); part_g['hidx'] is each particle's host in the
        staged halo order. Cached with the box leg's stage, by (nmesh, yb,
        want_shear, want_ranks, device)."""
        key = ('lc', int(nmesh), yb, bool(self.want_shear), bool(self.want_ranks), self.device)
        if self._fused_stage is not None and self._fused_stage[0] == key:
            return self._fused_stage[1]
        self._fused_stage = None
        halo, part = flat_catalogs(
            self.halo_data, self.particle_data, self.device, self.want_shear, self.want_ranks
        )
        for cat in (halo, part):
            del cat['cat_mass'], cat['cat_id']
        halo_g, part_g, plan_h, plan_p = group_inputs2d_linked_device(
            halo, part, nmesh, self.lbox, yb, margin=(RSD_MARGIN,) * 3, shift=0.0
        )
        part_g['hidx'] = part_g.pop('hkeep_at')
        stage = (halo_g, part_g, plan_h, plan_p)
        self._fused_stage = (key, stage)
        return stage

    def _flat_stage(self, particles=True):
        """Flat device catalogs in catalog order (population.flat_catalogs,
        with the shear columns the state holds), for run_hod, cached by
        (want_ranks, device). Without `particles` (NFW satellites) only the
        halos are staged, or taken from a cached stage of both; the
        particles are then None."""
        key = (bool(self.want_ranks), self.device)
        cached = self._flat_stage_cache
        if cached is not None and cached[0] == key and (cached[1][1] is not None or not particles):
            return cached[1]
        self._flat_stage_cache = None
        if particles:
            stage = flat_catalogs(
                self.halo_data, self.particle_data, self.device, True, self.want_ranks
            )
        else:
            stage = (halo_catalog(self.halo_data, self.device, True), None)
        self._flat_stage_cache = (key, stage)
        return stage

    def _clustering(self, spectra, ng, want, nmesh, nbins_k, counts):
        """The compute_power key schema from the device bin sums (waits for
        the device)."""
        wsum = torch.stack(list(spectra.values())).cpu().numpy()
        ng = torch.stack([ng[t] for t in want]).cpu().numpy()
        lbox = self.lbox
        kedges, _ = get_k_mu_edges(lbox, np.pi * nmesh / lbox, nbins_k, 1, False)
        clustering = {'k_binc': 0.5 * (kedges[1:] + kedges[:-1])}
        nonzero = counts != 0
        for (t1, t2), w in zip(spectra, wsum):
            P = np.divide(w, counts, out=np.zeros_like(w), where=nonzero) * lbox**3
            clustering[f'{t1}_{t2}'] = P
            clustering[f'{t1}_{t2}_modes'] = counts
            if t1 != t2:
                clustering[f'{t2}_{t1}'] = P
                clustering[f'{t2}_{t1}_modes'] = counts
        return clustering, {t: float(n) for t, n in zip(want, ng)}

    def _wcomp(self, nmesh, compensated):
        if not compensated:
            return None
        W = get_W_compensated(self.lbox, nmesh, 'TSC', False).astype(np.float32)
        return torch.from_numpy(W).to(self.device)

    def run_hod_pk_fused(
        self, tracers=None, want_rsd=True, nmesh=256, nbins_k=None, yb=None, reseed=None,
        compensated=True, mesh=None, slab=None,
    ):
        """Populate + TSC paint + FFT + every tracer auto/cross P(k) monopole
        on the device (abacus_hod.py:run_hod_pk_fused): two deposit launches
        and one rfftn per tracer, one binning launch for all pairs. The
        staged catalogs and the bin plan are cached, so a repeated call with
        new HOD parameters pays only the device step.

        `yb` sets the y extent of the deposit's bricks (None:
        ``ops.grid.BRICK``'s): it changes the order of summation, not the
        results (JAX's `yb` is its y-block). Returns ``(clustering,
        n_gal)``: clustering has the compute_power keys ('{t1}_{t2}',
        '{t1}_{t2}_modes', both orders of each cross pair, 'k_binc') as
        numpy arrays; n_gal maps tracer -> galaxy count. With ``halo_lc``
        set, the light-cone leg runs instead."""
        if mesh is not None or slab is not None:
            raise NotImplementedError(
                'sharded fused P(k) (mesh=, slab=) is not ported yet: ROADMAP.md queue 1, item 6 (multi-GPU)'
            )
        if tracers is None:
            tracers = self.tracers
        if self.halo_lc:
            return self._run_hod_pk_fused_lc(
                tracers, want_rsd, nmesh, nbins_k, yb, reseed, compensated
            )
        if self.z_type == 'secondary':
            raise RuntimeError(
                'Secondary redshifts have no particle subsamples; the fused '
                'path needs particle-based satellites'
            )
        if reseed:
            self._reseed_randoms(reseed)
        nbins_k = nmesh // 2 if nbins_k is None else nbins_k

        halo_g, part_g, plan_h, plan_p = self._box_stage(nmesh, yb)
        seg, counts = make_bin_plan_arrays(nmesh, self.lbox, nbins_k, self.device)
        want = tuple(t for t in TRACER_ORDER if t in tracers)
        self.deposit_overflow.zero_()
        spectra, ng = hod_pk_fused_multi(
            halo_g, part_g, self._tracer_tensors(tracers, want), seg,
            self._wcomp(nmesh, compensated), self.lbox, float(self.params['velz2kms']), want,
            int(nmesh), yb, int(nbins_k), plan_h, plan_p, rsd=bool(want_rsd),
            overflow=self.deposit_overflow,
        )
        return self._clustering(spectra, ng, want, nmesh, nbins_k, counts)

    def _run_hod_pk_fused_lc(
        self, tracers, want_rsd, nmesh, nbins_k, yb, reseed, compensated,
    ):
        """Light-cone leg of run_hod_pk_fused: populate the cached
        brick-staged catalogs (:meth:`_lc_stage`) with per-galaxy
        line-of-sight RSD from the light-cone origin (populate_lc_multi),
        then deposit each tracer's displaced centrals and satellites in the
        stage's order, two launches per tracer, and bin every pair in one
        launch (pk_grouped_multi). A galaxy displaced past its brick's margin
        goes straight into the grid (the overflow word counts it). The
        galaxies never reach the host."""
        if reseed:
            self._reseed_randoms(reseed)
        lbox = self.lbox
        nbins_k = nmesh // 2 if nbins_k is None else nbins_k

        halo, part, plan_h, plan_p = self._lc_stage(nmesh, yb)
        want = tuple(t for t in TRACER_ORDER if t in tracers)
        origin = torch.from_numpy(np.asarray(self.params['origin'], np.float32)).to(self.device)
        # 1.0 / velz2kms in f64 on the host, then f32 (abacus_hod.py:999)
        tr, ng = populate_lc_multi(
            halo, part, self._tracer_tensors(tracers, want), want, bool(want_rsd),
            _f32(1.0 / float(self.params['velz2kms'])), origin,
        )
        groups = {}
        for tracer in want:
            xc, yc, zc, wc, xs, ys, zs, ws = tr.pop(tracer)
            groups[tracer] = [(xc, yc, zc, wc, plan_h), (xs, ys, zs, ws, plan_p)]

        seg, counts = make_bin_plan_arrays(nmesh, lbox, nbins_k, self.device)
        self.deposit_overflow.zero_()
        spectra, ng = pk_grouped_multi(
            groups, ng, seg, self._wcomp(nmesh, compensated), lbox, int(nmesh), yb,
            int(nbins_k), want, overflow=self.deposit_overflow,
        )
        return self._clustering(spectra, ng, want, nmesh, nbins_k, counts)

    # ------------------------------------------------------------------
    def run_hod(
        self, tracers=None, want_rsd=True, want_nfw=False, NFW_draw=None, reseed=None,
        write_to_disk=False, Nthread=None, verbose=False, fn_ext=None,
    ):
        """Populate the staged catalog with galaxies (abacus_hod.py:run_hod).
        Returns the mock dict: per tracer {Ncent, x, y, z, vx, vy, vz, mass,
        id} as numpy, centrals first.

        The keep codes are those of run_hod_pk_fused (the same functions on
        the same columns, so each tracer gets the same galaxy count); the
        flat device catalogs are the light-cone leg's stage, cached; only
        the kept rows are copied to the host, into page-locked memory. The
        halo and particle shear columns are used where present, as the JAX
        gen_gals uses them. With want_nfw, the satellites follow NFW
        profiles drawn on the host from the sample `NFW_draw`
        (population.populate_nfw); the particles are not staged.

        write_to_disk: one ECSV table a tracer in
        ``{mock_dir}/galaxies{_rsd}{fn_ext}/{tracer}s.dat`` (``{tracer}s_
        chunk{n}.dat`` when params' chunk is not -1), meta Ncent, Gal_type
        and the tracer's HOD parameters; raises when the object has no
        mock_dir."""
        if tracers is None:
            tracers = self.tracers
        if self.z_type == 'secondary' and not want_nfw:
            raise RuntimeError(
                'Secondary redshifts do not have particle pos/vel outputs; '
                'only NFW profiles are supported'
            )
        if write_to_disk and tracers and self.mock_dir is None:
            raise ValueError('write_to_disk=True needs the catalog directory: AbacusHOD(..., '
                             'mock_dir=...)')
        if reseed:
            self._reseed_randoms(reseed)
        start = time.time()
        want = tuple(t for t in TRACER_ORDER if t in tracers)
        tparams = prepare_tracer_params({t: tracers[t] for t in want}, self.params['z'])
        if want_nfw:
            halo, _ = self._flat_stage(particles=False)
            mock = populate_nfw(
                halo, self.halo_data, tparams, want, bool(want_rsd), self.params['velz2kms'],
                self.lbox, self.params.get('origin'), NFW_draw, verbose,
            )
        else:
            halo, part = self._flat_stage()
            mock = populate_flat(
                halo, part, tparams, want, bool(want_rsd), self.params['velz2kms'], self.lbox,
                self.params.get('origin'), verbose,
            )
        _log.info(f'HOD generated in elapsed time {time.time() - start:.2f} s.')
        if write_to_disk and tracers:
            write_catalogs(mock, tracers, self.mock_dir / (
                'galaxies' + ('_rsd' if want_rsd else '') + (fn_ext or '')),
                self.params.get('chunk', -1))
        return mock

    def gal_reader(self, output_dir=None, simname=None, sim_dir=None, z_mock=None,
                   want_rsd=True, tracers=None):
        """The galaxy tables of run_hod(write_to_disk=True) as {tracer:
        io.table.Table} (abacus_hod.py:gal_reader): ``{tracer}s.dat`` of
        ``{mock_dir}/galaxies{_rsd}``, or of ``{output_dir}/{simname}/
        z{z_mock:.3f}/galaxies{_rsd}`` when output_dir is given (simname
        then required; z_mock defaults to the object's)."""
        from ...io.table import Table

        if tracers is None:
            tracers = self.tracers
        if output_dir is None:
            if self.mock_dir is None:
                raise ValueError('gal_reader needs output_dir and simname, or the object\'s '
                                 'mock_dir')
            base = self.mock_dir
        else:
            if simname is None:
                raise ValueError('gal_reader: output_dir needs simname')
            z_mock = self.z_mock if z_mock is None else z_mock
            base = Path(output_dir) / simname / ('z%4.3f' % z_mock)
        mock_dir = base / ('galaxies' + ('_rsd' if want_rsd else ''))
        return {tracer: Table.read(mock_dir / f'{tracer}s.dat') for tracer in tracers}

    # ------------------------------------------------------------------
    def _weighted_hist(self, dims, bins):
        """Mass-function histogram plus per-bin weighted mean coordinates
        over the occupied bins only (abacus_hod.py:_weighted_hist, host
        numpy). Returns (H, [c_0, ..., c_{d-1}])."""
        hd = self.halo_data
        zerosH = np.zeros(len(hd['hmass']))
        cols = {
            'logM': np.log10(_host(hd['hmass'])),
            'deltac': _host(hd['hdeltac']) if 'hdeltac' in hd else zerosH,
            'fenv': _host(hd['hfenv']) if 'hfenv' in hd else zerosH,
            'shear': _host(hd['hshear']) if 'hshear' in hd else zerosH,
        }
        flat = None
        for d, name in enumerate(dims):
            edges = np.asarray(bins[d])
            x = cols[name]
            idx = np.searchsorted(edges, x, side='right') - 1
            # histogramdd convention: the rightmost edge belongs to the
            # last bin; samples outside the range are dropped
            idx[x == edges[-1]] = len(edges) - 2
            valid_d = (idx >= 0) & (idx <= len(edges) - 2)
            if flat is None:
                flat = np.zeros(len(x), np.int64)
                valid = valid_d
            else:
                valid &= valid_d
            flat = flat * (len(edges) - 1) + np.clip(idx, 0, len(edges) - 2)
        w = np.asarray(_host(hd['hmultis']), np.float64)[valid]
        flat = flat[valid]
        uniq, inv = np.unique(flat, return_inverse=True)
        H = np.bincount(inv, weights=w, minlength=len(uniq))
        centers = []
        for name in dims:
            Hd = np.bincount(inv, weights=w * cols[name][valid], minlength=len(uniq))
            centers.append((Hd / H).astype(np.float32))
        return H, centers

    @property
    def halo_mass_func(self):
        if not hasattr(self, '_hmf'):
            self._hmf = self._weighted_hist(
                ('logM', 'deltac', 'fenv'), [self.logMbins, self.deltacbins, self.fenvbins]
            )
        return self._hmf[0]

    @property
    def hmf_centers(self):
        self.halo_mass_func
        return self._hmf[1]

    @property
    def halo_mass_func_wshear(self):
        if not hasattr(self, '_hmf_wshear'):
            self._hmf_wshear = self._weighted_hist(
                ('logM', 'deltac', 'fenv', 'shear'),
                [self.logMbins, self.deltacbins, self.fenvbins, self.shearbins],
            )
        return self._hmf_wshear[0]

    @property
    def hmf_centers_wshear(self):
        self.halo_mass_func_wshear
        return self._hmf_wshear[1]

    def compute_ngal(self, tracers=None, Nthread=None):
        """Expected tracer counts from the halo mass function histograms
        (abacus_hod.py:compute_ngal, host numpy). Returns (ngal, fsat)."""
        if tracers is None:
            tracers = self.tracers
        ngal_dict = {}
        fsat_dict = {}
        for etracer, hod in tracers.items():
            Delta_a = 1.0 / (1 + self.z_mock) - 1.0 / (1 + hod.get('z_pivot', self.z_mock))
            logM_cut = hod['logM_cut'] + hod.get('logM_cut_pr', 0) * Delta_a
            logM1 = hod['logM1'] + hod.get('logM1_pr', 0) * Delta_a
            ic = hod.get('ic', 1)
            Ac, As_ = hod.get('Acent', 0), hod.get('Asat', 0)
            Bc, Bs = hod.get('Bcent', 0), hod.get('Bsat', 0)

            if etracer == 'ELG':
                Cc, Cs = hod.get('Ccent', 0), hod.get('Csat', 0)
                LOGM4, DC4, FE4, SH4 = self.hmf_centers_wshear
                M = 10**LOGM4
                lMc = logM_cut + Ac * DC4 + Bc * FE4 + Cc * SH4
                M1 = 10 ** (logM1 + As_ * DC4 + Bs * FE4 + Cs * SH4)
                ncent = shapes_np.N_cen_ELG_v1(
                    M, hod['p_max'], hod['Q'], lMc, hod['sigma'], hod['gamma']
                ) * ic
                nsat = shapes_np.N_sat_elg(
                    M, 10**lMc, hod['kappa'], M1, hod['alpha'], hod.get('A_s', 1)
                ) * ic
                M1_conf = 10 ** (hod.get('logM1_EE', logM1) + As_ * DC4 + Bs * FE4 + Cs * SH4)
                nsat_conf = shapes_np.N_sat_elg(
                    M, 10**lMc, hod['kappa'], M1_conf, hod.get('alpha_EE', hod['alpha']),
                    hod.get('A_s', 1),
                ) * ic
                w = self.halo_mass_func_wshear
                ngal_cent = float((w * ncent).sum())
                ngal_sat = float((w * (nsat * (1 - ncent) + nsat_conf * ncent)).sum())
            else:
                LOGM3, DC3, FE3 = self.hmf_centers
                M = 10**LOGM3
                lMc = logM_cut + Ac * DC3 + Bc * FE3
                M1 = 10 ** (logM1 + As_ * DC3 + Bs * FE3)
                if etracer == 'LRG':
                    ncent = shapes_np.n_cen_LRG(M, lMc, hod['sigma'])
                    nsat = shapes_np.n_sat_LRG_modified(
                        M, lMc, 10**lMc, M1, hod['sigma'], hod['alpha'], hod['kappa']
                    )
                elif etracer == 'QSO':
                    ncent = shapes_np.N_cen_QSO(M, lMc, hod['sigma'])
                    nsat = shapes_np.N_sat_generic(M, 10**lMc, hod['kappa'], M1, hod['alpha'])
                else:
                    continue
                w = self.halo_mass_func
                ngal_cent = float((w * ncent * ic).sum())
                ngal_sat = float((w * nsat * ic).sum())

            ngal_dict[etracer] = ngal_cent + ngal_sat
            fsat_dict[etracer] = ngal_sat / (ngal_cent + ngal_sat)
        return ngal_dict, fsat_dict

    # ------------------------------------------------------------------
    def compute_clustering(self, mock_dict, *args, **kwargs):
        """The statistic named by ``clustering_type`` ('xirppi', 'wp' or
        'multipole'), with that method's arguments."""
        if self.clustering_type == 'xirppi':
            return self.compute_xirppi(mock_dict, *args, **kwargs)
        if self.clustering_type == 'wp':
            return self.compute_wp(mock_dict, *args, **kwargs)
        if self.clustering_type == 'multipole':
            return self.compute_multipole(mock_dict, *args, **kwargs)
        raise ValueError(
            'clustering_type not implemented or not specified, use xirppi, wp, multipole'
        )

    def _pair_loop(self, mock_dict, fn, symmetrize=True):
        """Run fn(pos1, pos2) over every tracer pair (pos2 None for an auto)
        and return {'{t1}_{t2}': result}, a cross under both orders. Each
        tracer's x, y, z go to the device once as three 1-D float32 tensors;
        the pair counts cache their cell stage by those tensors, so the autos
        and crosses of a mock (and wp, xi and the multipoles within one call)
        share one stage a tracer (abacus_hod.py:_pair_loop)."""
        def col(a):
            if isinstance(a, torch.Tensor):
                return a.to(self.device, torch.float32)
            return torch.from_numpy(np.ascontiguousarray(a, np.float32)).to(self.device)

        staged = {tr: tuple(col(d[c]) for c in ('x', 'y', 'z')) for tr, d in mock_dict.items()}
        out = {}
        keys = list(mock_dict.keys())
        for i1, tr1 in enumerate(keys):
            for i2 in range(i1, len(keys)):
                tr2 = keys[i2]
                out[f'{tr1}_{tr2}'] = fn(staged[tr1], None if i1 == i2 else staged[tr2])
                if i1 != i2 and symmetrize:
                    out[f'{tr2}_{tr1}'] = out[f'{tr1}_{tr2}']
        return out

    def compute_xirppi(self, mock_dict, rpbins, pimax, pi_bin_size, Nthread=None):
        """xi(rp, pi) of every tracer pair (abacus_hod.py:compute_xirppi)."""
        def fn(p1, p2):
            return calc_xirppi_fast(
                rpbins=rpbins, pimax=pimax, pi_bin_size=pi_bin_size, lbox=self.lbox,
                pos1=p1, pos2=p2,
            )

        return self._pair_loop(mock_dict, fn)

    def compute_wp(self, mock_dict, rpbins, pimax, pi_bin_size=None, Nthread=None):
        """wp(rp) of every tracer pair (abacus_hod.py:compute_wp)."""
        def fn(p1, p2):
            return calc_wp_fast(rpbins=rpbins, pimax=pimax, lbox=self.lbox, pos1=p1, pos2=p2)

        return self._pair_loop(mock_dict, fn)

    def compute_multipole(
        self, mock_dict, rpbins, pimax, sbins, nbins_mu, orders=(0, 2), Nthread=None
    ):
        """wp(rp) followed by the multipoles xi_ell(s) of every tracer pair,
        concatenated (abacus_hod.py:compute_multipole)."""
        def fn(p1, p2):
            multi = calc_multipole_fast(
                sbins=sbins, lbox=self.lbox, nbins_mu=nbins_mu, orders=orders, pos1=p1, pos2=p2,
            )
            wp = calc_wp_fast(rpbins=rpbins, pimax=pimax, lbox=self.lbox, pos1=p1, pos2=p2)
            return np.concatenate((wp, multi))

        return self._pair_loop(mock_dict, fn)

    def apply_zcv(self, mock_dict, config, zcv=None, load_presaved=False):
        """Variance-reduced P_ell(k) of the mock's tracers by Zel'dovich
        control variates (abacus_hod.py:apply_zcv) on the products `zcv` of
        models/zcv/precompute.py (None: read from config's zcv_dir); see
        models/zcv/apply.py:apply_zcv."""
        from ..zcv.apply import apply_zcv

        return apply_zcv(self, mock_dict, config, zcv, load_presaved=load_presaved)

    def apply_zcv_xi(self, mock_dict, config, zcv=None, load_presaved=False):
        """Variance-reduced xi_ell(r) of a one-tracer RSD mock by
        field-level Zel'dovich control variates (abacus_hod.py:apply_zcv_xi)
        on the products `zcv` (None: read from config's zcv_dir); see
        models/zcv/apply.py:apply_zcv_xi."""
        from ..zcv.apply import apply_zcv_xi

        return apply_zcv_xi(self, mock_dict, config, zcv, load_presaved=load_presaved)

    def compute_power(
        self, mock_dict, nbins_k, nbins_mu, k_hMpc_max, logk, poles=(), paste='TSC',
        num_cells=550, compensated=False, interlaced=False,
    ):
        """P(k, mu) and Legendre poles of every tracer pair
        (abacus_hod.py:compute_power): each tracer's field is painted once
        with K1 (twice when interlaced) and transformed once, then one K3
        launch bins every auto and cross pair, applying the 1/N^3 scale and
        the window per mode. Keys: '{t1}_{t2}', '_modes', '_ell',
        '_ell_modes' for both orders of each pair, 'k_binc', 'mu_binc'."""
        lbox = self.lbox
        keys = list(mock_dict.keys())
        poles = [int(p) for p in poles]
        W = get_W_compensated(lbox, num_cells, paste, interlaced) if compensated else None
        self.deposit_overflow.zero_()
        ffts, scale = [], 1.0
        for tr in keys:
            d = mock_dict[tr]
            F, scale = _field_fft(
                (d['x'], d['y'], d['z']), lbox, num_cells, paste, d.get('w'), interlaced,
                self.device, self.deposit_overflow,
            )
            ffts.append(F)
        kbins, mubins = get_k_mu_edges(lbox, k_hMpc_max, nbins_k, nbins_mu, logk)
        dk = 2.0 * np.pi / lbox
        plan, res = _binned_spectra(ffts, W, scale, dk, kbins, mubins, poles)
        clustering = {}
        for i1, tr1 in enumerate(keys):
            for i2 in range(i1, len(keys)):
                tr2 = keys[i2]
                P = _spectrum(plan, dk, *res[(i1, i2)], lbox, poles, True)
                cols = {'': P['power'], '_modes': P['N_mode']}
                if poles:
                    cols['_ell'] = np.asarray(P['binned_poles']).T
                    cols['_ell_modes'] = P['N_mode_poles']
                for suffix, v in cols.items():
                    clustering[f'{tr1}_{tr2}{suffix}'] = v
                    if i1 != i2:
                        clustering[f'{tr2}_{tr1}{suffix}'] = v
        clustering['k_binc'] = (kbins[1:] + kbins[:-1]) * 0.5
        mu_binc = (mubins[1:] + mubins[:-1]) * 0.5
        clustering['mu_binc'] = np.broadcast_to(mu_binc, P['power'].shape)[0]
        return clustering
