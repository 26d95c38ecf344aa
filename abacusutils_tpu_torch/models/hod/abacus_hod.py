r"""AbacusHOD's fused P(k) route on PyTorch + CUDA.

Counterpart of abacusutils_tpu/models/hod/abacus_hod.py limited to
``run_hod_pk_fused`` (the HOD-inference inner loop: one call per likelihood
evaluation, LRG + ELG + QSO populated together, every auto and cross P(k)
returned in the ``compute_power`` key schema), its light-cone leg
``_run_hod_pk_fused_lc`` and ``_reseed_randoms``.

The object is built from the staged state that the JAX ``staging()``
returns (``convert.staged_state_from_numpy`` carries a JAX object's state
over); reading AbacusSummit files from disk is not part of the port yet.
Columns may be numpy arrays or tensors: the first call moves the columns it
needs to the device once, stages them, and caches the stage.
"""

import logging
import time

import numpy as np
import torch

from ...convert import params_to_tensors
from ...ops.grid import _f32, check_deposit_err, default_yblock, stage_grouped2d
from ...ops.power import get_k_mu_edges, get_W_compensated
from ..pipeline import (
    group_inputs2d_linked_device,
    hod_pk_fused_multi,
    make_bin_plan_arrays,
    pk_grouped_multi,
    populate_lc_multi,
)
from .population import TRACER_ORDER, prepare_tracer_params

__all__ = ['AbacusHOD']

_log = logging.getLogger('AbacusHOD')

_RANK_COLUMNS = (('ranks', 'pranks'), ('ranksv', 'pranksv'), ('ranksp', 'pranksp'),
                 ('ranksr', 'pranksr'))


def _host(a):
    return a.detach().cpu().numpy() if isinstance(a, torch.Tensor) else np.asarray(a)


class AbacusHOD:
    """The fused HOD -> P(k) route over a staged AbacusSummit catalog.

    halo_data / particle_data: the column dicts of the JAX ``staging()``
    (``hpos``, ``hvel``, ``hveldev`` (N, 3); ``hmass``, ``hmultis``,
    ``hrandoms``, ``hsigma3d``, optional ``hdeltac``/``hfenv``/``hshear``;
    ``ppos``, ``pvel``, ``phvel`` (P, 3); ``phmass``, ``pweights``,
    ``prandoms``, ``pinds``, optional ``pdeltac``/``pfenv``/``pshear`` and
    the ``pranks*`` columns). params: ``z``, ``Lbox``, ``velz2kms`` and
    ``origin`` (light cone). tracers: tracer -> HOD parameter dict.
    """

    def __init__(
        self, halo_data, particle_data, params, tracers, device, *,
        want_ranks=False, want_shear=False, want_expvel=False, halo_lc=False,
        z_type='primary',
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
        self.lbox = float(self.params['Lbox'])
        self._fused_stage = None  # (key, box stage)
        self._fused_lc_stage = None  # (key, flat light-cone catalogs)
        # the K1 error word of the last call (0: every point in its cell)
        self.deposit_err = torch.zeros(1, dtype=torch.int32, device=self.device)

    # ------------------------------------------------------------------
    def _col(self, a, k=None):
        """Column `a` (or column k of an (N, 3) array) as float32 on the device."""
        if isinstance(a, torch.Tensor):
            a = a if k is None else a[:, k]
            return a.to(self.device, torch.float32).contiguous()
        a = np.asarray(a) if k is None else np.asarray(a)[:, k]
        return torch.from_numpy(np.ascontiguousarray(a, dtype=np.float32)).to(self.device)

    def _idx(self, a):
        """An index column as int32 on the device."""
        if isinstance(a, torch.Tensor):
            return a.to(self.device, torch.int32)
        return torch.from_numpy(np.asarray(a, np.int32)).to(self.device)

    def _col_or_zeros(self, data, key, n):
        if key in data:
            return self._col(data[key])
        return torch.zeros(n, dtype=torch.float32, device=self.device)

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
        self._fused_lc_stage = None
        _log.info(f'Randoms generated in elapsed time {time.time() - start:.2f} s.')

    def _tracer_tensors(self, tracers, want):
        tp = prepare_tracer_params({t: tracers[t] for t in want}, self.params['z'])
        return {t: params_to_tensors(tp[t], self.device) for t in want}

    def _box_stage(self, nmesh, yb):
        """(halo_g, part_g, starts_h, starts_p) of the box leg, cached by
        (nmesh, yb, want_shear, want_ranks, device): the staged column set
        depends on the flags, so toggling one restages."""
        key = (int(nmesh), int(yb), bool(self.want_shear), bool(self.want_ranks), self.device)
        if self._fused_stage is not None and self._fused_stage[0] == key:
            return self._fused_stage[1]
        self._fused_stage = None  # free the old stage before building the new one
        hd, pd = self.halo_data, self.particle_data
        c = self._col
        n_h, n_p = len(hd['hmass']), len(pd['phmass'])
        halo = {
            'x': c(hd['hpos'], 0), 'y': c(hd['hpos'], 1), 'z': c(hd['hpos'], 2),
            'vz': c(hd['hvel'], 2), 'vdevz': c(hd['hveldev'], 2), 'mass': c(hd['hmass']),
            'multis': c(hd['hmultis']), 'randoms': c(hd['hrandoms']),
            'deltac': self._col_or_zeros(hd, 'hdeltac', n_h),
            'fenv': self._col_or_zeros(hd, 'hfenv', n_h),
        }
        part = {
            'x': c(pd['ppos'], 0), 'y': c(pd['ppos'], 1), 'z': c(pd['ppos'], 2),
            'vz': c(pd['pvel'], 2), 'hvelz': c(pd['phvel'], 2), 'hmass': c(pd['phmass']),
            'weights': c(pd['pweights']), 'randoms': c(pd['prandoms']),
            'deltac': self._col_or_zeros(pd, 'pdeltac', n_p),
            'fenv': self._col_or_zeros(pd, 'pfenv', n_p),
            'hidx': self._idx(pd['pinds']),
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

    def _lc_stage(self):
        """Flat device catalogs of the light-cone leg, cached by
        (want_shear, want_ranks, device)."""
        key = (bool(self.want_shear), bool(self.want_ranks), self.device)
        if self._fused_lc_stage is not None and self._fused_lc_stage[0] == key:
            return self._fused_lc_stage[1]
        self._fused_lc_stage = None
        hd, pd = self.halo_data, self.particle_data
        c = self._col
        n_h, n_p = len(hd['hmass']), len(pd['phmass'])
        halo = {
            'mass': c(hd['hmass']), 'multis': c(hd['hmultis']), 'randoms': c(hd['hrandoms']),
            'deltac': self._col_or_zeros(hd, 'hdeltac', n_h),
            'fenv': self._col_or_zeros(hd, 'hfenv', n_h),
        }
        part = {
            'hmass': c(pd['phmass']), 'weights': c(pd['pweights']),
            'randoms': c(pd['prandoms']),
            'deltac': self._col_or_zeros(pd, 'pdeltac', n_p),
            'fenv': self._col_or_zeros(pd, 'pfenv', n_p),
            'hidx': self._idx(pd['pinds']),
        }
        for i, a in enumerate('xyz'):
            halo[a] = c(hd['hpos'], i)
            halo[f'v{a}'] = c(hd['hvel'], i)
            halo[f'vdev{a}'] = c(hd['hveldev'], i)
            part[a] = c(pd['ppos'], i)
            part[f'v{a}'] = c(pd['pvel'], i)
            part[f'hvel{a}'] = c(pd['phvel'], i)
        if self.want_shear:
            halo['shear'] = c(hd['hshear'])
            part['shear'] = c(pd['pshear'])
        if self.want_ranks:
            for k, col in _RANK_COLUMNS:
                part[k] = c(pd[col])
        self._fused_lc_stage = (key, (halo, part))
        return halo, part

    def _clustering(self, spectra, ng, want, nmesh, nbins_k, counts):
        """The compute_power key schema from the device bin sums (waits for
        the device; raises if the deposit counted misstaged points)."""
        wsum = torch.stack(list(spectra.values())).cpu().numpy()
        ng = torch.stack([ng[t] for t in want]).cpu().numpy()
        check_deposit_err(self.deposit_err)
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

        Returns ``(clustering, n_gal)``: clustering has the compute_power
        keys ('{t1}_{t2}', '{t1}_{t2}_modes', both orders of each cross
        pair, 'k_binc') as numpy arrays; n_gal maps tracer -> galaxy count.
        With ``halo_lc`` set, the light-cone leg runs instead."""
        if mesh is not None or slab is not None:
            raise NotImplementedError(
                'sharded fused P(k) (mesh=, slab=) is not ported yet: ROADMAP item 12 (multi-GPU)'
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
        yb = default_yblock(nmesh) if yb is None else yb
        nbins_k = nmesh // 2 if nbins_k is None else nbins_k

        halo_g, part_g, starts_h, starts_p = self._box_stage(nmesh, yb)
        seg, counts = make_bin_plan_arrays(nmesh, self.lbox, nbins_k, self.device)
        want = tuple(t for t in TRACER_ORDER if t in tracers)
        self.deposit_err.zero_()
        spectra, ng = hod_pk_fused_multi(
            halo_g, part_g, self._tracer_tensors(tracers, want), seg,
            self._wcomp(nmesh, compensated), self.lbox, float(self.params['velz2kms']), want,
            int(nmesh), int(yb), int(nbins_k), starts_h, starts_p, rsd=bool(want_rsd),
            err=self.deposit_err,
        )
        return self._clustering(spectra, ng, want, nmesh, nbins_k, counts)

    def _run_hod_pk_fused_lc(
        self, tracers, want_rsd, nmesh, nbins_k, yb, reseed, compensated,
    ):
        """Light-cone leg of run_hod_pk_fused: populate the flat catalogs
        with per-galaxy line-of-sight RSD from the light-cone origin
        (populate_lc_multi), re-stage each tracer's displaced galaxies
        (centrals and satellites together, raw coordinates), then one
        deposit launch per tracer and one binning launch
        (pk_grouped_multi). The galaxies never reach the host."""
        if reseed:
            self._reseed_randoms(reseed)
        lbox = self.lbox
        yb = default_yblock(nmesh) if yb is None else yb
        nbins_k = nmesh // 2 if nbins_k is None else nbins_k

        halo, part = self._lc_stage()
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
            cols = [torch.cat(pair) for pair in ((xc, xs), (yc, ys), (zc, zs), (wc, ws))]
            staged, starts = stage_grouped2d(cols, nmesh, lbox, yb, shift=0.0)
            groups[tracer] = (*staged, starts)

        seg, counts = make_bin_plan_arrays(nmesh, lbox, nbins_k, self.device)
        self.deposit_err.zero_()
        spectra, ng = pk_grouped_multi(
            groups, ng, seg, self._wcomp(nmesh, compensated), lbox, int(nmesh), int(yb),
            int(nbins_k), want, err=self.deposit_err,
        )
        return self._clustering(spectra, ng, want, nmesh, nbins_k, counts)
