"""What the statistics share: tracer pairs, the comparison of galaxy counts
and of run_hod mocks, and the gaps of spectra."""

import numpy as np
import torch

TRACER_ORDER = ('LRG', 'ELG', 'QSO')


def want(tracers):
    return [t for t in TRACER_ORDER if t in tracers]


def pairs(ts):
    return [(ts[i], ts[j]) for i in range(len(ts)) for j in range(i, len(ts))]


def ngal_gap(got, ref):
    """The largest |n - n_ref| / n_ref over the tracers."""
    return max(abs(float(got[t]) - float(ref[t])) / max(float(ref[t]), 1.0) for t in ref)


def mock_columns(mock, device):
    """A run_hod mock ({tracer: {'id', 'x', ...}}, numpy) as {tracer: (id,
    pos (n, 3), vel (n, 3))} float64 tensors on `device`."""
    out = {}
    for t, d in mock.items():
        ids = torch.from_numpy(np.asarray(d['id'], np.int64)).to(device)
        pos = torch.from_numpy(np.stack([d[a] for a in 'xyz'], 1).astype(np.float64)).to(device)
        vel = torch.from_numpy(np.stack([d['v' + a] for a in 'xyz'], 1).astype(np.float64))
        out[t] = (ids, pos, vel.to(device))
    return out


def as_columns(keep, device):
    """A mock as {tracer: (id, pos, vel)} tensors on `device`: the program's
    numpy mock, or the reference's columns as they are."""
    if all(isinstance(v, tuple) for v in keep.values()):
        return {t: tuple(c.to(device) for c in v) for t, v in keep.items()}
    return mock_columns(keep, device)


def mock_gaps(got, ref, lbox):
    """Gaps of a mock against the reference's: the share of galaxies kept
    by one side alone, and over the galaxies both keep (matched by id) the
    largest position gap (Mpc/h, periodic) and velocity gap (km/s)."""
    keep = pos_gap = vel_gap = 0.0
    for t, (rid, rpos, rvel) in ref.items():
        gid, gpos, gvel = got[t]
        rs, ro = torch.sort(rid)
        gs, go = torch.sort(gid)
        if rs.numel():
            at = torch.searchsorted(rs, gs).clamp(max=rs.numel() - 1)
            hit = rs[at] == gs
        else:
            at = hit = torch.zeros_like(gs, dtype=torch.bool)
        both = int(hit.sum())
        alone = (gs.numel() - both) + (rs.numel() - both)
        keep = max(keep, alone / max(rs.numel(), 1))
        if both:
            gi, ri = go[hit], ro[at[hit]]
            d = (gpos[gi] - rpos[ri]).abs()
            d = torch.minimum(d, lbox - d)
            pos_gap = max(pos_gap, float(d.max()))
            vel_gap = max(vel_gap, float((gvel[gi] - rvel[ri]).abs().max()))
    return {'mock_keep_gap': keep, 'mock_pos_gap': pos_gap, 'mock_vel_gap': vel_gap}


def spectrum_gap(got, ref, autos, modes):
    """The largest gap of a spectrum in units of its bin's Gaussian sample
    variance: |P - P_ref| / (sqrt(P_ref,ii P_ref,jj) sqrt(2 / N_modes)) over
    pairs and bins, pole rows scaled by the monopole autos; bins without
    modes or power left out. got, ref: {(t1, t2): array (nk, ...)}; autos:
    {t: (nk,)}; modes: (nk,) mode counts of the bins."""
    gap = 0.0
    m = np.asarray(modes, np.float64).reshape(-1)
    for (t1, t2), r in ref.items():
        g = np.asarray(got[(t1, t2)], np.float64)
        r = np.asarray(r, np.float64)
        scale = np.sqrt(np.abs(autos[t1] * autos[t2]) * 2.0 / np.maximum(m, 1.0)) * (m > 0)
        scale = np.broadcast_to(scale.reshape(scale.shape + (1,) * (r.ndim - 1)), r.shape)
        ok = scale > 0
        if ok.any():
            gap = max(gap, float(np.max(np.abs(g - r)[ok] / scale[ok])))
    return gap


def modes_gap(got, ref):
    return max(float(np.max(np.abs(np.asarray(got[k], np.float64) - np.asarray(r, np.float64))))
               for k, r in ref.items())
