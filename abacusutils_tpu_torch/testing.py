"""Inputs that exercise the deposit's edge cases, for tests and chip_smoke.py,
a CPU twin of K7's walk for the tests, the NFW radial sample that
``AbacusHOD.run_hod(want_nfw=True)`` draws from, the reciso smoothing at
the k bins' centres that makes the field-level LCV flow the k-level one's,
and a synthetic AbacusSummit simulation on disk (CompaSO halo_info slabs,
A subsamples, field particles and cleaning files in the AbacusSummit
encodings), written with the port's own ASDF writer or another."""

import math
from pathlib import Path

import numpy as np
import torch

from .models.zcv.cosmo import get_meta

__all__ = ['edge_points', 'edge_points_centred', 'menv_ranges', 'menv_walk', 'nfw_draw',
           'smoothing_at_bin_centres', 'summit_header', 'synthetic_compaso',
           'write_compaso_sim', 'decoded_catalog']


def edge_points(n, nmesh, yb, box, rng):
    """(n, 3) float32 points in [0, box) with about half placed where the
    cell index is fragile: on TSC cell edges and their next float32 up,
    on block edges (every `yb` cells: K1's brick edges), at 0 and at box,
    just below box, and just below 0 (which the single periodic wrap maps
    onto box)."""
    h = np.float32(box) / np.float32(nmesh)
    pos = (rng.random((n, 3)) * box).astype(np.float32)
    m = rng.random((n, 3))
    cell_edge = ((rng.integers(0, nmesh + 1, (n, 3)) + 0.5) * h).astype(np.float32)
    block_edge = ((rng.integers(0, nmesh // yb + 1, (n, 3)) * yb - 0.5) * h).astype(np.float32)
    picks = [
        (0.2, cell_edge),
        (0.3, block_edge),
        (0.33, np.float32(box)),
        (0.36, np.nextafter(np.float32(box), np.float32(0))),
        (0.39, np.float32(-1e-6)),
        (0.42, np.float32(0)),
        (0.5, np.nextafter(cell_edge, np.float32(np.inf))),
    ]
    lo = 0.0
    for hi, val in picks:
        pos = np.where((m >= lo) & (m < hi), val, pos)
        lo = hi
    return pos


def edge_points_centred(n, nmesh, yb, box, rng):
    """(n, 3) float32 points of a box-centred catalog, about [-box/2, box/2),
    for the unwrapped CIC paint: about half lie where the cell index
    floor(p * nmesh / box + 0.5) is fragile, on cell edges at negative and
    positive coordinates and their next float32 up or down, on block
    edges (every `yb` cells), at -box/2 and just below box/2, and up to a cell outside the box
    (galaxies displaced past the edge). Every point lies within one box
    length of [0, box), the domain of TSC's single periodic wrap."""
    h = np.float32(box) / np.float32(nmesh)
    half = np.float32(box) / 2
    pos = (rng.random((n, 3)) * box - box / 2).astype(np.float32)
    m = rng.random((n, 3))
    k = rng.integers(-(nmesh // 2) - 1, nmesh // 2 + 1, (n, 3))
    cell_edge = ((k - 0.5) * h).astype(np.float32)
    jb = rng.integers(-((nmesh // yb) // 2), (nmesh // yb) // 2 + 1, (n, 3))
    block_edge = ((jb * yb - 0.5) * h).astype(np.float32)
    outside = (rng.random((n, 3)) * h + half).astype(np.float32) * np.where(m < 0.45, -1, 1)
    picks = [
        (0.15, cell_edge),
        (0.2, np.nextafter(cell_edge, np.float32(np.inf))),
        (0.25, np.nextafter(cell_edge, np.float32(-np.inf))),
        (0.3, block_edge),
        (0.33, -half),
        (0.36, np.nextafter(half, np.float32(0))),
        (0.42, np.float32(-1e-6)),
        (0.5, outside),
    ]
    lo = 0.0
    for hi, val in picks:
        pos = np.where((m >= lo) & (m < hi), val, pos)
        lo = hi
    return pos.astype(np.float32)


def menv_ranges(st):
    """The 27 neighbour ranges K7 finds for each of its work items (the 9
    rows around the item's, each over its cells k0 - 1 .. k1 + 1 in up to
    three pieces cut at the periodic seam), from the Menv stage `st`
    (models/hod/menv_device.py:MenvStage): (begin, length, wrap) as int64
    tensors of shapes (nitems, 27), (nitems, 27) and (nitems, 27, 3), in
    csrc/prepare_sim.cu's slot order (row (di, dj) lexicographic, then
    piece: inside, below 0, past nc - 1)."""
    cells = st.cells.long()
    work = st.work.long()
    q = st.query.long()
    i0, i1 = q[work[:, 0]], q[work[:, 1] - 1]
    ci, cj, k0, k1 = cells[0, i0], cells[1, i0], cells[2, i0], cells[2, i1]
    nc0, nc1, nc2 = st.ncs
    per = st.periodic
    dev = cells.device

    def neighbour(c, d, n):
        m = c + d
        w = torch.zeros_like(m)
        if not per:
            return torch.where((m >= 0) & (m < n), m, -1), w
        w = (m >= n).long() - (m < 0).long()
        m = m - w * n
        ok = (n >= 3) or (d == 0 if n == 1 else d >= 0)
        return (m if ok else torch.full_like(m, -1)), w

    begin, length, wrap = [], [], []
    for t in range(27):
        r, piece = divmod(t, 3)
        ni, wi = neighbour(ci, r // 3 - 1, nc0)
        nj, wj = neighbour(cj, r % 3 - 1, nc1)
        wk = torch.zeros_like(k0)
        if per and nc2 < 3:
            ka, kb = torch.zeros_like(k0), torch.full_like(k0, nc2 - 1 if piece == 0 else -1)
        elif piece == 0:
            ka, kb = (k0 - 1).clamp_min(0), (k1 + 1).clamp_max(nc2 - 1)
        elif per:
            edge = (k0 == 0) if piece == 1 else (k1 == nc2 - 1)
            ka = torch.full_like(k0, nc2 - 1 if piece == 1 else 0)
            kb = torch.where(edge, ka, -1)
            wk = torch.where(edge, -1 if piece == 1 else 1, 0)
        else:
            ka, kb = torch.zeros_like(k0), torch.full_like(k0, -1)
        base = (ni * nc1 + nj) * nc2
        lo, hi = base + ka, base + kb + 1
        if st.ukeys is not None:
            lo, hi = (torch.searchsorted(st.ukeys, v) for v in (lo, hi))
        ok = (ni >= 0) & (nj >= 0) & (ka <= kb)
        starts = st.starts.long()
        lo, hi = torch.where(ok, lo, 0), torch.where(ok, hi, 0)
        begin.append(torch.where(ok, starts[lo], 0))
        length.append(torch.where(ok, starts[hi] - starts[lo], 0))
        wrap.append(torch.stack([wi, wj, wk], 1))
    return (torch.stack(begin, 1), torch.stack(length, 1),
            torch.stack(wrap, 1).to(dev))


def menv_walk(st, lbox, rout2, pairs=False):
    """K7's walk on the CPU: for every item, the ranges of
    :func:`menv_ranges` laid end to end, each candidate outside its centre's
    27 cells (a z cell more than one away) skipped, the rest summed in that
    order with the kernel's float64 steps (the minimum image by division on
    a periodic grid of fewer than 5 cells an axis, else by the range's
    wrap). Returns Menv in cell order, bit for bit the kernel's; with
    pairs=True, the (centre, candidate) int64 index pairs the sums take,
    in walk order, instead."""
    from .models.hod.menv_device import K7_CENTRES, _SHIFT_MIN_CELLS

    x, y, z, m, rin2 = st.cols
    n = x.numel()
    out = torch.zeros(n, dtype=torch.float64)
    begin, length, wrap = menv_ranges(st)
    cum = torch.cumsum(length, 1)
    total = cum[:, -1]
    cum = cum - length  # each range's first place in the item's walk
    work = st.work.long()
    nitems = work.shape[0]
    slot = torch.arange(K7_CENTRES)
    qi = work[:, :1] + slot[None, :]
    active = qi < work[:, 1:]
    ci = torch.where(active, st.query.long()[qi.clamp_max(st.query.numel() - 1)], 0)
    kz = st.cells[2].long()
    rnd = st.periodic and min(st.ncs) < _SHIFT_MIN_CELLS
    acc = torch.zeros(ci.shape, dtype=torch.float64)
    found = []
    items = torch.arange(nitems)
    for pos in range(int(total.max()) if nitems else 0):
        live = pos < total
        r = (torch.searchsorted(cum, torch.full((nitems, 1), pos), right=True) - 1)[:, 0]
        j = begin[items, r] + pos - cum[items, r]
        j = torch.where(live, j, 0)
        dk = kz[j][:, None] - kz[ci]
        if st.periodic:
            nc2 = st.ncs[2]
            dk = torch.where(dk > 1, dk - nc2, torch.where(dk < -1, dk + nc2, dk))
        take = active & live[:, None] & (dk.abs() <= 1)
        d = []
        for a, col in enumerate((x, y, z)):
            da = col[ci] - col[j][:, None]
            if rnd:
                da = da - lbox * torch.round(da / lbox)
            elif st.periodic:
                da = da - (wrap[items, r, a].double() * lbox)[:, None]
            d.append(da)
        d2 = (d[0] * d[0] + d[1] * d[1]) + d[2] * d[2]
        ann = (d2 <= rout2).long() - (d2 <= rin2[ci]).long()
        mj = m[j][:, None].expand_as(acc)
        acc = torch.where(take & (ann > 0), acc + mj, torch.where(take & (ann < 0), acc - mj, acc))
        if pairs:
            found.append(torch.stack([ci[take], j[:, None].expand_as(ci)[take]], 1))
    if pairs:
        return torch.cat(found) if found else torch.zeros((0, 2), dtype=torch.int64)
    out[ci[active]] = acc[active]
    return out


def nfw_draw(n, c_max, seed):
    """`n` draws of x from P(x) ~ x / (1 + x)^2 on (0, c_max] (the NFW_draw
    of run_hod(want_nfw=True)), by the inverse of its cumulative m(x) =
    ln(1 + x) - x / (1 + x) on a table of 2e5 intervals; numpy, seeded."""
    x = np.linspace(0.0, c_max, 200_001)
    m = np.log1p(x) - x / (1 + x)
    u = np.random.default_rng(seed).random(n) * m[-1]
    return np.interp(u, m, x)


def smoothing_at_bin_centres(k_bin_edges):
    """A stand-in for ``ops.power.get_smoothing`` that gives every rfft mode
    exp(-kc^2 R^2 / 2), kc the centre of the k bin that ``bin_kmu`` puts the
    mode in (squared edges in units of the fundamental as float32,
    searchsorted left, clipped into the first and last bin), instead of the
    mode's own |k|. The k-level LCV flow smooths at the bin centres, so the
    field-level flow under this stand-in is the k-level flow's arithmetic:
    patched into ``models.zcv.tools_cv``, it shows that the two reciso flows
    differ only by where the smoothing is taken."""
    from .ops.power import _mode_geometry

    edges = np.asarray(k_bin_edges, np.float64)
    centres = 0.5 * (edges[1:] + edges[:-1])

    def get_smoothing(n1d, L, R, dtype=np.float32, device=None):
        n1d = int(n1d)
        kmag2, _, _ = _mode_geometry(n1d, device)
        dk = 2.0 * np.pi / L
        edges2 = torch.from_numpy(((edges / dk) ** 2).astype(np.float32)).to(kmag2.device)
        b = (torch.searchsorted(edges2, kmag2, side='left') - 1).clamp_(0, len(centres) - 1)
        kc = torch.from_numpy(centres).to(kmag2.device)[b]
        return torch.exp(-(kc * kc) * (R * R) / 2.0).to(torch.float32).reshape(
            n1d, n1d, n1d // 2 + 1)

    return get_smoothing


# ---------------------------------------------------------------------------
# a synthetic AbacusSummit simulation on disk
# ---------------------------------------------------------------------------

INT16SCALE = 32000.0
RV_POS_QUANTUM = 1e-6  # of the box: RVint's 20-bit position step
RV_VEL_QUANTUM = 6000.0 / 2048  # km/s: RVint's 12-bit velocity step


def summit_header(z=0.5):
    """A halo_info header for AbacusSummit_base_c000_ph000 at redshift z.
    The simulation's name, redshift, scale factor, box (2000 Mpc/h), H0,
    Omega_M, Omega_DE, ppd, particle mass and subsample fractions are the
    values of the JAX package's metadata, read from the port's extract
    (models/zcv/cosmo.py:get_meta). That metadata has no velocity scale, so
    VelZSpace_to_kms is approximated as 100 E(z) BoxSize / (1 + z), with
    E(z) from Omega_M and Omega_DE alone (no radiation, no neutrinos)."""
    meta = get_meta('AbacusSummit_base_c000_ph000', redshift=z)
    header = {k: meta[k] for k in (
        'SimName', 'Redshift', 'ScaleFactor', 'BoxSize', 'H0', 'Omega_M', 'Omega_DE', 'ppd',
        'ParticleMassHMsun', 'ParticleSubsampleA', 'ParticleSubsampleB')}
    ez = math.sqrt(meta['Omega_M'] * (1 + z) ** 3 + meta['Omega_DE'])
    header.update(SimSet='AbacusSummit', BoxSizeHMpc=meta['BoxSize'],
                  LightConeOrigins=[0.0, 0.0, 0.0],
                  VelZSpace_to_kms=100 * ez * meta['BoxSize'] / (1 + z))
    return header


def _rvint(pos_box, vel_kms):
    """RVint words of positions (box units, in [-0.5, 0.5)) and velocities
    (km/s, clipped to the 12-bit range)."""
    p = np.floor(pos_box / RV_POS_QUANTUM).astype(np.int32)
    v = np.clip(np.rint(vel_kms / RV_VEL_QUANTUM), -2048, 2047).astype(np.int32)
    return (p << 12) | (v + 2048)


def synthetic_compaso(n_slabs, n_halo, n_part, n_field, seed=0, merge_frac=0.05, z=0.5):
    """A synthetic CompaSO catalog of `n_slabs` x-slabs of a periodic box:
    about `n_halo` halos (N ~ N^-2 over [35, 1e5] particles, in clumps of
    sigma 8 Mpc/h), about `n_part` A-subsample particles laid out halo by
    halo (each within ~0.4 r100 of its halo), `n_field` field particles, and
    the cleaning: a `merge_frac` share of each slab's halos merged into
    other halos of the slab (N_total 0; their A particles listed again in the
    cleaned_rvpid file under the halo that absorbed them).

    Returns {'header', 'slabs': [per slab {'halo_info': the stored halo_info
    columns, 'clean': the cleaned_halo_info columns, 'rv_A', 'clean_rv_A',
    'field_rv_A' (RVint words), 'merged_into' (absorbing halo or -1),
    'clean_rows' (the rv_A row of each clean_rv_A row), 'pos_true' /
    'vel_true' (the A particles' positions in Mpc/h and velocities in km/s
    before encoding)}]}."""
    header = summit_header(z)
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    slabs = []
    for s in range(n_slabs):
        rng = np.random.default_rng([seed, s])
        n = n_halo // n_slabs + (n_halo % n_slabs if s == n_slabs - 1 else 0)
        xlo, xhi = -0.5 + s / n_slabs, -0.5 + (s + 1) / n_slabs
        N = (1.0 / (1 / 35 - rng.random(n) * (1 / 35 - 1e-5))).astype(np.uint32)
        ncl = max(1, n // 500)
        cen = np.column_stack([rng.uniform(xlo, xhi, ncl), rng.uniform(-0.5, 0.5, (ncl, 2))])
        pos = cen[rng.integers(0, ncl, n)] + rng.normal(0, 8.0 / box, (n, 3))
        pos[:, 1:] = np.mod(pos[:, 1:] + 0.5, 1.0) - 0.5
        pos[:, 0] = np.clip(pos[:, 0], xlo, xhi - 1e-6)
        cube = np.cbrt(N / 1e3)
        r100 = ((0.3 + 0.7 * cube) / box).astype(np.float32)
        sig = (100.0 + 200.0 * cube) / kms
        fa = min(1.0, n_part / n_slabs / float(N.sum()))
        npout = rng.binomial(N, fa).astype(np.uint32)
        npstart = np.concatenate([[0], np.cumsum(npout, dtype=np.uint64)[:-1]]).astype(np.uint64)
        halo_info = {
            'id': (np.uint64(s + 1) * np.uint64(10**10) + np.arange(n, dtype=np.uint64)),
            'npstartA': npstart, 'npoutA': npout, 'N': N,
            'x_L2com': pos.astype(np.float32),
            'v_L2com': (rng.normal(0, 300.0, (n, 3)) / kms).astype(np.float32),
            'r100_L2com': r100, 'sigmav3d_L2com': sig.astype(np.float32),
            'r90_L2com_i16': (rng.uniform(0.70, 0.85, n) * INT16SCALE).astype(np.int16),
            'r25_L2com_i16': (rng.uniform(0.15, 0.35, n) * INT16SCALE).astype(np.int16),
            'r98_L2com_i16': (rng.uniform(0.86, 0.99, n) * INT16SCALE).astype(np.int16),
        }
        owner = np.repeat(np.arange(n), npout)
        gauss = rng.standard_normal((2, len(owner), 3), dtype=np.float32)
        ppos = pos[owner] + gauss[0] * (0.4 * r100[owner])[:, None]
        ppos = np.mod(ppos + 0.5, 1.0) - 0.5
        pvel = (halo_info['v_L2com'][owner] * kms
                + gauss[1] * (sig[owner] * kms / np.sqrt(3))[:, None])
        pvel = np.clip(pvel, -2048 * RV_VEL_QUANTUM, 2047 * RV_VEL_QUANTUM)

        # the cleaning: merged halos and the halos that absorb them
        merged = rng.random(n) < merge_frac
        keep = np.flatnonzero(~merged)
        into = np.full(n, -1, np.int64)
        into[merged] = keep[rng.integers(0, len(keep), int(merged.sum()))]
        N_total = N.copy()
        N_total[merged] = 0
        np.add.at(N_total, into[merged], N[merged])
        n_merge = np.bincount(into[merged], weights=N[merged], minlength=n).astype(np.uint32)
        nout_merge = np.bincount(into[merged], weights=npout[merged],
                                 minlength=n).astype(np.uint32)
        donors = np.flatnonzero(merged)
        donors = donors[np.lexsort((donors, into[donors]))]
        clean_rows = np.concatenate([np.arange(int(npstart[d]), int(npstart[d]) + int(npout[d]))
                                     for d in donors] + [np.empty(0, np.int64)])
        rv = _rvint(ppos, pvel)
        clean = {
            'npstartA_merge': np.concatenate([[0], np.cumsum(nout_merge, dtype=np.int64)[:-1]]),
            'npstartB_merge': np.zeros(n, np.int64), 'npoutA_merge': nout_merge,
            'npoutB_merge': np.zeros(n, np.uint32), 'N_total': N_total, 'N_merge': n_merge,
            'haloindex': np.arange(n, dtype=np.uint64), 'is_merged_to': into,
            'haloindex_mainprog': np.full(n, -1, np.int64),
            'v_L2com_mainprog': np.zeros((n, 3), np.float32),
        }
        nf = n_field // n_slabs + (n_field % n_slabs if s == n_slabs - 1 else 0)
        fpos = rng.random((nf, 3), dtype=np.float32) * np.float32([xhi - xlo, 1, 1])
        fpos += np.float32([xlo, -0.5, -0.5])
        fvel = np.clip(300.0 * rng.standard_normal((nf, 3), dtype=np.float32), -2048 * RV_VEL_QUANTUM,
                       2047 * RV_VEL_QUANTUM)
        slabs.append({
            'halo_info': halo_info, 'clean': clean, 'rv_A': rv, 'clean_rv_A': rv[clean_rows],
            'field_rv_A': _rvint(fpos, fvel), 'merged_into': into, 'clean_rows': clean_rows,
            'pos_true': ppos * box, 'vel_true': pvel,
        })
    return {'header': header, 'slabs': slabs}


def write_compaso_sim(root, sim, writer=None, compression='blsc'):
    """Write `sim` (:func:`synthetic_compaso`) under `root` in the AbacusSummit
    layout: ``<SimName>/halos/z<z>/{halo_info,halo_rv_A,field_rv_A}/*_NNN.asdf``
    and ``cleaning/<SimName>/z<z>/{cleaned_halo_info,cleaned_rvpid}/``. The
    writer is the port's ``write_asdf`` unless another with its arguments
    ``(fn, tree, compression=)`` is given. Returns {'groupdir', 'files',
    'raw_bytes' (the arrays' bytes), 'disk_bytes'}."""
    if writer is None:
        from .io.asdf_file import write_asdf as writer
    header = sim['header']
    name, zdir = header['SimName'], f'z{header["Redshift"]:4.3f}'
    groupdir = Path(root) / name / 'halos' / zdir
    cleandir = Path(root) / 'cleaning' / name / zdir
    clean_header = dict(header, TimeSliceRedshiftsPrev=[0.575, 0.65, 0.725, 0.8])
    files, raw = [], 0
    for s, slab in enumerate(sim['slabs']):
        for path, hdr, data in (
            (groupdir / 'halo_info' / f'halo_info_{s:03d}.asdf', header, slab['halo_info']),
            (groupdir / 'halo_rv_A' / f'halo_rv_A_{s:03d}.asdf', header, {'rvint': slab['rv_A']}),
            (groupdir / 'field_rv_A' / f'field_rv_A_{s:03d}.asdf', header,
             {'rvint': slab['field_rv_A']}),
            (cleandir / 'cleaned_halo_info' / f'cleaned_halo_info_{s:03d}.asdf', clean_header,
             slab['clean']),
            (cleandir / 'cleaned_rvpid' / f'cleaned_rvpid_{s:03d}.asdf', clean_header,
             {'rvint_A': slab['clean_rv_A']}),
        ):
            path.parent.mkdir(parents=True, exist_ok=True)
            writer(path, {'header': hdr, 'data': data}, compression=compression)
            files.append(path)
            raw += sum(a.nbytes for a in data.values())
    return {'groupdir': groupdir, 'files': files, 'raw_bytes': raw,
            'disk_bytes': sum(f.stat().st_size for f in files)}


def decoded_catalog(sim, slabs, cleaned, particles=True):
    """What ``CompaSOHaloCatalog(<those slabs' files>, fields=[N, x_L2com,
    v_L2com, r90_L2com, r25_L2com, r98_L2com, npstartA, npoutA, id,
    sigmav3d_L2com], subsamples=dict(A=True, rv=True), cleaned=cleaned)``
    returns, from the arrays `sim` was written from: (halos, particles), dicts
    of numpy columns. The halo columns follow the encodings' decode formulas
    (float32 arithmetic, as the loaders); the particles (each surviving
    halo's own A particles, then those of the halos merged into it) are given
    as their RVint words 'rvint' and their values before encoding,
    'pos_true' and 'vel_true' (None without `particles`)."""
    header = sim['header']
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    halos, parts = [], []
    for s in slabs:
        slab = sim['slabs'][s]
        h, c = slab['halo_info'], slab['clean']
        n = len(h['N'])
        cols = {
            'x_L2com': h['x_L2com'] * box, 'v_L2com': h['v_L2com'] * kms,
            **{f'r{p}_L2com': h[f'r{p}_L2com_i16'] * h['r100_L2com'] / INT16SCALE * box
               for p in (90, 25, 98)},
            'id': h['id'], 'sigmav3d_L2com': h['sigmav3d_L2com'] * kms,
            'N': c['N_total'] if cleaned else h['N'],
        }
        # a survivor's own particles, then those of the halos merged into it
        # (in the cleaned file's order); a merged halo keeps none
        cols['npoutA'] = (np.where(slab['merged_into'] < 0, h['npoutA'], 0) + c['npoutA_merge']
                          if cleaned else h['npoutA']).astype(np.uint32)
        halos.append(cols)
        if not particles:
            continue
        owner = np.repeat(np.arange(n), h['npoutA'])
        rows = np.arange(len(owner))
        if cleaned:
            own = slab['merged_into'][owner] < 0
            absorber = slab['merged_into'][owner[slab['clean_rows']]]
            order = np.argsort(np.concatenate([2 * owner[own], 2 * absorber + 1]), kind='stable')
            src = np.concatenate([rows[own], slab['clean_rows']])[order]
            words = np.concatenate([slab['rv_A'][own], slab['clean_rv_A']])[order]
        else:
            src, words = rows, slab['rv_A']
        parts.append({'rvint': words, 'pos_true': slab['pos_true'][src],
                      'vel_true': slab['vel_true'][src]})
    out = {k: np.concatenate([c[k] for c in halos]) for k in halos[0]}
    out['npstartA'] = np.concatenate(
        [[0], np.cumsum(out['npoutA'], dtype=np.uint64)[:-1]]).astype(np.uint64)
    out['N'] = out['N'].astype(np.uint32)
    if not particles:
        return out, None
    return out, {k: np.concatenate([p[k] for p in parts]) for k in parts[0]}
