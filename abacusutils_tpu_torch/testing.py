"""Inputs that exercise the deposit's edge cases, for tests and chip_smoke.py,
a CPU twin of K7's walk for the tests, the NFW radial sample that
``AbacusHOD.run_hod(want_nfw=True)`` draws from, the reciso smoothing at
the k bins' centres that makes the field-level LCV flow the k-level one's,
a synthetic AbacusSummit simulation on disk (CompaSO halo_info slabs, A and
B subsamples with packed PIDs, field particles and cleaning files in the
AbacusSummit encodings) and a synthetic halo light cone with a light-cone
particle file pair, written with the port's own ASDF writer or another,
and a pack9 encoder."""

import math
from pathlib import Path

import numpy as np
import torch

from .metadata import get_meta

__all__ = ['edge_points', 'edge_points_centred', 'menv_ranges', 'menv_walk', 'nfw_draw',
           'smoothing_at_bin_centres', 'summit_header', 'rvint_words', 'pid_words',
           'synthetic_compaso', 'write_compaso_sim', 'decoded_catalog', 'decoded_fields',
           'TIME_SLICE_PREV', 'pack9_rows', 'LC_ORIGINS',
           'LC_SHELL', 'synthetic_compaso_lc', 'write_compaso_lc', 'decoded_catalog_lc']


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


# the observers of an AbacusSummit base box's halo light cones, Mpc/h: one
# 10 Mpc/h outside the box's corner and its two copies one box along z and
# along y (the AbacusSummit documentation, "Light Cones": three observers at
# (-990, -990, -990), (-990, -990, -2990) and (-990, -2990, -990))
LC_ORIGINS = [-990.0, -990.0, -990.0, -990.0, -990.0, -2990.0, -990.0, -2990.0, -990.0]
# the light cone's shell around z = 0.5, in Mpc/h from the first observer:
# about the comoving distances halfway to its neighbouring output
# redshifts (0.45 and 0.575) in the c000 cosmology
LC_SHELL = (1240.0, 1390.0)


def summit_header(z=0.5, light_cone=False):
    """A halo_info header for AbacusSummit_base_c000_ph000 at redshift z.
    The simulation's name, redshift, scale factor, box (2000 Mpc/h), H0,
    Omega_M, Omega_DE, ppd, particle mass and subsample fractions are the
    values of the metadata registry (abacusutils_tpu_torch.metadata:
    get_meta). That metadata has no velocity scale, so
    VelZSpace_to_kms is approximated as 100 E(z) BoxSize / (1 + z), with
    E(z) from Omega_M and Omega_DE alone (no radiation, no neutrinos).
    LightConeOrigins is a box's placeholder [0, 0, 0], or with
    `light_cone` the three observers of LC_ORIGINS."""
    meta = get_meta('AbacusSummit_base_c000_ph000', redshift=z)
    header = {k: meta[k] for k in (
        'SimName', 'Redshift', 'ScaleFactor', 'BoxSize', 'H0', 'Omega_M', 'Omega_DE', 'ppd',
        'ParticleMassHMsun', 'ParticleSubsampleA', 'ParticleSubsampleB')}
    ez = math.sqrt(meta['Omega_M'] * (1 + z) ** 3 + meta['Omega_DE'])
    header.update(SimSet='AbacusSummit', BoxSizeHMpc=meta['BoxSize'],
                  LightConeOrigins=list(LC_ORIGINS) if light_cone else [0.0, 0.0, 0.0],
                  VelZSpace_to_kms=100 * ez * meta['BoxSize'] / (1 + z))
    return header


def rvint_words(pos_box, vel_kms):
    """RVint words of positions (box units, in [-0.5, 0.5)) and velocities
    (km/s, clipped to the 12-bit range)."""
    p = np.floor(pos_box / RV_POS_QUANTUM).astype(np.int32)
    v = np.clip(np.rint(vel_kms / RV_VEL_QUANTUM), -2048, 2047).astype(np.int32)
    return (p << 12) | (v + 2048)


def pid_words(rng, n, ppd):
    """`n` packed PID words, each from one raw 64-bit draw: a Lagrangian
    index triple in [0, ppd) (15 bits each at bits 0, 16 and 32), the
    tagged bit 48 set on about half, a 10-bit density at bits 49-58; the
    other bits zero."""
    u = np.uint64
    r = rng.bit_generator.random_raw(n)
    i0, i1, i2 = (((r >> u(15 * k)) & u(0x7FFF)) % u(int(ppd)) for k in range(3))
    tagged, dens = (r >> u(45)) & u(1), (r >> u(46)) & u(0x3FF)
    return i0 | (i1 << u(16)) | (i2 << u(32)) | (tagged << u(48)) | (dens << u(49))


def _halo_particles(rng, owner, pos, v_box, r100, sig, kms, uniform=False):
    """Particles of the halos `owner` (box units, periodic), each within
    ~0.4 r100 of its halo, velocities the halo's plus sigma / sqrt(3) an
    axis (km/s, clipped to RVint's range): Gaussian offsets, or with
    `uniform` (cheaper to draw) uniform ones of the same spread."""
    if uniform:
        # a uniform variate on [-sqrt(3), sqrt(3)) has unit variance; float32
        # throughout
        f = np.float32
        d = rng.random((2, len(owner), 3), dtype=f)
        d -= f(0.5)
        d *= f(2 * np.sqrt(3))
        ppos = pos.astype(f)[owner]
        ppos += d[0] * (f(0.4) * r100[owner])[:, None]
        ppos -= np.floor(ppos + f(0.5))
        pvel = v_box[owner] * f(kms)
        pvel += d[1] * (sig[owner] * (kms / np.sqrt(3))).astype(f)[:, None]
    else:
        d = rng.standard_normal((2, len(owner), 3), dtype=np.float32)
        ppos = pos[owner] + d[0] * (0.4 * r100[owner])[:, None]
        ppos = np.mod(ppos + 0.5, 1.0) - 0.5
        pvel = v_box[owner] * kms + d[1] * (sig[owner] * kms / np.sqrt(3))[:, None]
    return ppos, np.clip(pvel, -2048 * RV_VEL_QUANTUM, 2047 * RV_VEL_QUANTUM)


# the previous time slices of the cleaning files' headers, and so the width
# of their progenitor columns
TIME_SLICE_PREV = [0.575, 0.65, 0.725, 0.8]
# the int16 radius ratios of r100 (io/compaso.py:user_dt)
RADII = (10, 25, 33, 50, 67, 75, 90, 95, 98)
EULER16_CODES = 45 * 121 * 12  # the valid euler16 words: 0 .. EULER16_CODES - 1


def _halo_stats(rng, n, sufs, have):
    """The AbacusSummit halo_info columns of every halo statistic of the
    centre-of-mass definitions `sufs` ('_com', '_L2com') that `have` does
    not hold yet, in their encodings: x and r100 in box units, v, sigmav3d,
    meanSpeed, sigmav3d_r50, meanSpeed_r50 and vcirc_max in units of
    VelZSpace_to_kms, the int16 ratios of r100 (r10 ... r98, rvcirc_max,
    sigmar 3 wide) and of sigmav3d (sigmav{Min,Max,rad,tan}), sigman 3 wide
    of 32000, the euler16 words of the three eigenvector sets and the SO
    columns (central particle and radius in box units, density as stored).
    `have` supplies the values the new ones scatter around (x_L2com,
    v_L2com, r100_L2com, sigmav3d_L2com). float32 draws, cheap at 10^6
    halos."""
    f = np.float32
    cols = {}

    def put(name, value):
        if name not in have:
            cols[name] = value

    def ratio(lo, hi, shape=None):
        u = rng.random(n if shape is None else (n, shape), dtype=f)
        return (u * f(hi - lo) + f(lo)) * f(INT16SCALE)

    x0, v0 = have['x_L2com'], have['v_L2com']
    r0, s0 = have['r100_L2com'], have['sigmav3d_L2com']
    for suf in sufs:
        so = 'SO_L2max' if suf == '_L2com' else 'SO'
        jitter = (rng.random((n, 3), dtype=f) - f(0.5)) * (f(0.1) * r0)[:, None]
        put(f'x{suf}', x0 + jitter)
        put(f'v{suf}', v0 * f(1.02))
        r100 = r0 * f(1.05)
        put(f'r100{suf}', r100)
        sig = s0 * f(0.98)
        put(f'sigmav3d{suf}', sig)
        for name, scale in (('meanSpeed', 1.1), ('sigmav3d_r50', 1.2), ('meanSpeed_r50', 1.15),
                            ('vcirc_max', 1.4)):
            put(f'{name}{suf}', s0 * f(scale) * (f(0.9) + f(0.2) * rng.random(n, dtype=f)))
        for p in RADII:
            put(f'r{p}{suf}_i16', ratio(0.6 * p / 100, 0.7 * p / 100 + 0.3).astype(np.int16))
        put(f'rvcirc_max{suf}_i16', ratio(0.1, 0.9).astype(np.int16))
        put(f'sigmar{suf}_i16', ratio(0.1, 0.9, 3).astype(np.int16))
        put(f'sigman{suf}_i16', ratio(-0.9, 0.9, 3).astype(np.int16))
        # Min and Max bound sigmav3d^2 - Max^2 - Min^2 >= 0: Mid is real
        for w, lo, hi in (('Min', 0.2, 0.45), ('Max', 0.5, 0.7), ('rad', 0.3, 0.8),
                          ('tan', 0.3, 0.8)):
            put(f'sigmav{w}_to_sigmav3d{suf}_i16', ratio(lo, hi).astype(np.int16))
        for rnv in 'rnv':
            put(f'sigma{rnv}_eigenvecs{suf}_u16',
                rng.integers(0, EULER16_CODES, n, dtype=np.uint16))
        put(f'{so}_central_particle', x0 + jitter * f(0.5))
        put(f'{so}_central_density', rng.random(n, dtype=f) * f(1e4) + f(200))
        put(f'{so}_radius', r100 * f(0.9))
    return cols


def _halo_counts(rng, N):
    """The integer columns of halo_info besides N and the subsample
    indices: ntagged{A,B}, L2_N (5 wide: the largest L2 group first),
    L0_N, npout{A,B}_L0L1."""
    n = len(N)
    l2 = (N[:, None] * (rng.random((n, 5)) ** (np.arange(5) + 1))).astype(np.uint32)
    return {'ntaggedA': (N // 7).astype(np.uint32), 'ntaggedB': (N // 11).astype(np.uint32),
            'L2_N': l2, 'L0_N': (N * 1.3).astype(np.uint32),
            'npoutA_L0L1': (N // 5).astype(np.uint32), 'npoutB_L0L1': (N // 3).astype(np.uint32)}


def synthetic_compaso(n_slabs, n_halo, n_part, n_field, seed=0, merge_frac=0.05, z=0.5):
    """A synthetic CompaSO catalog of `n_slabs` x-slabs of a periodic box:
    about `n_halo` halos (N ~ N^-2 over [35, 1e5] particles, in clumps of
    sigma 8 Mpc/h), about `n_part` A-subsample particles laid out halo by
    halo (each within ~0.4 r100 of its halo), a B subsample of
    ParticleSubsampleB / ParticleSubsampleA times as many (uniform offsets
    of the same spread, cheaper to draw), packed PID words
    for both, `n_field` field particles, and the cleaning: a `merge_frac`
    share of each slab's halos merged into other halos of the slab (N_total
    0; their particles listed again in the cleaned_rvpid file under the
    halo that absorbed them). The B set and the PIDs come from a stream of
    their own, so the rest does not depend on them; every other halo
    statistic of io/compaso.py:user_dt (:func:`_halo_stats`,
    :func:`_halo_counts`) and the cleaning files' progenitor columns
    (TIME_SLICE_PREV wide) from a third.

    Returns {'header', 'slabs': [per slab {'halo_info': the stored halo_info
    columns, 'clean': the cleaned_halo_info columns, 'rv_A', 'rv_B',
    'clean_rv_A', 'clean_rv_B', 'field_rv_A' (RVint words), 'pid_A',
    'pid_B', 'clean_pid_A', 'clean_pid_B' (packed PIDs), 'merged_into'
    (absorbing halo or -1), 'clean_rows_A' / 'clean_rows_B' (the set's row
    of each cleaned row), 'pos_true_A' / 'vel_true_A' and the same of B
    (positions in Mpc/h and velocities in km/s before encoding)}]}."""
    header = summit_header(z)
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    b_per_a = header['ParticleSubsampleB'] / header['ParticleSubsampleA']
    slabs = []
    for s in range(n_slabs):
        rng = np.random.default_rng([seed, s])
        rng_b = np.random.default_rng([seed, s, 1])
        rng_s = np.random.default_rng([seed, s, 2])
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
        ppos, pvel = _halo_particles(rng, np.repeat(np.arange(n), npout), pos,
                                     halo_info['v_L2com'], r100, sig, kms)

        # the cleaning: merged halos and the halos that absorb them
        merged = rng.random(n) < merge_frac
        keep = np.flatnonzero(~merged)
        into = np.full(n, -1, np.int64)
        into[merged] = keep[rng.integers(0, len(keep), int(merged.sum()))]
        N_total = N.copy()
        N_total[merged] = 0
        np.add.at(N_total, into[merged], N[merged])
        n_merge = np.bincount(into[merged], weights=N[merged], minlength=n).astype(np.uint32)
        donors = np.flatnonzero(merged)
        donors = donors[np.lexsort((donors, into[donors]))]
        clean = {
            'npstartA_merge': None, 'npstartB_merge': None, 'npoutA_merge': None,
            'npoutB_merge': None, 'N_total': N_total, 'N_merge': n_merge,
            'haloindex': np.arange(n, dtype=np.uint64), 'is_merged_to': into,
            'haloindex_mainprog': np.full(n, -1, np.int64),
            'v_L2com_mainprog': np.zeros((n, 3), np.float32),
        }
        nf = n_field // n_slabs + (n_field % n_slabs if s == n_slabs - 1 else 0)
        fpos = rng.random((nf, 3), dtype=np.float32) * np.float32([xhi - xlo, 1, 1])
        fpos += np.float32([xlo, -0.5, -0.5])
        fvel = np.clip(300.0 * rng.standard_normal((nf, 3), dtype=np.float32), -2048 * RV_VEL_QUANTUM,
                       2047 * RV_VEL_QUANTUM)
        slab = {'halo_info': halo_info, 'clean': clean, 'field_rv_A': rvint_words(fpos, fvel),
                'merged_into': into}

        # the B set and both sets' PIDs
        npoutB = rng_b.binomial(N, min(1.0, fa * b_per_a)).astype(np.uint32)
        halo_info['npstartB'] = np.concatenate(
            [[0], np.cumsum(npoutB, dtype=np.uint64)[:-1]]).astype(np.uint64)
        halo_info['npoutB'] = npoutB
        pposB, pvelB = _halo_particles(rng_b, np.repeat(np.arange(n), npoutB), pos,
                                       halo_info['v_L2com'], r100, sig, kms, uniform=True)
        for ab, p, v, start, nout in (('A', ppos, pvel, npstart, npout),
                                      ('B', pposB, pvelB, halo_info['npstartB'], npoutB)):
            rv, pid = rvint_words(p, v), pid_words(rng_b, len(p), header['ppd'])
            nout_merge = np.bincount(into[merged], weights=nout[merged],
                                     minlength=n).astype(np.uint32)
            rows = np.concatenate([np.arange(int(start[d]), int(start[d]) + int(nout[d]))
                                   for d in donors] + [np.empty(0, np.int64)])
            clean[f'npstart{ab}_merge'] = np.concatenate(
                [[0], np.cumsum(nout_merge, dtype=np.int64)[:-1]])
            clean[f'npout{ab}_merge'] = nout_merge
            slab.update({f'rv_{ab}': rv, f'pid_{ab}': pid, f'clean_rv_{ab}': rv[rows],
                         f'clean_pid_{ab}': pid[rows], f'clean_rows_{ab}': rows,
                         f'pos_true_{ab}': p * box, f'vel_true_{ab}': v})

        # every other halo statistic and the progenitor columns
        halo_info.update(_halo_stats(rng_s, n, ('_com', '_L2com'), halo_info))
        halo_info.update(_halo_counts(rng_s, N))
        nprev = len(TIME_SLICE_PREV)
        clean.update(
            N_mainprog=(N[:, None] * rng_s.random((n, nprev), dtype=np.float32)).astype(np.uint32),
            vcirc_max_L2com_mainprog=rng_s.random((n, nprev), dtype=np.float32) * np.float32(300),
            sigmav3d_L2com_mainprog=rng_s.random((n, nprev), dtype=np.float32) * np.float32(250))
        slabs.append(slab)
    return {'header': header, 'slabs': slabs}


def write_compaso_sim(root, sim, writer=None, compression='blsc'):
    """Write `sim` (:func:`synthetic_compaso`) under `root` in the AbacusSummit
    layout: ``<SimName>/halos/z<z>/{halo_info,halo_rv_A,halo_rv_B,halo_pid_A,
    halo_pid_B,field_rv_A}/*_NNN.asdf`` and ``cleaning/<SimName>/z<z>/
    {cleaned_halo_info,cleaned_rvpid}/``. The writer is the port's
    ``write_asdf`` unless another with its arguments ``(fn, tree,
    compression=)`` is given. Returns {'groupdir', 'files', 'raw_bytes' (the
    arrays' bytes), 'disk_bytes'}."""
    if writer is None:
        from .io.asdf_file import write_asdf as writer
    header = sim['header']
    name, zdir = header['SimName'], f'z{header["Redshift"]:4.3f}'
    groupdir = Path(root) / name / 'halos' / zdir
    cleandir = Path(root) / 'cleaning' / name / zdir
    clean_header = dict(header, TimeSliceRedshiftsPrev=list(TIME_SLICE_PREV))
    files, raw = [], 0
    for s, slab in enumerate(sim['slabs']):
        particle_files = [
            (groupdir / f'halo_{kind}_{ab}' / f'halo_{kind}_{ab}_{s:03d}.asdf', header,
             {col: slab[f'{kind}_{ab}']})
            for kind, col in (('rv', 'rvint'), ('pid', 'packedpid')) for ab in 'AB']
        clean_words = {f'{col}_{ab}': slab[f'clean_{kind}_{ab}']
                       for kind, col in (('rv', 'rvint'), ('pid', 'packedpid')) for ab in 'AB'}
        for path, hdr, data in (
            (groupdir / 'halo_info' / f'halo_info_{s:03d}.asdf', header, slab['halo_info']),
            *particle_files,
            (groupdir / 'field_rv_A' / f'field_rv_A_{s:03d}.asdf', header,
             {'rvint': slab['field_rv_A']}),
            (cleandir / 'cleaned_halo_info' / f'cleaned_halo_info_{s:03d}.asdf', clean_header,
             slab['clean']),
            (cleandir / 'cleaned_rvpid' / f'cleaned_rvpid_{s:03d}.asdf', clean_header,
             clean_words),
        ):
            path.parent.mkdir(parents=True, exist_ok=True)
            writer(path, {'header': hdr, 'data': data}, compression=compression)
            files.append(path)
            raw += sum(a.nbytes for a in data.values())
    return {'groupdir': groupdir, 'files': files, 'raw_bytes': raw,
            'disk_bytes': sum(f.stat().st_size for f in files)}


def decoded_catalog(sim, slabs, cleaned, particles=True, sets='A'):
    """What ``CompaSOHaloCatalog(<those slabs' files>, fields=[N, x_L2com,
    v_L2com, r90_L2com, r25_L2com, r98_L2com, npstartA, npoutA, id,
    sigmav3d_L2com], subsamples=dict(A=True, rv=True), cleaned=cleaned)``
    returns (with B in `sets`: the B set too, and npstartB / npoutB), from
    the arrays `sim` was written from: (halos, particles), dicts of numpy
    columns. The halo columns follow the encodings' decode formulas
    (float32 arithmetic, as the loaders); the particles (each surviving
    halo's own particles, then those of the halos merged into it; every
    halo's A before every halo's B) are given as their RVint words 'rvint',
    their packed PIDs 'packedpid' and their values before encoding,
    'pos_true' and 'vel_true' (None without `particles`)."""
    header = sim['header']
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    halos, parts = [], {ab: [] for ab in sets}
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
        for ab in sets:
            # a survivor's own particles, then those of the halos merged into
            # it (in the cleaned file's order); a merged halo keeps none
            own_n, merge_n = h[f'npout{ab}'], c[f'npout{ab}_merge']
            cols[f'npout{ab}'] = (np.where(slab['merged_into'] < 0, own_n, 0) + merge_n
                                  if cleaned else own_n).astype(np.uint32)
            if not particles:
                continue
            owner = np.repeat(np.arange(n), own_n)
            rows = np.arange(len(owner))
            if cleaned:
                crows = slab[f'clean_rows_{ab}']
                own = slab['merged_into'][owner] < 0
                absorber = slab['merged_into'][owner[crows]]
                order = np.argsort(np.concatenate([2 * owner[own], 2 * absorber + 1]),
                                   kind='stable')
                src = np.concatenate([rows[own], crows])[order]
            else:
                src = rows
            parts[ab].append({'rvint': slab[f'rv_{ab}'][src], 'packedpid': slab[f'pid_{ab}'][src],
                              'pos_true': slab[f'pos_true_{ab}'][src],
                              'vel_true': slab[f'vel_true_{ab}'][src]})
        halos.append(cols)
    out = {k: np.concatenate([c[k] for c in halos]) for k in halos[0]}
    base = np.uint64(0)
    for ab in sets:
        # every halo's A, then every halo's B
        starts = np.concatenate([[0], np.cumsum(out[f'npout{ab}'], dtype=np.uint64)])
        out[f'npstart{ab}'] = (starts[:-1] + base).astype(np.uint64)
        base += np.uint64(starts[-1])
    out['N'] = out['N'].astype(np.uint32)
    if not particles:
        return out, None
    flat = [p for ab in sets for p in parts[ab]]
    return out, {k: np.concatenate([p[k] for p in flat]) for k in flat[0]}


def decoded_fields(stored, clean, header, fields, convert_units=True):
    """The halo fields `fields` of a catalog slab decoded from its stored
    columns by the AbacusSummit formulas, written out field by field in
    numpy (no loader table): `stored` the halo_info columns, `clean` the
    cleaned_halo_info columns or None, `header` the catalog's header (its
    BoxSize and VelZSpace_to_kms, 1.0 each without `convert_units`).
    Returns {field: column} with io/compaso.py's dtypes."""
    from .io.compaso import clean_dt_progen, halo_lc_dt, unpack_euler16, user_dt

    box = header['BoxSize'] if convert_units else 1.0
    kms = header['VelZSpace_to_kms'] if convert_units else 1.0
    clean = clean or {}
    col = {**stored, **clean}.__getitem__
    euler = {}  # one decode a word column

    def value(f):
        suf = '_L2com' if f.endswith('_L2com') else '_com' if f.endswith('_com') else ''
        stem = f[:len(f) - len(suf)] if suf else f
        if stem in ('x', 'r100'):
            return col(f) * box
        if stem in ('v', 'sigmav3d', 'meanSpeed', 'sigmav3d_r50', 'meanSpeed_r50', 'vcirc_max'):
            return col(f) * kms
        if stem == 'rvcirc_max' or (stem[:1] == 'r' and stem[1:].isdigit()):
            return col(f + '_i16') * col('r100' + suf) / INT16SCALE * box
        if stem == 'sigmavMid':
            s3, smaj, smin = (out_dtype(value(g + suf), g + suf)
                              for g in ('sigmav3d', 'sigmavMaj', 'sigmavMin'))
            return np.sqrt(s3 ** 2 - smaj ** 2 - smin ** 2)
        if stem in ('sigmavMin', 'sigmavMaj', 'sigmavrad', 'sigmavtan'):
            on_disk = stem.replace('Maj', 'Max')
            return col(f'{on_disk}_to_sigmav3d{suf}_i16') * col('sigmav3d' + suf) / INT16SCALE * kms
        if stem == 'sigmar':
            return col(f + '_i16') * col('r100' + suf)[:, None] / INT16SCALE * box
        if stem == 'sigman':
            return col(f + '_i16') / INT16SCALE
        if '_eigenvecs' in stem:
            word = stem[:-3] + suf + '_u16'
            if word not in euler:
                euler[word] = dict(zip(('Min', 'Mid', 'Maj'), unpack_euler16(col(word))))
            return euler[word][stem[-3:]]
        if f.startswith('SO') and f.endswith(('_central_particle', '_radius')):
            return col(f) * box
        if f == 'origin':
            return col(f) % 3
        if f in ('pos_interp', 'vel_interp'):
            have_avg = np.any(col('pos_avg'), axis=1)[:, None]
            return np.where(have_avg, col(f[:3] + '_avg'), col(f))
        return col(f)

    def out_dtype(v, f):
        if f in clean_dt_progen.names and f in clean:
            dt = clean_dt_progen[f]
            if np.ndim(clean[f]) == 2 and f not in ('v_L2com_mainprog',):
                dt = np.dtype((dt, clean[f].shape[1]))
        elif f in halo_lc_dt.names:
            dt = halo_lc_dt[f]
        elif f in user_dt.names:
            dt = user_dt[f]
        else:
            dt = np.asarray(v).dtype
        out = np.empty(len(v), dtype=dt)
        out[...] = v
        return out

    return {f: out_dtype(value(f), f) for f in fields}


# ---------------------------------------------------------------------------
# pack9 rows
# ---------------------------------------------------------------------------


def pack9_rows(pos, vel, box, cpd, velzspace_to_kms):
    """Encode particles as pack9 rows, a cell header (first byte 0xFF: cpd,
    the velocity scale, the cell's x, y, z) before each non-empty cell's
    particles, cells in x, y, z order. pos: (N, 3) in [-box/2, box/2);
    vel: (N, 3) km/s. The position step is 1/2000 of a cell and the
    velocity step vscale * 0.0005 / cpd * velzspace_to_kms, vscale the
    least integer that keeps every velocity within 2000 steps. Returns
    (rows, order): the (M, 9) uint8 rows and the particles' order in them."""
    pos = np.asarray(pos, np.float64)
    vel = np.asarray(vel, np.float64)
    csize = box / cpd
    cell = np.clip(np.floor((pos + box / 2) / csize).astype(np.int64), 0, cpd - 1)
    key = (cell[:, 0] * cpd + cell[:, 1]) * cpd + cell[:, 2]
    order = np.argsort(key, kind='stable')
    key, cell, pos, vel = key[order], cell[order], pos[order], vel[order]
    vunit = 0.0005 / cpd * velzspace_to_kms
    vscale = max(1, math.ceil(float(np.abs(vel).max(initial=0.0)) / (2000 * vunit)))
    centre = (cell + 0.5) * csize - box / 2
    off = np.clip(np.rint((pos - centre) / (0.0005 * csize)), -1000, 1000)
    dv = np.clip(np.rint(vel / (vscale * vunit)), -2000, 2000)
    fields = np.concatenate([off, dv], 1).astype(np.int64) + 2048

    first = np.ones(len(key), bool)
    first[1:] = key[1:] != key[:-1]
    ncell = np.cumsum(first)  # cells opened up to and including each particle's
    rows_at = np.arange(len(key)) + ncell
    hdr_at = rows_at[first] - 1
    hdr = np.empty((int(first.sum()), 6), np.int64)
    hdr[:, 0] = 0xFFF  # a first byte of 0xFF
    hdr[:, 1] = cpd - 2000 + 2048
    hdr[:, 2] = vscale - 2000 + 2048
    hdr[:, 3:] = cell[first] - 2000 + 2048
    u = np.empty((len(key) + len(hdr), 6), np.int64)
    u[rows_at], u[hdr_at] = fields, hdr
    out = np.empty((len(u), 9), np.uint8)
    for j in range(3):
        a, b = u[:, 2 * j], u[:, 2 * j + 1]
        out[:, 3 * j] = a >> 4
        out[:, 3 * j + 1] = (a & 0x0F) | ((b >> 8) << 4)
        out[:, 3 * j + 2] = b & 0xFF
    return out, order


# ---------------------------------------------------------------------------
# a synthetic AbacusSummit halo light cone and light-cone particle files
# ---------------------------------------------------------------------------


def synthetic_compaso_lc(n_halo, n_per_halo=5, n_particles=0, seed=0, z=0.5, shell=LC_SHELL):
    """A synthetic halo light cone of AbacusSummit_base_c000_ph000 at z: about
    `n_halo` halos in clumps (sigma 8 Mpc/h) filling the octant of the
    `shell` (Mpc/h from the first observer of LC_ORIGINS, the three of
    which the header carries), with the L2 stats in the encodings of
    :func:`synthetic_compaso` (every L2 statistic of io/compaso.py:user_dt,
    L2_N among them) and the columns of halo_lc_dt:
    N and N_interp, npstartA / npoutA (about `n_per_halo` A particles a
    halo), index_halo (distinct int64 in no order), origin 0-5, pos_avg and
    vel_avg (zero for about a third of the halos), pos_interp and
    vel_interp (Mpc/h, km/s) and redshift_interp; the A particles of
    ``lc_pid_rv.asdf`` (float32 pos and vel around their halo's position,
    the averaged one where it has one, and packed pid); and with
    `n_particles`, a light-cone particle file pair (RVint and packed PIDs,
    positions in the shell).

    Returns {'header', 'halos': the stored columns, 'pid_rv': {'pos', 'vel',
    'pid'}, 'particles': {'rvint', 'packedpid', 'pos_true', 'vel_true'} or
    None}."""
    header = summit_header(z, light_cone=True)
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    origin = np.asarray(LC_ORIGINS[:3])
    rng = np.random.default_rng([seed, 99])
    r_min, r_max = shell

    def in_shell(n, ncl):
        # clump centres uniform in the octant's shell volume, halos around
        # them, radii folded back into the shell
        r3 = rng.uniform(r_min ** 3, r_max ** 3, ncl)
        u = np.abs(rng.standard_normal((ncl, 3)))
        cen = u / np.linalg.norm(u, axis=1)[:, None] * np.cbrt(r3)[:, None]
        d = cen[rng.integers(0, ncl, n)] + rng.normal(0, 8.0, (n, 3))
        d = np.abs(d)
        r = np.linalg.norm(d, axis=1)
        span = r_max - r_min
        folded = r_min + np.abs(np.mod(r - r_min + span, 2 * span) - span)
        folded = np.minimum(folded, np.nextafter(r_max, 0))
        return origin + d * (folded / r)[:, None]

    N = (1.0 / (1 / 35 - rng.random(n_halo) * (1 / 35 - 1e-5))).astype(np.uint32)
    pos = in_shell(n_halo, max(1, n_halo // 500))
    cube = np.cbrt(N / 1e3)
    r100 = ((0.3 + 0.7 * cube) / box).astype(np.float32)
    sig = (100.0 + 200.0 * cube) / kms
    vel = rng.normal(0, 300.0, (n_halo, 3))
    have_avg = rng.random(n_halo) >= 1 / 3
    pos_avg = np.where(have_avg[:, None], pos, 0.0).astype(np.float32)
    vel_avg = np.where(have_avg[:, None], vel, 0.0).astype(np.float32)
    # the interpolated values differ from the averaged ones where both exist
    pos_interp = (pos + np.where(have_avg[:, None], rng.normal(0, 0.5, (n_halo, 3)), 0.0))
    vel_interp = vel + np.where(have_avg[:, None], rng.normal(0, 20.0, (n_halo, 3)), 0.0)
    fa = min(1.0, n_per_halo * n_halo / float(N.sum()))
    npout = rng.binomial(N, fa).astype(np.uint32)
    npstart = np.concatenate([[0], np.cumsum(npout, dtype=np.uint64)[:-1]]).astype(np.uint64)
    index_halo = rng.choice(np.int64(4) * n_halo, n_halo, replace=False).astype(np.int64)
    index_halo += np.int64(10**11)
    halos = {
        'N': N, 'N_interp': np.maximum(N + rng.integers(-3, 4, n_halo), 35).astype(np.uint32),
        'npstartA': npstart, 'npoutA': npout, 'index_halo': index_halo,
        'origin': rng.integers(0, 6, n_halo).astype(np.int8),
        'pos_avg': pos_avg, 'pos_interp': pos_interp.astype(np.float32),
        'vel_avg': vel_avg, 'vel_interp': vel_interp.astype(np.float32),
        'redshift_interp': (z + rng.normal(0, 0.01, n_halo)).astype(np.float32),
        'x_L2com': (pos / box).astype(np.float32), 'v_L2com': (vel / kms).astype(np.float32),
        'r100_L2com': r100, 'sigmav3d_L2com': sig.astype(np.float32),
        'r90_L2com_i16': (rng.uniform(0.70, 0.85, n_halo) * INT16SCALE).astype(np.int16),
        'r25_L2com_i16': (rng.uniform(0.15, 0.35, n_halo) * INT16SCALE).astype(np.int16),
        'r98_L2com_i16': (rng.uniform(0.86, 0.99, n_halo) * INT16SCALE).astype(np.int16),
    }
    halos.update(_halo_stats(np.random.default_rng([seed, 99, 2]), n_halo, ('_L2com',), halos))
    halos['L2_N'] = _halo_counts(np.random.default_rng([seed, 99, 3]), N)['L2_N']
    # the A particles around each halo's position as the loader reads it
    centre = np.where(have_avg[:, None], pos_avg, halos['pos_interp']).astype(np.float64)
    owner = np.repeat(np.arange(n_halo), npout)
    gauss = rng.standard_normal((2, len(owner), 3), dtype=np.float32)
    ppos = centre[owner] + gauss[0] * (0.4 * r100[owner] * box)[:, None]
    pvel = vel[owner] + gauss[1] * (sig[owner] * kms / np.sqrt(3))[:, None]
    pid_rv = {'pos': ppos.astype(np.float32), 'vel': pvel.astype(np.float32),
              'pid': pid_words(rng, len(owner), header['ppd'])}
    particles = None
    if n_particles:
        p = in_shell(n_particles, max(1, n_particles // 5000)) / box
        v = np.clip(300.0 * rng.standard_normal((n_particles, 3)), -2048 * RV_VEL_QUANTUM,
                    2047 * RV_VEL_QUANTUM)
        particles = {'rvint': rvint_words(p, v), 'packedpid': pid_words(rng, n_particles,
                                                                   header['ppd']),
                     'pos_true': p * box, 'vel_true': v}
    return {'header': header, 'halos': halos, 'pid_rv': pid_rv, 'particles': particles}


def write_compaso_lc(root, sim, writer=None, compression='blsc'):
    """Write `sim` (:func:`synthetic_compaso_lc`) under `root`:
    ``halo_light_cones/<SimName>/z<z>/{lc_halo_info,lc_pid_rv}.asdf``, and
    its light-cone particle pair as ``lightcones/<SimName>/{rv,pid}/
    LightCone0_{rv,pid}.asdf`` (headers with OutputType 'LightCone'). The
    writer as in :func:`write_compaso_sim`. Returns {'groupdir', 'files',
    'particle_files' ({'rv', 'pid'} or None), 'raw_bytes', 'disk_bytes'}."""
    if writer is None:
        from .io.asdf_file import write_asdf as writer
    header = sim['header']
    name, zdir = header['SimName'], f'z{header["Redshift"]:4.3f}'
    groupdir = Path(root) / 'halo_light_cones' / name / zdir
    todo = [(groupdir / 'lc_halo_info.asdf', header, sim['halos']),
            (groupdir / 'lc_pid_rv.asdf', header, sim['pid_rv'])]
    particle_files = None
    if sim['particles'] is not None:
        lc_header = dict(header, OutputType='LightCone')
        particle_files = {k: Path(root) / 'lightcones' / name / k / f'LightCone0_{k}.asdf'
                          for k in ('rv', 'pid')}
        todo += [(particle_files['rv'], lc_header, {'rvint': sim['particles']['rvint']}),
                 (particle_files['pid'], lc_header, {'packedpid': sim['particles']['packedpid']})]
    files, raw = [], 0
    for path, hdr, data in todo:
        path.parent.mkdir(parents=True, exist_ok=True)
        writer(path, {'header': hdr, 'data': data}, compression=compression)
        files.append(path)
        raw += sum(a.nbytes for a in data.values())
    return {'groupdir': groupdir, 'files': files, 'particle_files': particle_files,
            'raw_bytes': raw, 'disk_bytes': sum(f.stat().st_size for f in files)}


def decoded_catalog_lc(sim):
    """What ``CompaSOHaloCatalog(<the light cone>, fields=<the keys of the
    halos returned>, subsamples=dict(A=True, pid=True, rv=True))`` returns, from
    the arrays `sim` was written from: (halos, particles), dicts of numpy
    columns by the decode formulas."""
    header = sim['header']
    box, kms = header['BoxSize'], header['VelZSpace_to_kms']
    h = sim['halos']
    have_avg = np.any(h['pos_avg'], axis=1)[:, None]
    halos = {k: h[k] for k in ('N', 'N_interp', 'npstartA', 'npoutA', 'index_halo', 'pos_avg',
                               'vel_avg', 'redshift_interp')}
    halos.update(
        origin=h['origin'] % 3,
        pos_interp=np.where(have_avg, h['pos_avg'], h['pos_interp']),
        vel_interp=np.where(have_avg, h['vel_avg'], h['vel_interp']),
        x_L2com=h['x_L2com'] * box, v_L2com=h['v_L2com'] * kms,
        sigmav3d_L2com=h['sigmav3d_L2com'] * kms,
        **{f'r{p}_L2com': h[f'r{p}_L2com_i16'] * h['r100_L2com'] / INT16SCALE * box
           for p in (90, 25, 98)})
    return halos, dict(sim['pid_rv'])
