r"""prepare_sim's per-particle rank fields for every ranked halo at once (K6 + sorts).

Counterpart of abacusutils_tpu/models/hod/ranks_device.py. The reference
computes five rank fields per selected particle (distance, velocity,
radial-velocity and NFW-perihelion ranks, and the nearest-neighbour
concentration rank) in a serial per-halo loop with a fresh cKDTree a halo
(:func:`~.prepare_sim._rank_fields`, the ``'host'`` engine). Here:

- the four elementwise keys (float32 dist^2, v^2 and v_rad, float64 rp^2)
  are computed on the host by :func:`_host_rank_keys`, the loop's numpy
  expressions on per-particle arrays, so they equal the loop's bit for bit;
- the nearest-neighbour key is the float64 squared distance to the
  nearest other particle of the halo's window, selected or not, from K6
  (``csrc/prepare_sim.cu:nn_within_halo``, :func:`nn_within_halo`). The
  loop ranks cKDTree's distance, its correctly rounded square root, which
  orders alike; two squared distances one ulp apart can share a root, and
  the loop then sees a tie where the key does not (torch.sqrt on the CPU
  is not correctly rounded, so the key is not rooted);
- each rank is :func:`seg_rank`: the position of (segment, key, index)
  among the selected particles of the segment, from two stable
  ``torch.sort`` passes and a ``cummax`` of the segment starts (the
  counterpart of ``_seg_rank3``; a sort, not a kernel);
- the (rank - mean) / mean normalization runs on the host in float64
  (:func:`_norm_ranks_host`), as the loop does.

Ties rank by index (the sorts are stable). The loop's numpy argsort is not
stable, so mutual nearest neighbours, which tie exactly, may swap ranks with
it; every untied rank is equal. NaN keys (a particle at its halo's centre
has a NaN v_rad) and -0.0 are made canonical before sorting, as ``lax.sort``
makes them: every NaN sorts after +inf, -0.0 ties with 0.0.

Hopper has float64, so there is one precision: the JAX package's 'x64' mode.
"""

import numpy as np
import torch

from ... import _build
from ...convert import resolve_device
from ...ops.grid import work_items

__all__ = [
    'rank_fields_device', 'seg_rank', 'nn_within_halo', 'nn_within_halo_plain',
    'nn_within_halo_filtered_plain', 'k6_threshold_plain', 'nn_work', 'K6_QUERIES',
]

# queries of one halo a K6 work item (and block) takes
K6_QUERIES = 128
# csrc/prepare_sim.cu: K6's shared tile, and the candidates its filter tests
# before one branch
K6_TILE = 512
K6_GROUP = 8
# window entries of a chunk of the plain version's pairwise tile
_PLAIN_PAIRS = 1 << 22


def _host_rank_keys(ppos, pvel, hpos_p, hvel_p, mass_p, r25_p, r98_p, h):
    """Vectorized numpy mirror of the host loop's key math
    (prepare_sim.py:_rank_fields), bit-identical per element: every
    expression is the loop's, on per-particle arrays, so the dtype
    promotions (f32 distance/velocity keys; the f64 `alpha` promoting the
    NFW iteration) happen in the same order. Returns (dist2 f32, v2 f32,
    vrad f32, rp2 f64)."""
    f32 = np.float32
    ppos = np.asarray(ppos, f32)
    pvel = np.asarray(pvel, f32)
    r_rel = ppos - np.asarray(hpos_p, f32)
    vels_rel = pvel - np.asarray(hvel_p, f32)
    rs = np.asarray(r25_p, f32)

    with np.errstate(invalid='ignore', divide='ignore', over='ignore'):
        dist2 = np.sum(r_rel**2, axis=1)
        v2 = np.sum(vels_rel**2, axis=1)

        r0 = np.sqrt(np.sum(r_rel**2, axis=1))
        r_rel_norm = r_rel / r0[:, None]
        vrad = np.sum(vels_rel * r_rel_norm, axis=1)

        v_rad2 = vrad**2
        v_tan2 = v2 - v_rad2

        # NFW perihelion iteration (reference :943-977), alpha in the
        # reference's expression and scalar-promotion order
        m = np.asarray(mass_p, np.float64) / h
        c = np.asarray(r98_p, f32) / rs
        r0_kpc = r0 * 1000
        alpha = (
            1.0 / (np.log(1 + c) - c / (1 + c))
            * 2 * 6.67e-11 * m * 2e30 / r0_kpc / 3.086e19 / 1e6
        )
        x2 = v_tan2 / (v_tan2 + v_rad2)
        factorA = v_tan2 + v_rad2
        factorB = np.log(1 + r0_kpc / rs)
        for _ in range(20):
            oldx = np.sqrt(x2)
            x2 = v_tan2 / (factorA + alpha * (np.log(1 + oldx * r0_kpc / rs) / oldx - factorB))
        x2[np.isnan(x2)] = 1
        rp2 = r0_kpc**2 * x2
    return dist2, v2, vrad, rp2


def _norm_ranks_host(rank, sel, nsub_p):
    """The loop's normalization (rank - mean) / mean with mean = (nsub - 1)/2,
    in float64 on the host (np.mean of integer ranks is an exact integer or
    half-integer, so this is bit-identical to it); singletons (nsub == 1)
    get 0, unselected particles -1."""
    mean = (nsub_p - 1.0) * 0.5
    safe = np.where(mean > 0, mean, 1.0)
    out = (rank - mean) / safe
    out[nsub_p == 1] = 0.0
    out[~sel] = -1.0
    return out


def seg_rank(seg, sel, key):
    """Rank (int64) of each selected particle's key within its segment.

    seg: int32 segment id (-1: in none); sel: bool; key: float32 or float64.
    Unselected slots of a segment sort last as +inf; NaN keys sort after
    +inf and -0.0 equals 0.0, as ``lax.sort`` orders them, and ties rank by
    index. The rank of an unselected or unsegmented particle is meaningless
    (callers mask it). The order of (seg, key, index) comes from two stable
    sorts (by key, then by segment); a particle's rank is its position minus
    that of its segment's first, from a cummax of the segment starts
    (ranks_device.py:_seg_rank3)."""
    n = seg.numel()
    ok = sel & (seg >= 0)
    inf = torch.tensor(float('inf'), dtype=key.dtype, device=key.device)
    k = torch.where(ok, key, inf)
    # lax.sort's canonical forms: one positive NaN, and 0.0 for -0.0
    k = torch.where(k == 0, torch.zeros_like(k), k)
    k = torch.where(torch.isnan(k), torch.full_like(k, float('nan')), k)
    segk = torch.where(seg >= 0, seg, torch.full_like(seg, 2**30))
    _, by_key = torch.sort(k, stable=True)
    _, by_seg = torch.sort(segk[by_key], stable=True)
    order = by_key[by_seg]
    sseg = segk[order]
    iota = torch.arange(n, dtype=torch.int64, device=seg.device)
    is_start = torch.ones(n, dtype=torch.bool, device=seg.device)
    is_start[1:] = sseg[1:] != sseg[:-1]
    first = torch.cummax(torch.where(is_start, iota, torch.zeros_like(iota)), 0).values
    rank = torch.empty(n, dtype=torch.int64, device=seg.device)
    rank[order] = iota - first
    return rank


def nn_work(seg, sel, nhalo):
    """K6's queries and work list: the int32 indices of the selected
    particles of ranked halos, grouped by halo (stable, so by index within
    one), and the (halo, begin, end) items of at most :data:`K6_QUERIES`
    of them (ops/grid.py:work_items)."""
    qsel = sel & (seg >= 0)
    query = torch.nonzero(qsel).flatten()
    qseg, by_seg = torch.sort(seg[query], stable=True)
    query = query[by_seg].to(torch.int32).contiguous()
    starts = torch.zeros(nhalo + 1, dtype=torch.int64, device=seg.device)
    torch.cumsum(torch.bincount(qseg.long(), minlength=nhalo), 0, out=starts[1:])
    return query, work_items(starts, query.numel(), K6_QUERIES)


def nn_within_halo_plain(x, y, z, query, pstart, pnum, seg):
    """K6's function, halo by halo in float64 torch: for each query particle
    the least (dx dx + dy dy) + dz dz to another particle (by index) of its
    halo's window [pstart, pstart + pnum). Returns an (N,) float64 tensor,
    0 where no query lies."""
    out = torch.zeros(x.numel(), dtype=torch.float64, device=x.device)
    if query.numel() == 0:
        return out
    cols = [c.to(torch.float64) for c in (x, y, z)]
    query = query.long()
    qseg = seg[query].long()
    bounds = torch.searchsorted(qseg, torch.arange(pstart.numel() + 1, device=x.device))
    ps, pn, bounds = pstart.tolist(), pnum.tolist(), bounds.tolist()
    for h in range(len(ps)):
        q = query[bounds[h]:bounds[h + 1]]
        if q.numel() == 0:
            continue
        win = [c[ps[h]:ps[h] + pn[h]] for c in cols]
        chunk = max(1, _PLAIN_PAIRS // max(pn[h], 1))
        for c0 in range(0, q.numel(), chunk):
            qc = q[c0:c0 + chunk]
            dx, dy, dz = (c[qc][:, None] - w[None, :] for c, w in zip(cols, win))
            d2 = (dx * dx + dy * dy) + dz * dz
            self_slot = (qc - ps[h])[:, None] == torch.arange(pn[h], device=x.device)[None, :]
            d2 = d2.masked_fill(self_slot, float('inf'))
            out[qc] = d2.min(dim=1).values
    return out


def k6_threshold_plain(best):
    """K6's float32 filter threshold for a float64 running minimum `best`
    (csrc/prepare_sim.cu:k6_threshold): at least best (1 + 2^-21) + 2^-148.
    torch has no directed rounding, so the float64 value is raised by two
    ulps and its float32 rounding by one more where it fell below; the
    result may exceed the kernel's by an ulp, which keeps more candidates."""
    t = best * (1.0 + 2.0**-21) + 2.0**-148
    t = torch.nextafter(torch.nextafter(t, torch.full_like(t, float('inf'))),
                        torch.full_like(t, float('inf')))
    t32 = t.float()
    return torch.where(t32.double() < t,
                       torch.nextafter(t32, torch.full_like(t32, float('inf'))), t32)


def nn_within_halo_filtered_plain(x, y, z, query, pstart, pnum, seg):
    """K6's walk in torch, halo by halo: each query's running minimum starts
    at the slot after its own in the first tile of :data:`K6_TILE` (wrapped
    within it) and visits the window in order; a candidate whose float32
    squared distance dx dx + (dy dy + dz dz) exceeds
    :func:`k6_threshold_plain` of the minimum at the start of its group of
    :data:`K6_GROUP` (of the candidate itself past the last full group) is
    skipped, the rest take the exact float64 chain. The kernel fuses the
    float32 chain into FMAs; its proof (csrc/prepare_sim.cu) bounds the
    unfused chain alike. For finite coordinates the keys are bit-equal to
    :func:`nn_within_halo_plain`.

    Returns (the (N,) float64 keys, the float64 chains: one seed a query of
    a window of two or more, and every kept candidate but the query
    itself)."""
    out = torch.zeros(x.numel(), dtype=torch.float64, device=x.device)
    if query.numel() == 0:
        return out, 0
    cols = [c.to(torch.float64) for c in (x, y, z)]
    f32 = [c.to(torch.float32) for c in (x, y, z)]
    query = query.long()
    qseg = seg[query].long()
    bounds = torch.searchsorted(qseg, torch.arange(pstart.numel() + 1, device=x.device))
    ps, pn, bounds = pstart.tolist(), pnum.tolist(), bounds.tolist()
    chains = 0
    for h in range(len(ps)):
        q = query[bounds[h]:bounds[h + 1]]
        if q.numel() == 0:
            continue
        n = pn[h]
        win = [c[ps[h]:ps[h] + n] for c in cols]
        winf = [c[ps[h]:ps[h] + n] for c in f32]
        slots = torch.arange(n, device=x.device)
        # the group start whose minimum each candidate is tested against
        grouped = torch.where(slots < n // K6_GROUP * K6_GROUP, slots // K6_GROUP * K6_GROUP,
                              slots)
        chunk = max(1, _PLAIN_PAIRS // max(n, 1))
        for c0 in range(0, q.numel(), chunk):
            qc = q[c0:c0 + chunk]
            own = qc - ps[h]
            dx, dy, dz = (c[qc][:, None] - w[None, :] for c, w in zip(cols, win))
            key = ((dx * dx + dy * dy) + dz * dz).masked_fill(own[:, None] == slots[None, :],
                                                              float('inf'))
            del dx, dy, dz
            fx, fy, fz = (c[qc][:, None] - w[None, :] for c, w in zip(f32, winf))
            d2f = fx * fx + (fy * fy + fz * fz)
            del fx, fy, fz
            inf = torch.full((qc.numel(), 1), float('inf'), dtype=torch.float64,
                             device=x.device)
            seed = inf
            if n > 1:
                seed = key.gather(1, ((own + 1) % min(n, K6_TILE))[:, None])
                chains += qc.numel()
            before = torch.cat([inf, torch.cummin(key, 1).values[:, :-1]], 1)
            before = torch.minimum(before, seed)[:, grouped]
            kept = ~(d2f > k6_threshold_plain(before)) & torch.isfinite(key)
            chains += int(kept.sum())
            best = torch.where(kept, key, float('inf')).min(dim=1).values
            out[qc] = torch.minimum(best, seed[:, 0])
    return out, chains


def nn_within_halo(x, y, z, query, work, pstart, pnum, seg):
    """Least squared distance (float64) from each query particle to another
    particle of its halo's window, selected or not.

    x, y, z: contiguous float32 (N,) particle columns; query, work: from
    :func:`nn_work`; pstart, pnum: int32 windows of the ranked halos; seg:
    the int32 ranked-halo id of each particle (the plain version groups the
    queries by it). Returns an (N,) float64 tensor, written at the queries.

    On CUDA tensors this launches K6 (csrc/prepare_sim.cu) on the current
    stream; on CPU tensors it runs :func:`nn_within_halo_plain`."""
    dev = x.device
    if dev.type == 'cpu':
        return nn_within_halo_plain(x, y, z, query, pstart, pnum, seg)
    n = x.numel()
    for name, t in zip('xyz', (x, y, z)):
        if t.dtype != torch.float32 or t.shape != (n,) or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name} must be a contiguous ({n},) float32 tensor on {dev}')
    for name, t in (('query', query), ('work', work), ('pstart', pstart), ('pnum', pnum)):
        if t.dtype != torch.int32 or not t.is_contiguous() or t.device != dev:
            raise ValueError(f'{name} must be a contiguous int32 tensor on {dev}')
    if work.dim() != 2 or work.shape[1] != 3:
        raise ValueError('work must be an (nitems, 3) int32 tensor')
    out = torch.zeros(n, dtype=torch.float64, device=dev)
    lib = _build.lib()
    with torch.cuda.device(dev):
        code = lib.nn_within_halo(
            x.data_ptr(), y.data_ptr(), z.data_ptr(), query.data_ptr(), work.data_ptr(),
            work.shape[0], pstart.data_ptr(), pnum.data_ptr(), out.data_ptr(),
            torch.cuda.current_stream().cuda_stream,
        )
    _build.check(code, 'nn_within_halo')
    nn_within_halo.launches += 1
    return out


nn_within_halo.launches = 0


def rank_fields_device(ppos, pvel, submask, seg, nsub_p, pstart, pnum, hpos_p, hvel_p, mass_p,
                       r25_p, r98_p, h, device=None):
    """The five rank fields of every ranked halo on `device` (None: the card;
    'cpu' runs the plain versions), the contract of
    abacusutils_tpu/models/hod/ranks_device.py:rank_fields_device in its
    'x64' mode.

    ppos/pvel: (N, 3) float32 particle arrays in file order; submask: bool;
    seg: int32 ranked-halo id per particle (-1: not ranked); nsub_p: the
    selected count of the particle's halo; pstart/pnum: the ranked halos'
    windows (all particles of the halo: the NN rank sees unselected
    neighbours too); hpos_p/hvel_p: (N, 3) host-halo position and velocity
    per particle (float32); mass_p/r25_p/r98_p: per-particle halo columns.

    Returns (ranks, ranksv, ranksp, ranksr, ranksc), float64 numpy arrays:
    -1 for unselected particles, 0 for single-selection halos."""
    device = resolve_device(device)
    f32 = np.float32
    ppos = np.asarray(ppos, f32)
    seg_np = np.asarray(seg, np.int32)
    sel_np = np.asarray(submask, bool) & (seg_np >= 0)
    dist2, v2, vrad, rp2 = _host_rank_keys(ppos, pvel, hpos_p, hvel_p, mass_p, r25_p, r98_p, h)

    def up(a, dt=None):
        return torch.from_numpy(np.ascontiguousarray(a, dt)).to(device)

    seg_d, sel_d = up(seg_np), up(sel_np)
    x, y, z = (up(ppos[:, a]) for a in range(3))
    pstart_d = up(np.asarray(pstart, np.int64).astype(np.int32))
    pnum_d = up(np.asarray(pnum, np.int64).astype(np.int32))
    query, work = nn_work(seg_d, sel_d, pstart_d.numel())
    nn = nn_within_halo(x, y, z, query, work, pstart_d, pnum_d, seg_d)
    keys = [up(dist2), up(v2), up(rp2), up(vrad), nn]
    ranks = torch.stack([seg_rank(seg_d, sel_d, k) for k in keys]).cpu().numpy()
    nsub_p = np.asarray(nsub_p, np.float64)
    return tuple(_norm_ranks_host(r.astype(np.float64), sel_np, nsub_p) for r in ranks)
