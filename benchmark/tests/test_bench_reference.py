"""The plain references hold against brute force on small inputs, and the
configurations' derived numbers follow from their cosmology."""

import itertools
import math

import numpy as np
import pytest
import torch

from benchmark import cosmology, harness
from benchmark.reference import mesh, pairs

RNG = np.random.default_rng(5)
LBOX = 120.0
RPBINS = np.array([0.5, 2.0, 8.0, 20.0])
PIMAX = 30


def _brute(p, q, auto):
    d = p[:, None, :] - q[None, :, :]
    d -= LBOX * np.round(d / LBOX)
    rp2 = d[..., 0] ** 2 + d[..., 1] ** 2
    adz = np.abs(d[..., 2])
    out = np.zeros((len(RPBINS) - 1, PIMAX), np.int64)
    for i, j in itertools.product(range(len(p)), range(len(q))):
        if auto and i == j:
            continue
        b = np.searchsorted(RPBINS**2, rp2[i, j], side='right') - 1
        if 0 <= b < len(RPBINS) - 1 and adz[i, j] < PIMAX:
            out[b, int(adz[i, j])] += 1
    return out


@pytest.mark.parametrize('auto', [True, False])
def test_pair_counts_match_brute_force(auto):
    # clumped points in [-L/2, L/2), some across the periodic faces
    c = RNG.uniform(-LBOX / 2, LBOX / 2, (20, 3))
    p = (c[RNG.integers(0, 20, 300)] + RNG.normal(0, 6, (300, 3)) + LBOX / 2) % LBOX - LBOX / 2
    q = p if auto else (p[::-1] + RNG.normal(0, 1, p.shape) + LBOX / 2) % LBOX - LBOX / 2
    got = pairs.rppi_counts(torch.from_numpy(p), LBOX, RPBINS, PIMAX,
                            pos2=None if auto else torch.from_numpy(q), block_pairs=997)
    assert np.array_equal(got.numpy(), _brute(p, q, auto))


def test_tsc_mesh_matches_its_definition():
    n = 6
    p = torch.from_numpy(RNG.uniform(-LBOX / 2, LBOX / 2, (50, 3)))
    got = mesh.tsc_mesh(p, n, LBOX).numpy()
    want = np.zeros((n, n, n))
    for x in p.numpy():
        g = np.mod(x, LBOX) * n / LBOX
        i0 = np.floor(g + 0.5)
        w = {}
        for a in range(3):
            d = i0[a] - g[a]
            w[a] = {-1: 0.5 * (0.5 + d) ** 2, 0: 0.75 - d * d, 1: 0.5 * (0.5 - d) ** 2}
        for o in itertools.product((-1, 0, 1), repeat=3):
            idx = tuple(int(i0[a] + o[a]) % n for a in range(3))
            want[idx] += w[0][o[0]] * w[1][o[1]] * w[2][o[2]]
    np.testing.assert_allclose(got, want, rtol=1e-12, atol=1e-14)
    assert got.sum() == pytest.approx(50.0)


def test_binned_auto_spectrum_is_the_mode_mean():
    n = 8
    f = torch.fft.rfftn(torch.from_numpy(RNG.normal(size=(n, n, n))))
    kedges = np.linspace(0.0, math.pi * n / LBOX, 5)
    out, counts, _ = mesh.binned_spectra([f], LBOX, kedges, np.array([0.0, 1.0]))
    k = np.fft.fftfreq(n, 1.0 / n)
    kz = np.arange(n // 2 + 1)
    k2 = (k[:, None, None] ** 2 + k[None, :, None] ** 2 + kz[None, None, :] ** 2).astype(np.float32)
    dup = np.where((kz == 0) | (kz == n // 2), 1.0, 2.0)[None, None, :] * np.ones_like(k2)
    e2 = mesh.squared_edges(kedges, LBOX)
    b = np.clip(np.searchsorted(e2, k2, side='left') - 1, 0, 3)
    ok = (k2 >= e2[0]) & (k2 < e2[-1])
    p = np.abs(f.numpy()) ** 2 / n**6 * dup
    for j in range(4):
        sel = ok & (b == j)
        assert counts[j, 0] == dup[sel].sum()
        assert out[(0, 0)][0][j, 0] == pytest.approx(p[sel].sum() / dup[sel].sum() * LBOX**3)


@pytest.mark.parametrize('name', ['abacus_base_box_z05', 'abacus_base_lc_octant_z05'])
def test_configuration_numbers_follow_from_the_cosmology(name):
    cfg = harness.load_json(harness.ROOT / 'benchmark' / 'configs' / f'{name}.json')
    om = cfg['cosmology']['Omega_m']
    assert cfg['velz2kms'] == pytest.approx(cosmology.velz2kms(cfg['z'], om), rel=1e-12)
    if cfg['lightcone']:
        lc = cfg['lightcone']
        assert lc['chi_max'] == pytest.approx(cosmology.comoving_distance(lc['z_max'], om))
    c = cfg['cosmology']
    lnk = np.linspace(math.log(1e-5), math.log(1e2), 20001)
    k = np.exp(lnk)
    x = 8.0 * k
    w = 3.0 * (np.sin(x) - x * np.cos(x)) / x**3
    for z, want in ((0.0, c['sigma8']), (cfg['z'], c['sigma8'] * cosmology.growth(cfg['z'], om))):
        s2 = np.trapezoid(k**3 * cosmology.power_at_z(k, c, z) * w**2 / (2 * math.pi**2), lnk)
        assert math.sqrt(s2) == pytest.approx(want, rel=1e-4)
