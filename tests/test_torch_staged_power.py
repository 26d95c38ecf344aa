"""Port parity for StagedPower: abacusutils_tpu_torch's staged P(k) (K1's
brick stage, a z column per call gathered into it) against the port's own
calc_power and get_field_fft on the same points, against a fresh stage of
the moved points, and against abacusutils_tpu's StagedPower (JAX on the
CPU), mirroring tests/test_power.py's StagedPower tests.

Tolerances: power within rtol 2e-4 of JAX (tests/test_power.py's own budget:
deposits and FFTs summing in other orders), poles within 2e-4 max|pole|;
for a weighted catalog, whose weights do not average to 1, plus 1e-5
sqrt(|P| P_0) with P_0 the power of the k = 0 mode: the f32 round-off of
that mode, ~10^4 times the others', leaks into every mode of both
packages' transforms (measured up to 2e-6 sqrt(|P| P_0));
against the port's calc_power and a fresh stage, whose deposits are the
same plain scatter of the same f32 points in another order, within 1e-5
(power) and 1e-5 max|pole| (f32 sums in another order); mode counts exact."""

import numpy as np
import numpy.testing as npt
import pytest
import torch

from abacusutils_tpu.ops import power as jpow
from abacusutils_tpu_torch.ops import power as tpow
from torch_helpers import t

JAX_RTOL = 2e-4
PORT_RTOL = 1e-5
LBOX = 500.0


def _catalog(n, seed, weighted=True):
    rng = np.random.default_rng(seed)
    pos = (rng.random((n, 3)) * LBOX).astype(np.float32)
    w = rng.random(n).astype(np.float32) if weighted else None
    return pos, w


def _dc_power(w, nmesh):
    """The power of the k = 0 mode of a weighted catalog's overdensity
    (grid N^3 / n - 1 sums to N^3 (sum w / n - 1))."""
    return 0.0 if w is None else (
        float(w.sum(dtype=np.float64)) * nmesh**3 / len(w) - nmesh**3) ** 2 * LBOX**3 / nmesh**6


def _close(got, want, rtol, dc=0.0):
    """Spectrum tables equal in their counts, power within rtol |P| (plus
    the k = 0 mode's round-off leak, 1e-5 sqrt(|P| dc), for a weighted
    catalog of k = 0 power dc) and poles within rtol max|pole|."""
    npt.assert_array_equal(got['N_mode'], np.asarray(want['N_mode']))
    P = np.asarray(want['power'])
    assert (np.abs(got['power'] - P) <= rtol * np.abs(P) + 1e-5 * np.sqrt(np.abs(P) * dc)).all()
    for key in ('k_mid', 'k_min', 'k_max'):
        npt.assert_array_equal(got[key], np.asarray(want[key]))
    if 'poles' in want:
        pw = np.asarray(want['poles'])
        npt.assert_allclose(got['poles'], pw, rtol=rtol, atol=rtol * np.abs(pw).max())
        npt.assert_array_equal(got['N_mode_poles'], np.asarray(want['N_mode_poles']))


def _calc(pos, nmesh, w=None, **kw):
    return tpow.calc_power(pos, LBOX, kbins=16, mubins=2, k_max=np.pi * nmesh / LBOX,
                           nmesh=nmesh, paste='TSC', compensated=True, interlaced=False, w=w,
                           poles=[0, 2], device='cpu', **kw)


@pytest.mark.parametrize('nmesh', [16, 31, 32])
def test_staged_power_matches_calc_power_and_jax(nmesh):
    """tests/test_power.py:test_staged_power_matches_calc_power: a weighted
    catalog, then per-call z overrides (numpy and tensor), each equal to
    calc_power of the moved points, to a fresh stage of them and to JAX's
    StagedPower with the same override."""
    pos, w = _catalog(40_000, 21 + nmesh)
    staged = tpow.StagedPower(pos, LBOX, nmesh=nmesh, w=w, device='cpu')
    jstaged = jpow.StagedPower(pos, LBOX, nmesh=nmesh, w=w)
    kw = dict(kbins=16, mubins=2, poles=[0, 2], compensated=True)
    got = staged.power(**kw)
    assert isinstance(got, tpow.SpectrumTable)
    want = jstaged.power(**kw)
    dc = _dc_power(w, nmesh)
    _close(got, want, JAX_RTOL, dc)
    assert got.meta == dict(want.meta)
    _close(got, _calc(pos, nmesh, w), PORT_RTOL)

    z2 = (pos[:, 2] + 5.0) % LBOX
    pos2 = pos.copy()
    pos2[:, 2] = z2
    fresh = tpow.StagedPower(pos2, LBOX, nmesh=nmesh, w=w, device='cpu').power(**kw)
    ref = _calc(pos2, nmesh, w)
    jgot = jstaged.power(**kw, pz=z2)
    for pz in (z2, t(z2)):
        got2 = staged.power(**kw, pz=pz)
        _close(got2, ref, PORT_RTOL)
        _close(got2, fresh, PORT_RTOL)
        _close(got2, jgot, JAX_RTOL, dc)
    with pytest.raises(ValueError, match='pz override'):
        staged.power(**kw, pz=z2[:-1])


def test_pz_past_the_margin_goes_through_the_overflow_path():
    """A z override that moves points past their brick's tile and margin (4
    cells, past the box too, so the deposit's wrap takes it) is deposited
    straight into the grid: the spectrum equals calc_power of the wrapped
    points, and the overflow word of the call counts the points that
    left."""
    nmesh = 64
    pos, w = _catalog(30_000, 5)
    staged = tpow.StagedPower(pos, LBOX, nmesh=nmesh, w=w, device='cpu')
    assert int(staged.overflow) == 0
    kw = dict(kbins=16, mubins=2, poles=[0, 2], compensated=True)
    shift = 4 * LBOX / nmesh
    pz = pos[:, 2] + shift
    got = staged.power(**kw, pz=pz)
    moved = pos.copy()
    moved[:, 2] = np.where(pz >= LBOX, pz - LBOX, pz)
    _close(got, _calc(moved, nmesh, w), PORT_RTOL)
    left = int(staged.overflow)
    assert 0 < left <= len(pos)
    staged.power(**kw)
    assert int(staged.overflow) == 0


def test_staged_power_cross_matches_calc_power_and_jax():
    """tests/test_power.py:test_staged_power_cross, with a z override on the
    second side (pz2)."""
    nmesh = 32
    pos, _ = _catalog(40_000, 41, weighted=False)
    pos2, _ = _catalog(20_000, 42, weighted=False)
    s1 = tpow.StagedPower(pos, LBOX, nmesh=nmesh, device='cpu')
    s2 = tpow.StagedPower(pos2, LBOX, nmesh=nmesh, device='cpu')
    kw = dict(kbins=16, poles=[0, 2])
    got = s1.power(**kw, cross=s2)
    want = jpow.StagedPower(pos, LBOX, nmesh=nmesh).power(
        **kw, cross=jpow.StagedPower(pos2, LBOX, nmesh=nmesh))
    npt.assert_array_equal(got['N_mode'], np.asarray(want['N_mode']))
    pw = np.asarray(want['power'])
    npt.assert_allclose(got['power'], pw, rtol=JAX_RTOL, atol=1e-6 * np.abs(pw).max())
    assert got.meta['N_pos2'] == len(pos2) and got.meta['is_weighted2'] is False
    z2 = (pos2[:, 2] + 7.0) % LBOX
    moved = pos2.copy()
    moved[:, 2] = z2
    got = s1.power(**kw, cross=s2, pz2=z2)
    ref = tpow.calc_power(pos, LBOX, kbins=16, k_max=np.pi * nmesh / LBOX, nmesh=nmesh,
                          interlaced=False, pos2=moved, poles=[0, 2], device='cpu')
    pr = np.asarray(ref['power'])
    npt.assert_allclose(got['power'], pr, rtol=PORT_RTOL, atol=1e-6 * np.abs(pr).max())
    with pytest.raises(ValueError, match='cross-stage'):
        s1.power(cross=tpow.StagedPower(pos2, LBOX, nmesh=16, device='cpu'))


def test_staged_power_interlaced_and_field_fft():
    """tests/test_power.py:test_staged_power_interlaced: two stages, the
    second at the half-cell offset, equal to calc_power(interlaced=True) and
    to JAX; field_fft equal to get_field_fft of the same points, interlaced
    and not, compensated and not."""
    nmesh = 32
    pos, _ = _catalog(40_000, 51, weighted=False)
    staged = tpow.StagedPower(pos, LBOX, nmesh=nmesh, interlaced=True, device='cpu')
    got = staged.power(kbins=16, poles=[0, 2])
    want = jpow.StagedPower(pos, LBOX, nmesh=nmesh, interlaced=True).power(kbins=16, poles=[0, 2])
    npt.assert_array_equal(got['N_mode'], np.asarray(want['N_mode']))
    pw = np.asarray(want['power'])
    npt.assert_allclose(got['power'], pw, rtol=JAX_RTOL, atol=1e-6 * np.abs(pw).max())
    assert got.meta['interlaced'] is True
    ref = tpow.calc_power(pos, LBOX, kbins=16, k_max=np.pi * nmesh / LBOX, nmesh=nmesh,
                          interlaced=True, poles=[0, 2], device='cpu')
    npt.assert_allclose(got['power'], ref['power'], rtol=PORT_RTOL)
    for st in (staged, tpow.StagedPower(pos, LBOX, nmesh=nmesh, device='cpu')):
        for comp in (True, False):
            W = tpow.get_W_compensated(LBOX, nmesh, 'TSC', st.interlaced) if comp else None
            F = st.field_fft(compensated=comp)
            G = tpow.get_field_fft(pos, LBOX, nmesh, 'TSC', None, W, comp, st.interlaced,
                                   device='cpu')
            npt.assert_allclose(F.numpy(), G.numpy(), rtol=0,
                                atol=PORT_RTOL * np.abs(G.numpy()).max())


def test_staged_power_inputs():
    """tests/test_power.py:test_power_soa_and_device_inputs: an SoA (x, y, z)
    tuple and CPU tensors stage as the (N, 3) numpy array does; numpy input
    without a device goes to the card (refused without one); TSC only."""
    nmesh = 16
    pos, w = _catalog(20_000, 61)
    kw = dict(kbins=8, poles=[0, 2])
    ref = tpow.StagedPower(pos, LBOX, nmesh=nmesh, w=w, device='cpu').power(**kw)
    soa = tuple(pos[:, i] for i in range(3))
    for p, ww in ((soa, w), (t(pos), t(w)), (tuple(t(c) for c in soa), t(w))):
        got = tpow.StagedPower(p, LBOX, nmesh=nmesh, w=ww, device='cpu').power(**kw)
        npt.assert_array_equal(got['power'], ref['power'])
        npt.assert_array_equal(got['poles'], ref['poles'])
    with pytest.raises(ValueError, match='TSC'):
        tpow.StagedPower(pos, LBOX, nmesh=nmesh, paste='CIC', device='cpu')
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match='no CUDA device'):
            tpow.StagedPower(pos, LBOX, nmesh=nmesh)
