"""A clustered halo and particle catalog drawn on the device from a seed.

The deployment a configuration file describes (``benchmark/configs/``): a
prepared AbacusSummit box at one redshift, cut to its halos and subsample
particles, in the column dicts that ``AbacusHOD`` takes.

- A Gaussian field on an ngrid^3 mesh of the box, with the linear power of
  the configuration's cosmology at its redshift times a halo bias squared
  (``cosmology.py``), drawn from white noise.
- Halos fall in the mesh's cells in proportion to exp(delta_G - sigma^2/2),
  a lognormal density (Coles & Jones 1991), uniformly within a cell; the
  cells are taken in mesh order, so the halos come sorted in x as a
  catalog's slabs are.
- Masses are 10^(log10_min + span u^power), u uniform.
- Each subsample particle picks its host with probability proportional to
  the host's mass (a subsample keeps a fixed share of every halo's
  particles) and sits at a Gaussian offset from it whose 98th-percentile
  radius is r98 = r98_at_1e14 (M / 1e14)^(1/3) Mpc/h. Particles are stored
  grouped by host, in halo order; each weighs 1 / (its host's particle
  count), as prepare_sim's staged ``pweights`` do.
- Velocities are Gaussian: halo bulk, halo dispersion and particle
  velocities with the widths in the file.
- A light-cone configuration keeps the halos of the octant seen from its
  origin out to its comoving distance, and their particles.

Every random number comes from one ``torch.Generator`` on the device seeded
with the run's seed, so a seed gives the same catalog on the same card.
"""

import math

import numpy as np
import torch

from . import cosmology


def _gaussian_field(cfg, gen, device):
    """delta_G on the ngrid^3 mesh (float32) and its variance."""
    n = int(cfg['field']['ngrid'])
    lbox = float(cfg['Lbox'])
    cell = lbox / n
    cosmo = cfg['cosmology']
    white = torch.randn((n, n, n), generator=gen, device=device, dtype=torch.float32)
    wk = torch.fft.rfftn(white)
    del white
    f = torch.fft.fftfreq(n, d=1.0 / n, device=device, dtype=torch.float64)
    fz = torch.arange(n // 2 + 1, device=device, dtype=torch.float64)
    k = (2.0 * math.pi / lbox) * torch.sqrt(
        f[:, None, None] ** 2 + f[None, :, None] ** 2 + fz[None, None, :] ** 2)
    pk = cosmology.power_at_z(k, cosmo, float(cfg['z']), xp=torch)
    del k
    # <|DFT delta|^2> = n^3 P / cell^3 for white noise of unit variance a cell
    amp = (float(cfg['field']['bias']) * torch.sqrt(pk / cell**3)).to(torch.float32)
    del pk
    amp[0, 0, 0] = 0.0
    delta = torch.fft.irfftn(wk * amp, s=(n, n, n))
    del wk, amp
    return delta, float(delta.double().var())


def _halos(cfg, gen, device):
    n = int(cfg['field']['ngrid'])
    lbox = float(cfg['Lbox'])
    nh = int(cfg['n_halo'])
    delta, var = _gaussian_field(cfg, gen, device)
    cdf = torch.cumsum(torch.exp(delta.double().reshape(-1) - 0.5 * var), 0)
    del delta
    u = torch.rand(nh, generator=gen, device=device, dtype=torch.float64) * cdf[-1]
    cells = torch.searchsorted(cdf, u, right=True).clamp_(max=n**3 - 1)
    del cdf, u
    cells, _ = torch.sort(cells)
    ix = torch.div(cells, n * n, rounding_mode='floor')
    iy = torch.div(cells, n, rounding_mode='floor') % n
    iz = cells % n
    del cells
    idx = torch.stack([ix, iy, iz], 1).to(torch.float64)
    off = torch.rand((nh, 3), generator=gen, device=device, dtype=torch.float64)
    pos = ((idx + off) * (lbox / n) - lbox / 2).to(torch.float32)
    # a float32 rounding may land a halo on +L/2: the box is [-L/2, L/2)
    pos = torch.where(pos >= lbox / 2, pos - lbox, pos)
    m = cfg['mass']
    u = torch.rand(nh, generator=gen, device=device, dtype=torch.float32)
    mass = 10.0 ** (float(m['log10_min']) + float(m['log10_span']) * u ** float(m['power']))
    v = cfg['velocity']
    return {
        'hid': torch.arange(nh, dtype=torch.int64, device=device),
        'hpos': pos,
        'hvel': torch.randn((nh, 3), generator=gen, device=device) * float(v['halo_sigma_kms']),
        'hveldev': (torch.randn((nh, 3), generator=gen, device=device)
                    * float(v['halo_dev_sigma_kms'])),
        'hmass': mass,
        'hmultis': torch.ones(nh, dtype=torch.float32, device=device),
        'hrandoms': torch.rand(nh, generator=gen, device=device, dtype=torch.float32),
    }


def _particles(cfg, halos, gen, device):
    lbox = float(cfg['Lbox'])
    nh, npart = int(cfg['n_halo']), int(cfg['n_part'])
    mass = halos['hmass']
    cdf = torch.cumsum(mass.double(), 0)
    u = torch.rand(npart, generator=gen, device=device, dtype=torch.float64) * cdf[-1]
    host = torch.searchsorted(cdf, u, right=True).clamp_(max=nh - 1)
    del cdf, u
    host, _ = torch.sort(host)
    nper = torch.bincount(host, minlength=nh)
    p = cfg['particles']
    hm = mass[host]
    sigma = float(p['r98_at_1e14']) / float(p['r98_over_sigma']) * (hm / 1e14) ** (1.0 / 3.0)
    off = torch.randn((npart, 3), generator=gen, device=device) * sigma[:, None]
    pos = halos['hpos'][host] + off
    del off
    pos = torch.remainder(pos + lbox / 2, lbox) - lbox / 2
    pos = torch.where(pos >= lbox / 2, pos - lbox, pos)
    v = cfg['velocity']
    return {
        'ppos': pos,
        'pvel': torch.randn((npart, 3), generator=gen, device=device)
        * float(v['particle_sigma_kms']),
        'phvel': halos['hvel'][host],
        'phmass': hm,
        'pweights': (1.0 / nper[host].to(torch.float64)).to(torch.float32),
        'prandoms': torch.rand(npart, generator=gen, device=device, dtype=torch.float32),
        'pinds': host.to(torch.int32),
        # a unique id a particle (the halos hold 0 .. n_halo - 1), so a
        # run_hod mock's rows can be told apart by id alone
        'phid': torch.arange(nh, nh + npart, dtype=torch.int64, device=device),
    }


def _octant(cfg, halos, parts):
    """The halos of the light cone's octant (x, y, z above the origin's and
    within chi_max of it) and their particles, host indices renumbered."""
    lc = cfg['lightcone']
    origin = torch.tensor(lc['origin'], dtype=torch.float32, device=halos['hpos'].device)
    d = halos['hpos'] - origin
    keep = (d >= 0).all(1) & (d.double().norm(dim=1) < float(lc['chi_max']))
    new = torch.cumsum(keep.to(torch.int64), 0) - 1
    halos = {k: v[keep] for k, v in halos.items()}
    pk = keep[parts['pinds'].long()]
    parts = {k: v[pk] for k, v in parts.items()}
    parts['pinds'] = new[parts['pinds'].long()].to(torch.int32)
    return halos, parts


def draw(cfg, seed, device):
    """(halo_data, particle_data) of the configuration `cfg` (a parsed
    ``configs/<name>.json``) from `seed`, on `device`."""
    device = torch.device(device)
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    halos = _halos(cfg, gen, device)
    parts = _particles(cfg, halos, gen, device)
    if cfg.get('lightcone'):
        halos, parts = _octant(cfg, halos, parts)
    return halos, parts


def hod_params(cfg):
    """The params dict of ``AbacusHOD`` for the configuration."""
    lc = cfg.get('lightcone')
    return {
        'z': float(cfg['z']), 'Lbox': float(cfg['Lbox']), 'velz2kms': float(cfg['velz2kms']),
        'origin': None if not lc else np.asarray(lc['origin'], np.float64), 'chunk': -1,
    }
